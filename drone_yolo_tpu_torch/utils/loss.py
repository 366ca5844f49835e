"""v8 detection, segmentation, pose and oriented box losses: BCE on class logits, CIoU (probiou for rotated boxes) and
DFL on task-aligned targets, mask BCE, keypoint OKS and visibility; and the classifier's cross-entropy.

Counterpart of `drone_yolo_tpu/utils/loss.py` (`bce_with_logits`, `df_loss`, `v8DetectionLoss`, `v8SegmentationLoss`,
`v8PoseLoss`, `v8OBBLoss`, `E2EDetectLoss`, `v8ClassificationLoss`). Targets arrive padded to M slots per image with a
validity mask, in the collate format (`cls` (B, M), `bboxes` (B, M, 4) xyxy pixels, `mask` (B, M)); padded slots are
zeroed so that they catch no anchor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from drone_yolo_tpu_torch.nn.modules import dfl_expectation, wide
from drone_yolo_tpu_torch.ops.anchors import bbox2dist, dist2bbox, dist2rbox, make_anchors
from drone_yolo_tpu_torch.ops.boxes import bbox_ciou, probiou, xywh2xyxy
from drone_yolo_tpu_torch.ops.masks import crop_mask
from drone_yolo_tpu_torch.utils.metrics import kpt_sigmas
from drone_yolo_tpu_torch.utils.tal import RotatedTaskAlignedAssigner, TaskAlignedAssigner


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits: max(x, 0) - x * y + log1p(exp(-|x|))."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def df_loss(pred_dist: torch.Tensor, target: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Distribution focal loss: (..., 4, reg_max) logits, (..., 4) distances -> (..., 1), the mean over the 4 sides
    of the cross-entropy against the two bins around each distance, weighted by nearness."""
    target = target.clamp(0, reg_max - 1 - 0.01)
    tl = target.floor()
    wl = tl + 1.0 - target  # weight of the left bin
    wr = 1.0 - wl
    bins = torch.arange(reg_max, dtype=target.dtype, device=target.device)
    two_hot = wl[..., None] * (bins == tl[..., None]) + wr[..., None] * (bins == tl[..., None] + 1.0)
    return (torch.logsumexp(pred_dist, -1) - (two_hot * pred_dist).sum(-1)).mean(-1, keepdim=True)


class v8DetectionLoss:
    """Detection criterion over the head's per-level (B, 4 * reg_max + nc, H, W) train maps.

    Returns (sum of the gained items * B, items (3,) detached: box, cls, dfl).
    """

    def __init__(self, model, tal_topk: int = 10, box: float = 7.5, cls: float = 0.5, dfl: float = 1.5):
        head = model.head
        self.nc, self.reg_max = head.nc, head.reg_max
        self.strides = list(head.stride)
        self.gains = (box, cls, dfl)
        self.assigner = TaskAlignedAssigner(topk=tal_topk, num_classes=self.nc, alpha=0.5, beta=6.0)

    def _detect_parts(self, feats, targets: dict) -> dict:
        """The detection losses and the intermediates a task loss builds on (`drone_yolo_tpu/utils/loss.py:
        _detect_parts`): anchor_points (A, 2) and stride_tensor (A, 1) in grid units, fg_mask (B, A), t_gt_idx
        (B, A) the assigned GT slot, t_bboxes (B, A, 4) the assigned boxes in pixels, weight (B, A) the summed
        target scores of foreground anchors, and the unweighted loss_box, loss_cls, loss_dfl."""
        anchor_points, stride_tensor = make_anchors([f.shape[2:] for f in feats], self.strides, device=feats[0].device)
        # (B, A, no) in the compute dtype, anchors ordered level by level and row-major, as the JAX NHWC reshape
        flat = torch.cat([f.flatten(2) for f in feats], 2).transpose(1, 2)
        pred_distri, pred_scores = flat[..., : 4 * self.reg_max], wide(flat[..., 4 * self.reg_max :])
        pred_bboxes = dist2bbox(dfl_expectation(pred_distri, self.reg_max), anchor_points, xywh=False)  # grid units

        mask_gt = targets["mask"].to(pred_scores.dtype)
        gt_bboxes = targets["bboxes"].to(pred_scores.dtype) * mask_gt[..., None]
        _, t_bboxes, target_scores, fg_mask, t_gt_idx = self.assigner(
            pred_scores.detach().sigmoid(), pred_bboxes.detach() * stride_tensor, anchor_points * stride_tensor,
            targets["cls"].long(), gt_bboxes, mask_gt)
        target_scores_sum = target_scores.sum().clamp(min=1.0)

        loss_cls = bce_with_logits(pred_scores, target_scores).sum() / target_scores_sum
        target_bboxes = t_bboxes / stride_tensor
        weight = target_scores.sum(-1) * fg_mask
        iou = bbox_ciou(pred_bboxes, target_bboxes)
        loss_box = ((1.0 - iou) * weight).sum() / target_scores_sum
        target_ltrb = bbox2dist(anchor_points, target_bboxes, self.reg_max - 1)
        dfl = df_loss(wide(pred_distri).unflatten(-1, (4, self.reg_max)), target_ltrb, self.reg_max)[..., 0]
        loss_dfl = (dfl * weight).sum() / target_scores_sum
        return {"anchor_points": anchor_points, "stride_tensor": stride_tensor, "fg_mask": fg_mask,
                "t_gt_idx": t_gt_idx, "t_bboxes": t_bboxes, "weight": weight, "loss_box": loss_box,
                "loss_cls": loss_cls, "loss_dfl": loss_dfl}

    def __call__(self, feats, targets: dict):
        p = self._detect_parts(feats, targets)
        items = torch.stack([p["loss_box"] * self.gains[0], p["loss_cls"] * self.gains[1], p["loss_dfl"] * self.gains[2]])
        return items.sum() * feats[0].shape[0], items.detach()


class E2EDetectLoss:
    """YOLOv10's dual-assignment criterion over `v10Detect`'s train output {"one2many": maps, "one2one": maps}: the
    detection loss with TAL's top 10 on the one-to-many maps plus the one with TAL's top 1 on the one-to-one maps,
    losses and items both summed."""

    def __init__(self, model, box: float = 7.5, cls: float = 0.5, dfl: float = 1.5):
        self.one2many = v8DetectionLoss(model, tal_topk=10, box=box, cls=cls, dfl=dfl)
        self.one2one = v8DetectionLoss(model, tal_topk=1, box=box, cls=cls, dfl=dfl)

    def __call__(self, outs: dict, targets: dict):
        l_many, i_many = self.one2many(outs["one2many"], targets)
        l_one, i_one = self.one2one(outs["one2one"], targets)
        return l_many + l_one, i_many + i_one


def top_foreground(weight: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The `k` anchors of each image with the largest `weight` (B, A), as `jax.lax.top_k` picks them (ties to the
    lower anchor index): (scores (B, k), indices (B, k))."""
    scores, idx = weight.sort(dim=1, descending=True, stable=True)
    return scores[:, :k], idx[:, :k]


class v8SegmentationLoss(v8DetectionLoss):
    """Segmentation criterion over the segment head's train output (maps, coefficients (B, A, nm), protos
    (B, nm, Hm, Wm)): the detection losses and a mask BCE, in float32.

    Counterpart of `drone_yolo_tpu/utils/loss.py:v8SegmentationLoss`, whose result it copies where that departs
    from the reference: only the top `max_fg` anchors of each image by `weight` carry the mask loss (ties to the
    lower anchor index); an anchor's GT mask is the pixels of the collated overlap index mask `masks` equal to its
    assigned slot + 1, resized to the protos' shape by half-pixel nearest sampling when the two differ (a
    multi-scale batch); its loss is the BCE of `coeffs @ protos` against it, cropped to the assigned box in mask
    space, summed and divided by that box's area (at least 1); the loss is the mean over the selected anchors and
    takes the box gain. Targets add `masks` (B, H / r, W / r), the collated overlap index masks.

    Returns (sum of the gained items * B, items (4,) detached: box, seg, cls, dfl).
    """

    def __init__(self, model, max_fg: int = 128, **kw):
        super().__init__(model, **kw)
        self.max_fg, self.nm = max_fg, model.head.nm

    def __call__(self, outs, targets: dict):
        feats, coeffs, protos = outs
        p = self._detect_parts(feats, targets)
        b, _, hm, wm = protos.shape
        imgsz_h, imgsz_w = feats[0].shape[2] * int(self.strides[0]), feats[0].shape[3] * int(self.strides[0])

        k = min(self.max_fg, p["fg_mask"].shape[1])
        top_scores, top_idx = top_foreground(p["weight"], k)
        sel_valid = (top_scores > 0).float()
        sel_coeffs = wide(coeffs).gather(1, top_idx[..., None].expand(b, k, self.nm))
        sel_gt_idx = p["t_gt_idx"].gather(1, top_idx)
        sel_boxes = p["t_bboxes"].gather(1, top_idx[..., None].expand(b, k, 4))  # pixels

        pm = torch.einsum("bkn,bnhw->bkhw", sel_coeffs, wide(protos))  # mask logits
        om = targets["masks"]
        if om.shape[1:] != (hm, wm):  # jax.image.resize "nearest": half-pixel centres
            om = F.interpolate(om[:, None].float(), size=(hm, wm), mode="nearest-exact")[:, 0]
        gt_m = (om.long()[:, None] == (sel_gt_idx[:, :, None, None] + 1)).float()
        scale = torch.tensor([wm / imgsz_w, hm / imgsz_h, wm / imgsz_w, hm / imgsz_h], dtype=sel_boxes.dtype,
                             device=sel_boxes.device)
        mboxes = sel_boxes * scale
        bce = crop_mask(bce_with_logits(pm, gt_m).flatten(0, 1), mboxes.flatten(0, 1)).view(b, k, hm, wm)
        area = ((mboxes[..., 2] - mboxes[..., 0]) * (mboxes[..., 3] - mboxes[..., 1])).clamp(min=1.0)
        loss_seg = (bce.sum((2, 3)) / area * sel_valid).sum() / sel_valid.sum().clamp(min=1.0)

        items = torch.stack([p["loss_box"] * self.gains[0], loss_seg * self.gains[0], p["loss_cls"] * self.gains[1],
                             p["loss_dfl"] * self.gains[2]])
        return items.sum() * b, items.detach()


class v8PoseLoss(v8DetectionLoss):
    """Pose criterion over the pose head's train output (maps, raw keypoints (B, A, nk * nd)): the detection losses,
    an OKS-shaped keypoint location loss and a keypoint visibility BCE, in float32.

    Counterpart of `drone_yolo_tpu/utils/loss.py:v8PoseLoss`, whose result it copies where that departs from the
    reference: only the top `max_fg` anchors of each image by `weight` carry the keypoint losses (ties to the lower
    anchor index, as `jax.lax.top_k`), each keypoint loss is averaged over those anchors, its `nk / labelled points`
    factor is per anchor, the area is the assigned GT box's, and the sigmas are uniform 1 / nk unless nk == 17.
    Targets add `keypoints` (B, M, nk, 3) in pixels with visibility.

    Returns (sum of the gained items * B, items (5,) detached: box, pose, kobj, cls, dfl).
    """

    def __init__(self, model, pose_gain: float = 12.0, kobj_gain: float = 1.0, max_fg: int = 128, **kw):
        super().__init__(model, **kw)
        self.kpt_shape = tuple(model.head.kpt_shape)
        self.pose_gain, self.kobj_gain, self.max_fg = pose_gain, kobj_gain, max_fg
        self.sigmas = torch.from_numpy(kpt_sigmas(self.kpt_shape[0])).float()

    def __call__(self, outs, targets: dict):
        feats, pred_kpts = outs
        p = self._detect_parts(feats, targets)
        b, a = pred_kpts.shape[:2]
        nk, nd = self.kpt_shape
        anchors, strides = p["anchor_points"], p["stride_tensor"]
        kr = wide(pred_kpts).reshape(b, a, nk, nd)
        kxy = (kr[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) * strides[None, :, None, :]  # pixels

        k = min(self.max_fg, a)
        top_scores, top_idx = top_foreground(p["weight"], k)
        sel_valid = (top_scores > 0).float()
        sel_kxy = kxy.gather(1, top_idx[:, :, None, None].expand(b, k, nk, 2))
        sel_gt_idx = p["t_gt_idx"].gather(1, top_idx)
        sel_boxes = p["t_bboxes"].gather(1, top_idx[..., None].expand(b, k, 4))  # pixels
        gt_kpts = targets["keypoints"].float()
        sel_gt = gt_kpts.gather(1, sel_gt_idx[:, :, None, None].expand(b, k, nk, 3))  # (B, K, nk, 3)

        kpt_mask = (sel_gt[..., 2] > 0).float()
        area = ((sel_boxes[..., 2] - sel_boxes[..., 0]) * (sel_boxes[..., 3] - sel_boxes[..., 1])).clamp(min=1e-9)
        d2 = ((sel_kxy - sel_gt[..., :2]) ** 2).sum(-1)
        factor = nk / kpt_mask.sum(-1, keepdim=True).clamp(min=1.0)
        if self.sigmas.device != d2.device:  # moved once, not copied to the card every step
            self.sigmas = self.sigmas.to(d2.device)
        e = d2 / (2 * self.sigmas) ** 2 / (area[..., None] * 2) / 2
        oks_loss = factor * (1.0 - torch.exp(-e)) * kpt_mask
        n_fg = sel_valid.sum().clamp(min=1.0)
        loss_kpt = (oks_loss.mean(-1) * sel_valid).sum() / n_fg
        if nd == 3:
            sel_kconf = kr[..., 2].gather(1, top_idx[..., None].expand(b, k, nk))
            loss_kobj = (bce_with_logits(sel_kconf, kpt_mask).mean(-1) * sel_valid).sum() / n_fg
        else:
            loss_kobj = torch.zeros((), device=d2.device)

        items = torch.stack([p["loss_box"] * self.gains[0], loss_kpt * self.pose_gain, loss_kobj * self.kobj_gain,
                             p["loss_cls"] * self.gains[1], p["loss_dfl"] * self.gains[2]])
        return items.sum() * b, items.detach()


class v8OBBLoss(v8DetectionLoss):
    """Oriented box criterion over the OBB head's train output (maps, angles (B, A, 1) in radians), in float32: the
    class BCE, 1 - probiou of the predicted and assigned rotated boxes, and DFL on the assigned box's unrotated extent
    (`bbox2dist` of its xywh -> xyxy, in grid units), each weighted by the summed target scores, on the rotated
    task-aligned assignment (centres inside the rotated GT, probiou overlaps). Targets add `rboxes` (B, M, 5): cx, cy,
    w, h in pixels and the angle in radians.

    Counterpart of `drone_yolo_tpu/utils/loss.py:v8OBBLoss`, except that the predicted rotated box carries the
    predicted angle, as the reference's `bbox_decode` gives it: the JAX loss decodes 4 columns (`dist2rbox`'s
    centre and size), and its probiou then reads h^2 / 12 as the angle (JAX clamps the out-of-range index), so the
    assignment and the box loss never see the predicted orientation (ROADMAP queue 3).

    Returns (sum of the gained items * B, items (3,) detached: box, cls, dfl).
    """

    def __init__(self, model, **kw):
        super().__init__(model, **kw)
        self.assigner = RotatedTaskAlignedAssigner(topk=10, num_classes=self.nc, alpha=0.5, beta=6.0)

    def __call__(self, outs, targets: dict):
        feats, pred_angle = outs
        b = feats[0].shape[0]
        anchor_points, stride_tensor = make_anchors([f.shape[2:] for f in feats], self.strides, device=feats[0].device)
        flat = torch.cat([f.flatten(2) for f in feats], 2).transpose(1, 2)
        pred_distri, pred_scores = flat[..., : 4 * self.reg_max], wide(flat[..., 4 * self.reg_max :])
        angle = wide(pred_angle)
        pred_rboxes = torch.cat((dist2rbox(dfl_expectation(pred_distri, self.reg_max), angle, anchor_points), angle),
                                -1)  # grid units, the angle in radians

        mask_gt = targets["mask"].to(pred_scores.dtype)
        gt_rboxes = targets["rboxes"].to(pred_scores.dtype) * mask_gt[..., None]
        pred_px = torch.cat((pred_rboxes[..., :4] * stride_tensor, pred_rboxes[..., 4:]), -1)
        _, t_rboxes, target_scores, fg_mask, _ = self.assigner(
            pred_scores.detach().sigmoid(), pred_px.detach(), anchor_points * stride_tensor, targets["cls"].long(),
            gt_rboxes, mask_gt)
        target_scores_sum = target_scores.sum().clamp(min=1.0)
        loss_cls = bce_with_logits(pred_scores, target_scores).sum() / target_scores_sum

        t_grid = torch.cat((t_rboxes[..., :4] / stride_tensor, t_rboxes[..., 4:]), -1)
        weight = target_scores.sum(-1) * fg_mask
        loss_box = ((1.0 - probiou(pred_rboxes, t_grid)) * weight).sum() / target_scores_sum
        target_ltrb = bbox2dist(anchor_points, xywh2xyxy(t_grid[..., :4]), self.reg_max - 1)
        dfl = df_loss(wide(pred_distri).unflatten(-1, (4, self.reg_max)), target_ltrb, self.reg_max)[..., 0]
        loss_dfl = (dfl * weight).sum() / target_scores_sum

        items = torch.stack([loss_box * self.gains[0], loss_cls * self.gains[1], loss_dfl * self.gains[2]])
        return items.sum() * b, items.detach()


class v8ClassificationLoss:
    """Cross-entropy of the (B, nc) logits against `cls` (B,): the mean over the batch of the float32 log-softmax
    NLL. The loss item is the loss itself."""

    def __call__(self, preds: torch.Tensor, batch: dict):
        logp = wide(preds).log_softmax(-1)
        loss = -logp.gather(1, batch["cls"].long()[:, None])[:, 0].mean()
        return loss, loss.detach()[None]

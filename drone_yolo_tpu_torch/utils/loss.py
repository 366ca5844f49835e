"""v8 detection loss: BCE on class logits, CIoU and DFL on task-aligned targets.

Counterpart of `drone_yolo_tpu/utils/loss.py` (`bce_with_logits`, `df_loss`,
`v8DetectionLoss`). Targets arrive padded to M slots per image with a validity
mask, in the collate format (`cls` (B, M), `bboxes` (B, M, 4) xyxy pixels,
`mask` (B, M)); padded slots are zeroed so that they catch no anchor.
"""

from __future__ import annotations

import torch

from drone_yolo_tpu_torch.nn.modules import dfl_expectation, wide
from drone_yolo_tpu_torch.ops.anchors import bbox2dist, dist2bbox, make_anchors
from drone_yolo_tpu_torch.ops.boxes import bbox_ciou
from drone_yolo_tpu_torch.utils.tal import TaskAlignedAssigner


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

    def __call__(self, feats, targets: dict):
        b = feats[0].shape[0]
        anchor_points, stride_tensor = make_anchors([f.shape[2:] for f in feats], self.strides, device=feats[0].device)
        # (B, A, no) in the compute dtype, anchors ordered level by level and row-major, as the JAX NHWC reshape
        flat = torch.cat([f.flatten(2) for f in feats], 2).transpose(1, 2)
        pred_distri, pred_scores = flat[..., : 4 * self.reg_max], wide(flat[..., 4 * self.reg_max :])
        pred_bboxes = dist2bbox(dfl_expectation(pred_distri, self.reg_max), anchor_points, xywh=False)  # grid units

        mask_gt = targets["mask"].to(pred_scores.dtype)
        gt_bboxes = targets["bboxes"].to(pred_scores.dtype) * mask_gt[..., None]
        _, target_bboxes, target_scores, fg_mask, _ = self.assigner(
            pred_scores.detach().sigmoid(), pred_bboxes.detach() * stride_tensor, anchor_points * stride_tensor,
            targets["cls"].long(), gt_bboxes, mask_gt)
        target_scores_sum = target_scores.sum().clamp(min=1.0)

        loss_cls = bce_with_logits(pred_scores, target_scores).sum() / target_scores_sum
        target_bboxes = target_bboxes / stride_tensor
        weight = target_scores.sum(-1) * fg_mask
        iou = bbox_ciou(pred_bboxes, target_bboxes)
        loss_box = ((1.0 - iou) * weight).sum() / target_scores_sum
        target_ltrb = bbox2dist(anchor_points, target_bboxes, self.reg_max - 1)
        dfl = df_loss(wide(pred_distri).unflatten(-1, (4, self.reg_max)), target_ltrb, self.reg_max)[..., 0]
        loss_dfl = (dfl * weight).sum() / target_scores_sum

        items = torch.stack([loss_box * self.gains[0], loss_cls * self.gains[1], loss_dfl * self.gains[2]])
        return items.sum() * b, items.detach()

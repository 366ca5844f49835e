"""Task-aligned assigner: anchors to padded GT boxes by score^alpha * IoU^beta, with CIoU for axis-aligned boxes and
probiou for rotated ones.

Counterpart of `drone_yolo_tpu/utils/tal.py` (`assign`, `TaskAlignedAssigner`, `select_candidates_in_rotated_gts`,
`assign_rotated`, `RotatedTaskAlignedAssigner`), with
its results and without its TPU workarounds (anchor padding, optimization
barriers, the blocked top-k, one-hot contractions in place of gathers):

* top-k per GT thresholds the alignment against its k-th largest *value*
  (`topk(...).values[..., -1:]`, duplicates counted), so anchors tied at the k-th
  place are all admitted, as `kth_largest` admits them; `topk`'s indices are
  never used;
* an anchor claimed by several GTs goes to the one of largest IoU, the first on
  ties (`argmax`, as `jnp.argmax`);
* class scores and targets are exact gathers.
"""

from __future__ import annotations

import math

import torch

from drone_yolo_tpu_torch.ops.boxes import probiou


def _fpow(x: torch.Tensor, p: float) -> torch.Tensor:
    """x**p for non-negative x, by the JAX package's operations: sqrt for 0.5, square-and-multiply for 1..8."""
    if p == 0.5:
        return torch.sqrt(x)
    if p == float(int(p)) and 1 <= int(p) <= 8:
        n, y, b = int(p), None, x
        while n:
            if n & 1:
                y = b if y is None else y * b
            n >>= 1
            if n:
                b = b * b
        return y
    return x**p


def select_candidates_in_gts(xy_centers: torch.Tensor, gt_bboxes: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """(A, 2) anchor centres strictly inside (B, M, 4) xyxy GT boxes -> (B, M, A) bool."""
    x, y = xy_centers[:, 0], xy_centers[:, 1]
    x1, y1, x2, y2 = (gt_bboxes[..., i, None] for i in range(4))
    d = torch.minimum(torch.minimum(x - x1, y - y1), torch.minimum(x2 - x, y2 - y))
    return d > eps


def _ciou_gt_pd(gt: torch.Tensor, pd: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """CIoU of (B, M, 4) GT boxes against (B, A, 4) predicted boxes, all xyxy -> (B, M, A)."""
    gx1, gy1, gx2, gy2 = (gt[..., i, None] for i in range(4))  # (B, M, 1)
    px1, py1, px2, py2 = (pd[:, None, :, i] for i in range(4))  # (B, 1, A)
    w1, h1 = gx2 - gx1, gy2 - gy1
    w2, h2 = px2 - px1, py2 - py1
    inter = (torch.minimum(gx2, px2) - torch.maximum(gx1, px1)).clamp(min=0) * (
        torch.minimum(gy2, py2) - torch.maximum(gy1, py1)).clamp(min=0)
    iou = inter / (w1 * h1 + w2 * h2 - inter + eps)
    cw = torch.maximum(gx2, px2) - torch.minimum(gx1, px1)
    ch = torch.maximum(gy2, py2) - torch.minimum(gy1, py1)
    c2 = cw**2 + ch**2 + eps
    rho2 = ((px1 + px2 - gx1 - gx2) ** 2 + (py1 + py2 - gy1 - gy2) ** 2) / 4
    v = (4 / math.pi**2) * (torch.atan(w2 / (h2 + 2 * eps)) - torch.atan(w1 / (h1 + 2 * eps))) ** 2
    alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)


@torch.no_grad()
def assign(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, topk: int = 10, num_classes: int = 80,
           alpha: float = 0.5, beta: float = 6.0, eps: float = 1e-9):
    """Task-aligned assignment.

    Args:
        pd_scores: (B, A, nc) sigmoid class scores; pd_bboxes: (B, A, 4) xyxy; anc_points: (A, 2),
        in the units of gt_bboxes; gt_labels: (B, M) class ids; gt_bboxes: (B, M, 4) xyxy;
        mask_gt: (B, M) validity of each padded GT slot.

    Returns:
        target_labels (B, A) long, target_bboxes (B, A, 4), target_scores (B, A, nc),
        fg_mask (B, A) bool, target_gt_idx (B, A) long.
    """
    return _assign(pd_scores, select_candidates_in_gts(anc_points, gt_bboxes), _ciou_gt_pd(gt_bboxes, pd_bboxes),
                   gt_labels, gt_bboxes, mask_gt, topk, num_classes, alpha, beta, eps)


def select_candidates_in_rotated_gts(xy_centers: torch.Tensor, gt_rboxes: torch.Tensor, eps: float = 1e-9):
    """(A, 2) anchor centres strictly inside (B, M, 5) rotated GT boxes -> (B, M, A) bool: the offset from each box's
    centre, rotated into the box's frame, within half its width and height less eps."""
    cx, cy, w, h, r = (gt_rboxes[..., i, None] for i in range(5))
    cos, sin = r.cos(), r.sin()
    dx, dy = xy_centers[:, 0] - cx, xy_centers[:, 1] - cy  # (B, M, A)
    u, v = dx * cos + dy * sin, -dx * sin + dy * cos
    return (u.abs() < w / 2 - eps) & (v.abs() < h / 2 - eps)


@torch.no_grad()
def assign_rotated(pd_scores, pd_rboxes, anc_points, gt_labels, gt_rboxes, mask_gt, topk: int = 10,
                   num_classes: int = 80, alpha: float = 0.5, beta: float = 6.0, eps: float = 1e-9):
    """Task-aligned assignment of rotated boxes: `assign` with (B, A, 5) and (B, M, 5) xywhr boxes (angles in
    radians), centres inside the rotated GT and probiou overlaps. Returns target_rboxes (B, A, 5) in place of the
    target boxes."""
    overlaps = probiou(gt_rboxes[:, :, None, :], pd_rboxes[:, None, :, :])
    return _assign(pd_scores, select_candidates_in_rotated_gts(anc_points, gt_rboxes), overlaps, gt_labels, gt_rboxes,
                   mask_gt, topk, num_classes, alpha, beta, eps)


def _assign(pd_scores, mask_in_gts, overlaps, gt_labels, gt_boxes, mask_gt, topk, num_classes, alpha, beta, eps):
    """The assignment given each anchor's candidacy (B, M, A) and its IoU with each GT (B, M, A)."""
    b, a, nc = pd_scores.shape
    m = gt_boxes.shape[1]
    mask_gt = mask_gt.bool().reshape(b, m)
    gl = gt_labels.long().clamp(0, nc - 1)  # (B, M)
    bov = pd_scores.transpose(1, 2).gather(1, gl[..., None].expand(b, m, a))  # score of each anchor at each GT's class
    overlaps = overlaps.clamp(min=0)
    valid = mask_in_gts & mask_gt[..., None]
    align = torch.where(valid, _fpow(bov, alpha) * _fpow(overlaps, beta), 0.0)

    kth = align.topk(topk, dim=-1).values[..., -1:]  # k-th largest value, duplicates counted
    mask_pos = (align >= kth.clamp(min=eps)) & (align > eps) & valid

    fg_mask = mask_pos.any(1)  # (B, A)
    target_gt_idx = torch.where(mask_pos, overlaps, -1.0).argmax(1)  # (B, A), first maximum
    claimed = torch.zeros_like(mask_pos).scatter_(1, target_gt_idx[:, None], True)
    mask_pos = claimed & fg_mask[:, None] & mask_pos

    target_bboxes = gt_boxes.gather(1, target_gt_idx[..., None].expand(b, a, gt_boxes.shape[-1]))
    target_labels = gl.gather(1, target_gt_idx)

    align_pos = torch.where(mask_pos, align, 0.0)
    pos_align_max = align_pos.amax(-1, keepdim=True)  # (B, M, 1)
    pos_overlap_max = torch.where(mask_pos, overlaps, 0.0).amax(-1, keepdim=True)
    norm_metric = (align_pos * pos_overlap_max / (pos_align_max + eps)).amax(1)  # (B, A)
    target_scores = torch.nn.functional.one_hot(target_labels, num_classes).to(pd_scores.dtype)
    target_scores = target_scores * (fg_mask[..., None] * norm_metric[..., None])
    return target_labels, target_bboxes, target_scores, fg_mask, target_gt_idx


class TaskAlignedAssigner:
    """`assign` with its hyperparameters bound (the reference class's shape)."""

    def __init__(self, topk: int = 10, num_classes: int = 80, alpha: float = 0.5, beta: float = 6.0, eps: float = 1e-9):
        self.topk, self.num_classes = topk, num_classes
        self.alpha, self.beta, self.eps = alpha, beta, eps

    def __call__(self, pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt):
        return assign(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, topk=self.topk,
                      num_classes=self.num_classes, alpha=self.alpha, beta=self.beta, eps=self.eps)


class RotatedTaskAlignedAssigner(TaskAlignedAssigner):
    """`assign_rotated` with its hyperparameters bound."""

    def __call__(self, pd_scores, pd_rboxes, anc_points, gt_labels, gt_rboxes, mask_gt):
        return assign_rotated(pd_scores, pd_rboxes, anc_points, gt_labels, gt_rboxes, mask_gt, topk=self.topk,
                              num_classes=self.num_classes, alpha=self.alpha, beta=self.beta, eps=self.eps)

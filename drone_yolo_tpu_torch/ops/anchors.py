"""Grid anchors and the distance -> box transforms of the anchor-free head, axis-aligned and rotated."""

from __future__ import annotations

import torch


def make_anchors(feat_shapes, strides, device=None):
    """Anchor centres (cell centres, offset 0.5) and per-anchor strides for per-level (h, w) feature shapes.

    Returns (A, 2) float32 (x, y) cell centres in stride units and (A, 1) float32
    strides, levels in order and each level row-major over (h, w).
    """
    anchor_points, stride_tensor = [], []
    for (h, w), stride in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + 0.5
        sy = torch.arange(h, dtype=torch.float32, device=device) + 0.5
        sy, sx = torch.meshgrid(sy, sx, indexing="ij")
        anchor_points.append(torch.stack((sx, sy), -1).reshape(-1, 2))
        stride_tensor.append(torch.full((h * w, 1), float(stride), dtype=torch.float32, device=device))
    return torch.cat(anchor_points), torch.cat(stride_tensor)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True) -> torch.Tensor:
    """(l, t, r, b) distances around anchor points -> (cx, cy, w, h) boxes, or (x1, y1, x2, y2) with xywh=False."""
    lt, rb = distance.chunk(2, -1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if not xywh:
        return torch.cat((x1y1, x2y2), -1)
    return torch.cat(((x1y1 + x2y2) * 0.5, x2y2 - x1y1), -1)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max: int) -> torch.Tensor:
    """xyxy boxes -> (l, t, r, b) distances from anchor points, clamped to [0, reg_max - 0.01] (the DFL targets)."""
    x1y1, x2y2 = bbox.chunk(2, -1)
    return torch.cat((anchor_points - x1y1, x2y2 - anchor_points), -1).clamp(0, reg_max - 0.01)


def dist2rbox(pred_dist: torch.Tensor, pred_angle: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """(l, t, r, b) distances and an angle (..., 1) around anchor points -> (cx, cy, w, h): the centre offset
    ((r - l) / 2, (b - t) / 2) rotated by the angle, w = l + r, h = t + b
    (`drone_yolo_tpu/ops/anchors.py:dist2rbox`)."""
    lt, rb = pred_dist.chunk(2, -1)
    cos, sin = pred_angle.cos(), pred_angle.sin()
    xf, yf = ((rb - lt) * 0.5).chunk(2, -1)
    xy = torch.cat((xf * cos - yf * sin, xf * sin + yf * cos), -1) + anchor_points
    return torch.cat((xy, lt + rb), -1)

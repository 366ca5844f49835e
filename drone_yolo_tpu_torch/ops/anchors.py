"""Grid anchors and the distance -> box transform of the anchor-free head."""

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


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """(l, t, r, b) distances around anchor points -> (cx, cy, w, h) boxes."""
    lt, rb = distance.chunk(2, -1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    return torch.cat(((x1y1 + x2y2) * 0.5, x2y2 - x1y1), -1)

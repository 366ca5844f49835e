"""Box format conversion, clipping and rescaling on (..., 4) tensors."""

from __future__ import annotations

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = x.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack((cx - hw, cy - hh, cx + hw, cy + hh), -1)


def clip_boxes(boxes: torch.Tensor, shape) -> torch.Tensor:
    """Clip xyxy boxes to an image of shape (h, w)."""
    h, w = shape[0], shape[1]
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack((x1.clamp(0, w), y1.clamp(0, h), x2.clamp(0, w), y2.clamp(0, h)), -1)


def scale_boxes(img1_shape, boxes: torch.Tensor, img0_shape) -> torch.Tensor:
    """Rescale xyxy boxes from the letterboxed `img1_shape` (h, w) back to `img0_shape`: undo pad, divide by gain, clip."""
    gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
    pad_w = round((img1_shape[1] - img0_shape[1] * gain) / 2 - 0.1)
    pad_h = round((img1_shape[0] - img0_shape[0] * gain) / 2 - 0.1)
    boxes = boxes - torch.tensor([pad_w, pad_h, pad_w, pad_h], dtype=boxes.dtype, device=boxes.device)
    return clip_boxes(boxes / gain, img0_shape)

"""Box format conversion, clipping, rescaling and the CIoU of the box loss, on (..., 4) tensors."""

from __future__ import annotations

import math

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


def scale_boxes(img1_shape, boxes: torch.Tensor, img0_shape, ratio_pad=None) -> torch.Tensor:
    """Rescale xyxy boxes from the letterboxed `img1_shape` (h, w) back to `img0_shape`: undo pad, divide by gain, clip.

    Gain and pad follow from the two shapes, or from `ratio_pad` = ((gain, gain), (pad_w, pad_h)) as the
    dataset recorded them (the validator's case).
    """
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad_w = round((img1_shape[1] - img0_shape[1] * gain) / 2 - 0.1)
        pad_h = round((img1_shape[0] - img0_shape[0] * gain) / 2 - 0.1)
    else:
        gain = ratio_pad[0][0]
        pad_w, pad_h = ratio_pad[1]
    boxes = boxes - torch.tensor([pad_w, pad_h, pad_w, pad_h], dtype=boxes.dtype, device=boxes.device)
    return clip_boxes(boxes / gain, img0_shape)


def bbox_ciou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise complete IoU of broadcastable xyxy boxes (..., 4) -> (...).

    Counterpart of `drone_yolo_tpu/ops/boxes.py:bbox_iou` with xywh=False, CIoU=True, operation
    for operation (heights carry +eps; the aspect term's alpha is a constant for the gradient).
    """
    b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
    b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)
    w1, h1 = b1x2 - b1x1, (b1y2 - b1y1) + eps
    w2, h2 = b2x2 - b2x1, (b2y2 - b2y1) + eps
    inter = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0) * (
        torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0)
    union = w1 * (b1y2 - b1y1) + w2 * (b2y2 - b2y1) - inter + eps
    iou = inter / union
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)  # enclosing width
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)  # enclosing height
    c2 = cw**2 + ch**2 + eps
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    v = (4 / math.pi**2) * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)

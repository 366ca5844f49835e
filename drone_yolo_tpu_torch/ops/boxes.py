"""Box format conversion, clipping, rescaling and the CIoU of the box loss, on (..., 4) tensors; the probabilistic IoU
of rotated (..., 5) boxes."""

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


def _covariance(boxes: torch.Tensor):
    """Covariance terms (a, b, c) of rotated (cx, cy, w, h, angle) boxes as Gaussians: diag(w^2, h^2) / 12 rotated by
    the angle (`drone_yolo_tpu/ops/boxes.py:_get_covariance_matrix`)."""
    a, b = boxes[..., 2] ** 2 / 12, boxes[..., 3] ** 2 / 12
    cos, sin = boxes[..., 4].cos(), boxes[..., 4].sin()
    cos2, sin2 = cos**2, sin**2
    return a * cos2 + b * sin2, a * sin2 + b * cos2, (a - b) * cos * sin


def probiou(obb1: torch.Tensor, obb2: torch.Tensor, CIoU: bool = False, eps: float = 1e-7) -> torch.Tensor:
    """Probabilistic IoU of broadcastable rotated boxes (..., 5) (cx, cy, w, h, angle in radians) -> (...): one minus
    the Hellinger distance of the boxes' Gaussians, the Bhattacharyya distance clamped to [eps, 100].

    Counterpart of `drone_yolo_tpu/ops/boxes.py:probiou`, operation for operation; with `CIoU` the aspect term is
    subtracted, its alpha a constant for the gradient.
    """
    x1, y1 = obb1[..., 0], obb1[..., 1]
    x2, y2 = obb2[..., 0], obb2[..., 1]
    a1, b1, c1 = _covariance(obb1)
    a2, b2, c2 = _covariance(obb2)
    den = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / (den + eps) * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / (den + eps) * 0.5
    t3 = torch.log(den / (4 * torch.sqrt((a1 * b1 - c1**2).clamp(min=0) * (a2 * b2 - c2**2).clamp(min=0)) + eps)
                   + eps) * 0.5
    bd = (t1 + t2 + t3).clamp(eps, 100.0)
    iou = 1 - torch.sqrt(1.0 - torch.exp(-bd) + eps)
    if CIoU:
        w1, h1 = obb1[..., 2], obb1[..., 3]
        w2, h2 = obb2[..., 2], obb2[..., 3]
        v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
        with torch.no_grad():
            alpha = v / (v - iou + (1 + eps))
        return iou - v * alpha
    return iou

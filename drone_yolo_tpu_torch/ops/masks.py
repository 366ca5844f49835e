"""Mask ops of the segment task: prototypes combined with coefficients, cropped to boxes, mapped to the frame.

Counterpart of `drone_yolo_tpu/ops/masks.py` (`crop_mask`, `process_mask`, `scale_masks_np`, `mask_iou_np`), in
torch on any device: the predictor and the validator run them on the card, where the masks of a batch live.
Prototypes are (nm, Hm, Wm) per image, channels first, as the port's head gives them.
"""

from __future__ import annotations

import torch

from drone_yolo_tpu_torch.ops.letterbox import resize_linear_f32


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero the pixels of each mask (N, H, W) outside its box (N, 4) xyxy in mask pixels: pixel (r, c) is kept
    when x1 <= c < x2 and y1 <= r < y2."""
    _, h, w = masks.shape
    x1, y1, x2, y2 = boxes[:, :, None, None].unbind(1)  # each (N, 1, 1)
    c = torch.arange(w, dtype=boxes.dtype, device=boxes.device)[None, None, :]
    r = torch.arange(h, dtype=boxes.dtype, device=boxes.device)[None, :, None]
    return masks * ((c >= x1) & (c < x2) & (r >= y1) & (r < y2))


def process_mask(protos: torch.Tensor, coeffs: torch.Tensor, boxes: torch.Tensor, img_shape) -> torch.Tensor:
    """(N, Hm, Wm) float32 masks in [0, 1]: sigmoid(coeffs (N, nm) @ protos (nm, Hm, Wm)), cropped to the boxes
    (N, 4) xyxy in network-input pixels of `img_shape` (h, w), scaled to mask space."""
    nm, hm, wm = protos.shape
    ih, iw = img_shape
    masks = (coeffs.float() @ protos.float().reshape(nm, -1)).sigmoid().reshape(-1, hm, wm)
    scale = torch.tensor([wm / iw, hm / ih, wm / iw, hm / ih], dtype=torch.float32, device=boxes.device)
    return crop_mask(masks, boxes.float() * scale)


def scale_masks(masks: torch.Tensor, orig_shape, in_shape, ratio_pad=None) -> torch.Tensor:
    """Masks (N, Hm, Wm) aligned to a letterboxed `in_shape` (h, w) image -> (N, h0, w0) float32 masks of the
    `orig_shape` (h0, w0) image: the letterbox's content cropped (edges by `int(round(... -+ 0.1))`), then resized
    by `resize_linear_f32` (`cv2.resize`'s INTER_LINEAR). Gain and pad from the two shapes, or from `ratio_pad` =
    (gain, (pad_w, pad_h))."""
    h0, w0 = int(orig_shape[0]), int(orig_shape[1])
    if len(masks) == 0:
        return masks.new_zeros((0, h0, w0), dtype=torch.float32)
    ih, iw = in_shape
    if ratio_pad is None:
        gain = min(ih / h0, iw / w0)
        pad_w, pad_h = (iw - w0 * gain) / 2, (ih - h0 * gain) / 2
    else:
        pad_w, pad_h = ratio_pad[1]
    hm, wm = masks.shape[1:]
    sx, sy = wm / iw, hm / ih
    top, left = int(round(pad_h * sy - 0.1)), int(round(pad_w * sx - 0.1))
    bottom, right = int(round((ih - pad_h) * sy + 0.1)), int(round((iw - pad_w) * sx + 0.1))
    return resize_linear_f32(masks.float()[:, top:bottom, left:right].contiguous(), (h0, w0))


def mask_iou(masks1: torch.Tensor, masks2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU of binary masks (N, ...) x (M, ...) -> (N, M) float32: intersection / (union + eps)."""
    m1 = masks1.float().flatten(1)
    m2 = masks2.float().flatten(1)
    inter = m1 @ m2.T
    return inter / (m1.sum(1)[:, None] + m2.sum(1)[None, :] - inter + eps)

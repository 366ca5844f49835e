"""Letterbox on the device: aspect-preserving resize and constant pad to a fixed shape.

Two letterboxes, as in the JAX package (`drone_yolo_tpu/ops/letterbox.py`):

- `letterbox`, for a batch of frames of one shape, follows the device one
  (`jax.image.resize(method="linear")`, which antialiases when it shrinks, as
  `F.interpolate(mode="bilinear", antialias=True)` does), on float in [0, 1];
- `letterbox_u8`, for single frames, follows the host one (`cv2.resize` with
  INTER_LINEAR on uint8, then `cv2.copyMakeBorder` with 114) through
  `resize_linear_u8`, OpenCV's fixed-point bilinear resize in integer tensor
  arithmetic: the same integers on the card and on the CPU, and no image library.

The segment task's masks take two more of `cv2.resize`'s interpolations on tensors:
`resize_linear_f32` (INTER_LINEAR on float32 maps) and `resize_nearest` (INTER_NEAREST).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS: interpolation weights in units of 2**-11


def letterbox_params(shape, new_shape=(640, 640), scaleup: bool = True):
    """(ratio, (pad_w, pad_h), (new_w, new_h)) for an input of shape (h, w), centred; without `scaleup` the ratio
    is at most 1."""
    h, w = shape
    r = min(new_shape[0] / h, new_shape[1] / w)
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (round(w * r), round(h * r))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    return r, (dw / 2, dh / 2), new_unpad


def letterbox(img: torch.Tensor, new_shape=(640, 640), pad_value: float = 114.0 / 255.0) -> torch.Tensor:
    """Letterbox a float batch (B, C, H, W) in [0, 1] to `new_shape` (h, w), padding with `pad_value`."""
    b, c, h, w = img.shape
    _, (dw, dh), (nw, nh) = letterbox_params((h, w), new_shape)
    if (nh, nw) != (h, w):
        img = F.interpolate(img, size=(nh, nw), mode="bilinear", align_corners=False, antialias=True)
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    out = img.new_full((b, c, new_shape[0], new_shape[1]), pad_value)
    out[:, :, top : top + nh, left : left + nw] = img
    return out


def _linear_coords(n_in: int, n_out: int, fixed_point: bool = True) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV's INTER_LINEAR taps along one axis: (i0, i1, f) per output index, f the float32 weight of i1.

    The source coordinate is (d + 0.5) * n_in / n_out - 0.5, computed in double; its floor is the left tap
    and the rest its weight (coordinates before the first source pixel or at or past the last take that
    pixel alone). For the fixed-point (uint8) path `cv::resize` rounds the coordinate to float before
    taking its floor; for float maps it keeps the double fraction, rounded to float once.
    """
    scale = 1.0 / (n_out / n_in)
    f = (np.arange(n_out) + 0.5) * scale - 0.5
    if fixed_point:
        f = f.astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0.astype(f.dtype)).astype(np.float32)
    edge = (i0 < 0) | (i0 >= n_in - 1)
    f[edge] = 0.0
    i0 = np.clip(i0, 0, n_in - 1)
    return i0, np.minimum(i0 + 1, n_in - 1), f


def _linear_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV's fixed-point INTER_LINEAR taps along one axis: (i0, i1, w0, w1), weights in 2**-11 units."""
    i0, i1, f = _linear_coords(n_in, n_out)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(2**COEF_BITS)).astype(np.int64)
    w1 = np.rint(f * np.float32(2**COEF_BITS)).astype(np.int64)
    return i0, i1, w0, w1


def resize_linear_f32(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of float32 maps (N, H, W) to `size` (h, w), as `cv2.resize(map, (w, h), INTER_LINEAR)` of
    each map: OpenCV's float path, a horizontal pass S[i0] * (1 - f) + S[i1] * f, then the same vertical pass, in
    float32 with its taps (`_linear_coords`). The two differ in the rounding of a product or sum: within one
    float32 ulp of the result. Runs on the tensor's device."""
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"expected float32 (N, H, W) maps, got {x.dtype} {tuple(x.shape)}")
    _, h, w = x.shape
    out_h, out_w = int(size[0]), int(size[1])
    dev = x.device
    xi0, xi1, xf = (torch.from_numpy(t).to(dev) for t in _linear_coords(w, out_w, fixed_point=False))
    yi0, yi1, yf = (torch.from_numpy(t).to(dev) for t in _linear_coords(h, out_h, fixed_point=False))
    rows = x[:, :, xi0] * (1.0 - xf) + x[:, :, xi1] * xf  # (N, H, out_w)
    return rows[:, yi0] * (1.0 - yf)[:, None] + rows[:, yi1] * yf[:, None]


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest-neighbour resize of maps (..., H, W) to `size` (h, w), as `cv2.resize(..., INTER_NEAREST)`: output
    index d reads source floor(d * n_in / n_out), at most n_in - 1."""
    idx = [torch.from_numpy(np.minimum(np.floor(np.arange(n_out) * (1.0 / (n_out / n_in))), n_in - 1).astype(np.int64))
           .to(x.device) for n_in, n_out in zip(x.shape[-2:], size)]
    return x[..., idx[0][:, None], idx[1][None, :]]


def resize_linear_u8(img: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of a uint8 batch (B, H, W, C) to `size` (h, w), as `cv2.resize(..., INTER_LINEAR)`.

    OpenCV's fixed-point path: a horizontal pass in int32 (u8 x 11-bit weights), then the vertical
    pass of its vector code, ((r0 >> 4) * w0 >> 16) + ((r1 >> 4) * w1 >> 16), rounded by (+ 2) >> 2
    and saturated to uint8. Equal to `cv2.resize` at integer downscale factors (720x1280 to 360x640
    or 90x160, 1080x1920 to 360x640); at other factors within 1 on a fraction of values, where
    OpenCV's scalar tail rounds differently. The same integer ops run on any device.
    """
    if img.dtype != torch.uint8 or img.dim() != 4:
        raise ValueError(f"expected a uint8 (B, H, W, C) batch, got {img.dtype} {tuple(img.shape)}")
    _, h, w, _ = img.shape
    out_h, out_w = int(size[0]), int(size[1])
    dev = img.device
    xi0, xi1, xw0, xw1 = (torch.from_numpy(t).to(dev) for t in _linear_taps(w, out_w))
    yi0, yi1, yw0, yw1 = (torch.from_numpy(t).to(dev) for t in _linear_taps(h, out_h))
    src = img.to(torch.int32)
    rows = src[:, :, xi0] * xw0[:, None].int() + src[:, :, xi1] * xw1[:, None].int()  # (B, H, out_w, C), x 2**11
    r0, r1 = rows[:, yi0] >> 4, rows[:, yi1] >> 4
    y = ((r0 * yw0[:, None, None].int()) >> 16) + ((r1 * yw1[:, None, None].int()) >> 16)
    return ((y + 2) >> 2).clamp(0, 255).to(torch.uint8)


def letterbox_u8(img: torch.Tensor, new_shape=(640, 640), pad_value: int = 114, scaleup: bool = True) -> torch.Tensor:
    """Letterbox a uint8 batch (B, H, W, C) to `new_shape` (h, w): `resize_linear_u8` where the size changes,
    then a constant border of `pad_value`, top/left `round(pad - 0.1)` as `letterbox_np` of the JAX package
    (without `scaleup`, an image smaller than `new_shape` keeps its size)."""
    b, h, w, c = img.shape
    _, (dw, dh), (nw, nh) = letterbox_params((h, w), new_shape, scaleup)
    if (nh, nw) != (h, w):
        img = resize_linear_u8(img, (nh, nw))
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    out = img.new_full((b, new_shape[0], new_shape[1], c), pad_value)
    out[:, top : top + nh, left : left + nw] = img
    return out

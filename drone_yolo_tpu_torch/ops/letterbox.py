"""Letterbox on the device: aspect-preserving resize and constant pad to a fixed shape.

One torch function replaces both letterboxes of the JAX package, the device one
(`jax.image.resize(method="linear")`) and the host one (`cv2.resize`). It follows
the device one: `jax.image.resize` antialiases when it shrinks, and so does
`F.interpolate(mode="bilinear", antialias=True)`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def letterbox_params(shape, new_shape=(640, 640)):
    """(ratio, (pad_w, pad_h), (new_w, new_h)) for an input of shape (h, w), centred."""
    h, w = shape
    r = min(new_shape[0] / h, new_shape[1] / w)
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

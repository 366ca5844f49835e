"""Host image operations on uint8 HWC arrays without an image library: OpenCV's integer arithmetic in PyTorch.

The augmentation pipeline of the JAX package (`drone_yolo_tpu/data/augment.py`,
`data/dataset.py`) calls cv2 for these; the port computes them with CPU tensor ops, which
release the interpreter lock, so the loader's threads run them in parallel:

- `warp_affine_u8`: `cv2.warpAffine(img, M, dsize, borderValue=(v, v, v))` with INTER_LINEAR,
  as OpenCV 4.11 and later compute it, in float32 (OpenCV up to 4.10 used a fixed-point
  remap with 5-bit sub-pixel cells, which differs from it by up to 3 levels);
- `get_rotation_matrix_2d`: `cv2.getRotationMatrix2D`;
- `rgb_to_hsv_u8` / `hsv_to_rgb_u8`: `cv2.cvtColor` RGB2HSV (8-bit: division tables with 12
  fraction bits, hue in 0..179) and HSV2RGB (float32, saturating round);
- `resize_area_u8`: `cv2.resize(..., INTER_AREA)` for shrinking: integer factors as OpenCV's
  fast path, other factors with its area weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch

HSV_SHIFT = 12


def get_rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center, angle in degrees, scale): (2, 3) float64."""
    a = angle * math.pi / 180
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy], [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2.invertAffineTransform."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]], [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def warp_affine_u8(img: np.ndarray, m: np.ndarray, dsize, border: int = 114) -> np.ndarray:
    """Warp an (H, W, C) uint8 image by the (2, 3) matrix `m` (source -> destination) to `dsize` = (width, height),
    bilinear, with a constant border: cv2.warpAffine(img, m, dsize, borderValue=(border,) * 3).

    As OpenCV's warp kernels compute it (4.11 on): the inverse matrix in float32; per destination pixel the source
    point x * m00 + (y * m01 + m02), the last step a fused multiply-add; its floor picks the four taps (the border
    value outside the image) and its fraction the weights; two linear interpolations along x, one along y, each
    p0 + a * (p1 - p0) in float32; rounded half to even and saturated."""
    out_w, out_h = int(dsize[0]), int(dsize[1])
    h, w, c = img.shape
    inv = torch.from_numpy(_invert_affine(np.asarray(m, np.float64)).astype(np.float32))
    xs = torch.arange(out_w, dtype=torch.float32)[None, :]
    ys = torch.arange(out_h, dtype=torch.float32)[:, None]
    sx = _fma(xs, inv[0, 0].double(), ys * inv[0, 1] + inv[0, 2])
    sy = _fma(xs, inv[1, 0].double(), ys * inv[1, 1] + inv[1, 2])
    ix, iy = torch.floor(sx), torch.floor(sy)
    ax, ay = (sx - ix)[..., None], (sy - iy)[..., None]
    ix, iy = ix.long(), iy.long()
    src = torch.from_numpy(np.ascontiguousarray(img)).reshape(h * w, c)

    def tap(dx: int, dy: int) -> torch.Tensor:
        tx, ty = ix + dx, iy + dy
        inside = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
        v = src[(ty.clamp(0, h - 1) * w + tx.clamp(0, w - 1)).reshape(-1)].reshape(out_h, out_w, c).float()
        return torch.where(inside[..., None], v, torch.full_like(v, float(border)))

    p00, p01, p10, p11 = tap(0, 0), tap(1, 0), tap(0, 1), tap(1, 1)
    v0 = p00 + ax * (p01 - p00)
    v1 = p10 + ax * (p11 - p10)
    out = v0 + ay * (v1 - v0)
    return torch.round(out).clamp(0, 255).to(torch.uint8).numpy()


def _div_table(num: int, den_scale: float) -> torch.Tensor:
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        t = np.where(i > 0, np.rint((num << HSV_SHIFT) / (den_scale * np.maximum(i, 1))), 0)
    return torch.from_numpy(t.astype(np.int64))


_SDIV = _div_table(255, 1.0)
_HDIV180 = _div_table(180, 6.0)


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> HSV with hue in 0..179: cv2.cvtColor(img, COLOR_RGB2HSV)."""
    x = torch.from_numpy(np.ascontiguousarray(img)).long()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    diff = v - torch.minimum(torch.minimum(r, g), b)
    s = (diff * _SDIV[v] + (1 << (HSV_SHIFT - 1))) >> HSV_SHIFT
    h = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + (1 << (HSV_SHIFT - 1))) >> HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], -1).to(torch.uint8).numpy()


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32 (the product of two float32 values is exact in float64)."""
    return (a.double() * b + c).float()


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 HSV, hue in 0..179 -> RGB: cv2.cvtColor(hsv, COLOR_HSV2RGB). In float32 as OpenCV's vector
    code computes it: s and v scaled by float32(1/255), hue by float32(6/180), the sector table's 1 - s * f and
    1 - s * (1 - f) fused multiply-adds, then x 255 rounded half to even and saturated."""
    x = torch.from_numpy(np.ascontiguousarray(hsv)).float()
    h = x[..., 0] * torch.tensor(6.0 / 180, dtype=torch.float32)
    s = x[..., 1] * torch.tensor(1.0 / 255, dtype=torch.float32)
    v = x[..., 2] * torch.tensor(1.0 / 255, dtype=torch.float32)
    sector = torch.floor(h)
    f = h - sector
    tab = torch.stack([v, v * (1 - s), v * _fma(-s, f, 1.0), v * _fma(-s, 1 - f, 1.0)], -1)
    # per sector: the tab entries of (b, g, r), OpenCV's sector_data
    sector_data = torch.tensor([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
    bgr = torch.gather(tab, -1, sector_data[sector.long() % 6])
    bgr = torch.where((s == 0)[..., None], v[..., None].expand_as(bgr), bgr)
    return torch.round(bgr.flip(-1) * 255.0).clamp(0, 255).to(torch.uint8).numpy()


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """OpenCV's computeResizeAreaTab as an (n_out, n_in) matrix of float weights."""
    scale = n_in / n_out
    wts = np.zeros((n_out, n_in))
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            wts[d, s1 - 1] = (s1 - f1) / cell
        wts[d, s1:s2] = 1 / cell
        if f2 - s2 > 1e-3:
            wts[d, s2] = min(min(f2 - s2, 1.0), cell) / cell
    return wts


def resize_area_u8(img: np.ndarray, dsize) -> np.ndarray:
    """Shrink an (H, W, C) uint8 image to `dsize` = (width, height): cv2.resize(img, dsize, interpolation=INTER_AREA).
    Integer factors take OpenCV's fast path (factor 2: (sum of 4 + 2) >> 2; others: sum x float32(1 / area),
    rounded); other factors its area weights, summed in float64 and rounded (within 1 of OpenCV's float32 sums)."""
    out_w, out_h = int(dsize[0]), int(dsize[1])
    h, w, c = img.shape
    if out_w > w or out_h > h:
        raise ValueError(f"resize_area_u8 shrinks only: {w}x{h} -> {out_w}x{out_h}")
    x = torch.from_numpy(np.ascontiguousarray(img))
    fx, fy = w / out_w, h / out_h
    if fx == int(fx) and fy == int(fy):
        fx, fy = int(fx), int(fy)
        blocks = x[: out_h * fy, : out_w * fx].reshape(out_h, fy, out_w, fx, c).long().sum((1, 3))
        if fx == fy == 2:
            return ((blocks + 2) >> 2).to(torch.uint8).numpy()
        return torch.round(blocks.float() * np.float32(1.0 / (fx * fy))).clamp(0, 255).to(torch.uint8).numpy()
    wy = torch.from_numpy(_area_weights(h, out_h))
    wx = torch.from_numpy(_area_weights(w, out_w))
    y = torch.einsum("oh,hwc,pw->opc", wy, x.double(), wx)
    return torch.round(y).clamp(0, 255).to(torch.uint8).numpy()

"""Bind and launch the hand-written CUDA stride-2 conv backward (`csrc/s2_bwd.cu`).

Built and loaded by `ops/cuda_build.py`. One call computes (dx, dw) of a dense
stride-2 conv, k=3 p=1 or k=1 p=0, with three launches on PyTorch's current
stream: the split-K dw partials, their reduction, and dx (left out when dx is
not needed). The wrapper allocates dx, dw and the float32 split-K workspace.

Replaces the TPU kernels `drone_yolo_tpu/ops/pallas_s2bwd.py:s2_bwd`
(`_k3_kernel`, `_k1_kernel`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from drone_yolo_tpu_torch.ops.cuda_build import CudaLibrary

KINDS = {3: 1, 1: 0}  # kernel size -> padding
TILE_K = 16  # kTK in the source: a split's reduction range is a multiple of it
TARGET_CTAS = 4 * 132  # dw grid: about four CTAs per SM of an H100
MIN_CHUNK = 256  # least reduction length per split
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NAMES = {3: "s2_bwd_k3", 1: "s2_bwd_k1"}


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.s2_bwd_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    lib.s2_bwd_launch.restype = i
    lib.s2_bwd_error_string.argtypes = [i]
    lib.s2_bwd_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("s2_bwd", [], _bind)


def split_k(co: int, ci: int, k: int, reduction: int) -> tuple[int, int]:
    """(splits, chunk) of the dw reduction over B*Ho*Wo: enough CTAs to fill the card, chunks of >= MIN_CHUNK."""
    tiles = math.ceil(co / 64) * math.ceil(ci * k * k / 64)
    splits = max(1, min(math.ceil(TARGET_CTAS / tiles), math.ceil(reduction / MIN_CHUNK)))
    chunk = math.ceil(math.ceil(reduction / splits) / TILE_K) * TILE_K
    return math.ceil(reduction / chunk), chunk


def s2_bwd_cuda(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, k: int, need_dx: bool = True):
    """(dx, dw) of `conv2d(x, w, stride=2, padding=KINDS[k])` on the card: x (B, Ci, H, W) with H and W
    even, w (Co, Ci, k, k), dy (B, Co, H/2, W/2), all float32 or all bfloat16 on one CUDA device.
    Returns dx like x (None unless `need_dx`) and dw float32, equal within summation order to
    `ops.conv_s2.s2_bwd_reference`.

    Counts its calls in `s2_bwd_cuda.calls[name]` and its kernel launches in `s2_bwd_cuda.launches[name]`,
    name `s2_bwd_k3` or `s2_bwd_k1`; an input it has to make contiguous counts in `s2_bwd_cuda.copies`.
    """
    if k not in KINDS:
        raise ValueError(f"stride-2 backward kernel takes k in {sorted(KINDS)}, got k={k}")
    if not (x.is_cuda and w.device == x.device and dy.device == x.device):
        raise ValueError(f"x, w and dy must be on one CUDA device, got {x.device}, {w.device}, {dy.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or dy.dtype != x.dtype:
        raise TypeError(f"x, w and dy must all be float32 or all bfloat16, got {x.dtype}, {w.dtype}, {dy.dtype}")
    b, ci, h, wd = x.shape
    co = w.shape[0]
    if h % 2 or wd % 2 or tuple(w.shape) != (co, ci, k, k) or tuple(dy.shape) != (b, co, h // 2, wd // 2):
        raise ValueError(f"expected x (B, Ci, H, W) with even H, W, w (Co, Ci, {k}, {k}) and dy (B, Co, H/2, W/2), "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, {tuple(dy.shape)}")
    if max(x.numel(), dy.numel()) >= 2**31:
        raise ValueError("stride-2 backward kernel indexes with 32-bit pixel counts")
    tensors = []
    for t in (x, w, dy):
        if not t.is_contiguous():
            t = t.contiguous()
            s2_bwd_cuda.copies += 1
        tensors.append(t)
    x, w, dy = tensors
    splits, chunk = split_k(co, ci, k, b * (h // 2) * (wd // 2))
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty((co, ci, k, k), dtype=torch.float32, device=x.device)
    ws = torch.empty((splits, co * ci * k * k), dtype=torch.float32, device=x.device)
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.s2_bwd_launch(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr() if need_dx else None,
                                dw.data_ptr(), ws.data_ptr(), _DTYPES[x.dtype], b, ci, h, wd, co, k, KINDS[k],
                                splits, chunk, stream)
    if err != 0:
        raise RuntimeError(f"stride-2 backward kernel launch failed: {lib.s2_bwd_error_string(err).decode()}")
    name = NAMES[k]
    s2_bwd_cuda.calls[name] += 1
    s2_bwd_cuda.launches[name] += 3 if need_dx else 2
    return dx, dw


def reset_counts() -> None:
    """Set the call, launch and copy counts to 0."""
    s2_bwd_cuda.calls = dict.fromkeys(NAMES.values(), 0)
    s2_bwd_cuda.launches = dict.fromkeys(NAMES.values(), 0)
    s2_bwd_cuda.copies = 0


reset_counts()

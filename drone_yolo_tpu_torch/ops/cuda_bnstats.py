"""Bind and launch the hand-written CUDA BatchNorm-statistics kernel (`csrc/bn_stats.cu`).

Built and loaded by `ops/cuda_build.py`. One call computes the per-channel float32
sum and sum of squares of an NCHW bfloat16 or float32 tensor with two launches on
PyTorch's current stream: the per-block partials, then their sum in a fixed order.
The wrapper allocates the (2, C) output and the float32 partials.

Replaces the TPU kernel `tools/bn_stat_probe.py:make_pallas_stats`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from drone_yolo_tpu_torch.ops.cuda_build import CudaLibrary

TARGET_BLOCKS = 8 * 132  # about eight 256-thread blocks per SM of an H100
MIN_CHUNK = 2048  # least elements per block: 256 threads x one 16-byte vector of bf16
VEC = 8  # a part's start stays 16-byte aligned in bf16 when the plane's is
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bn_stats_launch.argtypes = [p, p, p, i, i, i, ll, i, ll, p]
    lib.bn_stats_launch.restype = i
    lib.bn_stats_error_string.argtypes = [i]
    lib.bn_stats_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("bn_stats", [], _bind)


def split_plane(n: int, c: int, hw: int) -> tuple[int, int]:
    """(parts, chunk): each H*W plane is read by `parts` blocks of `chunk` elements, enough blocks to fill the card."""
    parts = max(1, min(math.ceil(TARGET_BLOCKS / (n * c)), math.ceil(hw / MIN_CHUNK), 65535 // n))
    chunk = math.ceil(math.ceil(hw / parts) / VEC) * VEC
    return math.ceil(hw / chunk), chunk


def bn_stats_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum, sum of squares), each (C,) float32, of an (N, C, H, W) float32 or bfloat16 tensor on the card, over
    N, H and W; equal within summation order to `ops.bn_stats.bn_stats_reference`.

    Counts its calls in `bn_stats_cuda.calls` and its kernel launches (two per call) in `bn_stats_cuda.launches`;
    an input it has to make contiguous counts in `bn_stats_cuda.copies`.
    """
    if not x.is_cuda:
        raise ValueError(f"x must be on a CUDA device, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"BN-statistics kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"expected a non-empty (N, C, H, W) tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        x = x.contiguous()
        bn_stats_cuda.copies += 1
    n, c, h, w = x.shape
    parts, chunk = split_plane(n, c, h * w)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    ws = torch.empty((n * parts, 2, c), dtype=torch.float32, device=x.device)
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bn_stats_launch(x.data_ptr(), ws.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], n, c, h * w, parts,
                                  chunk, stream)
    if err != 0:
        raise RuntimeError(f"BN-statistics kernel launch failed: {lib.bn_stats_error_string(err).decode()}")
    bn_stats_cuda.calls += 1
    bn_stats_cuda.launches += 2
    return out[0], out[1]


def reset_counts() -> None:
    """Set the call, launch and copy counts to 0."""
    bn_stats_cuda.calls = bn_stats_cuda.launches = bn_stats_cuda.copies = 0


reset_counts()

"""Bind and launch the hand-written CUDA BatchNorm-statistics kernel (`csrc/bn_stats.cu`).

Built and loaded by `ops/cuda_build.py`. One call computes the per-channel float32
sum and sum of squares of an NCHW bfloat16 or float32 tensor with one launch on
PyTorch's current stream: each block reduces a run of one channel across the
images, and the channel's last block to finish sums its partials in a fixed
order. The wrapper allocates the (2, C) output; the float32 partials and the
per-channel block counters are kept per device and stream and grow with the
largest call.

Replaces the TPU kernel `tools/bn_stat_probe.py:make_pallas_stats`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from drone_yolo_tpu_torch.ops.cuda_build import CudaLibrary, on_device

# values a block reads: 32 KB of bf16, 8 vectors of 16 bytes a thread of 256. Fewer, longer runs were faster at the
# flagship's sites on an H100 than runs of 4-16 KB cut to fill the card with eight blocks an SM
RUN = 16384
VEC = 8  # a run's start stays on a 16-byte vector in bf16 (and float32) when the planes' starts do
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bn_stats_launch.argtypes = [p, p, p, p, i, i, i, ll, i, ll, p]
    lib.bn_stats_launch.restype = i
    lib.bn_stats_error_string.argtypes = [i]
    lib.bn_stats_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("bn_stats", [], _bind)


@functools.lru_cache(maxsize=None)
def split_channel(total: int) -> tuple[int, int]:
    """(parts, chunk): a channel's `total` = N * H*W values, image after image, are read by `parts` blocks of
    `chunk` values each (a multiple of VEC, at most RUN)."""
    parts = math.ceil(total / RUN)
    chunk = math.ceil(math.ceil(total / parts) / VEC) * VEC
    return math.ceil(total / chunk), chunk


_scratch: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int, floats: int, channels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The partials' workspace (at least `floats` float32) and the block counters (one int32 a channel, 0 between
    calls) of one device and stream; both grow when a larger call comes."""
    key = (device.index, stream)
    ws, counter = _scratch.get(key, (None, None))
    if counter is None or counter.numel() < channels:
        counter = torch.zeros(channels, dtype=torch.int32, device=device)
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=device)
    _scratch[key] = ws, counter
    return ws, counter


def bn_stats_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum, sum of squares), each (C,) float32, of an (N, C, H, W) float32 or bfloat16 tensor on the card, over
    N, H and W; equal within summation order to `ops.bn_stats.bn_stats_reference`, and bitwise equal from call to
    call.

    Counts its calls in `bn_stats_cuda.calls` and its kernel launches (one per call) in `bn_stats_cuda.launches`;
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
    parts, chunk = split_channel(n * h * w)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    lib = LIBRARY.load()
    with on_device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws, counter = _workspace(x.device, stream, parts * 2 * c, c)
        err = lib.bn_stats_launch(x.data_ptr(), ws.data_ptr(), out.data_ptr(), counter.data_ptr(), _DTYPES[x.dtype],
                                  n, c, h * w, parts, chunk, stream)
    if err != 0:
        raise RuntimeError(f"BN-statistics kernel launch failed: {lib.bn_stats_error_string(err).decode()}")
    bn_stats_cuda.calls += 1
    bn_stats_cuda.launches += 1
    return out[0], out[1]


def reset_counts() -> None:
    """Set the call, launch and copy counts to 0."""
    bn_stats_cuda.calls = bn_stats_cuda.launches = bn_stats_cuda.copies = 0


reset_counts()

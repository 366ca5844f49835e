"""Bind and launch the hand-written CUDA stride-2 conv backward (`csrc/s2_bwd.cu`).

Built and loaded by `ops/cuda_build.py`. One call computes (dx, dw) of a dense
stride-2 conv, k=3 p=1 or k=1 p=0, with three launches on PyTorch's current
stream: the split-K dw partials, their fixed-order reduction, and dx (left out
when dx is not needed). The wrapper plans the tiles and splits (`plan`),
allocates dx, dw and the float32 split-K workspace, and for bfloat16 packs w
per tap (`pack_weights`).

The implementation is chosen by dtype, never on a failure:
- bfloat16 (`"mma.sync"`): tensor cores, `mma.sync.m16n8k16` fed by ldmatrix
  from a three-stage cp.async ring. dw is an implicit GEMM over tiles of 64 dy
  pixels whose tap operands are formed on chip from one band of x rows; dx a
  GEMM per output-parity class over a tile of dy pixels, the four classes
  interleaved into whole dx rows in shared memory and stored 16 bytes at a time.
  It needs x and dy 16-byte aligned and raises otherwise. What bounds it now is
  described in the source note of `csrc/s2_bwd.cu` and measured in PERF.md.
- float32 (`"cuda-core"`): float32 FMAs on CUDA cores, within float32 rounding
  of the plain version.

Replaces the TPU kernels `drone_yolo_tpu/ops/pallas_s2bwd.py:s2_bwd`
(`_k3_kernel`, `_k1_kernel`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from drone_yolo_tpu_torch.ops.cuda_build import CudaLibrary, on_device

KINDS = {3: 1, 1: 0}  # kernel size -> padding
NAMES = {3: "s2_bwd_k3", 1: "s2_bwd_k1"}
IMPLS = {torch.bfloat16: "mma.sync", torch.float32: "cuda-core"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# float32: a split's reduction range is a multiple of kTK pixels; about four CTAs per SM of an H100
TILE_K = 16
TARGET_CTAS = 4 * 132
MIN_CHUNK = 256  # least reduction length per split
# bfloat16: dw K tiles of DW_PIXELS dy pixel slots (rows x cols of one image); dx tiles of 256 when one CTA
# covers Ci <= 32, else 128 (kDwPix, dx_pixels in the source); at least MIN_TILES tiles per split so that the
# copy ring runs ahead, and the splits filling at most MAX_WAVES waves of the card's dw CTAs
DW_PIXELS = 64
TILE_WIDTHS = (64, 32, 16, 8)
MIN_TILES = 4
MAX_WAVES = 8
H100_SMS = 132
ALIGN = 16  # bytes: cp.async of 16 bytes and 16-byte dx stores


class Plan(NamedTuple):
    """How one call is cut: `splits` dw partials of `chunk` reduction units each (pixels for float32, K tiles
    for bfloat16), the column widths of the dw and dx tiles (bfloat16), and the workspace's float32 count."""

    impl: str
    splits: int
    chunk: int
    dw_cols: int
    dx_cols: int
    ws_numel: int


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.s2_bwd_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, p]
    lib.s2_bwd_launch.restype = i
    lib.s2_bwd_dw_ctas_per_sm.argtypes = [i] * 7
    lib.s2_bwd_dw_ctas_per_sm.restype = i
    lib.s2_bwd_error_string.argtypes = [i]
    lib.s2_bwd_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("s2_bwd", [], _bind)


def split_k(co: int, ci: int, k: int, reduction: int) -> tuple[int, int]:
    """float32: (splits, chunk) of the dw reduction over B*Ho*Wo: enough CTAs to fill the card, chunks of >= MIN_CHUNK."""
    tiles = math.ceil(co / 64) * math.ceil(ci * k * k / 64)
    splits = max(1, min(math.ceil(TARGET_CTAS / tiles), math.ceil(reduction / MIN_CHUNK)))
    chunk = math.ceil(math.ceil(reduction / splits) / TILE_K) * TILE_K
    return math.ceil(reduction / chunk), chunk


def tile_widths(wo: int) -> tuple[int, ...]:
    """The tile widths the kernels take for dy rows of wo pixels: TILE_WIDTHS, and wo itself (whole rows) when it is
    a multiple of 4 below 64 (a 20-wide dy is 3 rows of a 64-pixel tile, not 3 x 3 tiles of 8 x 8)."""
    return TILE_WIDTHS + ((wo,) if wo % 4 == 0 and wo < 64 else ())


def tile_shape(ho: int, wo: int, pixels: int) -> tuple[int, int]:
    """(rows, cols) of a tile of `pixels` dy pixel slots, rows = pixels // cols, that covers an (ho, wo) image with
    the fewest tiles (ties: the widest)."""
    return min(((pixels // c, c) for c in tile_widths(wo)),
               key=lambda rc: (math.ceil(ho / rc[0]) * math.ceil(wo / rc[1]), -rc[1]))


def dx_pixels(ci: int) -> int:
    """Pixels of a bfloat16 dx tile: one CTA covers 32 channels x 256 pixels for Ci <= 32, else 64 x 128."""
    return 256 if ci <= 32 else 128


def split_tiles(k_tiles: int, ctas: int, slots: int) -> tuple[int, int]:
    """bfloat16: (splits, chunk) of k_tiles K tiles over `ctas` dw CTAs per split, when the card runs `slots` of them
    at once. A split count that fills w waves exactly costs w waves of `chunk` tiles; the cheapest such count wins
    (ties: the fewest splits, the least workspace), with at least MIN_TILES tiles a split."""
    most = max(1, k_tiles // MIN_TILES)
    options = {min(most, max(1, w * slots // ctas)) for w in range(1, MAX_WAVES + 1)}
    splits = min(options, key=lambda n: (math.ceil(n * ctas / slots) * math.ceil(k_tiles / n), n))
    chunk = math.ceil(k_tiles / splits)
    return math.ceil(k_tiles / chunk), chunk


def plan(b: int, ci: int, h: int, wd: int, co: int, k: int, dtype: torch.dtype, slots: int = H100_SMS) -> Plan:
    """The split and tile plan of one call (see `Plan`); `slots` is the number of bf16 dw CTAs the card runs at
    once (`device_plan`)."""
    ho, wo = h // 2, wd // 2
    ws = co * ci * k * k
    if dtype == torch.float32:
        splits, chunk = split_k(co, ci, k, b * ho * wo)
        return Plan(IMPLS[dtype], splits, chunk, 0, 0, splits * ws)
    rows, cols = tile_shape(ho, wo, DW_PIXELS)
    co_tile, ci_tile = (64, 8) if ci <= 8 else (128, 32) if co >= 128 else (64, 32)  # s2_dw_mma's CTA tiles
    splits, chunk = split_tiles(b * math.ceil(ho / rows) * math.ceil(wo / cols),
                                math.ceil(co / co_tile) * math.ceil(ci / ci_tile), slots)
    return Plan(IMPLS[dtype], splits, chunk, cols, tile_shape(ho, wo, dx_pixels(ci))[1], splits * ws)


@functools.lru_cache(maxsize=256)
def device_plan(device: torch.device, b: int, ci: int, h: int, wd: int, co: int, k: int, dtype: torch.dtype) -> Plan:
    """`plan` of a call on the CUDA `device`, kept per shape: for bfloat16 with the dw CTAs the card runs at once,
    the kernel instance's CTAs per SM (the library's occupancy query) times the SMs."""
    if dtype != torch.bfloat16:
        return plan(b, ci, h, wd, co, k, dtype)
    with torch.cuda.device(device):
        per_sm = LIBRARY.load().s2_bwd_dw_ctas_per_sm(b, ci, h, wd, co, k, tile_shape(h // 2, wd // 2, DW_PIXELS)[1])
    if per_sm < 1:
        raise RuntimeError(f"occupancy query of the bf16 dw kernel failed for {(b, ci, h, wd, co, k)}")
    return plan(b, ci, h, wd, co, k, dtype, per_sm * torch.cuda.get_device_properties(device).multi_processor_count)


def parity_taps(k: int, parity: int) -> list[tuple[int, int]]:
    """Taps (kq, dy offset) along one axis feeding dx at 2r + parity: y = 2i + kq - p gives i = r + (parity + p - kq) / 2."""
    p = KINDS[k]
    return [(kq, (parity + p - kq) // 2) for kq in range(k) if (kq - p) % 2 == parity]


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """w (Co, Ci, k, k) -> (k*k, Ci, Co), tap-major: the A operand of the bfloat16 dx kernel, w transposed per tap."""
    co, ci, k, _ = w.shape
    return w.permute(2, 3, 1, 0).reshape(k * k, ci, co).contiguous()


def packed_dx_reference(wt: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """float32 dx (B, Ci, 2*Ho, 2*Wo) from packed weights `wt` (k*k, Ci, Co), as the bfloat16 dx kernel computes it:
    per parity class (py, px), the sum over its taps (ky, kx) of wt[ky*k + kx] @ dy shifted by the taps' offsets
    (zero past the end)."""
    b, _, ho, wo = dy.shape
    dyp = F.pad(dy.float(), (0, 1, 0, 1))
    dx = dyp.new_zeros((b, wt.shape[1], 2 * ho, 2 * wo))
    for py in (0, 1):
        for px in (0, 1):
            for ky, oy in parity_taps(k, py):
                for kx, ox in parity_taps(k, px):
                    dx[:, :, py::2, px::2] += torch.einsum("io,bohw->bihw", wt[ky * k + kx].float(),
                                                           dyp[:, :, oy:oy + ho, ox:ox + wo])
    return dx


def s2_bwd_cuda(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, k: int, need_dx: bool = True):
    """(dx, dw) of `conv2d(x, w, stride=2, padding=KINDS[k])` on the card: x (B, Ci, H, W) with H and W
    even, w (Co, Ci, k, k), dy (B, Co, H/2, W/2), all float32 or all bfloat16 on one CUDA device; bfloat16
    inputs that are contiguous must start 16-byte aligned. Returns dx like x (None unless `need_dx`) and dw
    float32, equal within summation order to `ops.conv_s2.s2_bwd_reference`.

    Counts its calls in `s2_bwd_cuda.calls[name]`, by implementation in `s2_bwd_cuda.impl_calls[impl][name]`
    (impl `IMPLS[dtype]`), and its kernel launches in `s2_bwd_cuda.launches[name]`, name `s2_bwd_k3` or
    `s2_bwd_k1`; an input it has to make contiguous counts in `s2_bwd_cuda.copies`.
    """
    if k not in KINDS:
        raise ValueError(f"stride-2 backward kernel takes k in {sorted(KINDS)}, got k={k}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or dy.dtype != x.dtype:
        raise TypeError(f"x, w and dy must all be float32 or all bfloat16, got {x.dtype}, {w.dtype}, {dy.dtype}")
    b, ci, h, wd = x.shape
    co = w.shape[0]
    if h % 2 or wd % 2 or tuple(w.shape) != (co, ci, k, k) or tuple(dy.shape) != (b, co, h // 2, wd // 2):
        raise ValueError(f"expected x (B, Ci, H, W) with even H, W, w (Co, Ci, {k}, {k}) and dy (B, Co, H/2, W/2), "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, {tuple(dy.shape)}")
    if max(x.numel(), dy.numel()) >= 2**31:
        raise ValueError("stride-2 backward kernel indexes with 32-bit pixel counts")
    if x.dtype == torch.bfloat16:
        for name, t in (("x", x), ("dy", dy)):
            if t.is_contiguous() and t.data_ptr() % ALIGN:
                raise ValueError(f"the bfloat16 stride-2 backward kernel needs {name} {ALIGN}-byte aligned, "
                                 f"got data_ptr % {ALIGN} = {t.data_ptr() % ALIGN}")
    if not (x.is_cuda and w.device == x.device and dy.device == x.device):
        raise ValueError(f"x, w and dy must be on one CUDA device, got {x.device}, {w.device}, {dy.device}")
    tensors = []
    for t in (x, w, dy):
        if not t.is_contiguous():
            t = t.contiguous()
            s2_bwd_cuda.copies += 1
        tensors.append(t)
    x, w, dy = tensors
    pl = device_plan(x.device, b, ci, h, wd, co, k, x.dtype)
    wt = pack_weights(w) if need_dx and x.dtype == torch.bfloat16 else None
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty((co, ci, k, k), dtype=torch.float32, device=x.device)
    ws = torch.empty(pl.ws_numel, dtype=torch.float32, device=x.device)
    lib = LIBRARY.load()
    with on_device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.s2_bwd_launch(x.data_ptr(), w.data_ptr(), None if wt is None else wt.data_ptr(), dy.data_ptr(),
                                dx.data_ptr() if need_dx else None, dw.data_ptr(), ws.data_ptr(), _DTYPES[x.dtype],
                                b, ci, h, wd, co, k, KINDS[k], pl.splits, pl.chunk, pl.dw_cols, pl.dx_cols, stream)
    if err != 0:
        raise RuntimeError(f"stride-2 backward kernel launch failed: {lib.s2_bwd_error_string(err).decode()}")
    name = NAMES[k]
    s2_bwd_cuda.calls[name] += 1
    s2_bwd_cuda.impl_calls[pl.impl][name] += 1
    s2_bwd_cuda.launches[name] += 3 if need_dx else 2
    return dx, dw


def reset_counts() -> None:
    """Set the call, launch and copy counts to 0."""
    s2_bwd_cuda.calls = dict.fromkeys(NAMES.values(), 0)
    s2_bwd_cuda.impl_calls = {impl: dict.fromkeys(NAMES.values(), 0) for impl in IMPLS.values()}
    s2_bwd_cuda.launches = dict.fromkeys(NAMES.values(), 0)
    s2_bwd_cuda.copies = 0


reset_counts()

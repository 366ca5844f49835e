"""Bind and launch the hand-written CUDA greedy-NMS kernels (`csrc/greedy_nms.cu`).

Built and loaded by `ops/cuda_build.py` (nvcc for `sm_90a` into a shared library
with a plain C interface, bound with `ctypes`). The launches pass
`tensor.data_ptr()` and PyTorch's current stream. One call is two launches: the
suppression bitmask over many CTAs (`nms_mask`), then the sweep over it, one CTA
per image (`nms_sweep`). The bitmask's workspace comes from PyTorch's caching
allocator on the current stream.

Replaces the TPU kernel `drone_yolo_tpu/ops/pallas_nms.py:pallas_greedy_keep`.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from drone_yolo_tpu_torch.ops.cuda_build import CudaLibrary, on_device

WORD_BITS = 64


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nms_mask_launch.argtypes = [p, p, p, i, i, ctypes.c_float, p]
    lib.nms_mask_launch.restype = i
    lib.nms_sweep_launch.argtypes = [p, p, p, i, i, p]
    lib.nms_sweep_launch.restype = i
    lib.greedy_nms_error_string.argtypes = [i]
    lib.greedy_nms_error_string.restype = ctypes.c_char_p


# --fmad=false and no fast math: the IoU must round exactly as the plain version's.
LIBRARY = CudaLibrary("greedy_nms", ["--fmad=false"], _bind)


def workspace_bytes(b: int, k: int) -> int:
    """Bytes of the suppression bitmask of B images of K candidates: one 64-bit word per row and column block."""
    return 8 * b * k * -(-k // WORD_BITS)


def _check(boxes: torch.Tensor, valid: torch.Tensor) -> tuple[int, int]:
    if not (boxes.is_cuda and valid.is_cuda and boxes.device == valid.device):
        raise ValueError(f"boxes and valid must be on one CUDA device, got {boxes.device} and {valid.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"boxes must be float32 and valid bool, got {boxes.dtype} and {valid.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"expected boxes (B, K, 4) and valid (B, K), got {tuple(boxes.shape)} and {tuple(valid.shape)}")
    b, k = valid.shape
    if b * k * 4 >= 2**31:  # the kernels' int arguments; far above any K that non_max_suppression makes
        raise ValueError(f"greedy-NMS kernel takes B * K * 4 < 2**31, got B={b}, K={k}")
    if workspace_bytes(b, k) > sys.maxsize:  # the kernels index the workspace with size_t
        raise ValueError(f"greedy-NMS workspace of {workspace_bytes(b, k)} bytes exceeds the address range")
    return b, k


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"greedy-NMS {what} kernel launch failed: {lib.greedy_nms_error_string(err).decode()}")


def _words(lib: ctypes.CDLL, boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float, stream: int) -> torch.Tensor:
    """Launch the bitmask kernel: (B, ceil(K/64), K) int64 words, column-block major."""
    b, k = valid.shape
    words = torch.empty((b, -(-k // WORD_BITS), k), dtype=torch.int64, device=boxes.device)
    _raise_on(lib, lib.nms_mask_launch(boxes.data_ptr(), valid.data_ptr(), words.data_ptr(), b, k, float(iou_thres),
                                       stream), "mask")
    return words


def suppression_words_cuda(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """The bitmask kernel alone: (B, K, ceil(K/64)) int64, equal to `ops.nms.suppression_words_reference` (a
    transposed view of the kernel's column-block-major words). Counts its launches in
    `suppression_words_cuda.launches`."""
    b, k = _check(boxes, valid)
    if b == 0 or k == 0:
        return torch.zeros((b, k, -(-k // WORD_BITS)), dtype=torch.int64, device=boxes.device)
    lib = LIBRARY.load()
    with on_device(boxes.device):
        words = _words(lib, boxes.contiguous(), valid.contiguous(), iou_thres, torch.cuda.current_stream().cuda_stream)
    suppression_words_cuda.launches += 1
    return words.transpose(1, 2)


def greedy_keep_cuda(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Greedy-NMS keep mask on the card: (B, K, 4) float32 score-sorted xyxy boxes and (B, K) bool
    validity -> (B, K) bool, equal to `ops.nms.greedy_keep_reference`, for any K whose workspace
    (`workspace_bytes`) the card can allocate.

    Counts its calls in `greedy_keep_cuda.calls` and its kernel launches (two per call) in
    `greedy_keep_cuda.launches`.
    """
    b, k = _check(boxes, valid)
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    lib = LIBRARY.load()
    boxes, valid = boxes.contiguous(), valid.contiguous()
    with on_device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        words = _words(lib, boxes, valid, iou_thres, stream)
        _raise_on(lib, lib.nms_sweep_launch(words.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k, stream), "sweep")
    greedy_keep_cuda.calls += 1
    greedy_keep_cuda.launches += 2
    return keep


def reset_counts() -> None:
    """Set the call and launch counts to 0."""
    greedy_keep_cuda.calls = greedy_keep_cuda.launches = suppression_words_cuda.launches = 0


reset_counts()

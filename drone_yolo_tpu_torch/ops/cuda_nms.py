"""Bind and launch the hand-written CUDA greedy-NMS kernel (`csrc/greedy_nms.cu`).

Built and loaded by `ops/cuda_build.py` (nvcc for `sm_90a` into a shared library
with a plain C interface, bound with `ctypes`). The launch passes
`tensor.data_ptr()` and PyTorch's current stream.

Replaces the TPU kernel `drone_yolo_tpu/ops/pallas_nms.py:pallas_greedy_keep`.
"""

from __future__ import annotations

import ctypes

import torch

from drone_yolo_tpu_torch.ops.cuda_build import CudaLibrary

def _bind(lib: ctypes.CDLL) -> None:
    lib.greedy_nms_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.greedy_nms_launch.restype = ctypes.c_int
    lib.greedy_nms_error_string.argtypes = [ctypes.c_int]
    lib.greedy_nms_error_string.restype = ctypes.c_char_p
    lib.greedy_nms_max_staged_k.argtypes = []
    lib.greedy_nms_max_staged_k.restype = ctypes.c_int


# --fmad=false and no fast math: the IoU must round exactly as the plain version's.
LIBRARY = CudaLibrary("greedy_nms", ["--fmad=false"], _bind)


def greedy_keep_cuda(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Greedy-NMS keep mask on the card: (B, K, 4) float32 score-sorted xyxy boxes and (B, K) bool
    validity -> (B, K) bool, equal to `ops.nms.greedy_keep_reference`, for any K: up to
    `max_staged_k()` the boxes are staged in shared memory, above it read from global memory.

    Counts its launches in `greedy_keep_cuda.launches`.
    """
    if not (boxes.is_cuda and valid.is_cuda and boxes.device == valid.device):
        raise ValueError(f"boxes and valid must be on one CUDA device, got {boxes.device} and {valid.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"boxes must be float32 and valid bool, got {boxes.dtype} and {valid.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"expected boxes (B, K, 4) and valid (B, K), got {tuple(boxes.shape)} and {tuple(valid.shape)}")
    b, k = valid.shape
    if b * k * 4 >= 2**31:  # the kernel's int arguments; far above any K that non_max_suppression makes
        raise ValueError(f"greedy-NMS kernel takes B * K * 4 < 2**31, got B={b}, K={k}")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    lib = LIBRARY.load()
    boxes, valid = boxes.contiguous(), valid.contiguous()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.greedy_nms_launch(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k, float(iou_thres), stream)
    if err != 0:
        raise RuntimeError(f"greedy-NMS kernel launch failed: {lib.greedy_nms_error_string(err).decode()}")
    greedy_keep_cuda.launches += 1
    return keep


greedy_keep_cuda.launches = 0


def max_staged_k() -> int:
    """The largest K whose boxes, areas and mask the kernel stages in the current device's shared memory."""
    return LIBRARY.load().greedy_nms_max_staged_k()

"""Build, bind and launch the hand-written CUDA greedy-NMS kernel (`csrc/greedy_nms.cu`).

The source is compiled by `nvcc` for `sm_90a` into a shared library with a plain
C interface, at first use, into `build/` beside this package (a directory git
ignores), keyed by a hash of the source and the flags. It is loaded with
`ctypes`, so the build needs neither `ninja` nor PyTorch's headers. The launch
passes `tensor.data_ptr()` and PyTorch's current stream.

Replaces the TPU kernel `drone_yolo_tpu/ops/pallas_nms.py:pallas_greedy_keep`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "greedy_nms.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
# --fmad=false and no fast math: the IoU must round exactly as the plain version's.
# -Xptxas -v: the register and shared-memory report, kept beside the library (`report_path`).
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a", "--fmad=false",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_K = 1024  # kMaxK in the source: the shared-memory arrays of one CTA

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    for cand in (Path(os.environ.get("CUDA_HOME", "/nonexistent")) / "bin" / "nvcc", shutil.which("nvcc"),
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): the greedy-NMS kernel cannot be built")


def build() -> Path:
    """Compile the kernel library if it is not built yet; returns its path. Raises with the compiler's output on failure."""
    nvcc = find_nvcc()
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join([nvcc, *NVCC_FLAGS]).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libgreedy_nms_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    report_path(lib).write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builds leave one complete library
    return lib


def report_path(lib: Path) -> Path:
    """The compiler's output (ptxas register and shared-memory report) of the build of `lib`."""
    return lib.with_suffix(".txt")


def load() -> ctypes.CDLL:
    """Build (at first use) and bind the library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.greedy_nms_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
            lib.greedy_nms_launch.restype = ctypes.c_int
            lib.greedy_nms_error_string.argtypes = [ctypes.c_int]
            lib.greedy_nms_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def greedy_keep_cuda(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Greedy-NMS keep mask on the card: (B, K, 4) float32 score-sorted xyxy boxes and (B, K) bool
    validity -> (B, K) bool, equal to `ops.nms.greedy_keep_reference`. K <= 1024.

    Counts its launches in `greedy_keep_cuda.launches`.
    """
    if not (boxes.is_cuda and valid.is_cuda and boxes.device == valid.device):
        raise ValueError(f"boxes and valid must be on one CUDA device, got {boxes.device} and {valid.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"boxes must be float32 and valid bool, got {boxes.dtype} and {valid.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"expected boxes (B, K, 4) and valid (B, K), got {tuple(boxes.shape)} and {tuple(valid.shape)}")
    b, k = valid.shape
    if k > MAX_K:
        raise ValueError(f"greedy-NMS kernel takes K <= {MAX_K}, got K={k}")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    lib = load()
    boxes, valid = boxes.contiguous(), valid.contiguous()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.greedy_nms_launch(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k, float(iou_thres), stream)
    if err != 0:
        raise RuntimeError(f"greedy-NMS kernel launch failed: {lib.greedy_nms_error_string(err).decode()}")
    greedy_keep_cuda.launches += 1
    return keep


greedy_keep_cuda.launches = 0

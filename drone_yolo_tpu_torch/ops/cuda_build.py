"""Build and load the port's hand-written CUDA kernels: one `nvcc` path for every source in `csrc/`.

Each source is compiled by `nvcc` for `sm_90a` into a shared library with a
plain C interface, at first use, into `build/` beside this package (a directory
git ignores), keyed by a hash of the source, the flags and the compiler's path.
It is loaded with `ctypes`, so the build needs neither `ninja` nor PyTorch's
headers. A failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
# -Xptxas -v: the register and shared-memory report, kept beside the library (`report_path`).
BASE_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    for cand in (Path(os.environ.get("CUDA_HOME", "/nonexistent")) / "bin" / "nvcc", shutil.which("nvcc"),
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA kernels cannot be built")


def on_device(device: torch.device):
    """A context in which `device` is the current CUDA device: nothing to enter where it is already current."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def report_path(lib: Path) -> Path:
    """The compiler's output (ptxas register and shared-memory report) of the build of `lib`."""
    return lib.with_suffix(".txt")


class CudaLibrary:
    """One `csrc/<name>.cu` source: `build()` compiles it once, `load()` binds it with `bind(cdll)`."""

    def __init__(self, name: str, extra_flags: list[str], bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC_DIR / f"{name}.cu"
        self.flags = [*BASE_FLAGS, *extra_flags]
        self._bind = bind
        self._lock = threading.Lock()
        self._lib = None

    def build(self) -> Path:
        """Compile the library if it is not built yet; returns its path. Raises with the compiler's output on failure."""
        nvcc = find_nvcc()
        key = hashlib.sha256(self.source.read_bytes() + " ".join([nvcc, *self.flags]).encode()).hexdigest()[:16]
        lib = BUILD_DIR / f"lib{self.name}_{key}.so"
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *self.flags, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        report_path(lib).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: concurrent builds leave one complete library
        return lib

    def load(self) -> ctypes.CDLL:
        """Build (at first use) and bind the library."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
        return self._lib

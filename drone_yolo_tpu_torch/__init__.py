"""Drone-YOLO in PyTorch and CUDA: the port of `drone_yolo_tpu` to one NVIDIA H100.

The JAX package beside it is the reference; this package imports neither JAX
nor anything of it.
"""

from drone_yolo_tpu_torch.engine.model import YOLO

__version__ = "0.1.0"
__all__ = ["YOLO", "__version__"]

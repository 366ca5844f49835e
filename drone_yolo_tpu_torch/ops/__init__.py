"""Tensor operations of the port; `get_windows` and `tiled_inference` are exported here, as in the JAX package's
`ops/__init__.py`."""

from drone_yolo_tpu_torch.ops.tiling import get_windows, tiled_inference

__all__ = ["get_windows", "tiled_inference"]

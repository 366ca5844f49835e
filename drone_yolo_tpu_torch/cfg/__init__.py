"""Predict configuration: the predict keys of the JAX package's `cfg/default.yaml`.

The defaults are a Python dict, so reading them needs no YAML parser. Keys of the
modes that are not ported yet (train, val, export, track) are refused by name
rather than silently ignored.
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

MODEL_CFG_DIR = Path(__file__).resolve().parent / "models"

DEFAULT_CFG = {
    "imgsz": 640,  # (int | list) letterbox size (h, w)
    "conf": None,  # (float) confidence threshold, 0.25 when unset
    "iou": 0.7,  # (float) NMS IoU threshold
    "max_det": 300,  # (int) detection slots per image
    "source": None,
    "agnostic_nms": False,  # (bool) class-agnostic NMS
    "classes": None,  # (list[int]) keep only these classes
    "verbose": True,
    "dtype": "bfloat16",  # (str) compute dtype: bfloat16 or float32
    "pre_nms_topk": 4096,  # (int) score top-k fed to NMS (capped at 1024)
}

_FLOAT_KEYS = {"conf", "iou"}
_INT_KEYS = {"max_det", "pre_nms_topk"}


def get_cfg(cfg: dict | SimpleNamespace | None = None, overrides: dict | None = None) -> SimpleNamespace:
    """Merge defaults, a config and overrides into a checked namespace."""
    cfg = vars(cfg) if isinstance(cfg, SimpleNamespace) else dict(cfg or {})
    merged = {**DEFAULT_CFG, **cfg, **(overrides or {})}
    unknown = sorted(set(merged) - set(DEFAULT_CFG))
    if unknown:
        raise KeyError(f"unsupported predict arguments {unknown}; supported: {sorted(DEFAULT_CFG)}")
    for k in _FLOAT_KEYS:
        if merged[k] is not None:
            merged[k] = float(merged[k])
    for k in _INT_KEYS:
        merged[k] = int(merged[k])
    if merged["dtype"] not in ("bfloat16", "float32"):
        raise ValueError(f"dtype={merged['dtype']!r} must be 'bfloat16' or 'float32'")
    return SimpleNamespace(**merged)

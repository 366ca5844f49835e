"""Predict, validate and train configuration: the keys of the JAX package's `cfg/default.yaml` that the port reads.

The defaults are Python dicts, so reading them needs no YAML parser. Keys of the
modes and options that are not ported yet (export, track; the validator's data
files, plots and COCO JSON; the train loop's data, epochs, multi-scale, device
augmentation) are refused by name rather than silently ignored.
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
    "pre_nms_topk": 4096,  # (int) score top-k fed to NMS (predict caps it at 1024, as the JAX predictor)
}

_FLOAT_KEYS = {"conf", "iou"}
_INT_KEYS = {"max_det", "pre_nms_topk"}


def _merge(defaults: dict, cfg, overrides: dict | None, mode: str) -> dict:
    """defaults, then a config (dict or namespace), then overrides; a key the defaults lack is refused by name."""
    cfg = vars(cfg) if isinstance(cfg, SimpleNamespace) else dict(cfg or {})
    merged = {**defaults, **cfg, **(overrides or {})}
    unknown = sorted(set(merged) - set(defaults))
    if unknown:
        raise KeyError(f"unsupported {mode} arguments {unknown}; supported: {sorted(defaults)}")
    if merged.get("dtype", "float32") not in ("bfloat16", "float32"):
        raise ValueError(f"dtype={merged['dtype']!r} must be 'bfloat16' or 'float32'")
    return merged


def get_cfg(cfg: dict | SimpleNamespace | None = None, overrides: dict | None = None) -> SimpleNamespace:
    """Merge defaults, a config and overrides into a checked namespace."""
    merged = _merge(DEFAULT_CFG, cfg, overrides, "predict")
    for k in _FLOAT_KEYS:
        if merged[k] is not None:
            merged[k] = float(merged[k])
    for k in _INT_KEYS:
        merged[k] = int(merged[k])
    return SimpleNamespace(**merged)


VAL_CFG = {
    "imgsz": 640,  # (int) square letterbox size of the batches
    "device": None,  # (str) "cuda" (the default) or "cpu"
    "conf": None,  # (float) confidence threshold, 0.001 when unset
    "iou": 0.7,  # (float) NMS IoU threshold
    "max_det": 300,  # (int) detection slots per image
    "pre_nms_topk": 4096,  # (int) (anchor, class) candidates fed to multi-label NMS, uncapped
    "dtype": "bfloat16",  # (str) compute dtype: bfloat16 or float32
    "verbose": True,  # (bool) per-class rows in the printed results
}


def get_val_cfg(cfg: dict | SimpleNamespace | None = None, overrides: dict | None = None) -> SimpleNamespace:
    """Merge the validate defaults, a config and overrides into a checked namespace."""
    merged = _merge(VAL_CFG, cfg, overrides, "val")
    merged["conf"] = 0.001 if merged["conf"] is None else float(merged["conf"])
    merged["iou"] = float(merged["iou"])
    for k in ("imgsz", "max_det", "pre_nms_topk"):
        merged[k] = int(merged[k])
    return SimpleNamespace(**merged)


TRAIN_CFG = {
    "model": "yolov8n.yaml",  # (str) model yaml
    "device": None,  # (str) "cuda" (the default) or "cpu"
    "epochs": 100,  # (int) epochs, for the lr schedule and the 'auto' optimizer choice
    "batch": 16,  # (int) images per batch
    "imgsz": 640,  # (int) square train size; the head's bias priors follow it
    "seed": 0,  # (int) seed of the weight init
    "optimizer": "auto",  # (str) SGD, AdamW or auto
    "lr0": 0.01,  # (float) initial learning rate
    "lrf": 0.01,  # (float) final learning rate fraction (lr0 * lrf)
    "momentum": 0.937,  # (float) SGD momentum / AdamW beta1
    "weight_decay": 0.0005,  # (float) weight decay of the conv weights, scaled by batch * accumulate / nbs
    "warmup_epochs": 3.0,  # (float) warmup epochs (fractions ok)
    "warmup_momentum": 0.8,  # (float) warmup initial momentum
    "warmup_bias_lr": 0.1,  # (float) warmup initial bias lr
    "box": 7.5,  # (float) box loss gain
    "cls": 0.5,  # (float) cls loss gain
    "dfl": 1.5,  # (float) dfl loss gain
    "nbs": 64,  # (int) nominal batch size: gradients accumulate over round(nbs / batch) batches
    "amp": True,  # (bool) bfloat16 autocast
    "cos_lr": False,  # (bool) cosine lr schedule
    "s2grad": None,  # (str) backward of the dense stride-2 convs: None (stock autograd) or "cuda" (the kernel)
    "bnstats": None,  # (str) batch sums of train-mode BatchNorm: None (stock reductions) or "cuda" (the kernel)
}

_TRAIN_TYPES = {"epochs": int, "batch": int, "imgsz": int, "seed": int, "nbs": int, "amp": bool, "cos_lr": bool,
                **{k: float for k in ("lr0", "lrf", "momentum", "weight_decay", "warmup_epochs", "warmup_momentum",
                                      "warmup_bias_lr", "box", "cls", "dfl")}}


def get_train_cfg(cfg: dict | SimpleNamespace | None = None, overrides: dict | None = None) -> SimpleNamespace:
    """Merge the train defaults, a config and overrides into a checked namespace."""
    merged = _merge(TRAIN_CFG, cfg, overrides, "train")
    for k, typ in _TRAIN_TYPES.items():
        merged[k] = typ(merged[k])
    return SimpleNamespace(**merged)

"""Predict, validate and train configuration: the keys of the JAX package's `cfg/default.yaml` that the port reads.

The defaults are Python dicts, so reading them needs no YAML parser. Keys of the
modes and options that are not ported yet (export; plots, COCO JSON,
rectangular validation; device augmentation, the mesh options) are refused by name
rather than silently ignored.
"""

from __future__ import annotations

import os
from pathlib import Path
from types import SimpleNamespace

MODEL_CFG_DIR = Path(__file__).resolve().parent / "models"
TRACKER_CFG_DIR = Path(__file__).resolve().parent / "trackers"

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
    "tracker": "bytetrack.yaml",  # (str) tracker yaml for track: a path or a file in cfg/trackers/ (ByteTrack only)
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
    # the file dataset, when no dataloader is given
    "data": None,  # (str) dataset yaml
    "batch": 16,  # (int) images per batch
    "workers": 8,  # (int) loader threads
    "cache": False,  # (bool | str) keep decoded images in RAM (True or "ram")
    "single_cls": False,  # (bool) every class as class 0
    "classes": None,  # (list[int]) keep only these classes
    "rect": False,  # (bool) rectangular batches: not ported yet, only False is accepted
}


def get_val_cfg(cfg: dict | SimpleNamespace | None = None, overrides: dict | None = None) -> SimpleNamespace:
    """Merge the validate defaults, a config and overrides into a checked namespace."""
    merged = _merge(VAL_CFG, cfg, overrides, "val")
    merged["conf"] = 0.001 if merged["conf"] is None else float(merged["conf"])
    merged["iou"] = float(merged["iou"])
    for k in ("imgsz", "max_det", "pre_nms_topk", "batch", "workers"):
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
    # the epoch loop over a dataset on disk
    "data": None,  # (str) dataset yaml (train and val image directories, names)
    "patience": 100,  # (int) epochs without a better fitness before stopping early
    "save": True,  # (bool) write last.npz, best.npz and resume_state.npz each epoch
    "save_period": -1,  # (int) also write epoch{n}.npz every n epochs (off if < 1)
    "cache": False,  # (bool | str) keep decoded images in RAM (True or "ram")
    "workers": 8,  # (int) loader threads
    "project": None,  # (str) runs directory (runs/detect when unset)
    "name": None,  # (str) run name (train, train2, ... when unset)
    "exist_ok": False,  # (bool) reuse an existing run directory
    "close_mosaic": 10,  # (int) turn mosaic and mixup off for the last n epochs (0: never)
    "resume": False,  # (bool | str) resume from the run's weights/resume_state.npz, or from this path
    "fraction": 1.0,  # (float) share of the train images to use
    "multi_scale": False,  # (bool) per-batch size drawn from 0.5-1.5 x imgsz, a multiple of the largest stride
    "val": True,  # (bool) validate the EMA weights every epoch
    "single_cls": False,  # (bool) every class as class 0
    "classes": None,  # (list[int]) keep only these classes
    "rect": False,  # (bool) rectangular validation batches: not ported yet, only False is accepted
    "plots": False,  # (bool) plots: not ported yet, only False is accepted
    "hsv_h": 0.015,  # (float) hue gain
    "hsv_s": 0.7,  # (float) saturation gain
    "hsv_v": 0.4,  # (float) value gain
    "degrees": 0.0,  # (float) rotation (+/- degrees)
    "translate": 0.1,  # (float) translation (+/- fraction)
    "scale": 0.5,  # (float) scale (+/- gain)
    "shear": 0.0,  # (float) shear (+/- degrees)
    "perspective": 0.0,  # (float) perspective: not ported yet, only 0 is accepted
    "flipud": 0.0,  # (float) up-down flip probability
    "fliplr": 0.5,  # (float) left-right flip probability
    "bgr": 0.0,  # (float) RGB -> BGR probability
    "mosaic": 1.0,  # (float) mosaic probability
    "mixup": 0.0,  # (float) mixup probability
    "copy_paste": 0.0,  # (float) copy-paste probability (no effect on detect labels, which have no segments)
}

_TRAIN_TYPES = {**{k: int for k in ("epochs", "batch", "imgsz", "seed", "nbs", "patience", "save_period", "workers",
                                       "close_mosaic")},
                **{k: bool for k in ("amp", "cos_lr", "save", "exist_ok", "multi_scale", "val", "single_cls")},
                **{k: float for k in ("lr0", "lrf", "momentum", "weight_decay", "warmup_epochs", "warmup_momentum",
                                      "warmup_bias_lr", "box", "cls", "dfl", "fraction", "hsv_h", "hsv_s", "hsv_v",
                                      "degrees", "translate", "scale", "shear", "perspective", "flipud", "fliplr",
                                      "bgr", "mosaic", "mixup", "copy_paste")}}


def get_train_cfg(cfg: dict | SimpleNamespace | None = None, overrides: dict | None = None) -> SimpleNamespace:
    """Merge the train defaults, a config and overrides into a checked namespace."""
    merged = _merge(TRAIN_CFG, cfg, overrides, "train")
    for k, typ in _TRAIN_TYPES.items():
        merged[k] = typ(merged[k])
    for k in ("plots", "rect"):
        if merged[k]:
            raise ValueError(f"{k}=True is not ported yet (see ROADMAP.md)")
    if merged["perspective"]:
        raise ValueError("perspective > 0 (the perspective warp) is not ported yet (see ROADMAP.md)")
    return SimpleNamespace(**merged)


def increment_path(path, exist_ok: bool = False) -> Path:
    """runs/train -> runs/train2, runs/train3, ... unless exist_ok."""
    path = Path(path)
    if path.exists() and not exist_ok:
        for n in range(2, 9999):
            if not os.path.exists(f"{path}{n}"):
                return Path(f"{path}{n}")
    return path


def get_save_dir(args: SimpleNamespace) -> Path:
    """The run directory: {project or runs/detect}/{name or train}, numbered up unless exist_ok."""
    return increment_path(Path(args.project or Path("runs") / "detect") / (args.name or "train"), args.exist_ok)

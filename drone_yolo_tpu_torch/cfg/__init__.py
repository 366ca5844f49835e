"""Configuration: the full key set of the JAX package's `cfg/default.yaml`, its checks, and the command line.

Counterpart of `drone_yolo_tpu/cfg/__init__.py` (get_cfg, check_cfg, get_save_dir,
entrypoint) and `cfg/default.yaml`. `DEFAULT_CFG` holds every key of the JAX package's
defaults with the same values, as Python data, so reading them needs no YAML parser,
plus the port's own `s2grad` and `bnstats`.

`get_cfg` merges defaults, a config and overrides and checks types and ranges as the
JAX package does; a key outside the set is refused. `check_ported(args, mode)` refuses by
name every key whose feature the port lacks in that mode when it is set to a value other
than its default (`UNPORTED`): display, feature maps and test-time augmentation on
predict; COCO JSON on val; device augmentation, the mesh
options, the perspective warp and `overlap_mask=False` (which the JAX package accepts and
ignores) on train. Keys the JAX package itself does not read (export options, `time`,
`freeze`, `profile`, `retina_masks`, ...) are accepted and, as there, have no effect.
`plots` (default True) draws the train batches and fills the confusion matrix; the
training curves (`results.png`) and label statistics (`labels.jpg`) need matplotlib,
which the port does not use: a warning says so once.

`entrypoint` is the `k=v` command line (`dyt-torch`, `python -m drone_yolo_tpu_torch`).
"""

from __future__ import annotations

import ast
import logging
import os
import platform
import sys
from pathlib import Path
from types import SimpleNamespace

MODEL_CFG_DIR = Path(__file__).resolve().parent / "models"
TRACKER_CFG_DIR = Path(__file__).resolve().parent / "trackers"
ASSETS = Path(__file__).resolve().parents[1] / "assets"  # the default source, as the JAX package's (no files ship)
LOGGER = logging.getLogger("drone_yolo_tpu_torch")

TASKS = {"detect", "segment", "classify", "pose", "obb"}
MODES = {"train", "val", "predict", "export", "track", "benchmark"}
TASK2DATA = {"detect": "coco8.yaml", "segment": "coco8-seg.yaml", "classify": "imagenet10", "pose": "coco8-pose.yaml",
             "obb": "dota8.yaml"}
TASK2MODEL = {"detect": "yolov8n.yaml", "segment": "yolov8n-seg.yaml", "classify": "yolov8n-cls.yaml",
              "pose": "yolov8n-pose.yaml", "obb": "yolov8n-obb.yaml"}
TASK2METRIC = {"detect": "metrics/mAP50-95(B)", "segment": "metrics/mAP50-95(M)", "classify": "metrics/accuracy_top1",
               "pose": "metrics/mAP50-95(P)", "obb": "metrics/mAP50-95(B)"}  # each task's headline metric

DEFAULT_CFG = {
    "task": "detect", "mode": "train",
    # train
    "model": None, "data": None, "epochs": 100, "time": None, "patience": 100, "batch": 16, "imgsz": 640,
    "save": True, "save_period": -1, "cache": False, "device": None, "workers": 8, "project": None, "name": None,
    "exist_ok": False, "pretrained": True, "optimizer": "auto", "verbose": True, "seed": 0, "deterministic": True,
    "single_cls": False, "rect": False, "rect_max_shapes": 8, "cos_lr": False, "close_mosaic": 10, "resume": False,
    "amp": True, "fraction": 1.0, "profile": False, "freeze": None, "multi_scale": False, "spd_stem": False,
    "overlap_mask": True, "mask_ratio": 4, "dropout": 0.0,
    # val
    "val": True, "split": "val", "save_json": False, "save_hybrid": False, "conf": None, "iou": 0.7, "max_det": 300,
    "half": None, "dnn": False, "plots": True,
    # predict
    "source": None, "vid_stride": 1, "stream_buffer": False, "visualize": False, "augment": False,
    "agnostic_nms": False, "classes": None, "retina_masks": False, "embed": None,
    # visualize
    "show": False, "save_frames": False, "save_txt": False, "save_conf": False, "save_crop": False,
    "show_labels": True, "show_conf": True, "show_boxes": True, "line_width": None,
    # export
    "format": "stablehlo", "keras": False, "optimize": False, "int8": False, "dynamic": False, "simplify": True,
    "opset": None, "workspace": None, "nms": False,
    # hyperparameters
    "lr0": 0.01, "lrf": 0.01, "momentum": 0.937, "weight_decay": 0.0005, "warmup_epochs": 3.0,
    "warmup_momentum": 0.8, "warmup_bias_lr": 0.1, "box": 7.5, "cls": 0.5, "dfl": 1.5, "pose": 12.0, "kobj": 1.0,
    "nbs": 64, "tp": 1, "sp": 1, "device_aug": False, "zero": False, "lane_pad": False, "hsv_h": 0.015,
    "hsv_s": 0.7, "hsv_v": 0.4, "degrees": 0.0, "translate": 0.1, "scale": 0.5, "shear": 0.0, "perspective": 0.0,
    "flipud": 0.0, "fliplr": 0.5, "bgr": 0.0, "mosaic": 1.0, "mixup": 0.0, "copy_paste": 0.0,
    "copy_paste_mode": "flip", "auto_augment": "randaugment", "erasing": 0.4, "crop_fraction": 1.0,
    "cfg": None,
    "tracker": "botsort.yaml",
    # the JAX package's TPU settings
    "dtype": "bfloat16", "mesh_shape": None, "mesh_axes": None, "prefetch": 2, "pre_nms_topk": 4096,
    # the port's own: backward of the dense stride-2 convs and the batch sums of train-mode BatchNorm, None (stock
    # autograd) or "cuda" (the kernels)
    "s2grad": None, "bnstats": None,
}

CFG_FLOAT_KEYS = {"warmup_epochs", "box", "cls", "dfl", "degrees", "shear", "time", "workspace", "batch"}
CFG_FRACTION_KEYS = {
    "dropout", "lr0", "lrf", "momentum", "weight_decay", "warmup_momentum", "warmup_bias_lr",
    "hsv_h", "hsv_s", "hsv_v", "translate", "scale", "perspective", "flipud", "fliplr", "bgr",
    "mosaic", "mixup", "copy_paste", "conf", "iou", "fraction", "erasing", "crop_fraction",
}
CFG_INT_KEYS = {
    "epochs", "patience", "workers", "seed", "close_mosaic", "mask_ratio", "max_det",
    "vid_stride", "line_width", "nbs", "save_period", "prefetch", "pre_nms_topk", "tp", "sp",
}
CFG_BOOL_KEYS = {
    "save", "exist_ok", "verbose", "deterministic", "single_cls", "rect", "cos_lr",
    "overlap_mask", "val", "save_json", "save_hybrid", "half", "dnn", "plots", "show",
    "save_txt", "save_conf", "save_crop", "save_frames", "show_labels", "show_conf",
    "visualize", "augment", "agnostic_nms", "retina_masks", "show_boxes", "keras",
    "optimize", "int8", "dynamic", "simplify", "nms", "profile", "multi_scale", "spd_stem",
    "zero", "device_aug", "lane_pad",
}

# mode -> key -> why a value other than the default is refused
_MESH = "the JAX package's device mesh (data, tensor and spatial parallelism) is not ported yet (ROADMAP.md queue 1 item 8)"
_TPU = "a TPU layout option of the JAX package; the port computes the same result without it"
UNPORTED = {
    "predict": {
        "show": "showing results needs a display library (cv2.imshow), which the card's machine does not have",
        "visualize": "feature-map visualisation is not ported yet",
        "augment": "test-time augmentation is not ported yet",
    },
    "val": {
        "save_json": "COCO JSON and its evaluation are not ported yet (ROADMAP.md queue 1 item 3)",
    },
    "train": {
        "device_aug": "device augmentation is not ported yet (ROADMAP.md queue 1 item 8)",
        "perspective": "the perspective warp is not ported yet (ROADMAP.md queue 1 item 3)",
        "zero": _MESH, "tp": _MESH, "sp": _MESH, "mesh_shape": _MESH, "mesh_axes": _MESH,
        "lane_pad": _TPU, "spd_stem": _TPU,
        "overlap_mask": "the segment loss reads the overlap index mask only: overlap_mask=False has no effect in the "
                        "JAX package either",
    },
}
_WARNED: set = set()


def check_cfg(cfg: dict, hard: bool = True) -> None:
    """Check the types and ranges of known keys (coercing instead when not `hard`), as the JAX package does."""
    for k, v in cfg.items():
        if v is None:
            continue
        if k in CFG_FLOAT_KEYS and not isinstance(v, (int, float)):
            if hard:
                raise TypeError(f"'{k}={v}' must be int or float")
            cfg[k] = float(v)
        elif k in CFG_FRACTION_KEYS:
            if not isinstance(v, (int, float)):
                if hard:
                    raise TypeError(f"'{k}={v}' must be int or float")
                v = cfg[k] = float(v)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"'{k}={v}' is out of the valid range 0.0-1.0")
        elif k in CFG_INT_KEYS and not isinstance(v, int):
            if hard:
                raise TypeError(f"'{k}={v}' must be int")
            cfg[k] = int(v)
        elif k in CFG_BOOL_KEYS and not isinstance(v, bool):
            if hard:
                raise TypeError(f"'{k}={v}' must be bool")
            cfg[k] = bool(v)


def cfg2dict(cfg) -> dict:
    """A yaml path, a dict or a namespace -> a plain dict."""
    if isinstance(cfg, (str, Path)):
        from drone_yolo_tpu_torch.nn.build import load_yaml

        cfg = load_yaml(Path(cfg).read_text(encoding="utf-8"))
    elif isinstance(cfg, SimpleNamespace):
        cfg = vars(cfg)
    return dict(cfg or {})


def get_cfg(cfg=None, overrides: dict | None = None) -> SimpleNamespace:
    """Defaults, then a config (a dict, a namespace or a yaml path), then overrides, checked; a key outside
    `DEFAULT_CFG` is refused."""
    cfg = cfg2dict(cfg)
    if overrides:
        overrides = cfg2dict(overrides)
        overrides.pop("save_dir", None)
        cfg = {**cfg, **overrides}
    merged = {**DEFAULT_CFG, **cfg}
    unknown = sorted(set(merged) - set(DEFAULT_CFG))
    if unknown:
        raise KeyError(f"unsupported arguments {unknown}: not keys of the configuration (cfg.DEFAULT_CFG)")
    for k in ("project", "name"):
        if isinstance(merged.get(k), (int, float)):
            merged[k] = str(merged[k])
    if merged.get("name") == "model":
        merged["name"] = str(merged.get("model", "")).split(".")[0]
    check_cfg(merged)
    if merged["dtype"] not in ("bfloat16", "float32"):
        raise ValueError(f"dtype={merged['dtype']!r} must be 'bfloat16' or 'float32'")
    return SimpleNamespace(**merged)


def check_ported(args: SimpleNamespace, mode: str) -> SimpleNamespace:
    """Refuse, by name, each key of `UNPORTED[mode]` set to a value other than its default; warn once that the
    matplotlib plots are not drawn. Returns `args`."""
    bad = [f"{k}={getattr(args, k)!r} ({why})" for k, why in UNPORTED[mode].items() if getattr(args, k) != DEFAULT_CFG[k]]
    if bad:
        raise KeyError(f"unsupported {mode} arguments: " + "; ".join(bad))
    if mode in ("train", "val") and args.plots and "plots" not in _WARNED:
        _WARNED.add("plots")
        LOGGER.warning("plots=True: results.png and labels.jpg are not drawn (they need matplotlib, which the port "
                       "does not use; ROADMAP.md queue 1 item 4); train batches and the confusion matrix are")
    return args


def get_val_cfg(cfg=None, overrides: dict | None = None) -> SimpleNamespace:
    """The validate configuration: conf 0.001 when unset, imgsz an int, `half` (when set) choosing the dtype as in
    the JAX validator; checked for val."""
    args = check_ported(get_cfg(cfg, overrides), "val")
    if args.half is not None:  # the JAX validator's dtype is the half flag's
        args.dtype = "bfloat16" if args.half else "float32"
    args.conf = 0.001 if args.conf is None else float(args.conf)
    args.imgsz = int(args.imgsz)
    return args


def get_train_cfg(cfg=None, overrides: dict | None = None) -> SimpleNamespace:
    """The train configuration, checked for train; imgsz an int."""
    args = check_ported(get_cfg(cfg, overrides), "train")
    args.imgsz = int(args.imgsz)
    return args


def increment_path(path, exist_ok: bool = False) -> Path:
    """runs/train -> runs/train2, runs/train3, ... unless exist_ok."""
    path = Path(path)
    if path.exists() and not exist_ok:
        for n in range(2, 9999):
            if not os.path.exists(f"{path}{n}"):
                return Path(f"{path}{n}")
    return path


def get_save_dir(args: SimpleNamespace, name: str | None = None) -> Path:
    """The run directory: {project or runs/<task>}/{name or the mode}, numbered up unless exist_ok."""
    if getattr(args, "save_dir", None):
        return Path(args.save_dir)
    project = args.project or Path("runs") / args.task
    return increment_path(Path(project) / (name or args.name or args.mode), exist_ok=args.exist_ok)


# -- the command line ------------------------------------------------------------------------------------------------
def merge_equals_args(args: list[str]) -> list[str]:
    """Join 'k = v', 'k= v' and 'k =v' tokens into 'k=v' (the JAX package's copy of this keeps the value token as
    well, and its entrypoint does not call it)."""
    out, i = [], 0
    while i < len(args):
        a = args[i]
        if a == "=" and out and i + 1 < len(args):  # k = v
            out[-1] += f"={args[i + 1]}"
            i += 2
        elif a.endswith("=") and i + 1 < len(args) and "=" not in args[i + 1]:  # k= v
            out.append(a + args[i + 1])
            i += 2
        elif a.startswith("=") and out:  # k =v
            out[-1] += a
            i += 1
        else:
            out.append(a)
            i += 1
    return out


def smart_value(v: str):
    """A command-line value as Python data: none/true/false in any case, else a literal, else the string."""
    lower = v.lower()
    if lower == "none":
        return None
    if lower == "true":
        return True
    if lower == "false":
        return False
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def yaml_text(d: dict) -> str:
    """A flat dict as YAML text that `nn/build.py:load_yaml` reads back to the same dict."""
    from drone_yolo_tpu_torch.nn.build import _scalar

    def fmt(v):
        if v is None:
            return "null"
        if isinstance(v, (list, tuple)):
            return "[" + ", ".join(fmt(x) for x in v) + "]"
        if isinstance(v, str) and (_scalar(v) != v or any(ch in v for ch in ",[]#'\"")):
            return '"' + v + '"'
        return str(v)

    return "".join(f"{k}: {fmt(v)}\n" for k, v in d.items())


def copy_default_cfg() -> Path:
    """Write the defaults as YAML to default_copy.yaml in the working directory."""
    new_file = Path.cwd() / "default_copy.yaml"
    new_file.write_text(yaml_text(DEFAULT_CFG), encoding="utf-8")
    LOGGER.info(f"copied the default configuration to {new_file}")
    return new_file


def collect_system_info() -> str:
    """Python, torch, CUDA and the card."""
    import torch

    lines = [f"python {platform.python_version()}", f"torch {torch.__version__}", f"cuda {torch.version.cuda}",
             f"cuda available {torch.cuda.is_available()}"]
    if torch.cuda.is_available():
        lines += [f"device {torch.cuda.get_device_name(0)}", f"device count {torch.cuda.device_count()}"]
    return "\n".join(lines)


def entrypoint(debug: str = "") -> None:
    """`dyt-torch [task] [mode] k=v ...`: build a YOLO facade and run the mode with the overrides.

    The words help, version, cfg (print the defaults), copy-cfg and checks (torch, CUDA, the card) run alone;
    `cfg=file.yaml` merges a yaml under the other arguments; a bare *.yaml, *.npz or path is the model. The mode
    defaults to the configuration's (train), the source of predict and track to `ASSETS`, the data of train and
    val to the task's dataset yaml, as in the JAX package.
    """
    if not logging.getLogger().handlers:  # a console script: show the log lines
        logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = merge_equals_args((debug.split(" ") if debug else sys.argv)[1:])
    if not args:
        LOGGER.info(f"usage: dyt-torch TASK MODE ARGS\n  TASK in {sorted(TASKS)}\n  MODE in {sorted(MODES)}\n"
                    "  ARGS as k=v pairs, see drone_yolo_tpu_torch.cfg.DEFAULT_CFG")
        return
    special = {
        "help": lambda: LOGGER.info("dyt-torch [TASK] [MODE] k=v ..."),
        "version": lambda: LOGGER.info(__import__("drone_yolo_tpu_torch").__version__),
        "cfg": lambda: LOGGER.info(yaml_text(DEFAULT_CFG)),
        "copy-cfg": copy_default_cfg,
        "checks": lambda: LOGGER.info(collect_system_info()),
    }
    overrides = {}
    task, mode = None, None
    for a in args:
        if "=" in a:
            k, v = a.split("=", 1)
            if k == "cfg" and v:
                overrides = {**cfg2dict(v), **overrides}
            else:
                overrides[k] = smart_value(v)
        elif a in TASKS:
            task = a
        elif a in MODES:
            mode = a
        elif a.lower() in special:
            special[a.lower()]()
            return
        elif a.endswith((".yaml", ".yml", ".npz")) or "/" in a:
            overrides["model"] = a
        else:
            raise SyntaxError(f"'{a}' is not a valid argument. Use k=v pairs, a task {sorted(TASKS)}, "
                              f"or a mode {sorted(MODES)}.")

    mode = mode or overrides.pop("mode", None) or DEFAULT_CFG["mode"]  # "train", as in the JAX package
    if mode not in MODES:
        raise ValueError(f"invalid mode={mode}, must be one of {sorted(MODES)}")
    task = task or overrides.pop("task", None)
    model = overrides.pop("model", None) or (TASK2MODEL.get(task) if task else "yolov8n.yaml")

    from drone_yolo_tpu_torch.engine.model import YOLO

    ymodel = YOLO(model, task=task, device=overrides.get("device"))
    if mode in {"predict", "track"} and "source" not in overrides:
        overrides["source"] = str(ASSETS)
        LOGGER.warning(f"'source' argument is missing, using default source {overrides['source']}")
    if mode in {"train", "val"} and "data" not in overrides and "resume" not in overrides:
        overrides["data"] = TASK2DATA.get(task or ymodel.task, "coco8.yaml")
        LOGGER.warning(f"'data' argument is missing, using default data {overrides['data']}")
    getattr(ymodel, mode)(**overrides)  # nothing returned: a console script exits with what it returns

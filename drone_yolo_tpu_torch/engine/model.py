"""`YOLO` facade: build from a model yaml or load a `drone_yolo_tpu.v1` npz, then predict, track, train, validate or
export; or wrap an export artifact or a serving URL, then predict and validate through it.

Counterpart of `drone_yolo_tpu/engine/model.py` (YOLO) for detect, segment, pose, obb and classify models: predict,
track (not of an obb or classify model), train and val (the predictor, trainer and validator chosen by the task), `save`, `load` (a
transfer of the weights whose name and shape match), `info`, `embed`, `reset_weights`,
`names`, `stride`, and user callbacks forwarded to every trainer, validator and predictor
the facade makes. The model lives on `device`, which is the CUDA card unless the caller
passes `device="cpu"`; asking for CUDA where there is none is an error.

`overrides` holds the arguments every mode starts from, as the JAX facade's: the model
and task, and for a checkpoint its `train_args`, so that `imgsz` and every other train key
carry into predict and val. Each mode lays its defaults over them (predict: conf 0.25,
batch 1, save False; val: rect True), then the call's arguments. `export` writes an npz, TorchScript or ONNX
artifact (`engine/exporter.py`). A `.torchscript` or `.onnx` artifact or a KServe-v2 URL as the model
(`YOLO("best.onnx")`) runs through `nn/autobackend.py:AutoBackend`: `model` is None, `backend` is set, the task and
the artifact's input size come from it, and predict and val run through it (train, export and the weight methods are
refused). `tune` and `benchmark` are not ported and are refused by name.
"""

from __future__ import annotations

import copy
import logging
from collections import defaultdict

import numpy as np
import torch

from drone_yolo_tpu_torch.cfg import check_ported, get_cfg, get_save_dir
from drone_yolo_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
from drone_yolo_tpu_torch.nn import modules as M
from drone_yolo_tpu_torch.nn.autobackend import is_artifact
from drone_yolo_tpu_torch.nn.model import TASK2MODELCLASS, DetectionModel, guess_model_task

LOGGER = logging.getLogger("drone_yolo_tpu_torch")


def select_device(device=None) -> torch.device:
    """`device` as a torch.device, CUDA when None; raises if CUDA is asked for and absent."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False; pass device='cpu' to run on the CPU")
    return device


def _model_class(task: str):
    if task not in TASK2MODELCLASS:
        raise NotImplementedError(f"task {task!r} is not ported yet (ported: {sorted(TASK2MODELCLASS)}; ROADMAP.md queue 1 "
                                  "item 7)")
    return TASK2MODELCLASS[task]


class YOLO:
    """User-facing facade: `YOLO("yolov8s-p2-repvgg-sf.yaml").predict("frames/")`, `.track("clip.avi")`, `.val(data=...)`."""

    def __init__(self, model="yolov8n.yaml", task: str | None = None, device=None):
        self.device = select_device(device)
        self.predictor = self.trainer = self.validator = self.ckpt = None
        self.metrics = None
        self.overrides: dict = {}
        self.callbacks = defaultdict(list)  # user callbacks, forwarded to what the facade makes
        model = str(model).strip()
        self.model_name = model
        self.backend = None
        if is_artifact(model):
            self._load_backend(model, task)
            return
        if model.endswith((".yaml", ".yml")):
            self.task = task or guess_model_task(model)
            self.model = _model_class(self.task)(model)
            self.initialized = False
            self.overrides.update(model=model, task=self.task)
        elif model.endswith(".npz"):
            self.model, self.ckpt = load_checkpoint(model)
            self.task = task or self.model.task
            self.initialized = True
            self.overrides = {**self.ckpt.get("train_args", {}), "model": model, "task": self.task}
        else:
            raise ValueError(f"model must be a .yaml, a drone_yolo_tpu.v1 .npz checkpoint, a .torchscript or .onnx "
                             f"artifact or a serving URL, got {model!r}")
        self.model.to(self.device)

    def _load_backend(self, path: str, task: str | None = None) -> None:
        """Wrap an export artifact or a serving URL (`AutoBackend`): predict and val run through it."""
        from drone_yolo_tpu_torch.nn.autobackend import AutoBackend

        self.backend = AutoBackend(path, self.device)
        self.model = None
        self.task = task or self.backend.task
        self.initialized = True
        self.overrides = {"model": path, "task": self.task}
        if self.backend.input_shape:  # a fixed-shape artifact predicts and validates at its own size
            self.overrides["imgsz"] = self.backend.input_shape[-1]

    def _needs_model(self, what: str) -> None:
        if self.backend is not None:
            raise NotImplementedError(f"{what} needs the model's weights: {self.model_name} is an export artifact or a "
                                      "serving URL, which predicts and validates only")

    def ensure_variables(self, imgsz: int = 640, seed: int = 0) -> DetectionModel:
        """Initialize the weights from `seed` unless they are set; bias priors follow `imgsz`."""
        self._needs_model("ensure_variables")
        if not self.initialized:
            self.model.init(seed, imgsz=imgsz)
            self.initialized = True
        return self.model

    @property
    def names(self) -> dict:
        return self.backend.names if self.backend is not None else self.model.names

    @property
    def stride(self) -> list:
        return self.backend.stride if self.backend is not None else self.model.head.stride

    # -- callbacks ---------------------------------------------------------------------------------
    def add_callback(self, event: str, func) -> None:
        """Register `func(component)` for `event` on every trainer, validator and predictor made from now on."""
        self.callbacks[event].append(func)

    def clear_callback(self, event: str) -> None:
        self.callbacks[event] = []

    def reset_callbacks(self) -> None:
        self.callbacks = defaultdict(list)

    def _forward_callbacks(self, component) -> None:
        for event, fns in self.callbacks.items():
            for fn in fns:
                component.add_callback(event, fn)

    # -- weights -----------------------------------------------------------------------------------
    def fuse(self) -> YOLO:
        """Fold BN and RepVGG branches into plain convs, in place."""
        self.ensure_variables()
        self.model.fuse()
        return self

    def reset_weights(self) -> YOLO:
        """Forget the weights: the next use draws a new init (a model loaded fused is rebuilt from its yaml)."""
        self._needs_model("reset_weights")
        if not any(isinstance(m, M.BatchNorm2d) for m in self.model.modules()):
            names, stride = self.model.names, self.model.head.stride
            self.model = type(self.model)(self.model.yaml).to(self.device)
            self.model.names, self.model.head.stride = names, stride
        self.initialized = False
        self.ckpt = None
        self.predictor = None
        return self

    def save(self, path) -> None:
        """Write the weights as a `drone_yolo_tpu.v1` npz with `overrides` as its train_args."""
        model = self.ensure_variables()
        save_checkpoint(path, model, model.state_dict(), train_args=self.overrides)

    def load(self, weights) -> YOLO:
        """Copy the weights of the checkpoint `weights` whose name and shape match into this model; the rest keep
        theirs (a transfer across heads or class counts)."""
        self._needs_model("load")
        src, self.ckpt = load_checkpoint(weights)
        dst = self.ensure_variables().state_dict()
        same = {k: v for k, v in src.state_dict().items() if k in dst and v.shape == dst[k].shape}
        self.model.load_state_dict(same, strict=False)
        self.predictor = None
        LOGGER.info(f"transferred {len(same)}/{len(dst)} weights from {weights}")
        return self

    def info(self, verbose: bool = True) -> str:
        self._needs_model("info")
        msg = (f"{type(self.model).__name__}: {len(self.model.model)} layers, {self.model.param_count():,} parameters, "
               f"task={self.task}")
        if verbose:
            LOGGER.info(msg)
        return msg

    @torch.no_grad()
    def embed(self, source=None, layers=None, **kwargs) -> dict:
        """Per image, the mean over H and W of the outputs of `layers` (the layer before the head by default):
        {layer index: (B, C) float32}, on the letterboxed BGR frames of `source` at imgsz, in float32. Forward hooks
        on those layers read them while the model runs its own forward pass."""
        from drone_yolo_tpu_torch.ops.letterbox import letterbox_u8

        net = self.ensure_variables()
        layers = layers or [len(net.model) - 2]
        imgsz = kwargs.get("imgsz", self.overrides.get("imgsz", 640))
        imgs = source if isinstance(source, list) else [source]
        x = torch.cat([letterbox_u8(torch.from_numpy(np.ascontiguousarray(im)).to(self.device)[None], (imgsz, imgsz))
                       for im in imgs])
        feats = {}

        def pool(i, out):
            if isinstance(out, torch.Tensor):  # the head's output is a tuple, as in the JAX package
                feats[i] = out.float().mean((2, 3))

        hooks = [net.model[i].register_forward_hook(lambda mod, args, out, i=i: pool(i, out)) for i in layers]
        training = net.training
        try:
            net.eval()  # running BN statistics, as the JAX package's train=False
            net(x.flip(-1).permute(0, 3, 1, 2).float() / 255.0)
        finally:
            net.train(training)
            for h in hooks:
                h.remove()
        return feats

    # -- modes -------------------------------------------------------------------------------------
    def predict(self, source=None, stream: bool = False, **kwargs):
        """Detect (with masks for a segment model, keypoints for a pose model, oriented boxes for an obb model), or
        classify (probabilities for a classify model), on a
        source (`data/loaders.py`: files, directories, globs, .txt lists, MJPEG AVI, numpy frames); returns a list of
        Results (a generator with stream=True). The predictor, chosen by the task, is made at the first call, and again when the dtype changes;
        later calls update its arguments with theirs."""
        from drone_yolo_tpu_torch.models.yolo import TASK_MAP

        custom = {"conf": 0.25, "batch": 1, "save": False, "mode": "predict"}
        pred_cls = TASK_MAP[self.task]["predictor"]
        p = self.predictor
        if p is None or p.__class__ is not pred_cls or get_cfg(p.args, kwargs).dtype != p.args.dtype:
            self.predictor = pred_cls(overrides={**self.overrides, **custom, **kwargs})
            self.predictor.setup_model(self)
            self._forward_callbacks(self.predictor)
            for event, fn in getattr(self, "_pending_tracker_callbacks", []):
                self.predictor.add_callback(event, fn)
        else:
            p.args = check_ported(get_cfg(p.args, kwargs), "predict")
            if "project" in kwargs or "name" in kwargs:  # as Ultralytics; the JAX facade keeps the first call's folder
                p.save_dir = get_save_dir(p.args)
        return self.predictor(source=source, stream=stream)

    def __call__(self, source=None, stream: bool = False, **kwargs):
        return self.predict(source, stream, **kwargs)

    def track(self, source=None, stream: bool = False, persist: bool = False, **kwargs):
        """Predict, then track: boxes with track ids (7 columns). `tracker` names a tracker yaml: botsort.yaml (the
        default: BoT-SORT, ByteTrack's association on the host after camera-motion compensation by sparse optical
        flow on the model's device) or bytetrack.yaml. A new tracker starts at each call and at each new video file
        of the source; with `persist` the tracker carries over from call to call, so a video can go frame by frame.
        conf defaults to 0.1."""
        from drone_yolo_tpu_torch.trackers.track import register_tracker

        if self.task == "obb":
            raise NotImplementedError("tracking an obb model is not ported yet (ROADMAP.md queue 1 item 5): the JAX "
                                      "track callback reads only boxes, so it tracks nothing there")
        if self.task == "classify":
            raise NotImplementedError("a classify model gives no boxes to track")
        if not hasattr(self, "_pending_tracker_callbacks"):
            register_tracker(self, persist)
        kwargs["conf"] = kwargs.get("conf") or 0.1
        kwargs["mode"] = "track"
        return self.predict(source=source, stream=stream, **kwargs)

    def train(self, data=None, **kwargs) -> dict:
        """Train on the dataset `data` (a dataset yaml; an image folder for a classifier) with the task's trainer
        (`engine/trainer.py`, `models/yolo/segment.py`, `models/yolo/pose.py`, `models/yolo/obb.py`,
        `models/yolo/classify.py`), then take over the best EMA weights; returns the last epoch's validation metrics."""
        from drone_yolo_tpu_torch.models.yolo import TASK_MAP

        self._needs_model("train")
        overrides = {**self.overrides, "device": str(self.device), **kwargs, "mode": "train"}
        if data is not None:
            overrides["data"] = str(data)
        if not overrides.get("data"):
            raise ValueError("a dataset is required: pass data=<data.yaml>")
        self.trainer = TASK_MAP[self.task]["trainer"](overrides=overrides)
        self._forward_callbacks(self.trainer)
        self.trainer.model_facade = self
        self.trainer.train()
        self.model = copy.deepcopy(self.trainer.model).eval()  # the trainer's model keeps its last train state
        self.model.load_state_dict(self.trainer.best_state, strict=True)
        self.initialized = True
        self.predictor = None  # built again from the new weights
        return self.trainer.metrics

    def val(self, data=None, **kwargs) -> dict:
        """Validate on the val split of the dataset yaml `data` with the task's validator (`engine/validator.py`,
        `models/yolo/segment.py`, `models/yolo/pose.py`, `models/yolo/obb.py`, `models/yolo/classify.py`) in
        rectangular batches (rect=True unless the call says otherwise, as the JAX facade; a classifier's validator
        crops every image square; an artifact validates in square batches at its own batch and size); returns the
        metrics."""
        from drone_yolo_tpu_torch.models.yolo import TASK_MAP

        args = {**self.overrides, "rect": True, "mode": "val", "device": str(self.device), **kwargs}
        if data is not None:
            args["data"] = str(data)
        if not args.get("data"):
            raise ValueError("a dataset is required: pass data=<data.yaml>")
        self.validator = TASK_MAP[self.task]["validator"](args=args)
        self._forward_callbacks(self.validator)
        self.metrics = self.validator(model=self)
        return self.metrics

    def tune(self, *args, **kwargs):
        raise NotImplementedError("tune (the hyperparameter tuner) is not ported yet (ROADMAP.md queue 1 item 2, the "
                                  "next slice)")

    def benchmark(self, *args, **kwargs):
        raise NotImplementedError("benchmark (export formats' speed and accuracy) is not ported yet (ROADMAP.md queue 1 "
                                  "item 2, the next slice)")

    def export(self, **kwargs) -> str:
        """Write the fused model as `format` (npz, torchscript, onnx; stablehlo, the configuration's default, is
        written as torchscript) at imgsz and batch, with the npz always; returns the last path written."""
        from drone_yolo_tpu_torch.engine.exporter import Exporter

        self._needs_model("export")
        exporter = Exporter(overrides={**self.overrides, **kwargs, "mode": "export"})
        self._forward_callbacks(exporter)
        return exporter(self)

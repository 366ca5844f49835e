"""`YOLO` facade: build from a model yaml or load a JAX-package npz, then predict, track, train or validate.

Counterpart of `drone_yolo_tpu/engine/model.py` (YOLO) for predict and track (detect and
pose models, the predictor chosen by the model's task), train and val (detect). The model
lives on `device`, which is the CUDA card unless the caller passes `device="cpu"`; asking
for CUDA where there is none is an error. `overrides` holds predict arguments that every
predictor this facade makes starts from, as the JAX facade's `overrides`.
"""

from __future__ import annotations

import copy

import torch

from drone_yolo_tpu_torch.cfg import get_cfg
from drone_yolo_tpu_torch.engine.checkpoint import load_checkpoint
from drone_yolo_tpu_torch.nn.model import TASK2MODELCLASS, DetectionModel, guess_model_task


def select_device(device=None) -> torch.device:
    """`device` as a torch.device, CUDA when None; raises if CUDA is asked for and absent."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False; pass device='cpu' to run on the CPU")
    return device


class YOLO:
    """User-facing facade: `YOLO("yolov8s-p2-repvgg-sf.yaml").predict(frames)`, `.track(frames, persist=True)`."""

    def __init__(self, model="yolov8n.yaml", device=None):
        self.device = select_device(device)
        self.predictor = None
        self.trainer = None
        self.ckpt = None
        self.overrides: dict = {}
        model = str(model).strip()
        self.model_name = model
        if model.endswith((".yaml", ".yml")):
            self.model = TASK2MODELCLASS[guess_model_task(model)](model)
            self.initialized = False
        elif model.endswith(".npz"):
            self.model, self.ckpt = load_checkpoint(model)
            self.initialized = True
        else:
            raise ValueError(f"model must be a .yaml or a JAX-package .npz checkpoint, got {model!r}")
        self.model.to(self.device)

    def ensure_variables(self, imgsz: int = 640, seed: int = 0) -> DetectionModel:
        """Initialize the weights from `seed` unless they are set; bias priors follow `imgsz`."""
        if not self.initialized:
            self.model.init(seed, imgsz=imgsz)
            self.initialized = True
        return self.model

    def fuse(self) -> YOLO:
        """Fold BN and RepVGG branches into plain convs, in place."""
        self.ensure_variables()
        self.model.fuse()
        return self

    @property
    def task(self) -> str:
        return self.model.task

    def predict(self, source=None, stream: bool = False, **kwargs):
        """Detect (or, for a pose model, detect with keypoints) on numpy frames; returns a list of Results (a
        generator with stream=True). The predictor, chosen by the model's task, is made at the first call and again
        when the dtype changes; it gets the facade's tracker callbacks, if `track` registered them."""
        from drone_yolo_tpu_torch.models.yolo import TASK_MAP

        if self.predictor is None or get_cfg(self.predictor.args, kwargs).dtype != self.predictor.args.dtype:
            self.predictor = TASK_MAP[self.task]["predictor"](overrides={**self.overrides, "conf": 0.25, **kwargs})
            self.predictor.setup_model(self)
            for event, fn in getattr(self, "_pending_tracker_callbacks", []):
                self.predictor.add_callback(event, fn)
        else:
            self.predictor.args = get_cfg(self.predictor.args, kwargs)
        return self.predictor(source=source, stream=stream)

    def track(self, source=None, stream: bool = False, persist: bool = False, **kwargs):
        """Predict, then ByteTrack on the host: boxes with track ids (7 columns). With `persist` the tracker and its
        tracks carry over from call to call, so a video goes frame by frame. conf defaults to 0.1; `tracker` names a
        tracker yaml (bytetrack.yaml)."""
        from drone_yolo_tpu_torch.trackers.track import register_tracker

        if not hasattr(self, "_pending_tracker_callbacks"):
            register_tracker(self, persist)
        kwargs["conf"] = kwargs.get("conf") or 0.1
        return self.predict(source=source, stream=stream, **kwargs)

    def _detect_only(self, mode: str) -> None:
        if self.task != "detect":
            raise NotImplementedError(f"{mode} of a {self.task} model is not ported yet (ROADMAP.md queue 1 item 6)")

    def train(self, data=None, **overrides) -> dict:
        """Train on the dataset yaml `data` (`engine/trainer.py`), then take over the best EMA weights; returns the
        last epoch's validation metrics."""
        from drone_yolo_tpu_torch.engine.trainer import BaseTrainer

        self._detect_only("train")
        if not data:
            raise ValueError("a dataset is required: pass data=<data.yaml>")
        self.trainer = BaseTrainer(overrides={"model": self.model_name, "device": str(self.device), **overrides,
                                              "data": str(data)})
        self.trainer.model_facade = self
        self.trainer.train()
        self.model = copy.deepcopy(self.trainer.model).eval()  # the trainer's model keeps its last train state
        self.model.load_state_dict(self.trainer.best_state, strict=True)
        self.initialized = True
        self.predictor = None  # built again from the new weights
        return self.trainer.metrics

    def val(self, data=None, **overrides) -> dict:
        """Validate on the val split of the dataset yaml `data` (`engine/validator.py`); returns the metrics."""
        from drone_yolo_tpu_torch.engine.validator import DetectionValidator

        self._detect_only("val")
        if not data:
            raise ValueError("a dataset is required: pass data=<data.yaml>")
        self.validator = DetectionValidator(args={"device": str(self.device), **overrides, "data": str(data)})
        return self.validator(model=self)

"""`YOLO` facade: build from a model yaml or load a JAX-package npz, then predict.

Counterpart of `drone_yolo_tpu/engine/model.py` (YOLO) for predict, train and val.
The model lives on `device`, which is the CUDA card unless the caller passes
`device="cpu"`; asking for CUDA where there is none is an error.
"""

from __future__ import annotations

import copy

import torch

from drone_yolo_tpu_torch.cfg import get_cfg
from drone_yolo_tpu_torch.engine.checkpoint import load_checkpoint
from drone_yolo_tpu_torch.engine.predictor import DetectionPredictor
from drone_yolo_tpu_torch.nn.model import DetectionModel


def select_device(device=None) -> torch.device:
    """`device` as a torch.device, CUDA when None; raises if CUDA is asked for and absent."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False; pass device='cpu' to run on the CPU")
    return device


class YOLO:
    """User-facing facade: `YOLO("yolov8s-p2-repvgg-sf.yaml").predict(frames)`."""

    def __init__(self, model="yolov8n.yaml", device=None):
        self.device = select_device(device)
        self.predictor = None
        self.trainer = None
        self.ckpt = None
        model = str(model).strip()
        self.model_name = model
        if model.endswith((".yaml", ".yml")):
            self.model = DetectionModel(model)
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

    def predict(self, source=None, stream: bool = False, **kwargs):
        """Detect on numpy frames; returns a list of Results (a generator with stream=True)."""
        if self.predictor is None or get_cfg(self.predictor.args, kwargs).dtype != self.predictor.args.dtype:
            self.predictor = DetectionPredictor(overrides={"conf": 0.25, **kwargs})
            self.predictor.setup_model(self)
        else:
            self.predictor.args = get_cfg(self.predictor.args, kwargs)
        return self.predictor(source=source, stream=stream)

    def train(self, data=None, **overrides) -> dict:
        """Train on the dataset yaml `data` (`engine/trainer.py`), then take over the best EMA weights; returns the
        last epoch's validation metrics."""
        from drone_yolo_tpu_torch.engine.trainer import BaseTrainer

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

        if not data:
            raise ValueError("a dataset is required: pass data=<data.yaml>")
        self.validator = DetectionValidator(args={"device": str(self.device), **overrides, "data": str(data)})
        return self.validator(model=self)

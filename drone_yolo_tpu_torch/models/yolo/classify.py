"""Classification task: prediction, training and validation of image classifiers.

Counterpart of `drone_yolo_tpu/models/yolo/classify.py` (`ClassificationTrainer`, `ClassificationValidator`,
`ClassificationPredictor`). Data is an image folder (`data/utils.py:check_cls_dataset`, `data/dataset.py:
ClassificationDataset`): random resized crops and flips for training, the short side to imgsz and the centre crop for
validation. The trainer trains with `v8ClassificationLoss` and validates the EMA weights with `plots=False`; it draws
no train batches, as the JAX trainer draws only batches with boxes. The validator and the predictor run the fused
model in float32 whatever `dtype` says, as the JAX ones do. The validator takes each image's top min(5, nc) classes
by a stable descending sort, so that among equal probabilities the lower class index comes first, as
`jax.lax.top_k` orders them (`torch.topk` promises no order for ties). The predictor scales each frame's short side
to imgsz (the other by Python's round) with `ops/letterbox.py:resize_linear_u8` on the uploaded uint8 frame, crops
the centre and flips BGR to RGB; no letterbox.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from drone_yolo_tpu_torch.data.build import build_dataloader
from drone_yolo_tpu_torch.data.dataset import ClassificationDataset
from drone_yolo_tpu_torch.data.utils import check_cls_dataset
from drone_yolo_tpu_torch.engine.predictor import LOGGER, DetectionPredictor, Profile
from drone_yolo_tpu_torch.engine.results import Results
from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
from drone_yolo_tpu_torch.engine.validator import BaseValidator
from drone_yolo_tpu_torch.nn.model import ClassificationModel
from drone_yolo_tpu_torch.ops.letterbox import resize_linear_u8
from drone_yolo_tpu_torch.utils.loss import v8ClassificationLoss
from drone_yolo_tpu_torch.utils.metrics import ClassifyMetrics


class ClassificationPredictor(DetectionPredictor):
    """Softmax probabilities per image: Results with `probs` (nc,)."""

    def setup_model(self, facade) -> None:
        """The fused float32 model, or the facade's AutoBackend."""
        if facade.backend is not None:
            return super().setup_model(facade)
        facade.ensure_variables(imgsz=self.imgsz[0])
        self.device = facade.device
        self.dtype = torch.float32
        self.net = self.model = copy.deepcopy(facade.model).eval().to(self.device, torch.float32).fuse()
        self.names, self.nc = self.model.names, self.model.nc

    def preprocess(self, imgs) -> torch.Tensor:
        """BGR frames -> (B, 3, imgsz, imgsz) RGB float32 in [0, 1] on the device: each frame uploaded as uint8, its
        short side resized to imgsz, its centre cropped."""
        size = self.imgsz[0]
        out = []
        for im in imgs:
            h, w = im.shape[:2]
            r = size / min(h, w)
            t = resize_linear_u8(torch.from_numpy(np.ascontiguousarray(im)).to(self.device)[None], (round(h * r), round(w * r)))
            top, left = (t.shape[1] - size) // 2, (t.shape[2] - size) // 2
            out.append(t[0, top : top + size, left : left + size])
        return torch.stack(out).flip(-1).permute(0, 3, 1, 2).float() / 255.0

    @torch.inference_mode()
    def inference(self, x: torch.Tensor):
        """(probs (B, nc) float32, zeros (B,)): the predictor's (detections, counts) pair."""
        return self.net(x), torch.zeros(x.shape[0], dtype=torch.int32)

    def postprocess(self, probs, n_valid, x_shape, orig_imgs, paths):
        probs = probs.float().cpu().numpy()
        return [Results(im0, path, self.names, probs=probs[i]) for i, (im0, path) in enumerate(zip(orig_imgs, paths))]


class ClassificationValidator(BaseValidator):
    """Top-1 and top-5 accuracy over an image-folder dataset's val split (its train split when it has none)."""

    task = "classify"
    metrics_class = ClassifyMetrics

    def __init__(self, dataloader=None, args: dict | None = None):
        super().__init__(dataloader, args)
        self.dtype = torch.float32  # whatever args.dtype says, as the JAX validator

    def build_loader(self) -> tuple[dict, object]:
        data = check_cls_dataset(self.args.data)
        dataset = ClassificationDataset(data["val"] or data["train"], imgsz=self.args.imgsz, augment=False)
        return data, build_dataloader(dataset, self.args.batch, self.args.workers, shuffle=False, drop_last=False)

    def __call__(self, model=None, ema_state: dict | None = None) -> dict:
        self.run_callbacks("on_val_start")
        self.setup_model(model, ema_state)
        k = min(5, self.nc)
        self.pred, self.targets = [], []  # per batch: the top-k class indices, the labels
        dt = [Profile(self.device) for _ in range(3)]
        totals = [0.0, 0.0, 0.0]
        self.seen = 0
        for batch in self.dataloader:
            self.run_callbacks("on_val_batch_start")
            with dt[0]:
                x = self.preprocess(batch)
            with dt[1], torch.inference_mode():  # a stable sort: the lower class index first among equal ones
                top = torch.sort(self.net(x), dim=1, descending=True, stable=True).indices[:, :k].cpu().numpy()
            with dt[2]:
                self.pred.append(top)
                self.targets.append(np.asarray(batch["cls"]))
                self.seen += len(top)
            totals = [t + p.dt for t, p in zip(totals, dt)]
            self.run_callbacks("on_val_batch_end")
        self.metrics.process(np.concatenate(self.targets), np.concatenate(self.pred))
        self.speed = {k: t / max(self.seen, 1) * 1e3 for k, t in zip(("preprocess", "inference", "postprocess"), totals)}
        self.metrics.speed.update(self.speed)
        LOGGER.info(f"top1: {self.metrics.top1:.4f} top5: {self.metrics.top5:.4f}")
        self.run_callbacks("on_val_end")
        return self.metrics.results_dict


class ClassificationTrainer(BaseTrainer):
    """Trainer of classifiers over an image folder: `v8ClassificationLoss`, the EMA validated by
    `ClassificationValidator`."""

    task = "classify"
    loss_names = ("loss",)
    validator_class = ClassificationValidator

    def get_dataset(self) -> dict:
        return check_cls_dataset(self.args.data)

    def build_dataset(self, img_path, mode: str = "train") -> ClassificationDataset:
        return ClassificationDataset(img_path, imgsz=self.args.imgsz, augment=mode == "train",
                                     fraction=self.args.fraction if mode == "train" else 1.0, hyp=self.args)

    def build_model(self, cfg) -> ClassificationModel:
        return ClassificationModel(cfg, nc=self.data.get("nc"))

    def get_criterion(self):
        return v8ClassificationLoss()

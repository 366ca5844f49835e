"""Detection validator: the forward and multi-label NMS on the device, TP matching and mAP on the host.

Counterpart of `drone_yolo_tpu/engine/validator.py` (BaseValidator, DetectionValidator)
for the detect task, and the base of the pose, segment and obb tasks' (`models/yolo/pose.py:PoseValidator`,
`models/yolo/segment.py:SegmentationValidator`, `models/yolo/obb.py:OBBValidator`, which also overrides
`postprocess`: rotated NMS).
A batch goes to the device as uint8 and is normalised there; the model, an eval-mode fused
copy in `args.dtype`, gives (B, A, 4 + nc [+ extra]) predictions; `ops/nms.py` keeps up to
`max_det` per image from the top `pre_nms_topk` (anchor, class) candidates (K = 4096 by
default, the greedy-keep kernel on the card), carrying a pose model's keypoint columns with
them; only the detections and their counts come back to the host, where `update_metrics`
rescales them and the GT to the original frames and matches them, and `get_stats` computes
P, R, mAP50 and mAP50-95 with `utils/metrics.py`. A task validator sets `task`, `metrics_class`,
`stat_keys` (the arguments of its metrics' `process`, in order) and `print_cols`, and overrides
`update_metrics`.

Given a facade that wraps an export artifact or a serving URL (`nn/autobackend.py:AutoBackend`, which
`YOLO("best.onnx").val(...)` passes), the validator runs through it: the stride, the names and nc come from
the artifact, and a fixed-shape artifact validates in square batches (`rect` off, logged) at its own batch
and imgsz; multi-label NMS runs over its output, a YOLOv10 artifact's decoded one-to-one predictions too.

`dataloader` is any iterable of batches in the collate format
(`drone_yolo_tpu/data/dataset.py:YOLODataset.collate`): `img` (B, H, W, 3) uint8 RGB,
`cls` (B, M), `bboxes` (B, M, 4) letterboxed pixel xyxy, `mask` (B, M), and per image
`ori_shapes` (h, w) and `ratio_pads` (gain, (pad_w, pad_h)) or None. Given no dataloader,
the validator builds one over the val split of `args.data` (`data/build.py`: letterboxed
without enlarging, in order, every image; with `rect`, as `YOLO.val` sets it, in
rectangular batches of at most `rect_max_shapes` shapes, each batch at its own input
shape). With `plots` the detect validator also fills `confusion_matrix` (`utils/metrics.py:ConfusionMatrix`, conf
0.25) with each image's detections and GT in the original frame, as the JAX one does; COCO JSON comes with a later
slice.

Callbacks (`utils/callbacks.py`) run at `on_val_start`, `on_val_batch_start`,
`on_val_batch_end` and `on_val_end`.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from drone_yolo_tpu_torch.cfg import get_val_cfg
from drone_yolo_tpu_torch.data.build import build_dataloader, build_yolo_dataset
from drone_yolo_tpu_torch.data.utils import check_det_dataset
from drone_yolo_tpu_torch.engine.model import select_device
from drone_yolo_tpu_torch.engine.predictor import LOGGER, Profile
from drone_yolo_tpu_torch.nn.modules import v10Detect
from drone_yolo_tpu_torch.ops.boxes import scale_boxes
from drone_yolo_tpu_torch.ops.nms import end2end_detections, non_max_suppression
from drone_yolo_tpu_torch.utils.callbacks import CallbackMixin, get_default_callbacks
from drone_yolo_tpu_torch.utils.metrics import ConfusionMatrix, DetMetrics, box_iou_np, match_predictions


class BaseValidator(CallbackMixin):
    """`DetectionValidator(dataloader=batches, args={"imgsz": 640})(model=facade_or_model, ema_state=None)`.

    Validates on `args.device`, the CUDA card unless the caller passes device="cpu". Returns
    the metrics by the JAX package's keys, with `fitness`, each rounded to 5 decimals.
    """

    task = "detect"
    metrics_class = DetMetrics
    stat_keys = ("tp", "conf", "pred_cls", "target_cls")  # accumulated per image; `metrics.process`'s arguments
    print_cols = ("P", "R", "mAP50", "mAP50-95")  # the columns of `metrics.mean_results()` in the printed table

    def __init__(self, dataloader=None, args: dict | None = None):
        self.args = get_val_cfg(overrides=args)
        self.args.task = self.task  # the dataset reads this task's labels
        self.device = select_device(self.args.device)
        self.dtype = torch.bfloat16 if self.args.dtype == "bfloat16" else torch.float32
        self.dataloader = dataloader
        self.data = None  # the dataset yaml's contents, when the validator builds its own loader
        self.iouv = np.linspace(0.5, 0.95, 10)
        self.metrics = self.metrics_class()
        self.speed = {}
        self.model = self.backend = self.net = None  # `net`: the model, or the artifact's `AutoBackend.model_output`
        self.callbacks = get_default_callbacks()

    def setup_model(self, model, ema_state: dict | None = None) -> None:
        """An eval-mode, fused copy of `model` (a YOLO facade or a DetectionModel), with the weights of
        `ema_state` (a full state dict by name, such as `ModelEMA.state`) when given, in the compute
        dtype on the device; or the AutoBackend of a facade that wraps an artifact (or the AutoBackend itself)."""
        from drone_yolo_tpu_torch.nn.autobackend import AutoBackend

        self.backend = model if isinstance(model, AutoBackend) else getattr(model, "backend", None)
        if self.backend is not None:
            self.setup_backend()
        else:
            if hasattr(model, "ensure_variables"):  # the facade
                model.ensure_variables(imgsz=self.args.imgsz)
                model = model.model
            net = copy.deepcopy(model)
            if ema_state is not None:
                net.load_state_dict(ema_state, strict=True)
            self.net = self.model = net.eval().to(self.device, torch.float32).fuse().to(self.dtype)
            head = self.model.head
            self.nc, self.stride, self.kpt_shape = self.model.nc, head.stride, getattr(head, "kpt_shape", None)
        if self.dataloader is None:
            self.data, self.dataloader = self.build_loader()
        self.names = self.data["names"] if self.data else (self.model if self.backend is None else self.backend).names
        self.metrics = self.metrics_class(self.names)  # a fresh one per call: a reused validator reports no stale metrics
        self.confusion_matrix = ConfusionMatrix(nc=self.nc, conf=self.args.conf)

    def setup_backend(self) -> None:
        """Validate through `self.backend`: its stride, nc and keypoint shape; a fixed-shape artifact's batch and
        imgsz, in square batches."""
        b = self.backend
        self.net, self.nc, self.stride, self.kpt_shape = b.model_output, b.nc, b.stride, b.kpt_shape
        if b.input_shape:
            self.args.batch, self.args.imgsz = b.input_shape[0], b.input_shape[-1]
            if self.args.rect:  # a fixed-shape artifact takes one input shape: rect batches would feed others
                LOGGER.info("rect=True disabled for a fixed-shape artifact (square letterbox val)")
                self.args.rect = False

    def build_loader(self) -> tuple[dict, object]:
        """(the dataset yaml's contents, a loader over its val split in order, every image)."""
        data = check_det_dataset(self.args.data)
        dataset = build_yolo_dataset(self.args, data["val"], self.args.batch, data, mode="val",
                                     stride=int(max(self.stride)))
        return data, build_dataloader(dataset, self.args.batch, self.args.workers, shuffle=False, drop_last=False)

    def preprocess(self, batch: dict) -> torch.Tensor:
        """The uint8 NHWC batch to the device, there NCHW float32 in [0, 1]."""
        img = torch.from_numpy(np.ascontiguousarray(batch["img"])).to(self.device, non_blocking=True)
        return img.permute(0, 3, 1, 2).float() / 255.0

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Decoded predictions (B, A, 4 + nc [+ extra]), float32."""
        return self.net(x)[0]

    @torch.inference_mode()
    def postprocess(self, preds: torch.Tensor):
        """Multi-label NMS over the top `pre_nms_topk` candidates -> (dets (B, max_det, 6 + extra), n_valid (B,)); the
        columns after the nc scores (a pose model's keypoints) ride with their candidates. YOLOv10's NMS-free head
        gives its detections sorted (`v10Detect`): they are cut to `max_det` and `conf`, with no NMS."""
        if self.backend is None and isinstance(self.model.head, v10Detect):
            return end2end_detections(preds, self.args.conf, self.args.max_det)
        return non_max_suppression(preds, conf_thres=self.args.conf, iou_thres=self.args.iou, max_det=self.args.max_det,
                                   pre_topk=self.args.pre_nms_topk, multi_label=True, nc=self.nc)

    def __call__(self, model=None, ema_state: dict | None = None) -> dict:
        self.run_callbacks("on_val_start")
        self.setup_model(model, ema_state)
        self.stats = {k: [] for k in self.stat_keys}
        self.seen = 0
        dt = [Profile(self.device) for _ in range(3)]
        totals = [0.0, 0.0, 0.0]
        for batch in self.dataloader:
            self.run_callbacks("on_val_batch_start")
            with dt[0]:
                x = self.preprocess(batch)
            with dt[1]:
                dets, n_valid = self.postprocess(self.forward(x))
                dets, n_valid = dets.float().cpu().numpy(), n_valid.cpu().numpy()
            with dt[2]:
                self.update_metrics(dets, n_valid, batch, tuple(x.shape[2:]))
            totals = [t + p.dt for t, p in zip(totals, dt)]
            self.run_callbacks("on_val_batch_end")
        stats = self.get_stats()
        self.speed = {k: t / max(self.seen, 1) * 1e3 for k, t in zip(("preprocess", "inference", "postprocess"), totals)}
        self.print_results()
        self.run_callbacks("on_val_end")
        results = {**stats, "fitness": self.metrics.fitness}
        return {k: round(float(v), 5) for k, v in results.items()}

    def update_metrics(self, dets: np.ndarray, n_valid: np.ndarray, batch: dict, in_shape) -> None:
        """Per image: detections and GT back to the original frame, IoU, TP at the 10 thresholds, accumulated."""
        for i in range(len(dets)):
            self.seen += 1
            d = dets[i, : int(n_valid[i])].copy()
            gt_mask = batch["mask"][i].astype(bool)
            gt_native = batch["bboxes"][i][gt_mask]  # letterboxed pixel xyxy
            gt_cls = batch["cls"][i][gt_mask]
            ori_shape = batch["ori_shapes"][i]
            rp = batch["ratio_pads"][i]
            ratio_pad = ((rp[0], rp[0]), rp[1]) if rp else None
            if len(d):
                d[:, :4] = scale_boxes(in_shape, torch.from_numpy(d[:, :4]), ori_shape, ratio_pad).numpy()
            if len(gt_native):
                gt_native = scale_boxes(in_shape, torch.from_numpy(gt_native.copy()), ori_shape, ratio_pad).numpy()
            iou = box_iou_np(gt_native, d[:, :4]) if len(d) and len(gt_native) else np.zeros((len(gt_native), len(d)))
            tp = match_predictions(d[:, 5].astype(int), gt_cls.astype(int), iou, self.iouv)
            self.stats["tp"].append(tp)
            self.stats["conf"].append(d[:, 4])
            self.stats["pred_cls"].append(d[:, 5])
            self.stats["target_cls"].append(gt_cls)
            if self.args.plots:
                self.confusion_matrix.process_batch(d, gt_native, gt_cls)

    def get_stats(self) -> dict:
        """The metrics' means (P, R, mAP50 and mAP50-95 of each kind) over everything accumulated, by the JAX
        package's keys."""
        st = {k: np.concatenate(v) if v else np.zeros((0, len(self.iouv)) if k.startswith("tp") else 0, bool)
              for k, v in self.stats.items()}
        if len(st["conf"]):
            self.metrics.process(*(st[k] for k in self.stat_keys))
        self.nt_per_class = np.bincount(st["target_cls"].astype(int), minlength=self.nc)
        return dict(zip(self.metrics.keys, self.metrics.mean_results()))

    def print_results(self) -> None:
        """One line for all classes (and one a class with `verbose`) of the metrics' mean results, then the speed."""
        pf = "%22s%11i%11i" + "%11.3g" * len(self.print_cols)
        LOGGER.info(("%22s%11s%11s" + "%11s" * len(self.print_cols)) % ("Class", "Images", "Instances", *self.print_cols))
        LOGGER.info(pf % ("all", self.seen, int(self.nt_per_class.sum()), *self.metrics.mean_results()))
        if self.args.verbose and self.nc > 1 and len(self.metrics.box.ap_class_index):
            for i, c in enumerate(self.metrics.box.ap_class_index):
                name = self.names.get(int(c), str(c))
                LOGGER.info(pf % (name, self.seen, int(self.nt_per_class[int(c)]), *self.metrics.class_result(i)))
        t = self.speed
        LOGGER.info(f"Speed: {t['preprocess']:.1f}ms preprocess, {t['inference']:.1f}ms inference, "
                    f"{t['postprocess']:.1f}ms postprocess per image")


class DetectionValidator(BaseValidator):
    """Detection task validator."""

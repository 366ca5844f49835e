"""OBB task: prediction, training and validation of oriented box models.

Counterpart of `drone_yolo_tpu/models/yolo/obb.py` (`_rboxes_from_segments`, `OBBTrainer`, `OBBPredictor`,
`OBBValidator`). Labels are polygons (`cls x1 y1 x2 y2 x3 y3 x4 y4`, normalised), which ride the host augmentation
and reach the batch as `segments_list`; a rotated box is made from each by `ops/rotated.py:min_area_rect`
(`cv2.minAreaRect`, OpenCV 5.0's angle in [-90, 0) degrees, not regularized), in radians. The trainer trains with
`v8OBBLoss` (box, cls, dfl) on `rboxes` (B, M, 5) made from each image's first M polygons, or, when no image of the
batch has polygons, from the axis-aligned boxes at angle 0 (the JAX trainer falls back only when the batch has no
`segments_list`, and trains such a batch on zero boxes; ROADMAP queue 3). The predictor and validator suppress by
probiou with the JAX package's fast (matrix) NMS (`ops/nms.py:nms_rotated`); the predictor undoes the letterbox on
cx, cy, w and h and neither clips nor regularizes; the validator matches detections to the GT rotated boxes by
probiou in the letterboxed frame (neither side is scaled back), and reports the box metrics' keys (`OBBMetrics`).

`classes` filters the predictor's candidates by class, as for detection; the JAX OBB predictor ignores it. Tracking
an OBB model is refused: the JAX track callback reads only `boxes`, so it tracks nothing there (ROADMAP queue 1
item 5). COCO/DOTA JSON (`save_json`) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from drone_yolo_tpu_torch.engine.predictor import DetectionPredictor
from drone_yolo_tpu_torch.engine.results import Results
from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
from drone_yolo_tpu_torch.engine.validator import BaseValidator
from drone_yolo_tpu_torch.nn.model import OBBModel
from drone_yolo_tpu_torch.ops.boxes import probiou
from drone_yolo_tpu_torch.ops.nms import nms_rotated
from drone_yolo_tpu_torch.ops.rotated import min_area_rect
from drone_yolo_tpu_torch.utils.loss import v8OBBLoss
from drone_yolo_tpu_torch.utils.metrics import OBBMetrics, match_predictions


def rboxes_from_segments(segments) -> np.ndarray:
    """Polygons (each (K, 2), K >= 1) -> (N, 5) float32 xywhr by `min_area_rect`, the angle in radians."""
    out = np.zeros((len(segments), 5), np.float32)
    for i, seg in enumerate(segments):
        (cx, cy), (w, h), ang = min_area_rect(np.asarray(seg, np.float32))
        out[i] = [cx, cy, w, h, np.deg2rad(ang)]
    return out


def rboxes_from_xyxy(xyxy: np.ndarray) -> np.ndarray:
    """Axis-aligned (..., 4) xyxy boxes -> (..., 5) xywhr at angle 0."""
    out = np.zeros((*xyxy.shape[:-1], 5), np.float32)
    out[..., 0] = (xyxy[..., 0] + xyxy[..., 2]) / 2
    out[..., 1] = (xyxy[..., 1] + xyxy[..., 3]) / 2
    out[..., 2] = xyxy[..., 2] - xyxy[..., 0]
    out[..., 3] = xyxy[..., 3] - xyxy[..., 1]
    return out


class OBBPredictor(DetectionPredictor):
    """Predictor whose Results carry `obb` (N, 7): cx, cy, w, h, angle, conf, cls in the original frame."""

    @torch.inference_mode()
    def inference(self, x: torch.Tensor):
        """Forward, decode and rotated NMS over the top min(pre_nms_topk, 1024) anchors -> (dets (B, max_det, 7),
        n_valid (B,)), on the device."""
        preds, _ = self.net(x)
        return nms_rotated(preds, conf_thres=self.args.conf, iou_thres=self.args.iou, max_det=self.args.max_det,
                           pre_topk=min(self.args.pre_nms_topk, 1024), nc=self.nc, classes=self.args.classes)

    def postprocess(self, dets, n_valid, x_shape, orig_imgs, paths):
        """Detections to the host, cx, cy less the letterbox's pad and cx, cy, w, h over its gain; the angle stays."""
        dets = dets.float().cpu().numpy()
        results = []
        for i, (im0, path) in enumerate(zip(orig_imgs, paths)):
            d = dets[i, : int(n_valid[i])].copy()
            gain = min(x_shape[0] / im0.shape[0], x_shape[1] / im0.shape[1])
            d[:, 0] = (d[:, 0] - (x_shape[1] - im0.shape[1] * gain) / 2) / gain
            d[:, 1] = (d[:, 1] - (x_shape[0] - im0.shape[0] * gain) / 2) / gain
            d[:, 2:4] /= gain
            results.append(Results(im0, path, self.names, obb=d))
        return results


class OBBValidator(BaseValidator):
    """Rotated-box mAP: multi-label rotated NMS on the device, then per image the detections matched to the GT rotated
    boxes (from the polygons, else the axis-aligned boxes at angle 0) by probiou at the 10 thresholds, in the
    letterboxed frame."""

    task = "obb"
    metrics_class = OBBMetrics

    @torch.inference_mode()
    def postprocess(self, preds: torch.Tensor):
        return nms_rotated(preds, conf_thres=self.args.conf, iou_thres=self.args.iou, max_det=self.args.max_det,
                           pre_topk=self.args.pre_nms_topk, nc=self.nc, multi_label=True)

    def update_metrics(self, dets: np.ndarray, n_valid: np.ndarray, batch: dict, in_shape) -> None:
        segs = batch.get("segments_list")
        for i in range(len(dets)):
            self.seen += 1
            d = dets[i, : int(n_valid[i])]  # cx cy w h angle conf cls
            gt_mask = batch["mask"][i].astype(bool)
            gt_cls = batch["cls"][i][gt_mask]
            if segs and segs[i]:
                gt_r = rboxes_from_segments(segs[i])[: len(gt_cls)]
            else:
                gt_r = rboxes_from_xyxy(batch["bboxes"][i][gt_mask])
            if len(d) and len(gt_cls):
                iou = probiou(torch.from_numpy(gt_r)[:, None], torch.from_numpy(d[:, :5])[None]).numpy()
            else:
                iou = np.zeros((len(gt_cls), len(d)))
            self.stats["tp"].append(match_predictions(d[:, 6].astype(int), gt_cls.astype(int), iou, self.iouv))
            self.stats["conf"].append(d[:, 5])
            self.stats["pred_cls"].append(d[:, 6])
            self.stats["target_cls"].append(gt_cls)


class OBBTrainer(BaseTrainer):
    """Trainer of oriented box models: the batches gain `rboxes` (B, M, 5) from their polygons, the loss is
    `v8OBBLoss`, and the EMA is validated by `OBBValidator`."""

    task = "obb"
    validator_class = OBBValidator

    def build_model(self, cfg) -> OBBModel:
        return OBBModel(cfg, nc=self.data.get("nc"))

    def get_criterion(self):
        return v8OBBLoss(self.model, box=self.args.box, cls=self.args.cls, dfl=self.args.dfl)

    def preprocess_batch(self, batch: dict) -> dict:
        """`rboxes` (B, M, 5) from each image's first M polygons, zero for an image without polygons in a batch that
        has some, as the JAX trainer; from the axis-aligned boxes at angle 0 when no image has polygons."""
        b, m = batch["cls"].shape
        rboxes = np.zeros((b, m, 5), np.float32)
        segs = batch.get("segments_list")
        if segs and any(segs):
            for i, seg_list in enumerate(segs):
                if seg_list:
                    rb = rboxes_from_segments(seg_list[:m])
                    rboxes[i, : len(rb)] = rb
        else:
            rboxes = rboxes_from_xyxy(np.asarray(batch["bboxes"], np.float32))
        return super().preprocess_batch({**batch, "rboxes": rboxes})

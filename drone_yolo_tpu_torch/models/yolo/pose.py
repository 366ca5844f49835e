"""Pose task: prediction, training and validation of keypoint models.

Counterpart of `drone_yolo_tpu/models/yolo/pose.py` (`_scale_kpts`, `PoseTrainer`,
`PosePredictor.postprocess`, `PoseValidator`). The pose model's NMS carries the decoded
keypoints as extra columns of each detection; the predictor and the validator split them
off, reshape them to (n, K, 2|3) and map them back from the letterbox to the original frame.
The trainer trains with `v8PoseLoss` (box, pose, kobj, cls, dfl) on datasets whose yaml
carries `kpt_shape` (and `flip_idx`); the validator matches detections to GT by box IoU and
by OKS (the GT box's area x 0.53, COCO's sigmas for 17 keypoints) and reports both mAPs.
COCO JSON (`save_json`) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from drone_yolo_tpu_torch.engine.predictor import DetectionPredictor
from drone_yolo_tpu_torch.engine.results import Results
from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
from drone_yolo_tpu_torch.engine.validator import BaseValidator
from drone_yolo_tpu_torch.nn.model import PoseModel
from drone_yolo_tpu_torch.ops.boxes import scale_boxes
from drone_yolo_tpu_torch.utils.loss import v8PoseLoss
from drone_yolo_tpu_torch.utils.metrics import PoseMetrics, box_iou_np, kpt_iou, kpt_sigmas, match_predictions


def scale_kpts(kpts, in_shape, ori_shape, ratio_pad=None):
    """Keypoints (..., 2|3) of a letterboxed `in_shape` image -> pixels of the `ori_shape` image (xy only); gain and
    pad from the two shapes, or from `ratio_pad` = (gain, (pad_w, pad_h)) as the dataset recorded them."""
    if ratio_pad is not None:
        gain, (pad_w, pad_h) = ratio_pad
    else:
        gain = min(in_shape[0] / ori_shape[0], in_shape[1] / ori_shape[1])
        pad_w = (in_shape[1] - ori_shape[1] * gain) / 2
        pad_h = (in_shape[0] - ori_shape[0] * gain) / 2
    out = kpts.copy()
    out[..., 0] = (out[..., 0] - pad_w) / gain
    out[..., 1] = (out[..., 1] - pad_h) / gain
    return out


class PosePredictor(DetectionPredictor):
    """Detection predictor whose Results also carry `keypoints` (the dets' columns after the class)."""

    def postprocess(self, dets, n_valid, x_shape, orig_imgs, paths):
        dets = dets.float().cpu()
        nk, nd = self.kpt_shape
        results = []
        for i, (im0, path) in enumerate(zip(orig_imgs, paths)):
            n = int(n_valid[i])
            d = dets[i, :n].clone()
            kpts = None
            if n:
                kpts = scale_kpts(d[:, 6:].numpy().reshape(n, nk, nd), x_shape, im0.shape[:2])
                d[:, :4] = scale_boxes(x_shape, d[:, :4], im0.shape[:2])
            results.append(Results(im0, path, self.names, boxes=d[:, :6].numpy(), keypoints=kpts))
        return results


class PoseValidator(BaseValidator):
    """Box and keypoint mAP: detections match GT by box IoU (`tp`) and by OKS (`tp_p`) at the 10 thresholds; the
    metrics are `PoseMetrics`' 8 means, fitness the sum of the box and pose fitness."""

    task = "pose"
    metrics_class = PoseMetrics
    stat_keys = ("tp", "tp_p", "conf", "pred_cls", "target_cls")
    print_cols = ("P", "R", "mAP50", "mAP50-95", "P(P)", "R(P)", "mAP50(P)", "mAP50-95(P)")

    def update_metrics(self, dets: np.ndarray, n_valid: np.ndarray, batch: dict, in_shape) -> None:
        """Per image: boxes and keypoints of the detections and the GT back to the original frame, TP by box IoU and
        by OKS, accumulated."""
        nk, nd = self.kpt_shape
        sigmas = kpt_sigmas(nk)
        for i in range(len(dets)):
            self.seen += 1
            n = int(n_valid[i])
            d = dets[i, :n].copy()
            gt_mask = batch["mask"][i].astype(bool)
            gt_native = batch["bboxes"][i][gt_mask]  # letterboxed pixel xyxy
            gt_cls = batch["cls"][i][gt_mask]
            gk = batch["keypoints"][i][gt_mask] if "keypoints" in batch else np.zeros((0, nk, 3), np.float32)
            ori_shape = batch["ori_shapes"][i]
            rp = batch["ratio_pads"][i]
            ratio_pad = ((rp[0], rp[0]), rp[1]) if rp else None
            pk = d[:, 6:].reshape(n, nk, nd) if n else np.zeros((0, nk, nd), np.float32)
            if n:
                pk = scale_kpts(pk, in_shape, ori_shape, rp)
                d[:, :4] = scale_boxes(in_shape, torch.from_numpy(d[:, :4]), ori_shape, ratio_pad).numpy()
            if len(gt_native):
                gt_native = scale_boxes(in_shape, torch.from_numpy(gt_native.copy()), ori_shape, ratio_pad).numpy()
                gk = scale_kpts(gk, in_shape, ori_shape, rp)
            iou = box_iou_np(gt_native, d[:, :4]) if n and len(gt_native) else np.zeros((len(gt_native), n))
            tp = match_predictions(d[:, 5].astype(int), gt_cls.astype(int), iou, self.iouv)
            if n and len(gt_native):
                area = (gt_native[:, 2] - gt_native[:, 0]) * (gt_native[:, 3] - gt_native[:, 1]) * 0.53
                tp_p = match_predictions(d[:, 5].astype(int), gt_cls.astype(int), kpt_iou(gk, pk, area, sigmas),
                                         self.iouv)
            else:
                tp_p = np.zeros((n, len(self.iouv)), bool)
            self.stats["tp"].append(tp)
            self.stats["tp_p"].append(tp_p)
            self.stats["conf"].append(d[:, 4])
            self.stats["pred_cls"].append(d[:, 5])
            self.stats["target_cls"].append(gt_cls)


class PoseTrainer(BaseTrainer):
    """Trainer of pose models: the data's `kpt_shape` sizes the head, the loss is `v8PoseLoss` with the `pose` and
    `kobj` gains, and the EMA is validated by `PoseValidator`."""

    task = "pose"
    loss_names = ("box_loss", "pose_loss", "kobj_loss", "cls_loss", "dfl_loss")
    validator_class = PoseValidator

    def build_model(self, cfg) -> PoseModel:
        return PoseModel(cfg, nc=self.data.get("nc"), data_kpt_shape=tuple(self.data.get("kpt_shape") or (None, None)))

    def fits_data(self, model) -> bool:
        """The class count and the keypoint shape."""
        kpt = self.data.get("kpt_shape")
        return super().fits_data(model) and (not kpt or tuple(kpt) == tuple(model.head.kpt_shape))

    def get_criterion(self):
        return v8PoseLoss(self.model, pose_gain=self.args.pose, kobj_gain=self.args.kobj, box=self.args.box,
                          cls=self.args.cls, dfl=self.args.dfl)

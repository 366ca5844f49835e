"""Segment task: prediction, training and validation of instance segmentation models.

Counterpart of `drone_yolo_tpu/models/yolo/segment.py` (`SegmentationTrainer`, `SegmentationPredictor`,
`SegmentationValidator`). The segment model's NMS carries each detection's 32 mask coefficients as extra columns;
the masks are assembled on the card (`ops/masks.py`): `sigmoid(coefficients @ prototypes)` cropped to the box at
prototype resolution, then for prediction mapped back from the letterbox to the original frame by a bilinear resize
(`cv2.resize`'s) and thresholded at 0.5, and for validation thresholded at 0.5 and matched to the GT instances of the
collated overlap index mask by mask IoU. Boxes are matched in the original frame, as for detection; the metrics are
`SegmentMetrics`' 8 means. The trainer trains with `v8SegmentationLoss` (box, seg, cls, dfl). `retina_masks` is
accepted and, as in the JAX predictor, changes nothing. COCO JSON (`save_json`) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from drone_yolo_tpu_torch.engine.predictor import DetectionPredictor
from drone_yolo_tpu_torch.engine.results import Results
from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
from drone_yolo_tpu_torch.engine.validator import BaseValidator
from drone_yolo_tpu_torch.nn.model import SegmentationModel
from drone_yolo_tpu_torch.ops.boxes import scale_boxes
from drone_yolo_tpu_torch.ops.letterbox import resize_nearest
from drone_yolo_tpu_torch.ops.masks import mask_iou, process_mask, scale_masks
from drone_yolo_tpu_torch.ops.nms import non_max_suppression
from drone_yolo_tpu_torch.utils.loss import v8SegmentationLoss
from drone_yolo_tpu_torch.utils.metrics import SegmentMetrics, box_iou_np, match_predictions


class SegmentationPredictor(DetectionPredictor):
    """Detection predictor whose Results also carry `masks` (N, h0, w0) bool in the original frame."""

    @torch.inference_mode()
    def inference(self, x: torch.Tensor):
        """Forward, decode and NMS over the top min(pre_nms_topk, 1024) candidates, the coefficients riding as extra
        columns -> ((dets (B, max_det, 6 + nm), protos (B, nm, Hm, Wm)), n_valid (B,)), on the device."""
        preds, aux = self.net(x)
        protos = aux[-1]  # the model's (maps, coefficients, protos), an artifact's (protos,)
        dets, n_valid = non_max_suppression(
            preds, conf_thres=self.args.conf, iou_thres=self.args.iou, max_det=self.args.max_det,
            pre_topk=min(self.args.pre_nms_topk, 1024), classes=self.args.classes, agnostic=self.args.agnostic_nms,
            nc=self.nc)
        return (dets, protos), n_valid

    def postprocess(self, out, n_valid, x_shape, orig_imgs, paths):
        """Per image: the masks of its detections on the device (`process_mask`, `scale_masks` to the frame, > 0.5),
        then masks and boxes (rescaled to the frame) to the host."""
        dets, protos = out
        results = []
        for i, (im0, path) in enumerate(zip(orig_imgs, paths)):
            d = dets[i, : int(n_valid[i])].float()
            masks = None
            if len(d):
                m = process_mask(protos[i], d[:, 6:], d[:, :4], x_shape)
                masks = (scale_masks(m, im0.shape[:2], x_shape) > 0.5).cpu().numpy()
            d = d[:, :6].cpu().clone()
            if len(d):
                d[:, :4] = scale_boxes(x_shape, d[:, :4], im0.shape[:2])
            results.append(Results(im0, path, self.names, boxes=d.numpy(), masks=masks))
        return results


class SegmentationValidator(BaseValidator):
    """Box and mask mAP: detections match GT by box IoU in the original frame (`tp`) and by mask IoU at prototype
    resolution (`tp_m`) at the 10 thresholds; the metrics are `SegmentMetrics`' 8 means, fitness the sum of the box
    and mask fitness."""

    task = "segment"
    metrics_class = SegmentMetrics
    stat_keys = ("tp", "tp_m", "conf", "pred_cls", "target_cls")
    print_cols = ("P", "R", "mAP50", "mAP50-95", "P(M)", "R(M)", "mAP50(M)", "mAP50-95(M)")

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Decoded predictions (B, A, 4 + nc + nm); the batch's prototypes stay on the device in `protos` for
        `update_metrics`."""
        preds, aux = self.net(x)
        self.protos = aux[-1]  # the model's (maps, coefficients, protos), an artifact's (protos,)
        return preds

    def update_metrics(self, dets: np.ndarray, n_valid: np.ndarray, batch: dict, in_shape) -> None:
        """Per image: mask TP against the GT index mask (resized nearest when its shape is not the prototypes'), then
        detections and GT boxes back to the original frame and box TP, accumulated."""
        om = batch.get("masks")
        for i in range(len(dets)):
            self.seen += 1
            n = int(n_valid[i])
            d = dets[i, :n].copy()
            gt_mask = batch["mask"][i].astype(bool)
            gt_native = batch["bboxes"][i][gt_mask]  # letterboxed pixel xyxy
            gt_cls = batch["cls"][i][gt_mask]
            ori_shape = batch["ori_shapes"][i]
            rp = batch["ratio_pads"][i]
            ratio_pad = ((rp[0], rp[0]), rp[1]) if rp else None
            n_gt = len(gt_cls)
            tp_m = np.zeros((n, len(self.iouv)), bool)
            if n and n_gt and om is not None:
                dd = torch.from_numpy(d).to(self.device)
                pm = process_mask(self.protos[i], dd[:, 6:], dd[:, :4], in_shape) > 0.5
                omi = torch.from_numpy(np.asarray(om[i])).to(self.device)
                if omi.shape != pm.shape[1:]:
                    omi = resize_nearest(omi, pm.shape[1:])
                gm = omi[None] == torch.arange(1, n_gt + 1, device=self.device)[:, None, None]
                tp_m = match_predictions(d[:, 5].astype(int), gt_cls.astype(int), mask_iou(gm, pm).cpu().numpy(),
                                         self.iouv)
            if n:
                d[:, :4] = scale_boxes(in_shape, torch.from_numpy(d[:, :4]), ori_shape, ratio_pad).numpy()
            if n_gt:
                gt_native = scale_boxes(in_shape, torch.from_numpy(gt_native.copy()), ori_shape, ratio_pad).numpy()
            iou = box_iou_np(gt_native, d[:, :4]) if n and n_gt else np.zeros((n_gt, n))
            self.stats["tp"].append(match_predictions(d[:, 5].astype(int), gt_cls.astype(int), iou, self.iouv))
            self.stats["tp_m"].append(tp_m)
            self.stats["conf"].append(d[:, 4])
            self.stats["pred_cls"].append(d[:, 5])
            self.stats["target_cls"].append(gt_cls)


class SegmentationTrainer(BaseTrainer):
    """Trainer of segmentation models: the loss is `v8SegmentationLoss` (its mask loss at the box gain), the batches
    carry the overlap index masks at `mask_ratio`, and the EMA is validated by `SegmentationValidator`."""

    task = "segment"
    loss_names = ("box_loss", "seg_loss", "cls_loss", "dfl_loss")
    validator_class = SegmentationValidator

    def build_model(self, cfg) -> SegmentationModel:
        return SegmentationModel(cfg, nc=self.data.get("nc"))

    def get_criterion(self):
        return v8SegmentationLoss(self.model, box=self.args.box, cls=self.args.cls, dfl=self.args.dfl)

"""Pose prediction: detections with keypoints.

Counterpart of `drone_yolo_tpu/models/yolo/pose.py` (`_scale_kpts`,
`PosePredictor.postprocess`). The pose model's NMS carries the decoded keypoints
as extra columns of each detection; postprocess splits them off, reshapes them to
(n, K, 2|3) and maps them back from the letterbox to the original frame. Pose
validation and training (`PoseValidator`, `v8PoseLoss`) are not ported yet.
"""

from __future__ import annotations

from drone_yolo_tpu_torch.engine.predictor import DetectionPredictor
from drone_yolo_tpu_torch.engine.results import Results
from drone_yolo_tpu_torch.ops.boxes import scale_boxes


def scale_kpts(kpts, in_shape, ori_shape):
    """Keypoints (..., 2|3) of a letterboxed `in_shape` image -> pixels of the `ori_shape` image (xy only)."""
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
        nk, nd = self.model.head.kpt_shape
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

"""Association costs and linear assignment for ByteTrack, on the host.

Counterpart of `drone_yolo_tpu/trackers/matching.py` (`linear_assignment` by
`scipy.optimize.linear_sum_assignment`, `iou_distance` over `box_iou_np`,
`fuse_score`). BoT-SORT's `embedding_distance` is not ported yet.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

from drone_yolo_tpu_torch.utils.metrics import box_iou_np


def linear_assignment(cost_matrix: np.ndarray, thresh: float):
    """Hungarian assignment with cost gate. Returns (matches, unmatched_a, unmatched_b)."""
    if cost_matrix.size == 0:
        return (
            np.empty((0, 2), dtype=int),
            tuple(range(cost_matrix.shape[0])),
            tuple(range(cost_matrix.shape[1])),
        )
    row, col = linear_sum_assignment(cost_matrix)
    matches = [(r, c) for r, c in zip(row, col) if cost_matrix[r, c] <= thresh]
    matched_a = {m[0] for m in matches}
    matched_b = {m[1] for m in matches}
    unmatched_a = tuple(i for i in range(cost_matrix.shape[0]) if i not in matched_a)
    unmatched_b = tuple(j for j in range(cost_matrix.shape[1]) if j not in matched_b)
    return np.asarray(matches, dtype=int).reshape(-1, 2), unmatched_a, unmatched_b


def iou_distance(atracks, btracks) -> np.ndarray:
    """1 - IoU between two track/box lists (xyxy)."""
    if atracks and hasattr(atracks[0], "xyxy"):
        aboxes = np.asarray([t.xyxy for t in atracks], np.float32)
    else:
        aboxes = np.asarray(atracks, np.float32).reshape(-1, 4)
    if btracks and hasattr(btracks[0], "xyxy"):
        bboxes = np.asarray([t.xyxy for t in btracks], np.float32)
    else:
        bboxes = np.asarray(btracks, np.float32).reshape(-1, 4)
    if len(aboxes) == 0 or len(bboxes) == 0:
        return np.ones((len(aboxes), len(bboxes)), np.float32)
    return 1.0 - box_iou_np(aboxes, bboxes)


def fuse_score(cost_matrix: np.ndarray, detections) -> np.ndarray:
    """Fuse detection confidences into the IoU cost (reference matching.py:127)."""
    if cost_matrix.size == 0:
        return cost_matrix
    iou_sim = 1.0 - cost_matrix
    det_scores = np.asarray([d.score for d in detections], np.float32)
    fused = iou_sim * det_scores[None, :]
    return 1.0 - fused

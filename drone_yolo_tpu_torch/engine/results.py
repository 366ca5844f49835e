"""Inference results: `Results` per image with its `Boxes`, numpy-backed.

Counterpart of `drone_yolo_tpu/engine/results.py` (Boxes, Results) for
detection: xyxy, conf, cls and xywh. Plotting and saving need an image library
and come with a later slice.
"""

from __future__ import annotations

import numpy as np


class Boxes:
    """Detections (N, 6): x1, y1, x2, y2, conf, cls in the original image's pixels."""

    def __init__(self, boxes, orig_shape):
        boxes = np.asarray(boxes)
        if boxes.ndim == 1:
            boxes = boxes[None, :]
        if boxes.shape[-1] != 6:
            raise ValueError(f"expected 6 columns, got shape {boxes.shape}")
        self.data = boxes
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, 4]

    @property
    def cls(self):
        return self.data[:, 5]

    @property
    def xywh(self):
        x1, y1, x2, y2 = self.data[:, :4].T
        return np.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)


class Results:
    """Result of one image: the original frame, its path, the class names, boxes and timings."""

    def __init__(self, orig_img, path, names, boxes=None, speed=None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.names = names
        self.path = path
        self.speed = speed or {"preprocess": None, "inference": None, "postprocess": None}

    def __len__(self):
        return len(self.boxes) if self.boxes is not None else 0

    def verbose(self) -> str:
        """'2 class0, 1 class3, ' style summary."""
        if self.boxes is None or not len(self.boxes):
            return "(no detections), "
        counts = np.bincount(self.boxes.cls.astype(int))
        return "".join(f"{n} {self.names.get(c, c)}, " for c, n in enumerate(counts) if n)

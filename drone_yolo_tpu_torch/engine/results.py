"""Inference results: `Results` per image with its `Boxes` and `Keypoints`, numpy-backed.

Counterpart of `drone_yolo_tpu/engine/results.py` (Boxes, Keypoints, Results) for
detection, tracking and pose: boxes of 6 columns (xyxy, conf, cls) or, from a
tracker, 7 (xyxy, track id, conf, cls); keypoints (N, K, 2 or 3). Plotting and
saving need an image library and come with a later slice.
"""

from __future__ import annotations

import numpy as np


class Boxes:
    """Detections (N, 6) x1, y1, x2, y2, conf, cls, or tracks (N, 7) x1, y1, x2, y2, id, conf, cls, in the original
    image's pixels."""

    def __init__(self, boxes, orig_shape):
        boxes = np.asarray(boxes)
        if boxes.ndim == 1:
            boxes = boxes[None, :]
        if boxes.shape[-1] not in (6, 7):
            raise ValueError(f"expected 6 or 7 columns, got shape {boxes.shape}")
        self.data = boxes
        self.orig_shape = orig_shape
        self.is_track = boxes.shape[-1] == 7

    def __len__(self):
        return len(self.data)

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

    @property
    def id(self):
        """Track ids, or None for detections."""
        return self.data[:, -3] if self.is_track else None

    @property
    def xywh(self):
        x1, y1, x2, y2 = self.data[:, :4].T
        return np.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)


class Keypoints:
    """Keypoints (N, K, 2 or 3): x, y in the original image's pixels, then the visibility score if there is one."""

    def __init__(self, keypoints, orig_shape):
        keypoints = np.asarray(keypoints)
        if keypoints.ndim == 2:  # one instance (K, 2|3): keep the instance dimension
            keypoints = keypoints[None, :]
        self.data = keypoints
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xy(self):
        return self.data[..., :2]

    @property
    def xyn(self):
        """xy over the original image's width and height."""
        d = self.data[..., :2].copy()
        d[..., 0] /= self.orig_shape[1]
        d[..., 1] /= self.orig_shape[0]
        return d

    @property
    def conf(self):
        return self.data[..., 2] if self.data.shape[-1] == 3 else None


class Results:
    """Result of one image: the original frame, its path, the class names, boxes, keypoints and timings."""

    def __init__(self, orig_img, path, names, boxes=None, keypoints=None, speed=None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.keypoints = Keypoints(keypoints, self.orig_shape) if keypoints is not None else None
        self.names = names
        self.path = path
        self.speed = speed or {"preprocess": None, "inference": None, "postprocess": None}

    def __len__(self):
        for v in (self.boxes, self.keypoints):
            if v is not None:
                return len(v)
        return 0

    def update(self, boxes=None, keypoints=None) -> None:
        """Replace the boxes (6 or 7 columns) and/or the keypoints; what is None stays."""
        if boxes is not None:
            self.boxes = Boxes(boxes, self.orig_shape)
        if keypoints is not None:
            self.keypoints = Keypoints(keypoints, self.orig_shape)

    def verbose(self) -> str:
        """'2 class0, 1 class3, ' style summary."""
        if self.boxes is None or not len(self.boxes):
            return "(no detections), "
        counts = np.bincount(self.boxes.cls.astype(int))
        return "".join(f"{n} {self.names.get(c, c)}, " for c, n in enumerate(counts) if n)

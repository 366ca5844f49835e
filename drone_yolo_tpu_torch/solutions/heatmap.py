"""Cumulative presence heatmap (counterpart of `drone_yolo_tpu/solutions/heatmap.py`)."""

from __future__ import annotations

import numpy as np

from drone_yolo_tpu_torch.ops.draw import COLORMAP_PARULA, add_weighted, apply_color_map
from drone_yolo_tpu_torch.solutions.solutions import BaseSolution


class Heatmap(BaseSolution):
    """Adds a Gaussian bump over each track's box to a float32 map of the frame's size each frame, scales the map to
    0..255, colours it (`colormap`, PARULA by default) and blends it half and half into the frame. A tracker's box
    may reach past the frame's edges (its Kalman state is not clipped)."""

    def __init__(self, colormap=None, **kwargs):
        super().__init__(**kwargs)
        self.heat = None
        self.colormap = colormap

    def process(self, im0):
        if self.heat is None:
            self.heat = np.zeros(im0.shape[:2], np.float32)
        self.extract_tracks(im0)
        for box in self.boxes:
            x1, y1, x2, y2 = (int(v) for v in box)
            h, w = max(y2 - y1, 1), max(x2 - x1, 1)
            yy, xx = np.mgrid[0:h, 0:w]
            cy, cx = h / 2, w / 2
            bump = np.exp(-(((yy - cy) / (h / 2 + 1e-6)) ** 2 + ((xx - cx) / (w / 2 + 1e-6)) ** 2))
            # a box past the top or left edge keeps its full bump from the edge on, as the JAX package slices it; past
            # the bottom or right edge the bump is cut at the edge (the JAX package raises there: its slice of the
            # map is smaller than the bump)
            y1c, x1c = max(y1, 0), max(x1, 0)
            region = self.heat[y1c:y1c + h, x1c:x1c + w]
            region += bump[:region.shape[0], :region.shape[1]].astype(np.float32)
        norm = (self.heat / (self.heat.max() + 1e-9) * 255).astype(np.uint8)
        colored = apply_color_map(norm, self.colormap if self.colormap is not None else COLORMAP_PARULA)
        return {"im0": add_weighted(im0, 0.5, colored, 0.5, 0), "heatmap": self.heat}

"""Live object counts per region (counterpart of `drone_yolo_tpu/solutions/region_counter.py`)."""

from __future__ import annotations

import numpy as np

from drone_yolo_tpu_torch.solutions.solutions import BaseSolution


class RegionCounter(BaseSolution):
    """Counts the tracks whose centre lies in each of `regions` ({name: [(x, y), ...]}; a dict passed as `region`
    serves too), every frame afresh."""

    def __init__(self, regions=None, **kwargs):
        super().__init__(**kwargs)
        if regions is None and isinstance(self.region, dict):
            regions = self.region
        if isinstance(self.region, dict):
            self.region = None  # annotate() draws one polygon only
        self.regions = regions or ({"region-1": self.region} if self.region else {})
        self.region_counts = {k: 0 for k in self.regions}

    def process(self, im0):
        self.extract_tracks(im0)
        self.region_counts = {k: 0 for k in self.regions}
        for box in self.boxes:
            c = ((box[0] + box[2]) / 2, (box[1] + box[3]) / 2)
            for name, poly in self.regions.items():
                if self.point_in_region(c, poly):
                    self.region_counts[name] += 1
        self.annotate(im0.copy())
        for name, poly in self.regions.items():
            p = np.asarray(poly, np.float32)
            self._ann.draw_region(poly, color=(104, 0, 123), thickness=self.line_width * 2)
            self._ann.display_objects_labels(self._ann.im, f"{name}: {self.region_counts[name]}", (255, 255, 255),
                                             (104, 0, 123), float(p[:, 0].mean()), float(p[:, 1].mean()))
        return {"im0": self._ann.result(), "region_counts": dict(self.region_counts)}

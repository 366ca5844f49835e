"""Speed of each track (counterpart of `drone_yolo_tpu/solutions/speed_estimation.py`): the displacement of its last
two centres, times metres per pixel (for drone footage the ground sample distance, `apps/geo.py`) and the frame rate,
in km/h."""

from __future__ import annotations

import numpy as np

from drone_yolo_tpu_torch.solutions.solutions import BaseSolution


class SpeedEstimator(BaseSolution):
    def __init__(self, meters_per_pixel: float = 0.05, fps: float = 30.0, **kwargs):
        super().__init__(**kwargs)
        self.mpp = meters_per_pixel
        self.fps = fps
        self.speeds = {}  # track id -> km/h

    def process(self, im0):
        self.extract_tracks(im0)
        for box, tid in zip(self.boxes, self.track_ids):
            self.store_tracking_history(tid, box)
            trace = self.track_history[tid]
            if len(trace) >= 2:
                (x0, y0), (x1, y1) = trace[-2], trace[-1]
                self.speeds[tid] = float(np.hypot(x1 - x0, y1 - y0)) * self.mpp * self.fps * 3.6

        def label(tid, c):
            s = self.speeds.get(tid)
            return f"#{tid} {s:.1f} km/h" if s is not None else f"#{tid}"

        return {"im0": self.annotate(im0.copy(), label_fn=label), "speeds": dict(self.speeds)}

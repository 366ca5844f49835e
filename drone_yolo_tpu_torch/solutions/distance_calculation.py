"""Distance between two tracks (counterpart of `drone_yolo_tpu/solutions/distance_calculation.py`)."""

from __future__ import annotations

import numpy as np

from drone_yolo_tpu_torch.solutions.solutions import BaseSolution

# OpenCV's mouse event codes, which `mouse_event_for_distance` takes
EVENT_LBUTTONDOWN, EVENT_RBUTTONDOWN = 1, 2


class DistanceCalculation(BaseSolution):
    """The distance in metres between the centres of two tracks: the last two picked by `mouse_event_for_distance`,
    else `pair` (two track ids), else the frame's first two tracks."""

    def __init__(self, meters_per_pixel: float = 0.05, pair=None, **kwargs):
        super().__init__(**kwargs)
        self.mpp = meters_per_pixel
        self.pair = pair
        self.selected_ids: list[int] = []

    def mouse_event_for_distance(self, event, x, y, flags=0, param=None):
        """A mouse callback of OpenCV's signature: a left click inside a track's box picks it (the last two picks are
        kept), a right click clears the picks."""
        if event == EVENT_LBUTTONDOWN:
            for tid, b in zip(self.track_ids, self.boxes):
                if b[0] <= x <= b[2] and b[1] <= y <= b[3] and tid not in self.selected_ids:
                    self.selected_ids.append(int(tid))
                    self.selected_ids = self.selected_ids[-2:]
                    break
        elif event == EVENT_RBUTTONDOWN:
            self.selected_ids = []

    def attach_window(self, window_name: str = "drone-yolo distance") -> bool:
        """False: the port opens no window. Wiring the callback to a window needs OpenCV's HighGUI, which the port does
        not use; the JAX package returns False the same way where HighGUI has no display. Call
        `mouse_event_for_distance` from the UI that shows the frames."""
        return False

    def process(self, im0):
        self.extract_tracks(im0)
        dist_m = None
        centers = {tid: ((b[0] + b[2]) / 2, (b[1] + b[3]) / 2) for tid, b in zip(self.track_ids, self.boxes)}
        if len(self.selected_ids) == 2:
            ids = list(self.selected_ids)
        else:
            ids = list(self.pair) if self.pair else self.track_ids[:2]
        if len(ids) == 2 and all(i in centers for i in ids):
            (x0, y0), (x1, y1) = centers[ids[0]], centers[ids[1]]
            dist_m = float(np.hypot(x1 - x0, y1 - y0)) * self.mpp
        plotted = self.annotate(im0.copy())
        if dist_m is not None:
            self._ann.plot_distance_and_line(dist_m / self.mpp, (centers[ids[0]], centers[ids[1]]))
            plotted = self._ann.result()
        return {"im0": plotted, "distance_m": dist_m, "pair": ids if dist_m is not None else None}

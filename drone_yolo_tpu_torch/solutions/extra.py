"""Workout counting, parking occupancy, a security alarm, tracking inside a zone, a mask overlay and per-frame class
counts (counterpart of `drone_yolo_tpu/solutions/extra.py`)."""

from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np

from drone_yolo_tpu_torch.ops.polygon import fill_poly
from drone_yolo_tpu_torch.solutions.solutions import BaseSolution
from drone_yolo_tpu_torch.utils.plotting import Annotator

LOGGER = logging.getLogger("drone_yolo_tpu_torch")


class AIGym(BaseSolution):
    """Counts repetitions from the angle at keypoint kpts[1] of each detected person of a pose model: a rep when the
    angle rises above `up_angle` after it fell below `down_angle`. Counts and stages are keyed by the detection's
    index in the frame, not by a track, as in the JAX package."""

    def __init__(self, kpts=(6, 8, 10), up_angle: float = 145.0, down_angle: float = 90.0, **kwargs):
        kwargs.setdefault("model", "yolov8n-pose.yaml")
        super().__init__(**kwargs)
        self.kpts = list(kpts)
        self.up_angle = up_angle
        self.down_angle = down_angle
        self.count = defaultdict(int)
        self.stage = defaultdict(lambda: "-")

    @staticmethod
    def joint_angle(a, b, c):
        """The angle ABC in degrees from three (x, y) points."""
        a, b, c = (np.asarray(p, np.float64) for p in (a, b, c))
        v1, v2 = a - b, c - b
        cos = (v1 @ v2) / (np.linalg.norm(v1) * np.linalg.norm(v2) + 1e-9)
        return float(np.degrees(np.arccos(np.clip(cos, -1, 1))))

    def process(self, im0):
        r = self.model.predict(source=[im0], conf=self.conf, verbose=False)[0]
        ann = Annotator(im0.copy(), line_width=self.line_width)
        if r.keypoints is not None:
            for i, k in enumerate(r.keypoints.xy):
                if max(self.kpts) < len(k):
                    ang = self.joint_angle(k[self.kpts[0]], k[self.kpts[1]], k[self.kpts[2]])
                    if ang > self.up_angle and self.stage[i] == "down":
                        self.count[i] += 1
                        self.stage[i] = "up"
                    elif ang < self.down_angle:
                        self.stage[i] = "down"
                    ann.kpts(np.asarray(k), shape=im0.shape[:2])
                    ann.plot_angle_and_count_and_stage(f"{ang:.1f}", self.count[i], self.stage[i], k[self.kpts[1]])
        return {"im0": ann.result(), "counts": dict(self.count), "stages": dict(self.stage)}


class ParkingManagement(BaseSolution):
    """Occupancy of parking slots (polygons): a slot is taken when a track's centre lies in it."""

    def __init__(self, parking_regions=None, **kwargs):
        super().__init__(**kwargs)
        self.parking_regions = parking_regions or []
        self.occupied = 0
        self.available = 0

    def process(self, im0):
        self.extract_tracks(im0)
        centers = [((b[0] + b[2]) / 2, (b[1] + b[3]) / 2) for b in self.boxes]
        slot_states = [any(self.point_in_region(c, poly) for c in centers) for poly in self.parking_regions]
        self.occupied = sum(slot_states)
        self.available = len(self.parking_regions) - self.occupied
        self.annotate(im0.copy())
        for poly, taken in zip(self.parking_regions, slot_states):  # red taken, green free
            self._ann.draw_region(poly, color=(0, 0, 255) if taken else (0, 255, 0), thickness=self.line_width)
        self._ann.display_analytics(self._ann.im, {"Occupancy": self.occupied, "Available": self.available})
        return {"im0": self._ann.result(), "occupied": self.occupied, "available": self.available}


class SecurityAlarm(BaseSolution):
    """Calls `on_alarm(n)` once, at the first frame with more than `records` tracks."""

    def __init__(self, records: int = 5, on_alarm=None, **kwargs):
        super().__init__(**kwargs)
        self.records = records
        self.on_alarm = on_alarm or (lambda n: LOGGER.warning(f"ALARM: {n} objects detected"))
        self.triggered = False

    def process(self, im0):
        self.extract_tracks(im0)
        n = len(self.boxes)
        if n > self.records and not self.triggered:
            self.triggered = True
            self.on_alarm(n)
        plotted = self.annotate(im0.copy())
        self._ann.display_analytics(plotted, {"Objects": n, "Alarm": "FIRED" if self.triggered else "armed"},
                                    bg_color=(0, 0, 180) if self.triggered else (104, 31, 17))
        return {"im0": self._ann.result(), "n": n, "triggered": self.triggered}


class TrackZone(BaseSolution):
    """Tracks only inside a polygon zone: the frame outside it is blacked out before tracking and dimmed in the
    drawing."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if self.region is None:
            self.region = [(100, 100), (500, 100), (500, 400), (100, 400)]

    def process(self, im0):
        mask = fill_poly(np.zeros(im0.shape[:2], np.uint8), [np.asarray(self.region, np.int32)], 255)
        inside = mask[..., None].astype(bool)
        self.extract_tracks(np.where(inside, im0, 0).astype(im0.dtype))
        base = np.where(inside, im0, (im0 * 0.35).astype(im0.dtype))
        return {"im0": self.annotate(base.copy()), "n_tracks": len(self.track_ids)}


class InstanceSegmentation(BaseSolution):
    """The masks of a segment model drawn over each frame (`Results.plot`)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("model", "yolov8n-seg.yaml")
        super().__init__(**kwargs)

    def process(self, im0):
        r = self.model.predict(source=[im0], conf=self.conf, verbose=False)[0]
        return {"im0": r.plot(), "n": 0 if r.boxes is None else len(r.boxes)}


class Analytics(BaseSolution):
    """The count of tracks by class name each frame, kept in `series` for line or bar charts."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.series = []

    def process(self, im0):
        self.extract_tracks(im0)
        counts = defaultdict(int)
        for c in self.clss:
            counts[self.names.get(c, str(c))] += 1
        self.series.append(dict(counts))
        return {"im0": self.annotate(im0.copy()), "counts": dict(counts), "series": self.series}

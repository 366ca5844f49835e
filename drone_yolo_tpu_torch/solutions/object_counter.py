"""Counting across a line or in and out of a region (counterpart of `drone_yolo_tpu/solutions/object_counter.py`)."""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from drone_yolo_tpu_torch.solutions.solutions import BaseSolution


class ObjectCounter(BaseSolution):
    """A track is counted once: across a 2-point line when the sign of the cross product of its last two centres
    flips (IN when it turns positive), or when its centre enters (IN) or leaves (OUT) a polygon; also per class."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.in_count = 0
        self.out_count = 0
        self.counted_ids = set()
        self.classwise_counts = defaultdict(lambda: {"IN": 0, "OUT": 0})
        if self.region is None:
            self.region = [(20, 200), (620, 200)]  # the default counting line

    def count_objects(self, current_centroid, track_id, prev_position, cls):
        if prev_position is None or track_id in self.counted_ids:
            return
        if len(self.region) == 2:
            (x1, y1), (x2, y2) = self.region

            def side(p):
                return np.sign((x2 - x1) * (p[1] - y1) - (y2 - y1) * (p[0] - x1))

            s_prev, s_now = side(prev_position), side(current_centroid)
            if s_prev != 0 and s_now != 0 and s_prev != s_now:
                self._count("IN" if s_now > 0 else "OUT", cls)
                self.counted_ids.add(track_id)
        else:
            was_in = self.point_in_region(prev_position)
            is_in = self.point_in_region(current_centroid)
            if was_in != is_in:
                self._count("IN" if is_in else "OUT", cls)
                self.counted_ids.add(track_id)

    def _count(self, direction, cls):
        if direction == "IN":
            self.in_count += 1
        else:
            self.out_count += 1
        self.classwise_counts[self.names.get(cls, str(cls))][direction] += 1

    def process(self, im0):
        self.extract_tracks(im0)
        for box, tid, cls in zip(self.boxes, self.track_ids, self.clss):
            self.store_tracking_history(tid, box)
            current = ((box[0] + box[2]) / 2, (box[1] + box[3]) / 2)
            prev = self.track_history[tid][-2] if len(self.track_history[tid]) > 1 else None
            self.count_objects(current, tid, prev, cls)
        plotted = self.annotate(im0.copy())
        text = {k: f"IN {v['IN']} OUT {v['OUT']}" for k, v in self.classwise_counts.items() if v["IN"] or v["OUT"]}
        if text:
            self._ann.display_analytics(plotted, text)
            plotted = self._ann.result()
        return {"im0": plotted, "in_count": self.in_count, "out_count": self.out_count,
                "classwise": dict(self.classwise_counts)}

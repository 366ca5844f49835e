"""Queue length inside a region (counterpart of `drone_yolo_tpu/solutions/queue_management.py`)."""

from __future__ import annotations

from drone_yolo_tpu_torch.solutions.solutions import BaseSolution


class QueueManager(BaseSolution):
    """Counts the tracks seen at least twice whose centre lies in the region."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if self.region is None:
            self.region = [(20, 60), (300, 60), (300, 360), (20, 360)]
        self.queue_count = 0

    def process(self, im0):
        self.extract_tracks(im0)
        self.queue_count = 0
        for box, tid in zip(self.boxes, self.track_ids):
            self.store_tracking_history(tid, box)
            c = ((box[0] + box[2]) / 2, (box[1] + box[3]) / 2)
            if len(self.track_history[tid]) > 1 and self.point_in_region(c):
                self.queue_count += 1
        self.annotate(im0.copy())
        self._ann.queue_counts_display(f"Queue Counts : {self.queue_count}", points=self.region)
        return {"im0": self._ann.result(), "queue_count": self.queue_count}

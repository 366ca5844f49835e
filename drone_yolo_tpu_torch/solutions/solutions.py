"""`BaseSolution`: the detect + track scaffolding of the analytics apps (counterpart of
`drone_yolo_tpu/solutions/solutions.py`)."""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from drone_yolo_tpu_torch.utils.plotting import Annotator, colors


class BaseSolution:
    """Tracks frames with `model` (a facade, or a model yaml or checkpoint built with `YOLO(model, device=device)`: the
    CUDA card unless `device="cpu"`) and exposes each frame's boxes, track ids, classes and confidences."""

    def __init__(self, model="yolov8n.yaml", region=None, classes=None, show: bool = False, line_width=2,
                 conf: float = 0.25, device=None, **kwargs):
        from drone_yolo_tpu_torch.engine.model import YOLO

        self.model = model if hasattr(model, "track") else YOLO(model, device=device)
        self.region = region  # a list of (x, y) points: a line (2 points) or a polygon
        self.classes = classes
        self.show = show
        self.line_width = line_width
        self.conf = conf
        self.names = self.model.names
        self.track_history = defaultdict(list)
        self.boxes = np.zeros((0, 4))
        self.track_ids = []
        self.clss = []
        self.confs = []
        self.kwargs = kwargs

    def extract_tracks(self, im0):
        """Track one frame (the tracker persists from frame to frame) and keep its tracks; returns its Results."""
        r = self.model.track(source=[im0], persist=True, conf=self.conf, classes=self.classes, verbose=False)[0]
        if r.boxes is not None and len(r.boxes) and r.boxes.id is not None:
            self.boxes = r.boxes.xyxy
            self.track_ids = r.boxes.id.astype(int).tolist()
            self.clss = r.boxes.cls.astype(int).tolist()
            self.confs = r.boxes.conf.tolist()
        else:
            self.boxes = np.zeros((0, 4))
            self.track_ids, self.clss, self.confs = [], [], []
        return r

    def store_tracking_history(self, track_id, box):
        """Append the box's centre to the track's history, which keeps its last 30 points."""
        cx, cy = float((box[0] + box[2]) / 2), float((box[1] + box[3]) / 2)
        trace = self.track_history[track_id]
        trace.append((cx, cy))
        if len(trace) > 30:
            trace.pop(0)
        self.track_line = trace

    def point_in_region(self, point, region=None) -> bool:
        """Ray casting against the polygon (float32 vertices; 1e-12 added to each edge's height)."""
        poly = np.asarray(region if region is not None else self.region, np.float32)
        x, y = point
        inside = False
        j = len(poly) - 1
        for i in range(len(poly)):
            xi, yi = poly[i]
            xj, yj = poly[j]
            if (yi > y) != (yj > y) and x < (xj - xi) * (y - yi) / (yj - yi + 1e-12) + xi:
                inside = not inside
            j = i
        return inside

    def annotate(self, im0, label_fn=None, tracks: bool = True):
        """Draw the region, each track's box and label and its history on im0; the Annotator stays in `_ann` for the
        app's own overlays. Returns the image."""
        ann = Annotator(im0, line_width=self.line_width)
        if self.region is not None:
            ann.draw_region(self.region, color=(104, 0, 123), thickness=self.line_width * 2)
        for box, tid, c in zip(self.boxes, self.track_ids, self.clss):
            label = label_fn(tid, c) if label_fn else f"{self.names.get(c, c)} #{tid}"
            ann.box_label(box, label, color=colors(c, True))
            if tracks and len(self.track_history.get(tid, ())) > 1:
                ann.draw_centroid_and_tracks(self.track_history[tid], color=colors(c, True),
                                             track_thickness=self.line_width)
        self._ann = ann
        return ann.result()

    def process(self, im0):
        raise NotImplementedError

    def __call__(self, im0):
        return self.process(im0)

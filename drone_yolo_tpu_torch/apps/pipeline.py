"""Drone-video analytics pipeline: detect + track on the card, smoothing, geo conversion and trajectory export on
the host, with an optional pose model.

Counterpart of `drone_yolo_tpu/apps/pipeline.py` (`DroneVideoPipeline`: `step`, `_smooth`, `run`, `export_csv`
with the mix6 CSV columns). `run` reads a printf-pattern sequence of baseline JPEGs (`frames/%06d.jpg`, decoded by
`data/jpeg.py`), which the JAX package opens with `cv2.VideoCapture`, or any iterable of BGR uint8 frames. Video
container files need a video decoder, which is not ported yet (ROADMAP.md queue 1 item 4).
"""

from __future__ import annotations

import csv
import logging
from collections import defaultdict
from pathlib import Path

import numpy as np

from drone_yolo_tpu_torch.data.jpeg import decode_jpeg

LOGGER = logging.getLogger("drone_yolo_tpu_torch")
VIDEO_SUFFIXES = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".gif", ".m4v", ".mpg", ".mpeg", ".ts", ".wmv")
SEQUENCE_FPS = 25.0  # the frame rate cv2 (FFmpeg's image2 reader) reports for an image sequence
FRAMES_FPS = 30.0  # the JAX pipeline's rate when the source reports none


def image_sequence(pattern: str):
    """BGR frames of a printf-pattern JPEG sequence: from the first of indices 0-4 that exists, then index by index
    until one is missing, as FFmpeg's image2 reader under cv2.VideoCapture."""
    start = next((i for i in range(5) if Path(pattern % i).is_file()), None)
    if start is None:
        raise FileNotFoundError(f"no file of the sequence {pattern!r} at an index in 0-4")
    i = start
    while Path(pattern % i).is_file():
        yield np.ascontiguousarray(decode_jpeg(Path(pattern % i).read_bytes())[..., ::-1])  # RGB -> BGR
        i += 1


def open_source(source):
    """(frames, fps) of a source: a printf-pattern JPEG sequence (str or Path with '%') or an iterable of frames."""
    if isinstance(source, (str, Path)):
        s = str(source)
        if s.lower().endswith(VIDEO_SUFFIXES):
            raise NotImplementedError(f"{s}: video files need a video decoder, which is not ported yet (ROADMAP.md "
                                      "queue 1 item 4); pass a JPEG sequence such as frames/%06d.jpg or numpy frames")
        if "%" not in s:
            raise ValueError(f"{s}: expected a printf-pattern JPEG sequence such as frames/%06d.jpg")
        return image_sequence(s), SEQUENCE_FPS
    return iter(source), FRAMES_FPS


class DroneVideoPipeline:
    """Video analytics: detect + ByteTrack + smoothing + GSD scaling + trajectory CSV, with an optional pose model.

    `detector` and `pose_model` are YOLO facades, or model names that become facades on `device` (the card by
    default). `geo` is a `GeoConverter` or None.
    """

    def __init__(self, detector="yolov8s-p2-repvgg-sf.yaml", pose_model=None, geo=None, imgsz: int = 640,
                 conf: float = 0.25, tracker: str = "bytetrack.yaml", smooth_window: int = 5, classes=None,
                 device=None):
        from drone_yolo_tpu_torch import YOLO

        self.det = detector if hasattr(detector, "track") else YOLO(detector, device=device)
        self.pose = pose_model if (pose_model is None or hasattr(pose_model, "predict")) else YOLO(pose_model, device=device)
        self.geo = geo
        self.imgsz = imgsz
        self.conf = conf
        self.tracker = tracker
        self.smooth_window = smooth_window
        self.classes = classes
        self.trajectories = defaultdict(list)  # id -> [(frame, cx, cy, conf, cls)]
        self.frame_idx = 0

    def _smooth(self, pts):
        if len(pts) < self.smooth_window:
            return pts[-1]
        arr = np.asarray(pts[-self.smooth_window:], np.float64)
        return tuple(arr.mean(0))

    def step(self, frame_bgr) -> dict:
        """Process one frame. Returns a dict with the frame index, tracks (id -> smoothed centre), the detector's
        Results, geo positions (id -> (lat, lon)) when a GeoConverter is set, and the pose Results when a pose
        model is set and some track is active."""
        r = self.det.track(source=[frame_bgr], persist=True, imgsz=self.imgsz, conf=self.conf, tracker=self.tracker,
                           classes=self.classes, verbose=False)[0]
        out = {"frame": self.frame_idx, "tracks": {}, "geo": {}, "results": r}
        if r.boxes is not None and len(r.boxes) and r.boxes.id is not None:
            for box, tid, conf_v, cls_v in zip(r.boxes.xyxy, r.boxes.id.astype(int), r.boxes.conf, r.boxes.cls):
                cx, cy = float((box[0] + box[2]) / 2), float((box[1] + box[3]) / 2)
                self.trajectories[int(tid)].append((self.frame_idx, cx, cy, float(conf_v), int(cls_v)))
                sx, sy = self._smooth([(p[1], p[2]) for p in self.trajectories[int(tid)]])
                out["tracks"][int(tid)] = (sx, sy)
                if self.geo is not None:
                    out["geo"][int(tid)] = self.geo.pixel_to_latlon(sx, sy)
        if self.pose is not None and out["tracks"]:
            out["pose"] = self.pose.predict(source=[frame_bgr], imgsz=self.imgsz, verbose=False)[0]
        self.frame_idx += 1
        return out

    def run(self, source, max_frames: int | None = None, csv_path=None) -> dict:
        """Process a JPEG sequence or an iterable of frames (`open_source`); optionally export the trajectory CSV at
        the source's frame rate."""
        frames, fps = open_source(source)
        n = 0
        for frame in frames:
            if max_frames is not None and n >= max_frames:
                break
            self.step(frame)
            n += 1
        stats = self.export_csv(csv_path, fps=fps) if csv_path else None
        return {"frames": n, "n_tracks": len(self.trajectories), "fps": fps, "csv": csv_path, "stats": stats}

    def export_csv(self, path, fps: float = 30.0) -> dict:
        """Write per-frame trajectory rows (the mix6 CSV): frame, track_id, cx, cy, conf, cls [, lat, lon],
        speed_mps (from the GSD, empty without a GeoConverter and on a track's first row)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        mpp = self.geo.gsd if self.geo is not None else None
        with open(path, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            header = ["frame", "track_id", "cx", "cy", "conf", "cls"]
            if self.geo is not None:
                header += ["lat", "lon"]
            header += ["speed_mps"]
            w.writerow(header)
            for tid, rows in sorted(self.trajectories.items()):
                prev = None
                for fr, cx, cy, conf_v, cls_v in rows:
                    speed = ""
                    if prev is not None and mpp is not None:
                        dt_frames = fr - prev[0]
                        if dt_frames > 0:
                            speed = float(np.hypot(cx - prev[1], cy - prev[2])) * mpp * fps / dt_frames
                    row = [fr, tid, round(cx, 2), round(cy, 2), round(conf_v, 4), cls_v]
                    if self.geo is not None:
                        lat, lon = self.geo.pixel_to_latlon(cx, cy)
                        row += [round(lat, 7), round(lon, 7)]
                    row += [round(speed, 3) if speed != "" else ""]
                    w.writerow(row)
                    prev = (fr, cx, cy)
        LOGGER.info(f"trajectories -> {path}")
        return {"tracks": len(self.trajectories)}

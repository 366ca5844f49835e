"""Drone-video analytics pipeline: detect + track (ByteTrack or BoT-SORT) on the card, smoothing, geo conversion and
trajectory export on the host, with an optional pose model.

Counterpart of `drone_yolo_tpu/apps/pipeline.py` (`DroneVideoPipeline`: `step`, `_smooth`, `run`, `export_csv`
with the mix6 CSV columns). `run` reads what the JAX package opens with `cv2.VideoCapture`: an MJPEG AVI file
(`data/avi.py`, at the container's frame rate) or a printf-pattern JPEG or PNG sequence (`frames/%06d.jpg`, at 25
frames/s, FFmpeg's image2 rate); and, through `data/loaders.py`, also an image file, a directory, a glob or a .txt
list of images and AVI files, or any iterable of BGR uint8 frames (30 frames/s). Other video containers and
codecs need NVDEC, which is not ported yet (ROADMAP.md queue 1 item 4), and are refused by name.

The port decodes each frame as `cv2.imread`/`cv2.imdecode` does; the JAX `run` gets FFmpeg's pixels, which differ
(ROADMAP.md queue 3, reference behaviours), so `run` over a file agrees with `step` over the decoded frames.
"""

from __future__ import annotations

import csv
import logging
from collections import defaultdict
from pathlib import Path

import numpy as np

from drone_yolo_tpu_torch.data.avi import read_avi
from drone_yolo_tpu_torch.data.loaders import DECODED_VIDEOS, LoadImagesAndVideos
from drone_yolo_tpu_torch.data.utils import VID_FORMATS, imread

LOGGER = logging.getLogger("drone_yolo_tpu_torch")
SEQUENCE_FPS = 25.0  # the frame rate cv2 (FFmpeg's image2 reader) reports for an image sequence
FRAMES_FPS = 30.0  # the JAX pipeline's rate when the source reports none


def image_sequence(pattern: str):
    """BGR frames of a printf-pattern JPEG or PNG sequence: from the first of indices 0-4 that exists, then index by
    index until one is missing, as FFmpeg's image2 reader under cv2.VideoCapture."""
    start = next((i for i in range(5) if Path(pattern % i).is_file()), None)
    if start is None:
        raise FileNotFoundError(f"no file of the sequence {pattern!r} at an index in 0-4")
    i = start
    while Path(pattern % i).is_file():
        yield imread(pattern % i)
        i += 1


def _loader_frames(dataset: LoadImagesAndVideos):
    for _, imgs, _ in dataset:
        yield from imgs


def open_source(source):
    """(frames, fps) of a source: a printf-pattern sequence (a str or Path with '%'), an AVI file, an image, a
    directory, glob or .txt list (`LoadImagesAndVideos`; fps of its first video, else 25), or an iterable of frames."""
    if isinstance(source, (str, Path)):
        s = str(source)
        if "%" in s:
            return image_sequence(s), SEQUENCE_FPS
        suffix = s.rsplit(".", 1)[-1].lower()
        if suffix in VID_FORMATS and suffix not in DECODED_VIDEOS:
            raise NotImplementedError(f"{s}: .{suffix} video needs a decoder the port lacks (MJPEG in AVI only; "
                                      "H.264/HEVC through NVDEC is ROADMAP.md queue 1 item 4)")
        dataset = LoadImagesAndVideos(s)
        videos = [f for f, v in zip(dataset.files, dataset.video_flag) if v]
        return _loader_frames(dataset), read_avi(videos[0]).fps if videos else SEQUENCE_FPS
    return iter(source), FRAMES_FPS


class DroneVideoPipeline:
    """Video analytics: detect + track + smoothing + GSD scaling + trajectory CSV, with an optional pose model.

    `detector` and `pose_model` are YOLO facades, or model names that become facades on `device` (the card by
    default). `geo` is a `GeoConverter` or None. `tracker` is bytetrack.yaml by default, as in the JAX package, or
    botsort.yaml. `tiled`, `crop_size` and `gap` are stored, as the JAX pipeline stores them and never reads them:
    frames are not tiled (a warning says so once); `ops/tiling.py:tiled_inference` tiles a frame.
    """

    def __init__(self, detector="yolov8s-p2-repvgg-sf.yaml", pose_model=None, geo=None, imgsz: int = 640,
                 conf: float = 0.25, tracker: str = "bytetrack.yaml", tiled: bool = False, crop_size: int = 640,
                 gap: int = 128, smooth_window: int = 5, classes=None, device=None):
        from drone_yolo_tpu_torch import YOLO

        self.det = detector if hasattr(detector, "track") else YOLO(detector, device=device)
        self.pose = pose_model if (pose_model is None or hasattr(pose_model, "predict")) else YOLO(pose_model, device=device)
        self.geo = geo
        self.imgsz = imgsz
        self.conf = conf
        self.tracker = tracker
        self.tiled = tiled
        self.crop_size = crop_size
        self.gap = gap
        if tiled:
            LOGGER.warning("DroneVideoPipeline: tiled=True is stored, as in the JAX pipeline, which never reads it; "
                           "frames are not tiled (ops/tiling.py:tiled_inference tiles a frame)")
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
        """Process a video file, an image sequence or an iterable of frames (`open_source`); optionally export the
        trajectory CSV at the source's frame rate."""
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

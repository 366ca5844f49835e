"""Wire the trackers (BoT-SORT, ByteTrack) into the predictor's callbacks.

Counterpart of `drone_yolo_tpu/trackers/track.py`: `on_predict_start` makes the
tracker of the stream from the tracker yaml (a path, or a name in
`drone_yolo_tpu_torch/cfg/trackers/`: botsort.yaml, the default, or bytetrack.yaml)
at frame_rate 30, once when `persist`; `on_predict_postprocess_end` runs it on each
result's detections and frame in order and replaces the result's boxes with the
7-column tracks (x1, y1, x2, y2, id, conf, cls), or with None when no track is
active. Every frame reaches the tracker, also one whose boxes were all dropped, so
BoT-SORT's camera-motion compensation sees each frame: the frame the predictor
uploaded (`predictor.frames`), else the result's `orig_img`. Boxes of zero height (clipped at the
frame's top or bottom edge) are not given to the tracker: the JAX package's tracker
divides by their height and stops on the NaN costs a frame later. One tracker takes
every frame of a source, as the JAX package's first tracker does, except that a new
tracker starts when the frames move on to another video file (the loader's `mode` is
"video" and the path changes), as Ultralytics resets its tracker per video: the JAX
package carries the tracks of one video into the next. A pose model's keypoints are not
reindexed to the tracks, as in the JAX package.
"""

from __future__ import annotations

from functools import partial
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from drone_yolo_tpu_torch.cfg import TRACKER_CFG_DIR
from drone_yolo_tpu_torch.nn.build import load_yaml
from drone_yolo_tpu_torch.trackers.bot_sort import BOTSORT
from drone_yolo_tpu_torch.trackers.byte_tracker import BYTETracker

TRACKER_MAP = {"bytetrack": BYTETracker, "botsort": BOTSORT}


def load_tracker_cfg(tracker_yaml) -> SimpleNamespace:
    """A tracker yaml (a path, else a file name in cfg/trackers/) as a namespace; its tracker_type must be ported."""
    path = Path(tracker_yaml)
    if not path.exists():
        path = TRACKER_CFG_DIR / path.name
    if not path.exists():
        raise FileNotFoundError(f"tracker yaml {tracker_yaml!r} not found (nor in {TRACKER_CFG_DIR})")
    cfg = SimpleNamespace(**load_yaml(path.read_text(encoding="utf-8")))
    if cfg.tracker_type not in TRACKER_MAP:
        raise ValueError(f"tracker_type {cfg.tracker_type!r} is not a tracker (ported: {sorted(TRACKER_MAP)})")
    return cfg


def on_predict_start(predictor, persist: bool = False) -> None:
    """Make the stream's tracker, unless `persist` and the predictor has one."""
    if persist and hasattr(predictor, "trackers"):
        return
    _new_tracker(predictor)
    predictor.tracked_video = None  # the video file whose frames the tracker has seen


def _new_tracker(predictor) -> None:
    cfg = load_tracker_cfg(predictor.args.tracker)
    if cfg.tracker_type == "botsort":  # its motion compensation runs on the predictor's device
        predictor.trackers = [BOTSORT(args=cfg, frame_rate=30, device=getattr(predictor, "device", None))]
    else:
        predictor.trackers = [TRACKER_MAP[cfg.tracker_type](args=cfg, frame_rate=30)]


def on_predict_postprocess_end(predictor, persist: bool = False) -> None:
    """Associate each result's detections with the tracks and replace its boxes by the tracks with their ids."""
    if not hasattr(predictor, "trackers"):
        on_predict_start(predictor, persist)
    video = getattr(predictor.dataset, "mode", "image") == "video"
    frames = getattr(predictor, "frames", None)
    for i, result in enumerate(predictor.results):
        if video and result.path != getattr(predictor, "tracked_video", None):
            if getattr(predictor, "tracked_video", None) is not None:  # the next video file
                _new_tracker(predictor)
            predictor.tracked_video = result.path
        tracker = predictor.trackers[0]
        det = np.zeros((0, 6), np.float32) if result.boxes is None else result.boxes.data
        det = det[det[:, 3] > det[:, 1]]  # a box of no height has no aspect ratio for the Kalman state
        img = frames[i] if frames is not None else result.orig_img
        if len(det) == 0:
            tracker.update(np.zeros((0, 4)), np.zeros(0), np.zeros(0), img)
            continue
        tracks = tracker.update(det[:, :4], det[:, 4], det[:, 5], img)
        if len(tracks) == 0:
            result.boxes = None
            continue
        result.update(boxes=tracks[:, :7])  # [x1, y1, x2, y2, id, score, cls]: 7 columns make Boxes.is_track


def register_tracker(model, persist: bool = False) -> None:
    """Give a YOLO facade the tracking callbacks, which it adds to every predictor it makes."""
    model._pending_tracker_callbacks = [
        ("on_predict_start", partial(on_predict_start, persist=persist)),
        ("on_predict_postprocess_end", partial(on_predict_postprocess_end, persist=persist)),
    ]

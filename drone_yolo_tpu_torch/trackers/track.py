"""Wire ByteTrack into the predictor's callbacks.

Counterpart of `drone_yolo_tpu/trackers/track.py`: `on_predict_start` makes the
tracker of the stream from the tracker yaml (a path, or a name in
`drone_yolo_tpu_torch/cfg/trackers/`) at frame_rate 30, once when `persist`;
`on_predict_postprocess_end` runs it on each result's detections in order and
replaces the result's boxes with the 7-column tracks (x1, y1, x2, y2, id, conf,
cls), or with None when no track is active. Boxes of zero height (clipped at the
frame's top or bottom edge) are not given to the tracker: the JAX package's tracker
divides by their height and stops on the NaN costs a frame later. The port's sources are numpy frames of
one stream, so one tracker takes every frame, as the JAX package's first tracker
takes every frame of an image or video source. A pose model's keypoints are not
reindexed to the tracks, as in the JAX package. BoT-SORT is not ported yet.
"""

from __future__ import annotations

from functools import partial
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from drone_yolo_tpu_torch.cfg import TRACKER_CFG_DIR
from drone_yolo_tpu_torch.nn.build import load_yaml
from drone_yolo_tpu_torch.trackers.byte_tracker import BYTETracker

TRACKER_MAP = {"bytetrack": BYTETracker}


def load_tracker_cfg(tracker_yaml) -> SimpleNamespace:
    """A tracker yaml (a path, else a file name in cfg/trackers/) as a namespace; its tracker_type must be ported."""
    path = Path(tracker_yaml)
    if not path.exists():
        path = TRACKER_CFG_DIR / path.name
    if not path.exists():
        raise FileNotFoundError(f"tracker yaml {tracker_yaml!r} not found (nor in {TRACKER_CFG_DIR})")
    cfg = SimpleNamespace(**load_yaml(path.read_text(encoding="utf-8")))
    if cfg.tracker_type not in TRACKER_MAP:
        raise ValueError(f"tracker_type {cfg.tracker_type!r} is not ported yet (ported: {sorted(TRACKER_MAP)}; "
                         "BoT-SORT is on ROADMAP.md's queue 1)")
    return cfg


def on_predict_start(predictor, persist: bool = False) -> None:
    """Make the stream's tracker, unless `persist` and the predictor has one."""
    if persist and hasattr(predictor, "trackers"):
        return
    cfg = load_tracker_cfg(predictor.args.tracker)
    predictor.trackers = [TRACKER_MAP[cfg.tracker_type](args=cfg, frame_rate=30)]


def on_predict_postprocess_end(predictor, persist: bool = False) -> None:
    """Associate each result's detections with the tracks and replace its boxes by the tracks with their ids."""
    if not hasattr(predictor, "trackers"):
        on_predict_start(predictor, persist)
    tracker = predictor.trackers[0]
    for result in predictor.results:
        det = np.zeros((0, 6), np.float32) if result.boxes is None else result.boxes.data
        det = det[det[:, 3] > det[:, 1]]  # a box of no height has no aspect ratio for the Kalman state
        if len(det) == 0:
            tracker.update(np.zeros((0, 4)), np.zeros(0), np.zeros(0))
            continue
        tracks = tracker.update(det[:, :4], det[:, 4], det[:, 5])
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

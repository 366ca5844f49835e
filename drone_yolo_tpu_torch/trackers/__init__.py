"""Multi-object tracking on the host: ByteTrack, wired into the predictor's callbacks."""

from drone_yolo_tpu_torch.trackers.byte_tracker import BYTETracker
from drone_yolo_tpu_torch.trackers.track import register_tracker

__all__ = ["BYTETracker", "register_tracker"]

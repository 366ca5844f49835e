"""Multi-object tracking: BoT-SORT and ByteTrack on the host (BoT-SORT's camera-motion compensation on the frame's
device), wired into the predictor's callbacks."""

from drone_yolo_tpu_torch.trackers.bot_sort import BOTSORT
from drone_yolo_tpu_torch.trackers.byte_tracker import BYTETracker
from drone_yolo_tpu_torch.trackers.track import register_tracker

__all__ = ["BOTSORT", "BYTETracker", "register_tracker"]

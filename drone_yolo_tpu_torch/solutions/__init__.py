"""Solutions: ready-made video-analytics apps over detect + track (counterpart of `drone_yolo_tpu/solutions/`).

`BaseSolution` tracks each frame with the port's `YOLO.track` and keeps boxes, ids, classes and a 30-point history of
each track's centre; the apps count across a line or in and out of a region (`ObjectCounter`), count per region
(`RegionCounter`), measure a queue (`QueueManager`), speed (`SpeedEstimator`) and the distance between two tracks
(`DistanceCalculation`), accumulate a heatmap (`Heatmap`), watch parking slots (`ParkingManagement`), raise an alarm
(`SecurityAlarm`), track inside a zone (`TrackZone`), record per-frame class counts (`Analytics`), count workout
repetitions from pose keypoints (`AIGym`), overlay masks (`InstanceSegmentation`), and serve a browser app
(`Inference`). Their logic is numpy on the host, as in the JAX package; the models run on the card unless built with
`device="cpu"`; drawing goes through `ops/draw.py`.
"""

from drone_yolo_tpu_torch.solutions.distance_calculation import DistanceCalculation
from drone_yolo_tpu_torch.solutions.extra import (
    AIGym,
    Analytics,
    InstanceSegmentation,
    ParkingManagement,
    SecurityAlarm,
    TrackZone,
)
from drone_yolo_tpu_torch.solutions.heatmap import Heatmap
from drone_yolo_tpu_torch.solutions.inference_app import Inference
from drone_yolo_tpu_torch.solutions.object_counter import ObjectCounter
from drone_yolo_tpu_torch.solutions.queue_management import QueueManager
from drone_yolo_tpu_torch.solutions.region_counter import RegionCounter
from drone_yolo_tpu_torch.solutions.solutions import BaseSolution
from drone_yolo_tpu_torch.solutions.speed_estimation import SpeedEstimator

__all__ = [
    "BaseSolution", "ObjectCounter", "Heatmap", "SpeedEstimator",
    "RegionCounter", "QueueManager", "DistanceCalculation", "Inference",
    "AIGym", "Analytics", "InstanceSegmentation", "ParkingManagement",
    "SecurityAlarm", "TrackZone",
]

"""Drone-video application layer (the counterpart of `drone_yolo_tpu/apps/`): the detect + pose + track video
pipeline, pixel -> geographic conversion with a GSD camera model, trajectory and speed statistics, KDE density maps,
and the gait study over pose tracks (`apps/gait.py`, its random forest in numpy: `apps/forest.py`)."""

from drone_yolo_tpu_torch.apps.analytics import kde_density, trajectory_statistics
from drone_yolo_tpu_torch.apps.gait import GaitStudy, gait_features
from drone_yolo_tpu_torch.apps.geo import GeoConverter, gsd_meters_per_pixel
from drone_yolo_tpu_torch.apps.pipeline import DroneVideoPipeline

__all__ = ["GeoConverter", "gsd_meters_per_pixel", "DroneVideoPipeline", "trajectory_statistics", "kde_density",
           "GaitStudy", "gait_features"]

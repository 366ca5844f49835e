"""Drone-video application layer (the counterpart of `drone_yolo_tpu/apps/`): the detect + pose + track video
pipeline, pixel -> geographic conversion with a GSD camera model, trajectory and speed statistics and KDE density
maps. Group gait classification (`apps/gait.py`) is not ported yet."""

from drone_yolo_tpu_torch.apps.analytics import kde_density, trajectory_statistics
from drone_yolo_tpu_torch.apps.geo import GeoConverter, gsd_meters_per_pixel
from drone_yolo_tpu_torch.apps.pipeline import DroneVideoPipeline

__all__ = ["GeoConverter", "gsd_meters_per_pixel", "DroneVideoPipeline", "trajectory_statistics", "kde_density"]

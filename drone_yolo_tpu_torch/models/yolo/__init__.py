"""Task registry of the port: {task: {predictor}} (`drone_yolo_tpu/models/yolo/__init__.py:TASK_MAP` for the
ported predictors; the model classes are `nn.model.TASK2MODELCLASS`)."""

from drone_yolo_tpu_torch.engine.predictor import DetectionPredictor
from drone_yolo_tpu_torch.models.yolo.pose import PosePredictor

TASK_MAP = {"detect": {"predictor": DetectionPredictor}, "pose": {"predictor": PosePredictor}}

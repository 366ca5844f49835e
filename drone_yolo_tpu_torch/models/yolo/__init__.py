"""Task registry of the port: {task: {trainer, validator, predictor}} (`drone_yolo_tpu/models/yolo/__init__.py:TASK_MAP`
for the ported tasks; the model classes are `nn.model.TASK2MODELCLASS`)."""

from drone_yolo_tpu_torch.engine.predictor import DetectionPredictor
from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
from drone_yolo_tpu_torch.engine.validator import DetectionValidator
from drone_yolo_tpu_torch.models.yolo.classify import ClassificationPredictor, ClassificationTrainer, ClassificationValidator
from drone_yolo_tpu_torch.models.yolo.obb import OBBPredictor, OBBTrainer, OBBValidator
from drone_yolo_tpu_torch.models.yolo.pose import PosePredictor, PoseTrainer, PoseValidator
from drone_yolo_tpu_torch.models.yolo.segment import SegmentationPredictor, SegmentationTrainer, SegmentationValidator

TASK_MAP = {"detect": {"trainer": BaseTrainer, "validator": DetectionValidator, "predictor": DetectionPredictor},
            "segment": {"trainer": SegmentationTrainer, "validator": SegmentationValidator,
                        "predictor": SegmentationPredictor},
            "pose": {"trainer": PoseTrainer, "validator": PoseValidator, "predictor": PosePredictor},
            "obb": {"trainer": OBBTrainer, "validator": OBBValidator, "predictor": OBBPredictor},
            "classify": {"trainer": ClassificationTrainer, "validator": ClassificationValidator,
                         "predictor": ClassificationPredictor}}

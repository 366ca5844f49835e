"""Exporter: the fused model written as a deployable artifact.

Counterpart of `drone_yolo_tpu/engine/exporter.py` (Exporter). Formats:

* **npz** — the `drone_yolo_tpu.v1` checkpoint of the fused weights, written by every export, as in the JAX
  package; the port's `load_checkpoint` and the JAX package's read it.
* **torchscript** — `torch.jit.trace` of the fused model in eval mode (`nn/autobackend.py:ArtifactModel`: the
  decoded predictions, with the prototypes for segment, YOLOv10's decoded one-to-one branch) at a fixed
  (batch, 3, imgsz, imgsz), in float32, or in bfloat16 under `half=True`: `<stem>_<imgsz>.torchscript` and a
  `.json` sidecar (input, nms, names, task, stride; kpt_shape for pose). The trace bakes the anchors and strides
  of its imgsz: a fixed-shape artifact, as the JAX package's.
* **stablehlo** — the JAX package's native artifact and the configuration's default `format`; the JAX exporter
  maps torchscript to it, so the port maps it to torchscript, its own native artifact, and says so.
* **onnx** — the JAX package's graph, written by `export/onnx_export.py` on the fused float32 weights (opset 13,
  IR version 8, input `images`, outputs `output0` and `output1`), with its `.json` sidecar.

savedmodel, tflite and int8 need TensorFlow and are refused by name. `nms=True` is refused for torchscript (the
NMS kernel is bound by ctypes, `ops/cuda_build.py`, which a traced artifact cannot carry) and ignored for onnx, as
the JAX ONNX path ignores it: NMS runs after the artifact, in the predictor and the validator.
"""

from __future__ import annotations

import copy
import json
import logging
import time
import warnings
from pathlib import Path

import torch

from drone_yolo_tpu_torch.cfg import get_cfg
from drone_yolo_tpu_torch.engine.checkpoint import save_checkpoint
from drone_yolo_tpu_torch.nn.autobackend import ArtifactModel, model_meta
from drone_yolo_tpu_torch.utils.callbacks import CallbackMixin, get_default_callbacks

LOGGER = logging.getLogger("drone_yolo_tpu_torch")
EXPORT_FORMATS = ("npz", "torchscript", "onnx")
REFUSED_FORMATS = {
    "savedmodel": "a TensorFlow SavedModel needs TensorFlow, which the card's machine does not have",
    "tflite": "TFLite needs TensorFlow, which the card's machine does not have",
}


class Exporter(CallbackMixin):
    """`Exporter(overrides={"format": "onnx", "imgsz": 640, "batch": 1})(facade)` -> the last path written."""

    def __init__(self, cfg=None, overrides=None):
        self.args = get_cfg(cfg or {}, overrides)
        self.callbacks = get_default_callbacks()

    def check_format(self) -> str:
        """The format to write, or a refusal by name."""
        fmt = str(self.args.format or "stablehlo").lower()
        if fmt == "stablehlo":
            LOGGER.info("format stablehlo is the JAX package's native artifact (jax.export bytecode); the port writes "
                        "its own native artifact instead: torchscript")
            fmt = "torchscript"
        if fmt in REFUSED_FORMATS:
            raise NotImplementedError(f"format {fmt!r}: {REFUSED_FORMATS[fmt]}")
        if self.args.int8:
            raise NotImplementedError("int8=True (the JAX package's TFLite post-training quantization) needs TensorFlow, "
                                      "which the card's machine does not have")
        if fmt not in EXPORT_FORMATS:
            raise ValueError(f"unknown format {fmt!r}, choose from {list(EXPORT_FORMATS)}")
        if self.args.nms and fmt == "torchscript":
            raise NotImplementedError("nms=True for torchscript: the greedy-NMS kernel is bound by ctypes "
                                      "(ops/cuda_build.py), which a traced artifact cannot carry; NMS runs after the "
                                      "artifact, in the predictor and the validator")
        if self.args.nms:
            LOGGER.warning("nms=True is ignored for onnx, as in the JAX package: NMS runs after the artifact, in the "
                           "predictor and the validator")
        return fmt

    def __call__(self, facade) -> str:
        self.run_callbacks("on_export_start")
        t0 = time.time()
        fmt = self.check_format()
        imgsz = self.args.imgsz if isinstance(self.args.imgsz, int) else max(self.args.imgsz)
        batch = int(self.args.batch)
        facade.ensure_variables(imgsz=imgsz)
        model = copy.deepcopy(facade.model).eval().to(facade.device, torch.float32).fuse()
        stride = int(max(model.head.stride))
        if imgsz % stride:  # the artifact's anchors, reshapes and area attention assume whole cells on every level
            raise ValueError(f"imgsz={imgsz} must be a multiple of the model's largest stride, {stride}")
        stem = Path(str(facade.model_name)).stem or "model"
        out_base = Path(self.args.project or ".") / f"{stem}_{imgsz}"
        out_base.parent.mkdir(parents=True, exist_ok=True)

        produced = [str(save_checkpoint(out_base.with_suffix(".npz"), model, model.state_dict(),
                                        train_args=facade.overrides))]
        meta = model_meta(model, imgsz, batch)
        if fmt == "torchscript":
            dtype = torch.bfloat16 if self.args.half else torch.float32
            net = ArtifactModel(copy.deepcopy(model).to(dtype)).eval()
            x = torch.zeros(batch, 3, imgsz, imgsz, device=facade.device)
            with torch.no_grad(), warnings.catch_warnings():  # the shape checks the trace fixes, as it should
                warnings.simplefilter("ignore", torch.jit.TracerWarning)
                traced = torch.jit.trace(net, x, check_trace=False)
            path = out_base.with_suffix(".torchscript")
            traced.save(str(path))
            meta["dtype"] = str(dtype).split(".")[1]
            produced.append(str(path))
        elif fmt == "onnx":
            from drone_yolo_tpu_torch.export.onnx_export import export_onnx

            produced.append(export_onnx(model.cpu(), out_base.with_suffix(".onnx"), imgsz=imgsz, batch=batch))
        if fmt != "npz":
            Path(produced[-1] + ".json").write_text(json.dumps(meta, indent=2))
        LOGGER.info(f"export success ({time.time() - t0:.1f}s): {produced}")
        self.run_callbacks("on_export_end")
        return produced[-1]

"""Streaming predictor: letterbox on the device, one forward + decode + NMS step, Results.

Counterpart of `drone_yolo_tpu/engine/predictor.py` (BasePredictor and
DetectionPredictor) for numpy sources: one BGR uint8 frame (H, W, 3), a list of
them, or an NHWC batch, which is read like frames (BGR, 0-255), as the JAX
predictor reads it. File, video and stream sources need an image library and
come with a later slice.

Per batch only the (B, max_det, 6) detections and the (B,) counts leave the
device. The model runs fused, in the configured dtype (bfloat16 by default);
decode and NMS run in float32.
"""

from __future__ import annotations

import copy
import logging
import time

import numpy as np
import torch

from drone_yolo_tpu_torch.cfg import get_cfg
from drone_yolo_tpu_torch.engine.results import Results
from drone_yolo_tpu_torch.ops.boxes import scale_boxes
from drone_yolo_tpu_torch.ops.letterbox import letterbox
from drone_yolo_tpu_torch.ops.nms import non_max_suppression

LOGGER = logging.getLogger("drone_yolo_tpu_torch")


class Profile:
    """Wall-clock timer that waits for the device on entry and exit."""

    def __init__(self, device: torch.device):
        self.device = device
        self.dt = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.dt = time.perf_counter() - self.start


def load_inference_source(source):
    """Numpy source -> (paths, frames). A 4-D array is a batch of frames."""
    if isinstance(source, np.ndarray):
        frames = list(source) if source.ndim == 4 else [source]
    elif isinstance(source, (list, tuple)) and all(isinstance(im, np.ndarray) for im in source):
        frames = list(source)
    else:
        raise TypeError(f"sources are numpy frames, lists of them or NHWC batches; got {type(source).__name__} "
                        "(files and streams are not ported yet)")
    if not frames or any(im.ndim != 3 or im.shape[2] != 3 for im in frames):
        raise ValueError("each frame must be (H, W, 3)")
    return [f"image{i}.jpg" for i in range(len(frames))], frames


class DetectionPredictor:
    """Runs a YOLO facade's model over numpy sources, yielding one `Results` per image."""

    def __init__(self, cfg=None, overrides=None):
        self.args = get_cfg(cfg, overrides)
        if self.args.conf is None:
            self.args.conf = 0.25
        self.model = None
        self.results = None

    def setup_model(self, facade) -> None:
        """Take a fused copy of the facade's model, in the compute dtype, on the facade's device."""
        imgsz = self.args.imgsz if isinstance(self.args.imgsz, int) else max(self.args.imgsz)
        facade.ensure_variables(imgsz=imgsz)
        self.device = facade.device
        self.dtype = torch.bfloat16 if self.args.dtype == "bfloat16" else torch.float32
        self.model = copy.deepcopy(facade.model).fuse().to(self.device, self.dtype)
        self.names = self.model.names

    @property
    def imgsz(self) -> tuple[int, int]:
        s = self.args.imgsz
        return (int(s), int(s)) if isinstance(s, int) else (int(s[0]), int(s[1]))

    def preprocess(self, imgs) -> torch.Tensor:
        """BGR frames -> letterboxed RGB (B, 3, h, w) float32 in [0, 1] on the device.

        Frames of one shape are letterboxed as one batch; mixed shapes one by one.
        """
        groups = [imgs] if len({im.shape for im in imgs}) == 1 else [[im] for im in imgs]
        out = []
        for group in groups:
            raw = torch.from_numpy(np.ascontiguousarray(np.stack(group))).to(self.device)
            x = raw.flip(-1).permute(0, 3, 1, 2).float() / 255.0  # BGR -> RGB, NHWC -> NCHW
            out.append(letterbox(x, self.imgsz))
        return torch.cat(out) if len(out) > 1 else out[0]

    @torch.inference_mode()
    def inference(self, x: torch.Tensor):
        """The step on the device: forward, DFL decode, NMS -> (dets (B, max_det, 6), n_valid (B,))."""
        preds, _ = self.model(x)
        return non_max_suppression(
            preds, conf_thres=self.args.conf, iou_thres=self.args.iou, max_det=self.args.max_det,
            pre_topk=min(self.args.pre_nms_topk, 1024), classes=self.args.classes, agnostic=self.args.agnostic_nms)

    def postprocess(self, dets, n_valid, x_shape, orig_imgs, paths):
        """Detections -> Results with boxes rescaled to the original frames."""
        dets = dets.float().cpu()
        results = []
        for i, (im0, path) in enumerate(zip(orig_imgs, paths)):
            d = dets[i, : int(n_valid[i])].clone()
            if len(d):
                d[:, :4] = scale_boxes(x_shape, d[:, :4], im0.shape[:2])
            results.append(Results(im0, path, self.names, boxes=d.numpy()))
        return results

    def __call__(self, source=None, stream: bool = False):
        gen = self.stream_inference(source)
        return gen if stream else list(gen)

    def stream_inference(self, source):
        """Generator of Results, with per-image preprocess/inference/postprocess times in `speed` (ms)."""
        paths, im0s = load_inference_source(source if source is not None else self.args.source)
        profilers = (Profile(self.device), Profile(self.device), Profile(self.device))
        with profilers[0]:
            x = self.preprocess(im0s)
        with profilers[1]:
            dets, n_valid = self.inference(x)
            n_valid = n_valid.cpu()
        with profilers[2]:
            self.results = self.postprocess(dets, n_valid, x.shape[2:], im0s, paths)
        speed = {k: p.dt * 1e3 / len(im0s) for k, p in zip(("preprocess", "inference", "postprocess"), profilers)}
        for r in self.results:
            r.speed = speed
            if self.args.verbose:
                LOGGER.info(f"{r.path}: {r.verbose()}{speed['inference']:.1f}ms")
        if self.args.verbose:
            LOGGER.info(f"Speed: {speed['preprocess']:.1f}ms preprocess, {speed['inference']:.1f}ms inference, "
                        f"{speed['postprocess']:.1f}ms postprocess per image")
        yield from self.results

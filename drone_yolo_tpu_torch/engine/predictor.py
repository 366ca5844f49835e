"""Streaming predictor: sources through the loaders, letterbox on the device, one forward + decode + NMS step, Results.

Counterpart of `drone_yolo_tpu/engine/predictor.py` (BasePredictor and
DetectionPredictor). `setup_source` picks a loader (`data/loaders.py`): image files
(JPEG, PNG), MJPEG AVI videos, directories, globs and .txt lists of them, numpy BGR
frames, lists of frames or NHWC batches; `stream_inference` runs batch by batch over its
(paths, images, info) batches. `write_results` logs each result's line and writes
`save_txt` labels (under `<save_dir>/labels`, a video frame's as `<stem>_<frame>.txt`),
`save_crop` crops (under `<save_dir>/crops`) and, with `save`, the drawn result
(`Results.plot` with `show_conf`, `show_labels` and `line_width`): an image to
`<save_dir>/<its name>` (JPEG or PNG by its suffix), the frames of a video to one MJPEG AVI
per video, `<save_dir>/<its stem>.avi` at the video's frame rate (`data/avi.py:AviWriter`;
the JAX package writes `<stem>.mp4` with cv2's MPEG-4 encoder, which the port does not
have), closed when the stream ends. `show` needs a display and is refused by name
(`cfg.check_ported`).

Per batch only the (B, max_det, 6 [+ extra]) detections and the (B,) counts
leave the device. The model runs fused, in the configured dtype (bfloat16 by
default); decode and NMS run in float32.

Callbacks (`utils/callbacks.py`) run at `on_predict_start`, `on_predict_batch_start`,
`on_predict_postprocess_end` (where the tracker rewrites `self.results`),
`on_predict_batch_end` and `on_predict_end`.
"""

from __future__ import annotations

import copy
import logging
import time
from pathlib import Path

import numpy as np
import torch

from drone_yolo_tpu_torch.cfg import check_ported, get_cfg, get_save_dir
from drone_yolo_tpu_torch.data.avi import AviWriter
from drone_yolo_tpu_torch.data.loaders import load_inference_source
from drone_yolo_tpu_torch.engine.results import Results, write_image
from drone_yolo_tpu_torch.ops.boxes import scale_boxes
from drone_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_u8
from drone_yolo_tpu_torch.ops.nms import non_max_suppression
from drone_yolo_tpu_torch.utils.callbacks import CallbackMixin, get_default_callbacks

LOGGER = logging.getLogger("drone_yolo_tpu_torch")


class Profile:
    """Wall-clock timer that waits for the device on entry and exit."""

    def __init__(self, device: torch.device):
        self.device = device
        self.dt = 0.0
        self.t = 0.0

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
        self.t += self.dt


class DetectionPredictor(CallbackMixin):
    """Runs a YOLO facade's model over a source (`data/loaders.py`), yielding one `Results` per image."""

    def __init__(self, cfg=None, overrides=None):
        self.args = check_ported(get_cfg(cfg, overrides), "predict")
        if self.args.conf is None:
            self.args.conf = 0.25
        self.save_dir = get_save_dir(self.args)
        self.model = None
        self.results = None
        self.frames = None  # the batch's BGR uint8 frames on the device, as `preprocess` uploaded them
        self.dataset = None
        self.source_type = None
        self.vid_writers = {}  # one AviWriter per video written with save, by its output path
        self.callbacks = get_default_callbacks()

    def setup_model(self, facade) -> None:
        """Take a fused copy of the facade's model, in the compute dtype, on the facade's device."""
        imgsz = self.args.imgsz if isinstance(self.args.imgsz, int) else max(self.args.imgsz)
        facade.ensure_variables(imgsz=imgsz)
        self.device = facade.device
        self.dtype = torch.bfloat16 if self.args.dtype == "bfloat16" or self.args.half else torch.float32
        self.model = copy.deepcopy(facade.model).fuse().to(self.device, self.dtype)
        self.names = self.model.names

    @property
    def imgsz(self) -> tuple[int, int]:
        s = self.args.imgsz
        return (int(s), int(s)) if isinstance(s, int) else (int(s[0]), int(s[1]))

    def preprocess(self, imgs) -> torch.Tensor:
        """BGR frames -> letterboxed RGB (B, 3, h, w) float32 in [0, 1] on the device.

        Frames of one shape are letterboxed as one float batch (`ops.letterbox.letterbox`, the JAX
        package's device path); frames of mixed shapes one by one in uint8 (`letterbox_u8`, its
        `cv2.resize` path), then normalised. The uploaded uint8 frames stay in `self.frames` for the
        tracker's motion compensation.
        """
        if len({im.shape for im in imgs}) == 1:
            raw = torch.from_numpy(np.ascontiguousarray(np.stack(imgs))).to(self.device)
            self.frames = raw
            x = raw.flip(-1).permute(0, 3, 1, 2).float() / 255.0  # BGR -> RGB, NHWC -> NCHW
            return letterbox(x, self.imgsz)
        self.frames = [torch.from_numpy(np.ascontiguousarray(im)).to(self.device) for im in imgs]
        raw = torch.cat([letterbox_u8(f[None], self.imgsz) for f in self.frames])
        return raw.flip(-1).permute(0, 3, 1, 2).float() / 255.0

    @torch.inference_mode()
    def inference(self, x: torch.Tensor):
        """The step on the device: forward, DFL decode, NMS -> (dets (B, max_det, 6 + extra), n_valid (B,))."""
        preds, _ = self.model(x)
        return non_max_suppression(
            preds, conf_thres=self.args.conf, iou_thres=self.args.iou, max_det=self.args.max_det,
            pre_topk=min(self.args.pre_nms_topk, 1024), classes=self.args.classes, agnostic=self.args.agnostic_nms,
            nc=self.model.nc)

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

    def setup_source(self, source) -> None:
        """The loader of `source`: batches of `args.batch` files, or the frames given, with `args.vid_stride`."""
        self.dataset = load_inference_source(source, batch=self.args.batch, vid_stride=self.args.vid_stride)
        self.source_type = self.dataset.source_type

    def stream_inference(self, source):
        """Generator of Results, batch by batch, with per-image preprocess/inference/postprocess times in `speed`
        (ms)."""
        self.setup_source(source if source is not None else self.args.source)
        if self.args.save or self.args.save_txt:
            self.save_dir.mkdir(parents=True, exist_ok=True)
        self.run_callbacks("on_predict_start")
        profilers = (Profile(self.device), Profile(self.device), Profile(self.device))
        self.seen = 0
        for paths, im0s, infos in self.dataset:
            self.run_callbacks("on_predict_batch_start")
            with profilers[0]:
                x = self.preprocess(im0s)
            with profilers[1]:
                dets, n_valid = self.inference(x)
                n_valid = n_valid.cpu()
            with profilers[2]:
                self.results = self.postprocess(dets, n_valid, x.shape[2:], im0s, paths)
            self.run_callbacks("on_predict_postprocess_end")
            speed = {k: p.dt * 1e3 / len(im0s) for k, p in zip(("preprocess", "inference", "postprocess"), profilers)}
            for i, r in enumerate(self.results):
                self.seen += 1
                r.speed = speed
                if self.args.verbose or self.args.save or self.args.save_txt or self.args.save_crop:
                    self.write_results(i, Path(paths[i]), r, infos)
            self.run_callbacks("on_predict_batch_end")
            yield from self.results
        for w in self.vid_writers.values():
            w.close()
        self.vid_writers = {}
        if self.args.verbose and self.seen:
            t = tuple(p.t / self.seen * 1e3 for p in profilers)
            LOGGER.info(f"Speed: {t[0]:.1f}ms preprocess, {t[1]:.1f}ms inference, {t[2]:.1f}ms postprocess per image")
        self.run_callbacks("on_predict_end")

    def write_results(self, i: int, path: Path, result: Results, infos) -> None:
        """Log one result's line; write its labels (save_txt), crops (save_crop) and drawing (save) under
        `save_dir`."""
        if self.args.verbose:
            LOGGER.info(f"{infos[i] if i < len(infos) else ''}{result.verbose()}{result.speed['inference']:.1f}ms")
        if self.args.save_txt:
            frame = getattr(self.dataset, "frame", 0)
            suffix = "" if self.dataset.mode == "image" else f"_{frame}"
            result.save_txt(self.save_dir / "labels" / f"{path.stem}{suffix}.txt", save_conf=self.args.save_conf)
        if self.args.save_crop:
            result.save_crop(self.save_dir / "crops", path.stem)
        if self.args.save:
            plotted = result.plot(conf=self.args.show_conf, labels=self.args.show_labels,
                                  line_width=self.args.line_width)
            if self.dataset.mode == "image":
                write_image(self.save_dir / path.name, plotted)
            else:
                out = self.save_dir / f"{path.stem}.avi"
                if out not in self.vid_writers:
                    self.vid_writers[out] = AviWriter(out, fps=self.dataset.fps)
                self.vid_writers[out].write(plotted)

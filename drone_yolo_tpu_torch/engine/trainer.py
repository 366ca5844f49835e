"""Detection trainer, and the base of the segment and pose tasks': one optimizer step of the JAX package's train step,
in PyTorch.

Counterpart of `drone_yolo_tpu/engine/trainer.py` (`_setup_train`'s optimizer and
state part, `_build_train_step`/`step_fn`, `preprocess_batch`, `_warmup_hyp`). A
step (`train_step`) is: the batch to the device (uint8 NHWC, /255 there), the
train-mode forward under bfloat16 autocast when `amp` is set, the TAL assigner and
the v8 loss in float32, backward into the float32 masters' `.grad` (which
accumulates across micro-steps), and once `accumulate` micro-steps are in: the
gradients scaled by 1/accumulate, clipped to global norm 10, the SGD or AdamW
update of the three parameter groups, then the EMA. The BN running statistics
take this micro-step's batch statistics last, on every micro-step: the EMA sees
them as they were before the merge, as in the JAX step.

`train()` is the epoch loop of `drone_yolo_tpu/engine/trainer.py` (`_setup_train`,
`_do_train`, `save_model`, `resume_training`) over the dataset of `args.data`: the
augmented train set and the threaded loader (`data/build.py`), close-mosaic, the warmup
by global batch index, the per-batch multi-scale size (drawn from a generator seeded by
`args.seed`, applied on the device by an antialiased bilinear resize), the mean loss items
of each epoch, validation of the EMA weights every epoch on the val split, the best
fitness and its EMA weights, `results.csv`, `weights/last.npz` and `best.npz` in the JAX
package's `drone_yolo_tpu.v1` format, `weights/resume_state.npz` in the JAX trainer's
layout, early stopping, and resume from either package's resume state. With `plots` the
first three batches of the run are drawn to `train_batch{ni}.jpg` (`utils/plotting.py:
plot_images`, in threads joined before `train` returns).

Built with `train_loader` (any sized iterable of batches in the collate format,
`data/dataset.py`) instead, the trainer takes steps on them with `run_steps`; with
`val_loader` (collate-format batches with `ori_shapes` and `ratio_pads`) `validate` runs
`engine/validator.py` on the EMA weights over it. Device augmentation is not ported.

A task trainer (`models/yolo/segment.py:SegmentationTrainer`, `models/yolo/pose.py:PoseTrainer`,
`models/yolo/obb.py:OBBTrainer`, `models/yolo/classify.py:ClassificationTrainer`) sets `task`,
`loss_names` and `validator_class` and overrides `build_model`, `fits_data` and `get_criterion` (the classifier also
`get_dataset` and `build_dataset`: an image folder); the loss items, the
metrics and the columns of `results.csv` follow from them. A segment batch's `masks` go to the device with the rest
of it; a multi-scale resize leaves them at their size, as in the JAX step (the loss resamples them). An OBB batch's
`rboxes` are scaled with the boxes and keypoints (cx, cy, w, h; the angle stays), which the JAX step forgets
(ROADMAP queue 3).
"""

from __future__ import annotations

import math
import random
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from drone_yolo_tpu_torch.cfg import get_save_dir, get_train_cfg
from drone_yolo_tpu_torch.data.build import build_dataloader, build_yolo_dataset
from drone_yolo_tpu_torch.data.utils import check_det_dataset
from drone_yolo_tpu_torch.engine.checkpoint import load_checkpoint, read_resume_state, resume_state, save_checkpoint
from drone_yolo_tpu_torch.engine.model import select_device
from drone_yolo_tpu_torch.engine.predictor import LOGGER, Profile
from drone_yolo_tpu_torch.engine.validator import DetectionValidator
from drone_yolo_tpu_torch.nn import modules as M
from drone_yolo_tpu_torch.nn.model import DetectionModel
from drone_yolo_tpu_torch.nn.modules import collect_bn_stats
from drone_yolo_tpu_torch.utils.callbacks import CallbackMixin, get_default_callbacks
from drone_yolo_tpu_torch.utils.ema import EarlyStopping, ModelEMA
from drone_yolo_tpu_torch.utils.loss import E2EDetectLoss, v8DetectionLoss
from drone_yolo_tpu_torch.utils.optimizer import auto_optimizer, build_lr_fn, build_optimizer, set_hyp
from drone_yolo_tpu_torch.utils.plotting import plot_images

MAX_GRAD_NORM = 10.0


class BaseTrainer(CallbackMixin):
    """`BaseTrainer(overrides={"model": "yolov8s-p2-repvgg-sf.yaml", "data": "data.yaml", ...}).train()`, or with
    `train_loader=batches, data={"nc": 80}` for steps on batches in memory.

    The model trains on `args.device`, the CUDA card unless the caller passes device="cpu".
    """

    task = "detect"
    loss_names = ("box_loss", "cls_loss", "dfl_loss")
    validator_class = DetectionValidator

    def __init__(self, cfg=None, overrides=None, train_loader=None, data: dict | None = None, val_loader=None):
        self.args = get_train_cfg(cfg, overrides)
        self.args.task = self.task  # the dataset reads this task's labels
        self.device = select_device(self.args.device)
        self.batch_size = self.args.batch
        self.epochs = self.args.epochs
        self.train_loader = train_loader
        self.val_loader = val_loader
        if data is None and self.args.data:
            data = self.get_dataset()
        self.data = dict(data or {})
        self.save_dir = get_save_dir(self.args)
        self.wdir = self.save_dir / "weights"
        self.model = None
        self.model_facade = None  # a YOLO facade whose model to train (`YOLO.train`)
        self.trainset = None
        self.validator = None
        self.metrics, self.fitness, self.best_fitness = {}, None, None
        self.best_state = self.final_state = None
        self.start_epoch = self.epoch = 0
        self.ni = 0  # batches seen, for the warmup
        self.plot_threads = []  # plot_images of the first batches (plots), joined at the end of training
        self.plot_join_s = 0.0  # the seconds that join waited
        self.epoch_stats: list[dict] = []  # per epoch: wall seconds, seconds waiting for the loader, validation
        self.callbacks = get_default_callbacks()

    def get_dataset(self) -> dict:
        """The dataset of `args.data`: a detection dataset yaml (`check_det_dataset`)."""
        return check_det_dataset(self.args.data)

    def build_dataset(self, img_path, mode: str = "train"):
        """The dataset of the split at `img_path`, augmented for "train"; rect shapes round to the largest stride."""
        return build_yolo_dataset(self.args, img_path, self.batch_size, self.data, mode=mode,
                                  stride=int(max(self.model.head.stride)))

    def build_model(self, cfg) -> DetectionModel:
        """This task's model of the yaml (or yaml dict) `cfg`, for the data's class count."""
        return DetectionModel(cfg, nc=self.data.get("nc"))

    def fits_data(self, model) -> bool:
        """Whether `model`'s head fits the data: its class count."""
        nc = self.data.get("nc")
        return not nc or model.nc == nc

    def get_criterion(self):
        """The detection loss; for YOLOv10's NMS-free head (`v10Detect`) the dual-assignment `E2EDetectLoss`."""
        loss = E2EDetectLoss if isinstance(self.model.head, M.v10Detect) else v8DetectionLoss
        return loss(self.model, box=self.args.box, cls=self.args.cls, dfl=self.args.dfl)

    def setup_model(self) -> None:
        """The model to train, with the data's class count and names, on the device, in train mode: the facade's,
        or `args.model` (a yaml, initialised from `args.seed`, or a `drone_yolo_tpu.v1` npz of unfused weights).
        A model whose head does not fit the data (`fits_data`) is rebuilt and initialised, as in the JAX trainer."""
        if self.model_facade is not None:
            model = self.model_facade.ensure_variables(imgsz=self.args.imgsz, seed=self.args.seed)
        elif str(self.args.model).endswith(".npz"):
            model, _ = load_checkpoint(self.args.model)
        else:
            model = self.build_model(self.args.model)
            model.init(self.args.seed, imgsz=self.args.imgsz)
        if model.task != self.task:
            raise ValueError(f"{self.args.model}: a {model.task} model, which the {self.task} trainer does not train")
        if not self.fits_data(model):
            model = self.build_model(model.yaml)
            model.init(self.args.seed, imgsz=self.args.imgsz)
        if not any(isinstance(m, M.BatchNorm2d) for m in model.modules()):
            raise ValueError(f"{self.args.model}: fused weights (no BatchNorm) cannot be trained")
        if self.data.get("names"):
            model.names = dict(self.data["names"])
        self.model = model.set_s2grad(self.args.s2grad).set_bnstats(self.args.bnstats)
        self.model.to(self.device).train()
        if self.model_facade is not None:
            self.model_facade.model = self.model

    def _setup_train(self) -> None:
        """Model, data and loaders, optimizer, EMA, early stopping; then the resume state, if asked for."""
        self.run_callbacks("on_pretrain_routine_start")
        self.setup_model()
        if self.train_loader is None:
            self.trainset = self.build_dataset(self.data["train"], "train")
            self.train_loader = build_dataloader(self.trainset, self.batch_size, self.args.workers, shuffle=True,
                                                 seed=self.args.seed)
        self.nb = len(self.train_loader)
        self.accumulate = max(round(self.args.nbs / self.batch_size), 1)
        self.weight_decay = self.args.weight_decay * self.batch_size * self.accumulate / self.args.nbs
        iterations = math.ceil(self.nb / self.accumulate) * self.epochs
        self.opt_name, self.lr0, self.momentum = auto_optimizer(self.args, self.model.nc, iterations)
        self.lf = build_lr_fn(self.args, self.epochs)
        self.criterion = self.get_criterion()
        self.optimizer = build_optimizer(self.model, self.opt_name, self.lr0, self.momentum, self.weight_decay)
        self.ema = ModelEMA(self.model)
        self.count = 0  # micro-steps since the last optimizer step
        self.step = 0  # optimizer steps (the EMA ramp)
        self.stopper = EarlyStopping(patience=self.args.patience)
        self.scale_rng = random.Random(self.args.seed)  # multi-scale sizes
        self.resume_training()
        self.run_callbacks("on_pretrain_routine_end")

    def preprocess_batch(self, batch: dict) -> dict:
        """Collate-format numpy batch -> tensors on the device; the uint8 NHWC image becomes float NCHW / 255 there."""
        out = {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items() if isinstance(v, np.ndarray)}
        img = out["img"]
        if img.dtype == torch.uint8:
            img = img.float() / 255.0
        out["img"] = img.permute(0, 3, 1, 2).contiguous()
        return out

    def _warmup_hyp(self, ni: int, epoch: int) -> tuple[float, float, float]:
        """(lr_w, lr_b, momentum) of batch `ni`: linear warmup over max(round(warmup_epochs * nb), 100) batches."""
        nw = max(round(self.args.warmup_epochs * self.nb), 100) if self.args.warmup_epochs > 0 else -1
        lr = self.lr0 * self.lf(epoch)
        if 0 < nw and ni <= nw:
            xi = [0, nw]
            return (float(np.interp(ni, xi, [0.0, lr])), float(np.interp(ni, xi, [self.args.warmup_bias_lr, lr])),
                    float(np.interp(ni, xi, [self.args.warmup_momentum, self.momentum])))
        return lr, lr, self.momentum

    def train_step(self, batch: dict, lr_w: float, lr_b: float, momentum: float, size: int | None = None):
        """One micro-step on a collate-format batch, resized on the device to `size` (with its boxes, keypoints and
        rotated boxes) when given; returns (loss, items (len(loss_names),)) on the device, detached."""
        batch = self.preprocess_batch(batch)
        if size and size != batch["img"].shape[2]:
            scale = size / batch["img"].shape[2]
            batch["img"] = F.interpolate(batch["img"], size=(size, size), mode="bilinear", align_corners=False,
                                         antialias=True)
            if "bboxes" in batch:  # a classifier's batch has none
                batch["bboxes"] = batch["bboxes"] * scale
            if "keypoints" in batch:  # x, y move with the image, visibility stays
                kp = batch["keypoints"]
                batch["keypoints"] = torch.cat([kp[..., :2] * scale, kp[..., 2:]], -1)
            if "rboxes" in batch:  # cx, cy, w, h move with the image, the angle stays
                rb = batch["rboxes"]
                batch["rboxes"] = torch.cat([rb[..., :4] * scale, rb[..., 4:]], -1)
        with collect_bn_stats() as bn_stats:
            with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.args.amp):
                out = self.model(batch["img"])  # the head's train output: maps (and a pose head's raw keypoints)
            loss, items = self.criterion(out, batch)
        loss.backward()
        self.count += 1
        if self.count >= self.accumulate:
            params = list(self.model.parameters())
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                p.grad.div_(self.accumulate)
            torch.nn.utils.clip_grad_norm_(params, MAX_GRAD_NORM)
            set_hyp(self.optimizer, lr_w, lr_b, momentum)
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.step += 1
            self.ema.update(self.model, self.step)
            self.count = 0
        self.model.merge_bn_updates(bn_stats)
        return loss.detach(), items

    def run_steps(self, steps: int | None = None) -> list[dict]:
        """Set up at first call, then train on the loader's next `steps` batches (all by default) with the warmup
        schedule of epoch 0. Returns per step its loss, items and wall milliseconds (waiting for the card)."""
        if self.model is None:
            self._setup_train()
        out = []
        for i, batch in enumerate(self.train_loader):
            if steps is not None and i >= steps:
                break
            lr_w, lr_b, mom = self._warmup_hyp(self.ni, 0)
            with Profile(self.device) as dt:
                loss, items = self.train_step(batch, lr_w, lr_b, mom)
            self.ni += 1
            out.append({"loss": float(loss), "items": items.tolist(), "ms": dt.dt * 1e3})
        return out

    def get_validator(self):
        """This task's validator at the train size and device, in bfloat16 when `amp` is set, conf 0.001: over
        `val_loader`, or over the val split of `args.data` at the train batch (in rectangular batches with `rect`)."""
        args = dict(imgsz=self.args.imgsz, device=str(self.device), conf=0.001,
                    dtype="bfloat16" if self.args.amp else "float32", plots=False)
        if self.val_loader is None:
            args.update(data=self.args.data, batch=self.batch_size, workers=self.args.workers, cache=self.args.cache,
                        single_cls=self.args.single_cls, classes=self.args.classes, rect=self.args.rect,
                        rect_max_shapes=self.args.rect_max_shapes)
        return self.validator_class(self.val_loader, args=args)

    def validate(self) -> dict:
        """Validate the EMA weights: sets and returns `metrics`, and sets `fitness`."""
        if self.model is None:
            self._setup_train()
        if self.validator is None:
            self.validator = self.get_validator()
        self.metrics = self.validator(model=self.model, ema_state=self.ema.state)
        self.fitness = self.metrics.get("fitness", 0.0)
        return self.metrics

    # -- the epoch loop ------------------------------------------------------------------
    def train(self) -> None:
        self._setup_train()
        self._do_train()

    def _multi_scale_size(self) -> int | None:
        """This batch's train size under `multi_scale`: randrange(0.5 imgsz, 1.5 imgsz + stride) rounded down to a
        multiple of the largest stride."""
        if not self.args.multi_scale:
            return None
        stride = int(max(self.model.head.stride))
        imgsz = self.args.imgsz
        return self.scale_rng.randrange(int(imgsz * 0.5), int(imgsz * 1.5 + stride)) // stride * stride

    def _do_train(self) -> None:
        has_val = self.args.val and (self.val_loader is not None or bool(self.data.get("val")))
        self.wdir.mkdir(parents=True, exist_ok=True)
        LOGGER.info(f"Logging results to {self.save_dir}\nStarting training for {self.epochs} epochs...")
        t0 = time.time()
        self.ni = self.start_epoch * self.nb
        self.run_callbacks("on_train_start")
        for epoch in range(self.start_epoch, self.epochs):
            self.epoch = epoch
            self.run_callbacks("on_train_epoch_start")
            t_epoch = time.perf_counter()
            if (self.args.close_mosaic and epoch == self.epochs - self.args.close_mosaic
                    and hasattr(self.trainset, "close_mosaic")):
                LOGGER.info("Closing dataloader mosaic")
                self.trainset.close_mosaic(self.args)
            if hasattr(self.train_loader, "set_epoch"):
                self.train_loader.set_epoch(epoch)
            tloss, n_done, pending = None, 0, None  # items are read one step late: the next batch's host work
            wait = 0.0                              # overlaps this step on the card
            batches = iter(self.train_loader)
            while True:
                t_wait = time.perf_counter()
                batch = next(batches, None)
                wait += time.perf_counter() - t_wait
                if batch is None:
                    break
                self.run_callbacks("on_train_batch_start")
                lr_w, lr_b, mom = self._warmup_hyp(self.ni, epoch)
                _, items = self.train_step(batch, lr_w, lr_b, mom, self._multi_scale_size())
                if self.args.plots and self.ni < 3 and "bboxes" in batch:
                    self.plot_threads.append(self.plot_training_samples(batch, self.ni))
                if pending is not None:
                    tloss = self._running_mean(tloss, pending, n_done)
                    n_done += 1
                pending = items
                self.ni += 1
                self.lr_current = lr_w
                self.run_callbacks("on_train_batch_end")
            if pending is not None:
                tloss = self._running_mean(tloss, pending, n_done)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            train_s = time.perf_counter() - t_epoch
            self.tloss = tloss if tloss is not None else np.zeros(len(self.loss_names), np.float32)
            self.label_loss_items_dict = {f"train/{n}": float(v) for n, v in zip(self.loss_names, self.tloss)}
            self.label_loss_items_dict["lr"] = self.lr_current if self.nb else 0.0
            self.run_callbacks("on_train_epoch_end")
            self.metrics = {}
            t_val = time.perf_counter()
            if has_val:
                self.metrics = self.validate()
                if self.best_fitness is None or self.fitness > self.best_fitness:
                    self.best_fitness = self.fitness
                    self.best_state = {k: v.detach().cpu().clone() for k, v in self.ema.state.items()}
            val_s = time.perf_counter() - t_val
            self.save_metrics()
            self.run_callbacks("on_fit_epoch_end")
            if self.args.save:
                self.save_model()
                self.run_callbacks("on_model_save")
            self.epoch_stats.append({"epoch": epoch, "train_s": train_s, "data_wait_s": wait, "val_s": val_s,
                                     "batches": self.nb, "images": self.nb * self.batch_size,
                                     "loss_items": self.tloss.tolist()})
            if self.stopper(epoch, self.fitness):
                LOGGER.info(f"EarlyStopping: no improvement for {self.args.patience} epochs, stopping at epoch {epoch}")
                break
        LOGGER.info(f"{self.epochs - self.start_epoch} epochs completed in {(time.time() - t0) / 3600:.3f} hours.")
        self.final_state = {k: v.detach().cpu().clone() for k, v in self.ema.state.items()}
        if self.best_state is None:
            self.best_state = self.final_state
        t_join = time.perf_counter()
        for t in self.plot_threads:
            t.join()
        self.plot_join_s = time.perf_counter() - t_join
        self.run_callbacks("on_train_end")

    def plot_training_samples(self, batch: dict, ni: int):
        """Draw the host batch `ni` (its labelled boxes, pixel xyxy) to train_batch{ni}.jpg in a thread, with the
        arguments the JAX trainer gives `plot_images`; returns the thread."""
        valid = batch["mask"].reshape(-1).astype(bool)
        bi = np.repeat(np.arange(batch["cls"].shape[0]), batch["cls"].shape[1])
        return plot_images(batch["img"].astype(np.float32) / 255.0, bi[valid], batch["cls"].reshape(-1)[valid],
                           batch["bboxes"].reshape(-1, 4)[valid], fname=self.save_dir / f"train_batch{ni}.jpg",
                           names=self.model.names)

    @staticmethod
    def _running_mean(tloss, items: torch.Tensor, n: int) -> np.ndarray:
        """The JAX trainer's running mean of the loss items, in float32."""
        items = items.detach().float().cpu().numpy()
        return items if tloss is None else (tloss * n + items) / (n + 1)

    def save_metrics(self) -> None:
        """One row of results.csv: the epoch, the mean loss items, the lr and the validation metrics."""
        metrics = {**self.label_loss_items_dict, **(self.metrics or {})}
        path = Path(self.save_dir) / "results.csv"
        header = not path.exists()
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            if header:
                f.write(",".join(["epoch", *metrics]) + "\n")
            f.write(",".join(str(v) for v in [self.epoch, *(f"{v:.5f}" if isinstance(v, float) else v
                                                               for v in metrics.values())]) + "\n")

    def save_model(self) -> None:
        """weights/last.npz with the EMA weights, best.npz when this epoch's fitness is the best, epoch{n}.npz every
        `save_period` epochs, and resume_state.npz with the whole train state."""
        meta = {"epoch": self.epoch, "best_fitness": float(self.best_fitness) if self.best_fitness is not None else 0.0}
        train_args = {k: str(v) if isinstance(v, Path) else v for k, v in vars(self.args).items()}
        ema = self.ema.state
        save_checkpoint(self.wdir / "last.npz", self.model, ema, train_args=train_args, meta=meta)
        if self.best_fitness is not None and self.best_fitness == self.fitness:
            save_checkpoint(self.wdir / "best.npz", self.model, ema, train_args=train_args, meta=meta)
        if self.args.save_period > 0 and self.epoch % self.args.save_period == 0:
            save_checkpoint(self.wdir / f"epoch{self.epoch}.npz", self.model, ema, train_args=train_args, meta=meta)
        np.savez(self.wdir / "resume_state.npz", **resume_state(self.train_state(), self.epoch))

    def resume_training(self) -> None:
        """With `resume` (True: this run's weights/resume_state.npz; a path: that file), take over its params,
        optimizer state, EMA, step and count, with the accumulator at zero, and start after its epoch."""
        if not self.args.resume:
            return
        path = Path(self.args.resume) if isinstance(self.args.resume, str) else self.wdir / "resume_state.npz"
        if not path.exists():
            raise FileNotFoundError(f"resume state {path} not found")
        ts, epoch = read_resume_state(path)
        self.load_train_state(ts)
        self.start_epoch = epoch + 1
        LOGGER.info(f"Resuming training from epoch {self.start_epoch}")

    def train_state(self) -> dict:
        """The step's state by the port's names: params (the state dict), opt, ema, acc (the gradients
        accumulated so far), count and step; the layout `engine.checkpoint.from_jax_train_state` gives."""
        names = {p: n for n, p in self.model.named_parameters()}
        state = self.optimizer.state
        if isinstance(self.optimizer, torch.optim.AdamW):
            opt = {"m": {names[p]: s["exp_avg"] for p, s in state.items()},
                   "v": {names[p]: s["exp_avg_sq"] for p, s in state.items()},
                   "t": int(next(iter(state.values()))["step"]) if state else 0}
        else:
            opt = {"momentum": {names[p]: s["momentum_buffer"] for p, s in state.items()}}
        acc = {n: (torch.zeros_like(p) if p.grad is None else p.grad) for p, n in names.items()}
        return {"params": self.model.state_dict(), "opt": opt, "ema": dict(self.ema.state), "acc": acc,
                "count": self.count, "step": self.step}

    @torch.no_grad()
    def load_train_state(self, ts: dict) -> None:
        """Take over a state in `train_state`'s layout (for example a JAX train state through
        `engine.checkpoint.from_jax_train_state`)."""
        if self.model is None:
            self._setup_train()
        self.model.load_state_dict(ts["params"], strict=True)
        params = dict(self.model.named_parameters())
        self.optimizer.state.clear()
        for n, p in params.items():
            if "momentum" in ts["opt"]:
                self.optimizer.state[p] = {"momentum_buffer": ts["opt"]["momentum"][n].to(p).clone()}
            else:
                self.optimizer.state[p] = {"step": torch.tensor(float(ts["opt"]["t"])),
                                           "exp_avg": ts["opt"]["m"][n].to(p).clone(),
                                           "exp_avg_sq": ts["opt"]["v"][n].to(p).clone()}
            p.grad = ts["acc"][n].to(p).clone() if ts["count"] else None
        self.ema.state = {k: ts["ema"][k].to(self.device, torch.float32).clone() for k in self.ema.state}
        self.count, self.step = int(ts["count"]), int(ts["step"])

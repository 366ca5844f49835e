"""Detection trainer: one optimizer step of the JAX package's train step, in PyTorch.

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

`train_loader` is any sized iterable of batches in the collate format
(`data/dataset.py`). `run_steps` walks it with the warmup schedule. `validate`
runs `engine/validator.py` on the EMA weights over `val_loader`, an iterable of
collate-format batches with `ori_shapes` and `ratio_pads`, and sets `metrics` and
`fitness` (`drone_yolo_tpu/engine/trainer.py:validate`). The epoch loop, early
stopping, checkpoints, multi-scale resizing and device augmentation come with the
trainer loop.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from drone_yolo_tpu_torch.cfg import get_train_cfg
from drone_yolo_tpu_torch.engine.model import select_device
from drone_yolo_tpu_torch.engine.predictor import Profile
from drone_yolo_tpu_torch.engine.validator import DetectionValidator
from drone_yolo_tpu_torch.nn.model import DetectionModel
from drone_yolo_tpu_torch.nn.modules import collect_bn_stats
from drone_yolo_tpu_torch.utils.ema import ModelEMA
from drone_yolo_tpu_torch.utils.loss import v8DetectionLoss
from drone_yolo_tpu_torch.utils.optimizer import auto_optimizer, build_lr_fn, build_optimizer, set_hyp

MAX_GRAD_NORM = 10.0


class BaseTrainer:
    """`BaseTrainer(overrides={"model": "yolov8s-p2-repvgg-sf.yaml", ...}, train_loader=batches, data={"nc": 80})`.

    The model trains on `args.device`, the CUDA card unless the caller passes device="cpu".
    """

    loss_names = ("box_loss", "cls_loss", "dfl_loss")

    def __init__(self, cfg=None, overrides=None, train_loader=None, data: dict | None = None, val_loader=None):
        self.args = get_train_cfg(cfg, overrides)
        self.device = select_device(self.args.device)
        self.batch_size = self.args.batch
        self.epochs = self.args.epochs
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.data = dict(data or {})
        self.model = None
        self.validator = None
        self.metrics, self.fitness = {}, None
        self.ni = 0  # batches seen, for the warmup

    def setup_model(self) -> None:
        """The model from `args.model` with the data's class count, seeded init, on the device, in train mode."""
        self.model = DetectionModel(self.args.model, nc=self.data.get("nc"), s2grad=self.args.s2grad,
                                    bnstats=self.args.bnstats)
        self.model.init(self.args.seed, imgsz=self.args.imgsz)
        self.model.to(self.device).train()

    def _setup_train(self) -> None:
        self.setup_model()
        self.nb = len(self.train_loader)
        self.accumulate = max(round(self.args.nbs / self.batch_size), 1)
        self.weight_decay = self.args.weight_decay * self.batch_size * self.accumulate / self.args.nbs
        iterations = math.ceil(self.nb / self.accumulate) * self.epochs
        self.opt_name, self.lr0, self.momentum = auto_optimizer(self.args, self.model.nc, iterations)
        self.lf = build_lr_fn(self.args, self.epochs)
        self.criterion = v8DetectionLoss(self.model, box=self.args.box, cls=self.args.cls, dfl=self.args.dfl)
        self.optimizer = build_optimizer(self.model, self.opt_name, self.lr0, self.momentum, self.weight_decay)
        self.ema = ModelEMA(self.model)
        self.count = 0  # micro-steps since the last optimizer step
        self.step = 0  # optimizer steps (the EMA ramp)

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

    def train_step(self, batch: dict, lr_w: float, lr_b: float, momentum: float):
        """One micro-step on a collate-format batch; returns (loss, items (3,)) on the device, detached."""
        batch = self.preprocess_batch(batch)
        with collect_bn_stats() as bn_stats:
            with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.args.amp):
                maps = self.model(batch["img"])
            loss, items = self.criterion(maps, batch)
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

    def get_validator(self) -> DetectionValidator:
        """A validator over `val_loader` at the train size and device, in bfloat16 when `amp` is set, conf 0.001."""
        return DetectionValidator(self.val_loader, args=dict(imgsz=self.args.imgsz, device=str(self.device), conf=0.001,
                                                             dtype="bfloat16" if self.args.amp else "float32"))

    def validate(self) -> dict:
        """Validate the EMA weights on `val_loader`: sets and returns `metrics`, and sets `fitness`."""
        if self.model is None:
            self._setup_train()
        if self.validator is None:
            self.validator = self.get_validator()
        self.metrics = self.validator(model=self.model, ema_state=self.ema.state)
        self.fitness = self.metrics.get("fitness", 0.0)
        return self.metrics

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

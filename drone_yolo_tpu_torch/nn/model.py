"""Detection, segmentation, pose, oriented box and classification models: the built layer list as one `nn.Module`, with
stride probe, seeded init and fuse.

Counterpart of `drone_yolo_tpu/nn/model.py` (BaseModel / DetectionModel / SegmentationModel / PoseModel / OBBModel /
ClassificationModel, `guess_model_task`). Layers
live in `self.model` (an `nn.ModuleList`), so parameter names are the reference
torch names `model.<i>....`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from drone_yolo_tpu_torch.nn import modules as M
from drone_yolo_tpu_torch.nn.build import parse_model, yaml_model_load


class DetectionModel(nn.Module):
    """Executable detection graph, built in eval mode.

    `nc` overrides the yaml's class count, as in the JAX package. `s2grad="cuda"` (or
    `set_s2grad`) routes the backward of the dense stride-2 sites through the CUDA
    kernel (`ops/conv_s2.py`); `bnstats="cuda"` (or `set_bnstats`) takes the batch
    sums of train-mode BatchNorm from the CUDA kernel (`ops/bn_stats.py`). The
    defaults, None, keep stock autograd and the stock reductions.
    """

    task = "detect"

    def __init__(self, cfg="yolov8n.yaml", nc: int | None = None, s2grad: str | None = None, bnstats: str | None = None):
        super().__init__()
        self.yaml = dict(cfg) if isinstance(cfg, dict) else yaml_model_load(cfg)
        if nc:
            self.yaml["nc"] = int(nc)
        modules, self.froms, self.save, self.nc, self.ch_list = parse_model(self.yaml, ch=3)
        self.model = nn.ModuleList(modules)
        self.names = {i: f"class{i}" for i in range(self.nc)}
        self.eval()
        self._probe_strides()
        self.set_s2grad(s2grad)
        self.set_bnstats(bnstats)

    @property
    def head(self) -> M.Detect:
        return self.model[-1]

    def _probe_strides(self, imgsz: int = 256) -> None:
        """Per-level strides from the head's map shapes, traced on the meta device (no arithmetic)."""
        state = {k: torch.empty_like(v, device="meta") for k, v in self.state_dict(keep_vars=True).items()}
        x = torch.empty(1, 3, imgsz, imgsz, device="meta")
        maps = torch.func.functional_call(self, state, (x,), {"raw": True})
        self.head.stride = [int(imgsz / m.shape[-2]) for m in maps]

    @torch.no_grad()
    def init(self, seed: int = 0, imgsz: int = 640) -> None:
        """Random init from a seed: conv weights and biases U(+-1/sqrt(fan_in)) as torch's Conv2d and
        ConvTranspose2d defaults, BN at identity, A2C2f's gamma at 0.01, then the head's bias priors for `imgsz`."""
        g = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = mod.weight.shape[1] * mod.kernel_size[0] * mod.kernel_size[1]
                bound = 1.0 / math.sqrt(fan_in)
                for p in (mod.weight, mod.bias):
                    if p is not None:
                        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))
            elif isinstance(mod, nn.Linear):  # Classify's: U(+-1/sqrt(fan_in)) and a zero bias, as the JAX package
                bound = 1.0 / math.sqrt(mod.in_features)
                mod.weight.copy_(torch.empty(mod.weight.shape).uniform_(-bound, bound, generator=g))
                mod.bias.zero_()
            elif isinstance(mod, M.BatchNorm2d):
                mod.reset_parameters()
            elif isinstance(mod, M.A2C2f) and mod.gamma is not None:
                mod.gamma.fill_(0.01)
        if isinstance(self.head, M.Detect):
            self.head.bias_init(imgsz)

    def set_s2grad(self, mode: str | None) -> DetectionModel:
        """Backward of the dense stride-2 sites: "cuda" (the kernel; its plain version on CPU tensors) or None (stock)."""
        if mode not in M.S2GRAD_MODES:
            raise ValueError(f"s2grad={mode!r} must be one of {M.S2GRAD_MODES}")
        for mod in self.modules():
            if isinstance(mod, (M.Conv, M.BasicBlock)):
                mod.s2grad = mode
        return self

    def set_bnstats(self, mode: str | None) -> DetectionModel:
        """Batch sums of train-mode BatchNorm: "cuda" (the kernel; its plain version on CPU tensors) or None (stock)."""
        if mode not in M.BNSTATS_MODES:
            raise ValueError(f"bnstats={mode!r} must be one of {M.BNSTATS_MODES}")
        for mod in self.modules():
            if isinstance(mod, M.BatchNorm2d):
                mod.bnstats = mode
        return self

    def forward(self, x: torch.Tensor, raw: bool = False):
        """(B, 3, H, W) -> ((B, A, 4 + nc) decoded predictions, per-level maps); `raw=True` gives the per-level
        (B, 4 * reg_max + nc, H, W) maps only; train mode gives the head's train output (`Detect.train_out`: the
        maps, for a pose head the raw keypoints with them, for a segment head the mask coefficients and prototypes, for
        an OBB head the angles),
        undecoded.

        The input is cast to the parameters' dtype, the compute dtype. Train mode runs under
        `nn.modules.collect_bn_stats()`.
        """
        out = self.head_input(x)
        return self.head.raw_maps(out) if raw else self.head.train_out(out) if self.training else self.head(out)

    def head_input(self, x: torch.Tensor):
        """Every layer before the head on (B, 3, H, W), cast to the parameters' dtype; returns the head's input."""
        if x.dim() != 4 or x.shape[1] != 3:
            raise ValueError(f"expected a (B, 3, H, W) batch, got shape {tuple(x.shape)}")
        out = x.to(next(self.parameters()).dtype)
        y = []
        for i, (mod, f) in enumerate(zip(self.model, self.froms)):
            if f != -1:
                out = y[f] if isinstance(f, int) else [out if j == -1 else y[j] for j in f]
            if mod is self.head:
                return out
            out = mod(out)
            y.append(out if i in self.save else None)
        raise AssertionError("the last layer is the head")

    @torch.no_grad()
    def merge_bn_updates(self, stats: dict, momentum: float = M.BN_MOMENTUM) -> None:
        """Fold collected batch statistics into the running ones: new = (1 - m) * old + m * batch."""
        for bn, (mean, var) in stats.items():
            bn.running_mean.copy_((1 - momentum) * bn.running_mean + momentum * mean)
            bn.running_var.copy_((1 - momentum) * bn.running_var + momentum * var)

    @torch.no_grad()
    def fuse(self) -> DetectionModel:
        """Fold BN into convs and collapse the RepVGGBlock, RepConv and RepVGGDW branches, in place."""
        for kind in (M.RepVGGBlock, M.RepConv, M.RepVGGDW, M.Conv, M.TorchVision):  # the first 3 fold their Convs' BNs
            for mod in [m for m in self.modules() if isinstance(m, kind)]:
                mod.fuse()
        return self

    def param_count(self) -> int:
        """Parameters and BN statistics, as the JAX package counts its variables."""
        return sum(t.numel() for t in self.state_dict().values())


class PoseModel(DetectionModel):
    """Pose model: a DetectionModel whose head is `Pose` (keypoints of the yaml's `kpt_shape` per detection).
    Counterpart of `drone_yolo_tpu/nn/model.py` `PoseModel`: a `data_kpt_shape` that differs from the yaml's
    (a dataset's) replaces it, so the head is built for the dataset's keypoints."""

    task = "pose"

    def __init__(self, cfg="yolov8n-pose.yaml", nc: int | None = None, data_kpt_shape=(None, None),
                 s2grad: str | None = None, bnstats: str | None = None):
        cfg = dict(cfg) if isinstance(cfg, dict) else yaml_model_load(cfg)
        if any(data_kpt_shape) and list(data_kpt_shape) != list(cfg.get("kpt_shape", [])):
            cfg["kpt_shape"] = list(data_kpt_shape)
        super().__init__(cfg, nc=nc, s2grad=s2grad, bnstats=bnstats)


class SegmentationModel(DetectionModel):
    """Instance segmentation model: a DetectionModel whose head is `Segment` (mask coefficients per detection and
    prototype masks per image). Counterpart of `drone_yolo_tpu/nn/model.py` `SegmentationModel`."""

    task = "segment"


class OBBModel(DetectionModel):
    """Oriented box model: a DetectionModel whose head is `OBB` (a rotated box per detection, its angle last).
    Counterpart of `drone_yolo_tpu/nn/model.py` `OBBModel`."""

    task = "obb"


class ClassificationModel(DetectionModel):
    """Classification model: the layers end in `Classify`, which gives (B, nc) softmax probabilities in eval mode and
    the logits in train mode. Counterpart of `drone_yolo_tpu/nn/model.py` `ClassificationModel`; its stride is 1, as
    there, and its init sets no bias priors."""

    task = "classify"

    def _probe_strides(self, imgsz: int = 256) -> None:
        """A classifier has no detection levels: `Classify.stride` is [1]."""

    def forward(self, x: torch.Tensor):
        return self.head(self.head_input(x))


TASK2MODELCLASS = {"detect": DetectionModel, "segment": SegmentationModel, "pose": PoseModel, "obb": OBBModel,
                   "classify": ClassificationModel}


def guess_model_task(cfg) -> str:
    """The task of a model yaml (or its dict) by the name of its head, as the JAX package's: "classify", "segment",
    "pose", "obb" or "rtdetr" when the head's name holds it, else "detect"."""
    d = cfg if isinstance(cfg, dict) else yaml_model_load(cfg)
    head = d["head"][-1][2].lower()
    return next((t for t in ("classify", "segment", "pose", "obb", "rtdetr") if t in head), "detect")

"""Detection model: the built layer list as one `nn.Module`, with stride probe, seeded init and fuse.

Counterpart of `drone_yolo_tpu/nn/model.py` (BaseModel / DetectionModel). Layers
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
    """Executable detection graph, built in eval mode: its BatchNorm has no train form yet."""

    task = "detect"

    def __init__(self, cfg="yolov8n.yaml"):
        super().__init__()
        self.yaml = dict(cfg) if isinstance(cfg, dict) else yaml_model_load(cfg)
        modules, self.froms, self.save, self.nc, self.ch_list = parse_model(self.yaml, ch=3)
        self.model = nn.ModuleList(modules)
        self.names = {i: f"class{i}" for i in range(self.nc)}
        self.eval()
        self._probe_strides()

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
        """Random init from a seed: conv weights and biases U(+-1/sqrt(fan_in)) as torch's Conv2d
        default, BN at identity, then the head's bias priors for `imgsz`."""
        g = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
                bound = 1.0 / math.sqrt(fan_in)
                for p in (mod.weight, mod.bias):
                    if p is not None:
                        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))
            elif isinstance(mod, M.BatchNorm2d):
                mod.reset_parameters()
        self.head.bias_init(imgsz)

    def forward(self, x: torch.Tensor, raw: bool = False):
        """(B, 3, H, W) -> ((B, A, 4 + nc) decoded predictions, per-level maps); `raw=True` gives the maps only.

        The input is cast to the parameters' dtype, the compute dtype.
        """
        if x.dim() != 4 or x.shape[1] != 3:
            raise ValueError(f"expected a (B, 3, H, W) batch, got shape {tuple(x.shape)}")
        out = x.to(next(self.parameters()).dtype)
        y = []
        for i, (mod, f) in enumerate(zip(self.model, self.froms)):
            if f != -1:
                out = y[f] if isinstance(f, int) else [out if j == -1 else y[j] for j in f]
            if mod is self.head:
                return mod.raw_maps(out) if raw else mod(out)
            out = mod(out)
            y.append(out if i in self.save else None)
        raise AssertionError("the last layer is the head")

    @torch.no_grad()
    def fuse(self) -> DetectionModel:
        """Fold BN into convs and collapse RepVGG branches, in place."""
        for kind in (M.RepVGGBlock, M.Conv):  # RepVGG first: it folds the BNs of its own Conv branches
            for mod in [m for m in self.modules() if isinstance(m, kind)]:
                mod.fuse()
        return self

    def param_count(self) -> int:
        """Parameters and BN statistics, as the JAX package counts its variables."""
        return sum(t.numel() for t in self.state_dict().values())

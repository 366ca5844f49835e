"""Optimizer over the three parameter groups of the reference, and its schedules.

Counterpart of `drone_yolo_tpu/utils/optimizer.py` (`label_tree`, `sgd_step`,
`adamw_step`, `clip_global_norm`, `build_lr_fn`, `auto_optimizer`):

* groups: conv and linear weights, and A2C2f's gamma, with weight decay ("decay"),
  BN weights without ("scale"), all biases without and with the bias learning rate
  ("bias"). BN running statistics are buffers, outside the optimizer (the JAX
  package's "frozen" group);
* SGD is torch's with Nesterov momentum, AdamW torch's with beta1 = momentum;
  the learning rates and momentum of each step are written into the groups
  (`set_hyp`), as the JAX step receives them as scalars;
* clipping scales all gradients by min(1, max_norm / (norm + 1e-6)).
"""

from __future__ import annotations

import math

import torch
from torch import nn

GROUPS = ("decay", "scale", "bias")


def label_params(model: nn.Module) -> dict[str, list[str]]:
    """Parameter names by group: biases "bias", BN weights (the 1-D weights) "scale", the rest (conv weights, gamma)
    "decay", as the JAX package's `label_tree`."""
    groups = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        if name.endswith(".bias"):
            groups["bias"].append(name)
        elif name.endswith(".weight") and p.ndim == 1:
            groups["scale"].append(name)
        else:
            groups["decay"].append(name)
    return groups


def build_optimizer(model: nn.Module, name: str, lr: float, momentum: float, weight_decay: float) -> torch.optim.Optimizer:
    """SGD (Nesterov) or AdamW over the three groups, in the order decay, scale, bias."""
    params = dict(model.named_parameters())
    groups = [{"params": [params[n] for n in names], "group": g, "weight_decay": weight_decay if g == "decay" else 0.0}
              for g, names in label_params(model).items()]
    if name.lower() == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=momentum, nesterov=True)
    if name.lower() == "adamw":
        return torch.optim.AdamW(groups, lr=lr, betas=(momentum, 0.999), eps=1e-8)
    raise ValueError(f"optimizer {name!r} is not ported; SGD and AdamW are (and 'auto')")


def set_hyp(optimizer: torch.optim.Optimizer, lr_w: float, lr_b: float, momentum: float) -> None:
    """This step's learning rates (weights, biases) and momentum (SGD momentum, AdamW beta1)."""
    for group in optimizer.param_groups:
        group["lr"] = lr_b if group["group"] == "bias" else lr_w
        if "betas" in group:
            group["betas"] = (momentum, group["betas"][1])
        else:
            group["momentum"] = momentum


def build_lr_fn(cfg, epochs: int):
    """Epoch -> lr fraction: linear to lrf, or one-cycle cosine with cos_lr."""
    lrf = cfg.lrf
    if cfg.cos_lr:
        return lambda e: lrf + 0.5 * (1 - lrf) * (1 + math.cos(math.pi * e / epochs))
    return lambda e: max(1 - e / epochs, 0) * (1.0 - lrf) + lrf


def auto_optimizer(cfg, nc: int, iterations: float) -> tuple[str, float, float]:
    """(name, lr0, momentum); 'auto' picks SGD(0.01, 0.9) past 10,000 iterations, else AdamW(round(0.002 * 5 / (4 + nc), 6), 0.9),
    and then sets warmup_bias_lr to 0."""
    name, lr0, momentum = str(cfg.optimizer), cfg.lr0, cfg.momentum
    if name.lower() == "auto":
        if iterations > 10000:
            name, lr0, momentum = "SGD", 0.01, 0.9
        else:
            name, lr0, momentum = "AdamW", round(0.002 * 5 / (4 + nc), 6), 0.9
        cfg.warmup_bias_lr = 0.0
    return name, lr0, momentum

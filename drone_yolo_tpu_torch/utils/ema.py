"""Exponential moving average of every floating entry of a model's state, BN running statistics included; early stopping.

Counterpart of `drone_yolo_tpu/utils/ema.py:ema_update`: ema = d * ema + (1 - d) * new with
d = 0.9999 * (1 - exp(-step / 2000)), step counting optimizer steps from 1.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class ModelEMA:
    """float32 copies of a model's floating state-dict entries, by name."""

    def __init__(self, model: nn.Module, decay: float = 0.9999, tau: float = 2000.0):
        self.decay, self.tau = decay, tau
        self.state = {k: v.detach().float().clone() for k, v in model.state_dict().items() if v.is_floating_point()}

    @torch.no_grad()
    def update(self, model: nn.Module, step: int) -> None:
        d = self.decay * (1.0 - math.exp(-step / self.tau))
        current = model.state_dict()
        for k, e in self.state.items():
            e.mul_(d).add_(current[k].float(), alpha=1.0 - d)


class EarlyStopping:
    """Stop when the fitness has not improved for `patience` epochs (`drone_yolo_tpu/utils/ema.py:EarlyStopping`)."""

    def __init__(self, patience: int = 100):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: float | None) -> bool:
        if fitness is None:
            return False
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        return (epoch - self.best_epoch) >= self.patience

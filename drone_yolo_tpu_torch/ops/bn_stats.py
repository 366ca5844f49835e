"""Per-channel sum and sum of squares of an NCHW tensor: the batch statistics of train-mode BatchNorm.

Counterpart of the two float32 reductions `s1`, `s2` of `drone_yolo_tpu/nn/modules.py:_bn_apply`
and of the Pallas TPU kernel `tools/bn_stat_probe.py:make_pallas_stats`, which computes the same
pair in one pass. `bn_stats` is an autograd Function: its forward is the hand-written CUDA kernel
(`ops/cuda_bnstats.py`) on a CUDA tensor and the plain version `bn_stats_reference` on a CPU
tensor; its backward, gx = g_sum + 2 x g_sumsq, is plain tensor code on both (the JAX package has
no backward kernel for this reduction either). `nn/modules.py:BatchNorm2d` routes its statistics
here when built or set with `bnstats="cuda"`; by default it keeps the stock reductions.
"""

from __future__ import annotations

import torch

from drone_yolo_tpu_torch.ops import cuda_bnstats

BNSTATS_MODES = (None, "cuda")


def bn_stats_reference(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain (sum, sum of squares) over N, H and W of (N, C, H, W) `x`, in float32 (float64 for float64)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    return xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3))


class BNStats(torch.autograd.Function):
    """(sum, sum of squares) of x per channel, float32, with the gradient gx = g_sum + 2 x g_sumsq in x's dtype."""

    @staticmethod
    def forward(ctx, x):
        if x.is_cuda:
            s, q = cuda_bnstats.bn_stats_cuda(x)
        elif x.device.type == "cpu":
            s, q = bn_stats_reference(x)
        else:
            raise ValueError(f"bn_stats runs on cuda or cpu tensors, got {x.device}")
        ctx.save_for_backward(x)
        return s, q

    @staticmethod
    def backward(ctx, g_sum, g_sumsq):
        (x,) = ctx.saved_tensors
        # one pass: x is read in its dtype, the sum is formed in float32 and rounded once into x's dtype
        return torch.addcmul(g_sum[:, None, None], x, g_sumsq[:, None, None], value=2.0, out=torch.empty_like(x))


def bn_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum, sum of squares), each (C,): the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor."""
    return BNStats.apply(x)

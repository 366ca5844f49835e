"""Stride-2 convolution whose backward is the hand-written CUDA kernel (`csrc/s2_bwd.cu`).

Counterpart of `drone_yolo_tpu/ops/conv_s2.py` (`conv2d_s2` and its custom VJP)
and of the Pallas kernel behind it, `drone_yolo_tpu/ops/pallas_s2bwd.py:s2_bwd`.
The forward is the stock `F.conv2d`; the backward computes (dx, dw) in one call:
on a CUDA tensor with the kernel (`ops/cuda_s2bwd.py`), on a CPU tensor with its
plain version `s2_bwd_reference` below.

It covers the sites the Pallas kernel covers (`covers`): dense (groups == 1),
stride 2, dilation 1, k=3 p=1 or k=1 p=0, even input height and width. A model
routes exactly those sites here when it is built or set with `s2grad="cuda"`
(`nn/modules.py:conv_forward`); every other conv, and every conv by default, keeps stock
autograd (cuDNN on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from drone_yolo_tpu_torch.ops import cuda_s2bwd

KINDS = cuda_s2bwd.KINDS  # kernel size -> padding


def covers(conv: nn.Conv2d, x: torch.Tensor) -> bool:
    """Whether `conv` applied to `x` is a site of the stride-2 backward: dense, stride 2, dilation 1,
    k=3 p=1 or k=1 p=0, even H and W."""
    k, p = conv.kernel_size, conv.padding
    return (conv.stride == (2, 2) and conv.dilation == (1, 1) and conv.groups == 1 and k[0] == k[1]
            and p[0] == p[1] and KINDS.get(k[0]) == p[0] and conv.bias is None
            and x.shape[-2] % 2 == 0 and x.shape[-1] % 2 == 0)


def s2_bwd_reference(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, k: int, need_dx: bool = True):
    """Plain (dx, dw) of `conv2d(x, w, stride=2, padding=KINDS[k])`, with float32 sums (float64 for float64 inputs).

    dw: for each tap (ky, kx), the strided slice of the padded x against dy, summed over
    (B, Ho, Wo). dx: per output-parity class, the sum over its taps of dy (shifted by the tap's
    offset, zero past the end) against the tap's kernel slice, cast once to x's dtype.
    """
    p = KINDS[k]
    b, ci, h, wd = x.shape
    ho, wo = dy.shape[2:]
    wide = torch.promote_types(x.dtype, torch.float32)
    xf, wf, dyf = x.to(wide), w.to(wide), dy.to(wide)
    xp = F.pad(xf, (p, p, p, p))
    dw = torch.stack([torch.stack([
        torch.einsum("bchw,bohw->oc", xp[:, :, ky:ky + 2 * ho - 1:2, kx:kx + 2 * wo - 1:2], dyf)
        for kx in range(k)], -1) for ky in range(k)], -2)
    if not need_dx:
        return None, dw
    dyp = F.pad(dyf, (0, 1, 0, 1))  # offsets are 0 or +1: reads past the end are zeros
    dx = xf.new_zeros((b, ci, h, wd))
    for py in (0, 1):
        for px in (0, 1):
            for ky, oy in cuda_s2bwd.parity_taps(k, py):
                for kx, ox in cuda_s2bwd.parity_taps(k, px):
                    dx[:, :, py::2, px::2] += torch.einsum("bohw,oc->bchw", dyp[:, :, oy:oy + ho, ox:ox + wo], wf[:, :, ky, kx])
    return dx.to(x.dtype), dw


def s2_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, k: int, need_dx: bool = True):
    """(dx, dw): the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return cuda_s2bwd.s2_bwd_cuda(x, w, dy, k, need_dx)
    if x.device.type != "cpu":
        raise ValueError(f"s2_bwd runs on cuda or cpu tensors, got {x.device}")
    return s2_bwd_reference(x, w, dy, k, need_dx)


class Conv2dS2(torch.autograd.Function):
    """`F.conv2d(x, w, stride=2, padding=p)` with (dx, dw) from `s2_bwd`.

    Under autocast the forward casts x and the float32 master w to the autocast dtype, as the
    stock conv does, and saves those casts: the backward sees bf16 x, w and dy. dw comes back in
    the master's dtype (float32 sums, no bf16 round trip); dx in x's dtype, and only when x needs it.
    """

    @staticmethod
    def forward(ctx, x, w, p: int):
        dev = x.device.type
        dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype
        xc, wc = x.to(dtype), w.to(dtype)
        ctx.save_for_backward(xc, wc)
        ctx.x_dtype, ctx.w_dtype = x.dtype, w.dtype
        return F.conv2d(xc, wc, None, 2, p)

    @staticmethod
    def backward(ctx, dy):
        xc, wc = ctx.saved_tensors
        dx, dw = s2_bwd(xc, wc, dy.to(xc.dtype), wc.shape[-1], need_dx=ctx.needs_input_grad[0])
        return (None if dx is None else dx.to(ctx.x_dtype)), dw.to(ctx.w_dtype), None


def conv2d_s2(x: torch.Tensor, w: torch.Tensor, p: int) -> torch.Tensor:
    """Stride-2 conv, stock forward, backward through `s2_bwd`."""
    return Conv2dS2.apply(x, w, p)

"""The v8 module set of the Drone-YOLO flagship as PyTorch modules (NCHW, OIHW).

Counterpart of `drone_yolo_tpu/nn/modules.py`. Parameter names follow the
reference torch `state_dict` (`conv.weight`, `bn.running_mean`, `rbr_dense`, ...),
so `drone_yolo_tpu/utils/torch_convert.py:convert_state_dict` reads them. The JAX
package's `Conv2dRaw` (the head's output layers) is `nn.Conv2d` here, and its
`max_pool2d` is `F.max_pool2d`, whose padding never wins the max either.

Precision follows the JAX package: activations flow in the parameters' dtype
(bfloat16 on the card after `fuse()` and a cast), BatchNorm runs in float32 and
the detection decode (DFL expectation, anchors, sigmoid) in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from drone_yolo_tpu_torch.ops.anchors import dist2bbox, make_anchors

BN_EPS = 1e-3  # reference initialize_weights sets BatchNorm2d eps=1e-3


def autopad(k: int, p: int | None = None, d: int = 1) -> int:
    """'same' padding for an odd kernel."""
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2 if p is None else p


def bn_fold(bn: BatchNorm2d, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BN into an OIHW kernel: returns (scaled kernel, bias)."""
    inv = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    return w * inv[:, None, None, None], bn.bias - bn.running_mean * inv


class BatchNorm2d(nn.Module):
    """Eval-form BatchNorm over NCHW in float32: (x - mean) * rsqrt(var + eps) * weight + bias.

    Holds exactly the four tensors the JAX package keeps (`scale, bias, mean,
    var`), under the torch names. Train-mode batch statistics belong to the
    train slice and are not ported yet.
    """

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("train-mode BatchNorm is not ported yet; call .eval()")
        inv = torch.rsqrt(self.running_var.float() + BN_EPS) * self.weight.float()
        y = (x.float() - self.running_mean.float()[:, None, None]) * inv[:, None, None] + self.bias.float()[:, None, None]
        return y.to(x.dtype)


class Conv(nn.Module):
    """Conv2d + BN + SiLU; after `fuse()` a conv with bias + SiLU."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, d=1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
        self.bn = BatchNorm2d(c2)
        self.act = act

    def forward(self, x):
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y)
        return F.silu(y) if self.act else y

    @torch.no_grad()
    def fuse(self) -> None:
        if self.bn is None:
            return
        w, b = bn_fold(self.bn, self.conv.weight)
        conv = self.conv
        fused = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride, conv.padding,
                          dilation=conv.dilation, groups=conv.groups, bias=True, device=w.device, dtype=w.dtype)
        fused.weight.copy_(w)
        fused.bias.copy_(b)
        self.conv, self.bn = fused, None


class DWConv(Conv):
    """Depth-wise conv: groups = gcd(c1, c2)."""

    def __init__(self, c1, c2, k=1, s=1, d=1, act=True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), d=d, act=act)


class Concat(nn.Module):
    """Concatenate along channels."""

    def __init__(self, dim=1):
        super().__init__()
        self.dim = dim

    def forward(self, xs):
        return torch.cat(xs, self.dim)


class Upsample(nn.Module):
    """Nearest-neighbour upsample by an integer factor."""

    def __init__(self, size=None, scale_factor=2, mode="nearest"):
        super().__init__()
        if mode != "nearest" or size is not None:
            raise ValueError(f"only scale_factor nearest upsampling is supported, got size={size} mode={mode}")
        self.scale = int(scale_factor)

    def forward(self, x):
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")


class Bottleneck(nn.Module):
    """Standard bottleneck."""

    def __init__(self, c1, c2, shortcut=True, g=1, k=(3, 3), e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck with 2 convs, the v8 workhorse."""

    def __init__(self, c1, c2, n=1, shortcut=False, g=1, e=0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0) for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast."""

    def __init__(self, c1, c2, k=5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.k = k

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(y, 1))


class RepVGGBlock(nn.Module):
    """3x3 + 1x1 (+ identity BN) branches, summed, then SiLU; `fuse()` collapses them into one 3x3 conv."""

    def __init__(self, c1, c2, k=3, s=1):
        super().__init__()
        if k != 3:
            raise ValueError(f"RepVGGBlock is a 3x3 block, got k={k}")
        self.c1, self.c2, self.s = c1, c2, s
        self.rbr_dense = Conv(c1, c2, 3, s, 1, act=False)
        self.rbr_1x1 = Conv(c1, c2, 1, s, 0, act=False)
        self.rbr_identity = BatchNorm2d(c1) if (c1 == c2 and s == 1) else None
        self.rbr_reparam = None

    def forward(self, x):
        if self.rbr_reparam is not None:
            return F.silu(self.rbr_reparam(x))
        y = self.rbr_dense(x) + self.rbr_1x1(x)
        if self.rbr_identity is not None:
            y = y + self.rbr_identity(x)
        return F.silu(y)

    @torch.no_grad()
    def fuse(self) -> None:
        """Fold each branch's BN, pad the 1x1 to 3x3, add identity as a centred delta kernel."""
        if self.rbr_reparam is not None:
            return
        w3, b3 = bn_fold(self.rbr_dense.bn, self.rbr_dense.conv.weight)
        w1, b1 = bn_fold(self.rbr_1x1.bn, self.rbr_1x1.conv.weight)
        w, b = w3 + F.pad(w1, (1, 1, 1, 1)), b3 + b1
        if self.rbr_identity is not None:
            ident = torch.zeros_like(w3)
            ident[torch.arange(self.c2), torch.arange(self.c2), 1, 1] = 1.0
            wid, bid = bn_fold(self.rbr_identity, ident)
            w, b = w + wid, b + bid
        self.rbr_reparam = nn.Conv2d(self.c1, self.c2, 3, self.s, 1, bias=True, device=w.device, dtype=w.dtype)
        self.rbr_reparam.weight.copy_(w)
        self.rbr_reparam.bias.copy_(b)
        self.rbr_dense = self.rbr_1x1 = self.rbr_identity = None


def dfl_expectation(box_logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """(..., 4 * reg_max) logits -> (..., 4) expected distances: softmax . arange in float32."""
    x = box_logits.float().unflatten(-1, (4, reg_max))
    return x.softmax(-1) @ torch.arange(reg_max, dtype=torch.float32, device=x.device)


class Detect(nn.Module):
    """Anchor-free decoupled detection head.

    Per level: box branch `cv2` -> 4*reg_max DFL logits, class branch `cv3` -> nc
    logits. `raw_maps` gives the per-level (B, 4*reg_max + nc, H, W) maps;
    `decode` gives (B, A, 4 + nc): xywh pixel boxes and sigmoid scores.
    """

    def __init__(self, nc=80, ch=(), reg_max=16):
        super().__init__()
        self.nc = nc
        self.reg_max = reg_max
        self.stride = [8, 16, 32] if len(ch) == 3 else [4, 8, 16, 32][: len(ch)]  # set by the model's stride probe
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1)) for x in ch)
        self.cv3 = nn.ModuleList(nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), nn.Conv2d(c3, nc, 1)) for x in ch)

    @torch.no_grad()
    def bias_init(self, imgsz: int = 640) -> None:
        """Prior-probability bias init: box logits 1, class logits log(5 / nc / (imgsz / s)^2)."""
        for box, cls, s in zip(self.cv2, self.cv3, self.stride):
            box[-1].bias.fill_(1.0)
            cls[-1].bias.fill_(math.log(5 / self.nc / (imgsz / s) ** 2))

    def raw_maps(self, xs):
        return [torch.cat((box(x), cls(x)), 1) for box, cls, x in zip(self.cv2, self.cv3, xs)]

    def decode(self, maps):
        feat_shapes = [m.shape[2:] for m in maps]
        anchors, strides = make_anchors(feat_shapes, self.stride, device=maps[0].device)
        flat = torch.cat([m.flatten(2) for m in maps], 2).transpose(1, 2)  # (B, A, no)
        box_logits, cls_logits = flat[..., : 4 * self.reg_max], flat[..., 4 * self.reg_max :]
        dist = dfl_expectation(box_logits, self.reg_max)
        dbox = dist2bbox(dist, anchors[None]) * strides[None]
        return torch.cat((dbox, cls_logits.float().sigmoid()), -1)

    def forward(self, xs):
        maps = self.raw_maps(xs)
        return self.decode(maps), maps

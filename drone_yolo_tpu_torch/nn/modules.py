"""The module sets of the v3, v5, v6, v8 (P2, P6, Ghost), v9 (GELAN), v10, YOLO11 and YOLO12 families and of the
classifiers as PyTorch modules (NCHW, OIHW).

Counterpart of `drone_yolo_tpu/nn/modules.py`. Parameter names follow the
reference torch `state_dict` (`conv.weight`, `bn.running_mean`, `rbr_dense`, ...),
so `drone_yolo_tpu/utils/torch_convert.py:convert_state_dict` reads them. The JAX
package's `Conv2dRaw` (the head's output layers, CBLinear's conv) is `nn.Conv2d` here, its `ConvTranspose2dRaw`
`nn.ConvTranspose2d`, its `Identity`, `MaxPool2d` and `ZeroPad2d` torch's, its `_Seq` and `_RepeatSeq`
`nn.Sequential`, and its `max_pool2d` is `F.max_pool2d`, whose padding never wins the max either.

Precision follows the JAX package: activations flow in the parameters' dtype
(bfloat16 on the card after `fuse()` and a cast, or under bf16 autocast in
training), BatchNorm runs in float32 and the detection decode (DFL expectation,
anchors, sigmoid) in float32. The attention blocks take their logits and softmax in
float32 with autocast off (`attention_softmax`), and `Classify` its pool and linear, as the
JAX package does. The classifiers' trunks: `ResNetLayer` (the JAX package's names, `stem`,
`blocks`, `short`) and `TorchVision` (a native ResNet-18/34 under the reference's
torchvision names).

Train mode: BatchNorm normalizes with batch statistics and hands them to the
collector of `collect_bn_stats` (the JAX package's `Ctx.updates`); the running
statistics change only in `DetectionModel.merge_bn_updates`. A `Conv` whose
`s2grad` is "cuda" routes its stride-2 sites (`ops.conv_s2.covers`) through
`ops.conv_s2.conv2d_s2`, whose backward is the hand-written CUDA kernel (so does a
`BasicBlock`, whose convs are plain `nn.Conv2d` under torchvision's names). A
`BatchNorm2d` whose `bnstats` is "cuda" takes its batch sums from
`ops.bn_stats.bn_stats`, whose forward is the hand-written CUDA kernel.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import math
import warnings

import torch
import torch.nn.functional as F
from torch import nn

from drone_yolo_tpu_torch.ops.anchors import dist2bbox, dist2rbox, make_anchors
from drone_yolo_tpu_torch.ops.bn_stats import BNSTATS_MODES, bn_stats, bn_stats_reference
from drone_yolo_tpu_torch.ops.boxes import xywh2xyxy
from drone_yolo_tpu_torch.ops.conv_s2 import conv2d_s2, covers

BN_EPS = 1e-3  # reference initialize_weights sets BatchNorm2d eps=1e-3
BN_MOMENTUM = 0.03  # reference: momentum=0.03; new = (1 - m) * old + m * batch
S2GRAD_MODES = (None, "cuda")

_BN_STATS: contextvars.ContextVar[dict | None] = contextvars.ContextVar("bn_stats", default=None)


@contextlib.contextmanager
def collect_bn_stats():
    """Collect the batch statistics of train-mode BatchNorms: yields {module: (mean, var)}, float32, detached."""
    stats: dict = {}
    token = _BN_STATS.set(stats)
    try:
        yield stats
    finally:
        _BN_STATS.reset(token)


def wide(t: torch.Tensor) -> torch.Tensor:
    """`t` in float32, the precision of BN and of the decode and loss, or wider if it is (a float64 check)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


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
    """BatchNorm over NCHW in float32: (x - mean) * rsqrt(var + eps) * weight + bias.

    Holds exactly the four tensors the JAX package keeps (`scale, bias, mean,
    var`), under the torch names. Eval mode uses the running statistics. Train
    mode (`_bn_apply` of the JAX package) uses the batch's: two independent float32
    sums over N, H and W, and the biased one-pass variance max(E[x^2] - E[x]^2, 0),
    which also goes to the running update. They are handed to `collect_bn_stats`;
    the forward writes no buffer. The sums are the stock reductions
    (`bn_stats_reference`), or with `bnstats="cuda"` the `bn_stats` Function.
    """

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.bnstats = None

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = wide(x)
        if self.training:
            stats = _BN_STATS.get()
            if stats is None:
                raise RuntimeError("train-mode BatchNorm runs under collect_bn_stats(), which receives its batch statistics")
            n = x.numel() // x.shape[1]
            s1, s2 = bn_stats(x) if self.bnstats == "cuda" else bn_stats_reference(xf)
            mean = s1 / n
            var = (s2 / n - mean.square()).clamp(min=0.0)
            stats[self] = (mean.detach(), var.detach())
        else:
            mean, var = wide(self.running_mean), wide(self.running_var)
        inv = torch.rsqrt(var + BN_EPS) * wide(self.weight)
        y = (xf - mean[:, None, None]) * inv[:, None, None] + wide(self.bias)[:, None, None]
        return y.to(x.dtype)


@torch.no_grad()
def fuse_conv_bn(conv: nn.Conv2d, bn: BatchNorm2d) -> nn.Conv2d:
    """A conv with bias that computes bn(conv(x)) in eval mode."""
    w, b = bn_fold(bn, conv.weight)
    fused = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride, conv.padding,
                      dilation=conv.dilation, groups=conv.groups, bias=True, device=w.device, dtype=w.dtype)
    fused.weight.copy_(w)
    fused.bias.copy_(b)
    return fused


def conv_forward(mod: nn.Conv2d, x: torch.Tensor, s2grad: str | None) -> torch.Tensor:
    """`mod(x)`; with s2grad="cuda" a site that `covers` accepts runs `conv2d_s2` (stock forward, kernel backward)."""
    if s2grad == "cuda" and covers(mod, x):
        return conv2d_s2(x, mod.weight, mod.padding[0])
    return mod(x)


ACTIVATIONS = {True: F.silu, "relu": F.relu}  # a Conv's `act`: True is the default, SiLU; False is none


class Conv(nn.Module):
    """Conv2d + BN + activation; after `fuse()` a conv with bias + activation. `act` is True (SiLU), "relu" (a yaml's
    `activation:` ReLU, set by the build) or False. `s2grad` picks the backward of its stride-2 sites."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, d=1, act=True):
        super().__init__()
        if act not in (False, *ACTIVATIONS):
            raise ValueError(f"Conv activation {act!r} is not ported; True (SiLU), 'relu' and False are")
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
        self.bn = BatchNorm2d(c2)
        self.act = act
        self.s2grad = None

    def forward(self, x):
        y = conv_forward(self.conv, x, self.s2grad)
        if self.bn is not None:
            y = self.bn(y)
        return ACTIVATIONS[self.act](y) if self.act else y

    def fuse(self) -> None:
        if self.bn is not None:
            self.conv, self.bn = fuse_conv_bn(self.conv, self.bn), None


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


class C3(nn.Module):
    """CSP bottleneck with 3 convs: cv3(cat(m(cv1(x)), cv2(x)))."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, k=(1, 3), e=1.0) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))


class C2(nn.Module):
    """CSP bottleneck with 2 convs: cv2(cat(m(a), b)) for the halves a, b of cv1(x)."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0) for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, 1)
        return self.cv2(torch.cat((self.m(a), b), 1))


class SPP(nn.Module):
    """Spatial pyramid pooling: cv1, then max pools of each size in `k` (stride 1, same size) beside it, into cv2."""

    def __init__(self, c1, c2, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * (len(k) + 1), c2, 1, 1)
        self.k = tuple(k)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [F.max_pool2d(x, k, 1, k // 2) for k in self.k], 1))


class GhostConv(nn.Module):
    """Ghost convolution: a primary Conv `cv1` to half the width, then a 5x5 depthwise Conv `cv2` of it beside it."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, None, g, act=act)
        self.cv2 = Conv(c_, c_, 5, 1, None, c_, act=act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat((y, self.cv2(y)), 1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck under the reference's torch names: `conv` is GhostConv, (with s=2) a depthwise k x k stride-2
    DWConv, GhostConv without activation; with s=2 `shortcut` is DWConv then a 1x1 Conv, added to the path, else the
    input is added when the widths agree (the JAX package's `g1`, `dw`, `g2`, `sc_dw`, `sc_pw`)."""

    def __init__(self, c1, c2, k=3, s=1):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(GhostConv(c1, c_, 1, 1), DWConv(c_, c_, k, s, act=False) if s == 2 else nn.Identity(),
                                  GhostConv(c_, c2, 1, 1, act=False))
        self.shortcut = (nn.Sequential(DWConv(c1, c1, k, s, act=False), Conv(c1, c2, 1, 1, act=False)) if s == 2
                         else None)
        self.add = s == 1 and c1 == c2

    def forward(self, x):
        y = self.conv(x)
        if self.shortcut is not None:
            return y + self.shortcut(x)
        return x + y if self.add else y


class C3k(C3):
    """C3 whose bottlenecks are k x k on both convs."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, k=3):
        super().__init__(c1, c2, n, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, k=(k, k), e=1.0) for _ in range(n)))


class C3k2(C2f):
    """The YOLO11 workhorse: a C2f whose blocks are C3k(c, c, 2) with `c3k`, else Bottleneck(e=0.5)."""

    def __init__(self, c1, c2, n=1, c3k=False, e=0.5, g=1, shortcut=True):
        super().__init__(c1, c2, n, shortcut, g, e)
        c = self.c
        self.m = nn.ModuleList(C3k(c, c, 2, shortcut, g) if c3k else Bottleneck(c, c, shortcut, g, e=0.5) for _ in range(n))


class C3Ghost(C3):
    """C3 whose blocks are GhostBottlenecks."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = nn.Sequential(*(GhostBottleneck(c_, c_) for _ in range(n)))


def float32_region(device_type: str):
    """A region with autocast off on devices that have it (not the meta device of the stride probe)."""
    usable = torch.amp.autocast_mode.is_autocast_available(device_type)
    return torch.autocast(device_type, enabled=False) if usable else contextlib.nullcontext()


def attention_softmax(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q^T k * scale) over the keys, in float32 (or wider) with autocast off: (..., d, N) x 2 -> (..., N, N).

    As the JAX package's attention: the logits and the softmax are float32 whatever the compute dtype; the
    caller casts the weights to it before the product with v. Autocast would otherwise take the matmul to bfloat16.
    """
    with float32_region(q.device.type):
        return ((wide(q).transpose(-2, -1) @ wide(k)) * scale).softmax(-1)


class Attention(nn.Module):
    """Multi-head self-attention over the H*W positions, plus a depthwise 3x3 positional conv `pe` on v.

    The qkv channels are grouped per head as [q (key_dim), k (key_dim), v (head_dim)].
    """

    def __init__(self, dim, num_heads=8, attn_ratio=0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim**-0.5
        self.qkv = Conv(dim, dim + 2 * self.key_dim * num_heads, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        qkv = self.qkv(x).reshape(b, self.num_heads, 2 * self.key_dim + self.head_dim, h * w)
        q, k, v = qkv.split([self.key_dim, self.key_dim, self.head_dim], dim=2)
        attn = attention_softmax(q, k, self.scale).to(v.dtype)
        out = (v @ attn.transpose(-2, -1)).reshape(b, c, h, w)
        return self.proj(out + self.pe(v.reshape(b, c, h, w)))


class PSABlock(nn.Module):
    """Attention, then the feed-forward `ffn` (Conv 1x1 SiLU -> Conv 1x1), each with a residual when `shortcut`."""

    def __init__(self, c, attn_ratio=0.5, num_heads=4, shortcut=True):
        super().__init__()
        self.attn = Attention(c, num_heads=num_heads, attn_ratio=attn_ratio)
        self.ffn = nn.Sequential(Conv(c, c * 2, 1), Conv(c * 2, c, 1, act=False))
        self.add = shortcut

    def forward(self, x):
        y = self.attn(x)
        x = x + y if self.add else y
        y = self.ffn(x)
        return x + y if self.add else y


class C2PSA(nn.Module):
    """CSP block around n PSABlocks on half the channels (YOLO11's last backbone layer)."""

    def __init__(self, c1, c2, n=1, e=0.5):
        super().__init__()
        if c1 != c2:
            raise ValueError(f"C2PSA keeps its width, got c1={c1} c2={c2}")
        self.c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c1, 1)
        self.m = nn.ModuleList(PSABlock(self.c, attn_ratio=0.5, num_heads=max(self.c // 64, 1)) for _ in range(n))

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, 1)
        for m in self.m:
            b = m(b)
        return self.cv2(torch.cat((a, b), 1))


class AAttn(nn.Module):
    """Area attention: full attention within `area` horizontal stripes of the map, plus a depthwise 7x7 `pe` on v.

    The stripes split the row-major H*W positions into `area` equal runs. As in the JAX package, a map whose
    H*W does not divide by `area` is attended whole (area 1).
    """

    def __init__(self, dim, num_heads, area=1):
        super().__init__()
        self.nh, self.area = num_heads, area
        self.hd = dim // num_heads
        self.qkv = Conv(dim, dim * 3, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 7, 1, 3, g=dim, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        n = h * w
        area = self.area if self.area > 1 and n % self.area == 0 else 1
        qkv = self.qkv(x).flatten(2).transpose(1, 2).reshape(b * area, n // area, self.nh, 3 * self.hd)
        q, k, v = qkv.permute(0, 2, 3, 1).split([self.hd] * 3, dim=2)  # each (B * area, nh, hd, N / area)
        attn = attention_softmax(q, k, self.hd**-0.5).to(v.dtype)
        out = v @ attn.transpose(-2, -1)

        def to_map(t):  # (B * area, nh, hd, N / area) -> (B, C, H, W)
            return t.permute(0, 3, 1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)

        return self.proj(to_map(out) + self.pe(to_map(v)))


class ABlock(nn.Module):
    """Area attention, then the MLP `mlp` (Conv 1x1 SiLU to dim * mlp_ratio -> Conv 1x1), both residual."""

    def __init__(self, dim, num_heads, mlp_ratio=1.2, area=1):
        super().__init__()
        self.attn = AAttn(dim, num_heads=num_heads, area=area)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(Conv(dim, hidden, 1), Conv(hidden, dim, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    """The YOLO12 workhorse (R-ELAN): cv1, then n blocks each fed the last output, all concatenated into cv2.

    With `a2` each block is a sequence of two ABlocks (heads = width / 32), else a C3k. With `a2` and `residual`
    the output is x + gamma * cv2(...), `gamma` a learned per-channel scale that starts at 0.01.
    """

    def __init__(self, c1, c2, n=1, a2=True, area=1, residual=False, mlp_ratio=2.0, e=0.5, g=1, shortcut=True):
        super().__init__()
        c_ = int(c2 * e)
        if c_ % 32:
            raise ValueError(f"A2C2f's ABlock width must be a multiple of 32, got {c_}")
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv((1 + n) * c_, c2, 1)
        self.gamma = nn.Parameter(torch.full((c2,), 0.01)) if a2 and residual else None
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock(c_, c_ // 32, mlp_ratio, area) for _ in range(2))) if a2
            else C3k(c_, c_, 2, shortcut, g) for _ in range(n))

    def forward(self, x):
        y = [self.cv1(x)]
        for m in self.m:
            y.append(m(y[-1]))
        out = self.cv2(torch.cat(y, 1))
        return out if self.gamma is None else x + self.gamma.to(out.dtype)[:, None, None] * out


class PSA(nn.Module):
    """YOLOv10's partial self-attention: of the halves a, b of cv1(x), b goes through `attn` and the feed-forward `ffn`,
    each residual, and cv2 takes both back to the input width."""

    def __init__(self, c1, c2, e=0.5):
        super().__init__()
        if c1 != c2:
            raise ValueError(f"PSA keeps its width, got c1={c1} c2={c2}")
        self.c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c1, 1)
        self.attn = Attention(self.c, attn_ratio=0.5, num_heads=max(self.c // 64, 1))
        self.ffn = nn.Sequential(Conv(self.c, self.c * 2, 1), Conv(self.c * 2, self.c, 1, act=False))

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, 1)
        b = b + self.attn(b)
        b = b + self.ffn(b)
        return self.cv2(torch.cat((a, b), 1))


class SCDown(nn.Module):
    """YOLOv10's separable downsample: a 1x1 Conv, then a k x k stride-s depthwise Conv without activation (a depthwise
    conv: not a stride-2 kernel site)."""

    def __init__(self, c1, c2, k=3, s=2):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, k, s, g=c2, act=False)

    def forward(self, x):
        return self.cv2(self.cv1(x))


class CIB(nn.Module):
    """YOLOv10's conditional identity block: the sequence `cv1` of a 3x3 depthwise Conv, a 1x1 Conv to 2 c_, a 3x3
    depthwise Conv (a RepVGGDW with `lk`), a 1x1 Conv to c2 and a 3x3 depthwise Conv; the input is added when
    `shortcut` and the widths agree."""

    def __init__(self, c1, c2, shortcut=True, e=0.5, lk=False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = nn.Sequential(Conv(c1, c1, 3, g=c1), Conv(c1, 2 * c_, 1),
                                 RepVGGDW(2 * c_) if lk else Conv(2 * c_, 2 * c_, 3, g=2 * c_),
                                 Conv(2 * c_, c2, 1), Conv(c2, c2, 3, g=c2))
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv1(x)
        return x + y if self.add else y


class C2fCIB(C2f):
    """C2f whose blocks are CIB(c, c, shortcut, e=1.0, lk)."""

    def __init__(self, c1, c2, n=1, shortcut=False, lk=False, g=1, e=0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        self.m = nn.ModuleList(CIB(self.c, self.c, shortcut, e=1.0, lk=lk) for _ in range(n))


def fold_rep_branches(big: Conv, small: Conv) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel and bias of bn(big(x)) + bn(small(x)) in eval mode: each BN folded, the smaller kernel (a 1x1 into a
    3x3, a 3x3 into a 7x7) padded into the larger's centre."""
    wb, bb = bn_fold(big.bn, big.conv.weight)
    ws, bs = bn_fold(small.bn, small.conv.weight)
    p = (wb.shape[-1] - ws.shape[-1]) // 2
    return wb + F.pad(ws, (p, p, p, p)), bb + bs


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
        w, b = fold_rep_branches(self.rbr_dense, self.rbr_1x1)
        if self.rbr_identity is not None:
            ident = torch.zeros_like(w)
            ident[torch.arange(self.c2), torch.arange(self.c2), 1, 1] = 1.0
            wid, bid = bn_fold(self.rbr_identity, ident)
            w, b = w + wid, b + bid
        self.rbr_reparam = nn.Conv2d(self.c1, self.c2, 3, self.s, 1, bias=True, device=w.device, dtype=w.dtype)
        self.rbr_reparam.weight.copy_(w)
        self.rbr_reparam.bias.copy_(b)
        self.rbr_dense = self.rbr_1x1 = self.rbr_identity = None


class RepConv(nn.Module):
    """YOLOv9's re-parameterisable conv: a 3x3 Conv `conv1` and a 1x1 Conv `conv2` (each with BN, no activation)
    summed, then SiLU (`act` True) or nothing; `fuse()` collapses them into one 3x3 conv held as the block's own
    `weight` and `bias` (the JAX package's fused `kernel` and `bias`). The identity branch of `bn=True` is refused: no
    model yaml builds it."""

    def __init__(self, c1, c2, k=3, s=1, p=1, g=1, d=1, act=True, bn=False):
        super().__init__()
        if k != 3 or p != 1 or d != 1:
            raise ValueError(f"RepConv is a 3x3 block with padding 1, got k={k} p={p} d={d}")
        if bn:
            raise NotImplementedError("RepConv(bn=True), the identity branch, is not ported")
        self.s, self.g, self.act = s, g, act
        self.conv1 = Conv(c1, c2, 3, s, p=p, g=g, act=False)
        self.conv2 = Conv(c1, c2, 1, s, p=p - 1, g=g, act=False)
        self.register_parameter("weight", None)
        self.register_parameter("bias", None)

    def forward(self, x):
        if self.weight is not None:
            y = F.conv2d(x, self.weight, self.bias, self.s, 1, 1, self.g)
        else:
            y = self.conv1(x) + self.conv2(x)
        return F.silu(y) if self.act is True else y

    @torch.no_grad()
    def fuse(self) -> None:
        if self.weight is None:
            w, b = fold_rep_branches(self.conv1, self.conv2)
            self.weight, self.bias = nn.Parameter(w), nn.Parameter(b)
            self.conv1 = self.conv2 = None


class RepVGGDW(nn.Module):
    """YOLOv10's depthwise RepVGG block: a 7x7 depthwise Conv `conv` and a 3x3 one `conv1` (each with BN, no
    activation) summed, then SiLU; `fuse()` collapses them into one 7x7 depthwise conv held as the block's own
    `weight` and `bias` (the JAX package's fused `kernel` and `bias`), the 3x3 padded by 2."""

    def __init__(self, c):
        super().__init__()
        self.c = c
        self.conv = DWConv(c, c, 7, 1, act=False)
        self.conv1 = DWConv(c, c, 3, 1, act=False)
        self.register_parameter("weight", None)
        self.register_parameter("bias", None)

    def forward(self, x):
        if self.weight is not None:
            return F.silu(F.conv2d(x, self.weight, self.bias, 1, 3, 1, self.c))
        return F.silu(self.conv(x) + self.conv1(x))

    @torch.no_grad()
    def fuse(self) -> None:
        if self.weight is None:
            w, b = fold_rep_branches(self.conv, self.conv1)
            self.weight, self.bias = nn.Parameter(w), nn.Parameter(b)
            self.conv = self.conv1 = None


class RepBottleneck(Bottleneck):
    """Bottleneck whose first conv is a RepConv."""

    def __init__(self, c1, c2, shortcut=True, g=1, k=(3, 3), e=0.5):
        super().__init__(c1, c2, shortcut, g, k, e)
        self.cv1 = RepConv(c1, int(c2 * e), k[0], 1)


class RepCSP(C3):
    """C3 whose blocks are RepBottlenecks."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = nn.Sequential(*(RepBottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)))


class RepNCSPELAN4(nn.Module):
    """YOLOv9's GELAN block: the halves of cv1(x), then cv2 (RepCSP, 3x3 Conv) of the second half and cv3 (the same)
    of that, all four concatenated into cv4. cv2 and cv3 are sequences (the JAX package's `_Seq`)."""

    def __init__(self, c1, c2, c3, c4, n=1):
        super().__init__()
        self.c = c3 // 2
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv2 = nn.Sequential(RepCSP(c3 // 2, c4, n), Conv(c4, c4, 3, 1))
        self.cv3 = nn.Sequential(RepCSP(c4, c4, n), Conv(c4, c4, 3, 1))
        self.cv4 = Conv(c3 + 2 * c4, c2, 1, 1)

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        y.append(self.cv2(y[-1]))
        y.append(self.cv3(y[-1]))
        return self.cv4(torch.cat(y, 1))


class ELAN1(RepNCSPELAN4):
    """RepNCSPELAN4 with a plain 3x3 Conv for cv2 and for cv3 (yolov9t's and -s's first block)."""

    def __init__(self, c1, c2, c3, c4):
        super().__init__(c1, c2, c3, c4)
        self.cv2 = Conv(c3 // 2, c4, 3, 1)
        self.cv3 = Conv(c4, c4, 3, 1)


def avg_pool2d_2x1(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean at stride 1, no padding (H-1 x W-1 out), summed in float32 (or wider) and cast back."""
    return F.avg_pool2d(wide(x), 2, 1, 0).to(x.dtype)


class AConv(nn.Module):
    """Downsample: a 2x2 mean at stride 1, then a 3x3 stride-2 Conv (on an odd map: not a stride-2 kernel site)."""

    def __init__(self, c1, c2):
        super().__init__()
        self.cv1 = Conv(c1, c2, 3, 2, 1)

    def forward(self, x):
        return self.cv1(avg_pool2d_2x1(x))


class ADown(nn.Module):
    """Downsample: a 2x2 mean at stride 1, then of its halves a 3x3 stride-2 Conv `cv1` and a 3x3 stride-2 max pool
    (pad 1) with a 1x1 Conv `cv2`, concatenated."""

    def __init__(self, c1, c2):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = Conv(c1 // 2, self.c, 3, 2, 1)
        self.cv2 = Conv(c1 // 2, self.c, 1, 1, 0)

    def forward(self, x):
        x1, x2 = avg_pool2d_2x1(x).chunk(2, 1)
        return torch.cat((self.cv1(x1), self.cv2(F.max_pool2d(x2, 3, 2, 1))), 1)


class SPPELAN(nn.Module):
    """SPP-ELAN: cv1, three chained k x k max pools (stride 1, same size), all four concatenated into cv5."""

    def __init__(self, c1, c2, c3, k=5):
        super().__init__()
        self.c = c3
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv5 = Conv(4 * c3, c2, 1, 1)
        self.k = k

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], self.k, 1, self.k // 2))
        return self.cv5(torch.cat(y, 1))


class CBLinear(nn.Module):
    """YOLOv9-E's projection: one conv with bias to sum(c2s) channels, split into a tuple of c2s widths."""

    def __init__(self, c1, c2s, k=1, s=1, p=None, g=1):
        super().__init__()
        self.c2s = list(c2s)
        self.conv = nn.Conv2d(c1, sum(self.c2s), k, s, autopad(k, p), groups=g, bias=True)

    def forward(self, x):
        return self.conv(x).split(self.c2s, 1)


class CBFuse(nn.Module):
    """YOLOv9-E's fusion: from each earlier CBLinear tuple its `idx[i]`-th map, resized to the last input's size by
    half-pixel nearest neighbour ("nearest-exact", as `jax.image.resize`), summed in order, plus the last input."""

    def __init__(self, idx):
        super().__init__()
        self.idx = list(idx)

    def forward(self, xs):
        size = xs[-1].shape[2:]
        outs = [F.interpolate(x[self.idx[i]], size=size, mode="nearest-exact") for i, x in enumerate(xs[:-1])]
        return sum(outs) + xs[-1]


def dfl_expectation(box_logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """(..., 4 * reg_max) logits -> (..., 4) expected distances: softmax . arange in float32."""
    x = wide(box_logits).unflatten(-1, (4, reg_max))
    return x.softmax(-1) @ torch.arange(reg_max, dtype=x.dtype, device=x.device)


class Detect(nn.Module):
    """Anchor-free decoupled detection head.

    Per level: box branch `cv2` -> 4*reg_max DFL logits, class branch `cv3` -> nc
    logits. `legacy=False` (the YOLO11 and YOLO12 heads) makes `cv3` two depthwise-separable
    stages, DWConv 3x3 then Conv 1x1, each a nested sequence. `raw_maps` gives the per-level
    (B, 4*reg_max + nc, H, W) maps;
    `decode` gives (B, A, 4 + nc): xywh pixel boxes and sigmoid scores.
    """

    def __init__(self, nc=80, ch=(), reg_max=16, legacy=True):
        super().__init__()
        self.nc = nc
        self.reg_max = reg_max
        self.stride = [8, 16, 32] if len(ch) == 3 else [4, 8, 16, 32][: len(ch)]  # set by the model's stride probe
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1)) for x in ch)
        if legacy:
            self.cv3 = nn.ModuleList(nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), nn.Conv2d(c3, nc, 1)) for x in ch)
        else:
            self.cv3 = nn.ModuleList(nn.Sequential(nn.Sequential(DWConv(x, x, 3), Conv(x, c3, 1)),
                                                   nn.Sequential(DWConv(c3, c3, 3), Conv(c3, c3, 1)),
                                                   nn.Conv2d(c3, nc, 1)) for x in ch)

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

    def train_out(self, xs):
        """The train-mode output the loss reads: the per-level maps, undecoded."""
        return self.raw_maps(xs)

    def forward(self, xs):
        maps = self.raw_maps(xs)
        return self.decode(maps), maps


class v10Detect(Detect):
    """YOLOv10's NMS-free end-to-end head: Detect with the depthwise class branch (the one-to-many head, trained with
    TAL's top 10) and a second pair of the same branches, `one2one_cv2` and `one2one_cv3` (the one-to-one head, TAL's
    top 1, the one served), which take the features detached, so that their loss moves no layer before the head.

    Counterpart of `drone_yolo_tpu/nn/modules.py` `v10Detect`. Train mode (`train_out`) gives {"one2many": maps,
    "one2one": maps}. Eval mode decodes the one-to-one maps and takes the top k = min(max_det, A) of the A * nc
    (anchor, class) scores, ties to the lower flat index as `jax.lax.top_k` (a stable descending sort): (dets (B, k,
    6): xyxy pixels, score, class, by score; {"one2one": maps}). No NMS follows.
    """

    max_det = 300

    def __init__(self, nc=80, ch=(), reg_max=16, legacy=False):
        super().__init__(nc, ch, reg_max, legacy=False)  # the head's `legacy` is the depthwise class branch always
        self.one2one_cv2 = copy.deepcopy(self.cv2)
        self.one2one_cv3 = copy.deepcopy(self.cv3)

    @torch.no_grad()
    def bias_init(self, imgsz: int = 640) -> None:
        """Detect's priors on both heads."""
        super().bias_init(imgsz)
        for box, cls, s in zip(self.one2one_cv2, self.one2one_cv3, self.stride):
            box[-1].bias.fill_(1.0)
            cls[-1].bias.fill_(math.log(5 / self.nc / (imgsz / s) ** 2))

    def one2one_maps(self, xs):
        """The one-to-one head's per-level (B, 4 * reg_max + nc, H, W) maps, on the features detached."""
        return [torch.cat((box(x), cls(x)), 1)
                for box, cls, x in zip(self.one2one_cv2, self.one2one_cv3, [x.detach() for x in xs])]

    def train_out(self, xs):
        one2one = self.one2one_maps(xs)
        return {"one2many": self.raw_maps(xs), "one2one": one2one}

    def forward(self, xs):
        one2one = self.one2one_maps(xs)
        preds = self.decode(one2one)  # (B, A, 4 + nc) xywh pixels and scores, float32
        b, a, _ = preds.shape
        k = min(self.max_det, a)
        top, idx = preds[..., 4:].reshape(b, -1).sort(dim=-1, descending=True, stable=True)
        top, idx = top[:, :k], idx[:, :k]
        boxes = preds[..., :4].gather(1, (idx // self.nc)[..., None].expand(-1, -1, 4))
        dets = torch.cat((xywh2xyxy(boxes), top[..., None], (idx % self.nc).to(top.dtype)[..., None]), -1)
        return dets, {"one2one": one2one}


class Pose(Detect):
    """Pose head: Detect plus a keypoint branch `cv4` -> nk = kpt_shape[0] * kpt_shape[1] values per anchor.

    Counterpart of `drone_yolo_tpu/nn/modules.py` `Pose`. `forward` gives (B, A, 4 + nc + nk): Detect's decoded
    predictions, then the keypoints decoded to pixels in float32, (x, y[, sigmoid visibility]) per keypoint; and
    (maps, raw keypoints (B, A, nk)). In train mode (`train_out`) it gives (maps, raw keypoints) undecoded, as the
    JAX head does, so the keypoint branch takes part in the loss. `cv4`'s last conv keeps its init (no prior), as in
    the JAX package.
    """

    def __init__(self, nc=80, kpt_shape=(17, 3), ch=(), reg_max=16, legacy=True):
        super().__init__(nc, ch, reg_max, legacy)
        self.kpt_shape = tuple(kpt_shape)
        self.nk = self.kpt_shape[0] * self.kpt_shape[1]
        c4 = max(ch[0] // 4, self.nk)
        self.cv4 = nn.ModuleList(nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3), nn.Conv2d(c4, self.nk, 1)) for x in ch)

    def kpts_decode(self, kpts: torch.Tensor, feat_shapes) -> torch.Tensor:
        """(B, A, nk) raw keypoints -> pixels: xy = (2 y + anchor - 0.5) * stride, visibility by a sigmoid."""
        anchors, strides = make_anchors(feat_shapes, self.stride, device=kpts.device)
        b, a, _ = kpts.shape
        y = wide(kpts).view(b, a, *self.kpt_shape)
        xy = (y[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) * strides[None, :, None, :]
        if self.kpt_shape[1] == 3:
            xy = torch.cat((xy, y[..., 2:3].sigmoid()), -1)
        return xy.reshape(b, a, self.nk)

    def raw_kpts(self, xs) -> torch.Tensor:
        """(B, A, nk) raw keypoint outputs, anchors level by level and row-major."""
        return torch.cat([cv(x).flatten(2) for cv, x in zip(self.cv4, xs)], 2).transpose(1, 2)

    def train_out(self, xs):
        kpt = self.raw_kpts(xs)
        return self.raw_maps(xs), kpt

    def forward(self, xs):
        kpt = self.raw_kpts(xs)
        maps = self.raw_maps(xs)
        pkpt = self.kpts_decode(kpt, [m.shape[2:] for m in maps])
        return torch.cat((self.decode(maps), pkpt), -1), (maps, kpt)



class OBB(Detect):
    """Oriented box head: Detect plus an angle branch `cv4` -> ne = 1 value per anchor, the angle
    (sigmoid - 0.25) * pi in float32, in [-pi/4, 3pi/4).

    Counterpart of `drone_yolo_tpu/nn/modules.py` `OBB`. `forward` gives (B, A, 4 + nc + 1): the rotated boxes
    decoded by `dist2rbox` (centre and size in pixels), the sigmoid class scores, then the angle; and (maps, angle
    (B, A, 1)). In train mode (`train_out`) it gives (maps, angle), so that `cv4` takes part in the loss. `cv4`'s last
    conv keeps its init (no prior), as in the JAX package.
    """

    def __init__(self, nc=80, ne=1, ch=(), reg_max=16, legacy=True):
        super().__init__(nc, ch, reg_max, legacy)
        self.ne = ne
        c4 = max(ch[0] // 4, ne)
        self.cv4 = nn.ModuleList(nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3), nn.Conv2d(c4, ne, 1)) for x in ch)

    def angles(self, xs) -> torch.Tensor:
        """(B, A, ne) angles in radians, float32, anchors level by level and row-major."""
        raw = torch.cat([cv(x).flatten(2) for cv, x in zip(self.cv4, xs)], 2).transpose(1, 2)
        return (wide(raw).sigmoid() - 0.25) * math.pi

    def train_out(self, xs):
        angle = self.angles(xs)
        return self.raw_maps(xs), angle

    def forward(self, xs):
        angle = self.angles(xs)
        maps = self.raw_maps(xs)
        anchors, strides = make_anchors([m.shape[2:] for m in maps], self.stride, device=maps[0].device)
        flat = torch.cat([m.flatten(2) for m in maps], 2).transpose(1, 2)  # (B, A, no)
        dist = dfl_expectation(flat[..., : 4 * self.reg_max], self.reg_max)
        rbox = dist2rbox(dist, angle, anchors[None]) * strides[None]
        return torch.cat((rbox, flat[..., 4 * self.reg_max :].float().sigmoid(), angle), -1), (maps, angle)

class Proto(nn.Module):
    """Mask prototypes: Conv k3 -> 2x2 stride-2 transposed conv (with bias) -> Conv k3 -> Conv k1 to `c2` maps.

    Counterpart of `drone_yolo_tpu/nn/modules.py` `Proto`. `upsample` holds the torch `ConvTranspose2d` weight
    (in, out, 2, 2), which the JAX package keeps as `up/kernel` (2, 2, out, in) and applies with
    `conv_transpose(transpose_kernel=True)`.
    """

    def __init__(self, c1, c_=256, c2=32):
        super().__init__()
        self.cv1 = Conv(c1, c_, k=3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, k=3)
        self.cv3 = Conv(c_, c2)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


class Segment(Detect):
    """Segmentation head: Detect plus `proto` (nm prototype maps at twice the first level's resolution) and a
    coefficient branch `cv4` -> nm mask coefficients per anchor.

    Counterpart of `drone_yolo_tpu/nn/modules.py` `Segment`. `forward` gives (B, A, 4 + nc + nm): Detect's decoded
    predictions, then the coefficients in float32; and (maps, coefficients (B, A, nm), protos (B, nm, Hm, Wm)). In
    train mode (`train_out`) it gives (maps, coefficients, protos), so that `cv4` and `proto` take part in the loss.
    """

    def __init__(self, nc=80, nm=32, npr=256, ch=(), reg_max=16, legacy=True):
        super().__init__(nc, ch, reg_max, legacy)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        c4 = max(ch[0] // 4, nm)
        self.cv4 = nn.ModuleList(nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3), nn.Conv2d(c4, nm, 1)) for x in ch)

    def coeffs(self, xs) -> torch.Tensor:
        """(B, A, nm) mask coefficients, anchors level by level and row-major."""
        return torch.cat([cv(x).flatten(2) for cv, x in zip(self.cv4, xs)], 2).transpose(1, 2)

    def train_out(self, xs):
        protos = self.proto(xs[0])
        return self.raw_maps(xs), self.coeffs(xs), protos

    def forward(self, xs):
        protos = self.proto(xs[0])
        mc = self.coeffs(xs)
        maps = self.raw_maps(xs)
        preds = self.decode(maps)
        return torch.cat((preds, mc.to(preds.dtype)), -1), (maps, mc, protos)


class Classify(nn.Module):
    """Classification head: Conv(c1, 1280), the global mean in float32, then a float32 linear to c2 classes; softmax
    in eval mode, the logits in train mode.

    Counterpart of `drone_yolo_tpu/nn/modules.py` `Classify`. `linear` holds the torch (c2, 1280) weight, which the
    JAX package keeps as `linear/kernel` (1280, c2). The pool and the linear run with autocast off, as the JAX head
    runs them in float32 whatever the compute dtype. A list input is concatenated on channels. `stride` is [1], the
    stride the JAX model reports for a head that is not a detection head.
    """

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1):
        super().__init__()
        c_ = 1280
        self.conv = Conv(c1, c_, k, s, p, g)
        self.linear = nn.Linear(c_, c2)
        self.stride = [1]

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            x = torch.cat(x, 1)
        y = self.conv(x)
        with float32_region(y.device.type):
            y = F.linear(wide(y).mean((2, 3)), wide(self.linear.weight), wide(self.linear.bias))
        return y if self.training else y.softmax(-1)


class ResNetBlock(nn.Module):
    """ResNet bottleneck: Conv 1x1, Conv 3x3 with stride s, Conv 1x1 to e * c2 without activation, plus the input or
    `short` (Conv 1x1 with stride s, no activation) where the stride or width changes, then a ReLU. The names are the
    JAX package's (`short`)."""

    def __init__(self, c1, c2, s=1, e=4):
        super().__init__()
        c3 = e * c2
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, 3, s)
        self.cv3 = Conv(c2, c3, 1, act=False)
        self.short = Conv(c1, c3, 1, s, act=False) if s != 1 or c1 != c3 else None

    def forward(self, x):
        y = self.cv3(self.cv2(self.cv1(x)))
        return F.relu(y + (x if self.short is None else self.short(x)))


class ResNetLayer(nn.Module):
    """With `is_first` the stem, Conv 7x7 stride 2 pad 3 then a 3x3 stride-2 max pool (pad 1); else `n` ResNetBlocks,
    the first with stride s. The arguments pass through the build unscaled, as in the JAX package."""

    def __init__(self, c1, c2, s=1, is_first=False, n=1, e=4):
        super().__init__()
        self.is_first = is_first
        if is_first:
            self.stem = Conv(c1, c2, 7, 2, p=3)
        else:
            self.blocks = nn.ModuleList([ResNetBlock(c1, c2, s, e=e)] + [ResNetBlock(e * c2, c2, 1, e=e) for _ in range(n - 1)])

    def forward(self, x):
        if self.is_first:
            return F.max_pool2d(self.stem(x), 3, 2, 1)
        for b in self.blocks:
            x = b(x)
        return x


def _conv_bn(conv: nn.Conv2d, bn: BatchNorm2d | None, x: torch.Tensor, s2grad: str | None) -> torch.Tensor:
    y = conv_forward(conv, x, s2grad)
    return y if bn is None else bn(y)


class BasicBlock(nn.Module):
    """torchvision's ResNet BasicBlock: conv1 3x3 (stride s), bn1, ReLU, conv2 3x3, bn2, plus the input or
    `downsample` (1x1 conv with stride s, BN), then a ReLU. `s2grad` picks the backward of its stride-2 convs, as
    `Conv`'s does; `fuse()` folds each BN into its conv."""

    def __init__(self, c1, c2, s=1):
        super().__init__()
        self.conv1 = nn.Conv2d(c1, c2, 3, s, 1, bias=False)
        self.bn1 = BatchNorm2d(c2)
        self.conv2 = nn.Conv2d(c2, c2, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(c2)
        self.downsample = (nn.Sequential(nn.Conv2d(c1, c2, 1, s, bias=False), BatchNorm2d(c2))
                           if s != 1 or c1 != c2 else None)
        self.s2grad = None

    def forward(self, x):
        y = F.relu(_conv_bn(self.conv1, self.bn1, x, self.s2grad))
        y = _conv_bn(self.conv2, self.bn2, y, self.s2grad)
        if self.downsample is not None:
            d = self.downsample
            x = _conv_bn(d[0], d[1] if len(d) > 1 else None, x, self.s2grad)
        return F.relu(y + x)

    def fuse(self) -> None:
        if self.bn1 is None:
            return
        self.conv1, self.bn1 = fuse_conv_bn(self.conv1, self.bn1), None
        self.conv2, self.bn2 = fuse_conv_bn(self.conv2, self.bn2), None
        if self.downsample is not None:
            self.downsample = nn.Sequential(fuse_conv_bn(*self.downsample))


class TorchVision(nn.Module):
    """A torchvision ResNet-18 or -34 trunk built natively (the card's machine has no torchvision), in place of the
    reference's TorchVision loader module, as the JAX package builds it.

    `m` is `nn.Sequential(*list(resnet.children())[:-2])`, as the reference's with unwrap=True and truncate=2: conv1
    (7x7 stride 2), bn1, ReLU, a 3x3 stride-2 max pool (pad 1), then layer1..layer4 of BasicBlocks (the first of
    layers 2-4 with stride 2 and a downsample), so that the state-dict names are the reference's (`m.0.weight`,
    `m.4.0.conv1.weight`). BN is the port's (eps 1e-3, as in the JAX package). `weights` is accepted and the trunk is
    initialised at random, as in the JAX package, with a warning (once) that no pretrained weights are loaded. Other
    trunks, unwrap=False, truncate < 2 and split=True are refused, as there.
    """

    STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}

    def __init__(self, model="resnet18", weights="DEFAULT", unwrap=True, truncate=2, split=False):
        super().__init__()
        if model not in self.STAGES or not unwrap or truncate < 2 or split:
            raise NotImplementedError(f"native TorchVision trunk supports {sorted(self.STAGES)} with unwrap=True, "
                                      f"truncate>=2, split=False (got {model})")
        if weights:  # a warning, which Python shows once per process
            warnings.warn(f"TorchVision({model}, weights={weights!r}): no pretrained weights are loaded (nothing is "
                          "downloaded); the trunk is initialised at random", stacklevel=2)
        layers, cin = [], 64
        for si, (cout, n) in enumerate(zip((64, 128, 256, 512), self.STAGES[model])):
            blocks = [BasicBlock(cin, cout, 1 if si == 0 else 2)] + [BasicBlock(cout, cout) for _ in range(n - 1)]
            layers.append(nn.Sequential(*blocks))
            cin = cout
        self.m = nn.Sequential(nn.Conv2d(3, 64, 7, 2, 3, bias=False), BatchNorm2d(64), nn.ReLU(), nn.MaxPool2d(3, 2, 1),
                               *layers)

    def forward(self, x):
        return self.m(x)

    def fuse(self) -> None:
        if isinstance(self.m[1], BatchNorm2d):
            self.m[0] = fuse_conv_bn(self.m[0], self.m[1])
            self.m[1] = nn.Identity()
        for mod in [m for m in self.m.modules() if isinstance(m, BasicBlock)]:
            mod.fuse()

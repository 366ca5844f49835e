"""ONNX export: the fused model's graph written as an ONNX file, with no `onnx` and no `google.protobuf`.

Counterpart of `drone_yolo_tpu/export/onnx_export.py` (Builder, Emitter, export_onnx): one
emitter branch per module type, each writing the nodes of that module's forward on the FUSED
weights (`DetectionModel.fuse()`: BN folded, RepVGGBlock, RepConv and RepVGGDW collapsed into
single convs), which are already OIHW. The graph is the JAX package's node for node: input
`images` (B, 3, H, W) float32; `output0` = (B, 4 + nc, A) decoded xywh and scores for a detect
head (YOLOv10: its one-to-one branch), (B, 4 + nc + nm, A) with `output1` the prototypes
(B, nm, H/4, W/4) for segment, (B, 4 + nc + nk, A) with the keypoints decoded for pose,
(B, 4 + nc + 1, A) rotated boxes with the angle last for obb, and (B, nc) probabilities for
classify. Weights go in `raw_data`; the messages are written by `export/onnx_pb.py`. A module
that the JAX emitter does not cover (the ResNet and TorchVision trunks, YOLOv9-E's CBLinear and
CBFuse) is refused by name.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from drone_yolo_tpu_torch.export import onnx_pb as P
from drone_yolo_tpu_torch.nn import modules as M
from drone_yolo_tpu_torch.ops.anchors import make_anchors

FLOAT = P.TensorProto.FLOAT
INT64 = P.TensorProto.INT64
IR_VERSION = 8
# opset >= 13 is required for correctness: the DFL decode emits
# Softmax(axis=2) on a 4-D tensor, and opset<13 Softmax coerces to 2-D and
# normalizes over ALL trailing dims (OpenCV's importer is lenient, but
# spec-conformant runtimes like onnxruntime would produce wrong boxes)
OPSET = 13


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _ints(v) -> int:
    """A conv's stride, padding or dilation, which must be square."""
    v = tuple(v) if isinstance(v, (tuple, list)) else (v, v)
    if v[0] != v[1]:
        raise NotImplementedError(f"ONNX export: non-square conv parameter {v}")
    return int(v[0])


class Builder:
    """Incremental ONNX graph: nodes, initializers and value names."""

    def __init__(self):
        self.nodes, self.inits = [], []
        self._init_dims = {}  # initializer name -> dims (for kernel_shape)
        self._n = 0

    def name(self, hint: str = "t") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def const(self, arr, hint: str = "const") -> str:
        arr = np.asarray(arr)
        data_type = INT64 if arr.dtype == np.int64 else FLOAT
        arr = arr.astype("<i8" if data_type == INT64 else "<f4")  # a scalar stays 0-d (ascontiguousarray makes it 1-d)
        t = P.TensorProto(name=self.name(hint), dims=list(arr.shape), data_type=data_type, raw_data=arr.tobytes())
        self.inits.append(t)
        self._init_dims[t.name] = tuple(arr.shape)
        return t.name

    def node(self, op: str, inputs, n_out: int = 1, hint: str | None = None, **attrs):
        if op in ("Conv", "ConvTranspose") and "kernel_shape" not in attrs:
            # kernel_shape is optional per spec (inferable from the weight
            # tensor) but required by older importers (OpenCV <4.7 C++ DNN);
            # emit it whenever the weight is one of our constants
            dims = self._init_dims.get(inputs[1])
            if dims is not None and len(dims) == 4:
                attrs["kernel_shape"] = list(dims[2:])
        A = P.AttributeProto
        attributes = []
        for k, val in attrs.items():
            if isinstance(val, float):
                attributes.append(A(name=k, type=A.FLOAT, f=val))
            elif isinstance(val, (bool, int, np.integer)):
                attributes.append(A(name=k, type=A.INT, i=int(val)))
            elif isinstance(val, str):
                attributes.append(A(name=k, type=A.STRING, s=val.encode()))
            elif isinstance(val, (list, tuple)) and all(isinstance(x, (int, np.integer)) for x in val):
                attributes.append(A(name=k, type=A.INTS, ints=[int(x) for x in val]))
            elif isinstance(val, (list, tuple)):
                attributes.append(A(name=k, type=A.FLOATS, floats=[float(x) for x in val]))
            else:
                raise TypeError(f"attr {k}={val!r}")
        outs = [self.name(hint or op.lower()) for _ in range(n_out)]
        self.nodes.append(P.NodeProto(input=list(inputs), output=outs, name=self.name(op), op_type=op,
                                      attribute=attributes))
        return outs[0] if n_out == 1 else outs


class Emitter:
    """Walks the fused model and writes each module's nodes."""

    def __init__(self, builder: Builder):
        self.b = builder

    def conv(self, conv: nn.Conv2d, x: str) -> str:
        if conv.padding_mode != "zeros" or isinstance(conv.padding, str):
            raise NotImplementedError(f"ONNX export: conv padding {conv.padding!r} ({conv.padding_mode})")
        b = self.b
        ins = [x, b.const(_np(conv.weight), "W")] + ([b.const(_np(conv.bias), "B")] if conv.bias is not None else [])
        p = _ints(conv.padding)
        return b.node("Conv", ins, strides=[_ints(conv.stride)] * 2, pads=[p, p, p, p], group=conv.groups,
                      dilations=[_ints(conv.dilation)] * 2)

    def act(self, act, y: str) -> str:
        if act is True:
            return self.silu(y)
        if act == "relu":
            return self.b.node("Relu", [y])
        return y

    def silu(self, y: str) -> str:
        return self.b.node("Mul", [y, self.b.node("Sigmoid", [y])], hint="silu")

    def fused_conv(self, weight, bias, x: str, stride: int, pad: int, group: int) -> str:
        """A RepConv's or RepVGGDW's own fused kernel and bias as one Conv."""
        if weight is None:
            raise ValueError("ONNX export needs the fused model (DetectionModel.fuse())")
        b = self.b
        return b.node("Conv", [x, b.const(_np(weight), "W"), b.const(_np(bias), "B")], strides=[stride, stride],
                      pads=[pad] * 4, group=group, dilations=[1, 1])

    def emit(self, mod, x):
        b = self.b
        if isinstance(mod, M.Conv):  # DWConv too
            if mod.bn is not None:
                raise ValueError("ONNX export needs the fused model (DetectionModel.fuse())")
            return self.act(mod.act, self.conv(mod.conv, x))
        if isinstance(mod, nn.Conv2d):  # a head's output conv
            return self.conv(mod, x)
        if isinstance(mod, M.RepVGGBlock):  # fused: one 3x3 conv + bias + SiLU
            if mod.rbr_reparam is None:
                raise ValueError("ONNX export needs the fused model (DetectionModel.fuse())")
            return self.silu(self.conv(mod.rbr_reparam, x))
        if isinstance(mod, M.Bottleneck):  # RepBottleneck too (its cv1 a RepConv)
            y = self.emit(mod.cv2, self.emit(mod.cv1, x))
            return b.node("Add", [x, y]) if mod.add else y
        if isinstance(mod, M.C2f):  # C3k2, C2fCIB
            y0 = self.emit(mod.cv1, x)
            ys = [self.slice_ch(y0, 0, mod.c), self.slice_ch(y0, mod.c, 2 * mod.c)]
            for m in mod.m:
                ys.append(self.emit(m, ys[-1]))
            return self.emit(mod.cv2, b.node("Concat", ys, axis=1))
        if isinstance(mod, M.C2):
            y0 = self.emit(mod.cv1, x)
            a, bb = self.slice_ch(y0, 0, mod.c), self.slice_ch(y0, mod.c, 2 * mod.c)
            return self.emit(mod.cv2, b.node("Concat", [self.emit(mod.m, a), bb], axis=1))
        if isinstance(mod, M.C3):  # C3k, C3Ghost, RepCSP
            a = self.emit(mod.m, self.emit(mod.cv1, x))
            return self.emit(mod.cv3, b.node("Concat", [a, self.emit(mod.cv2, x)], axis=1))
        if isinstance(mod, (M.SPPF, M.SPPELAN)):
            y = [self.emit(mod.cv1, x)]
            for _ in range(3):
                y.append(b.node("MaxPool", [y[-1]], kernel_shape=[mod.k, mod.k], strides=[1, 1], pads=[mod.k // 2] * 4))
            return self.emit(mod.cv2 if isinstance(mod, M.SPPF) else mod.cv5, b.node("Concat", y, axis=1))
        if isinstance(mod, M.SPP):
            y0 = self.emit(mod.cv1, x)
            ys = [y0] + [b.node("MaxPool", [y0], kernel_shape=[k, k], strides=[1, 1], pads=[k // 2] * 4) for k in mod.k]
            return self.emit(mod.cv2, b.node("Concat", ys, axis=1))
        if isinstance(mod, M.GhostConv):
            y = self.emit(mod.cv1, x)
            return b.node("Concat", [y, self.emit(mod.cv2, y)], axis=1)
        if isinstance(mod, M.GhostBottleneck):
            y = self.emit(mod.conv, x)
            if mod.shortcut is not None:
                return b.node("Add", [y, self.emit(mod.shortcut, x)])
            return b.node("Add", [x, y]) if mod.add else y
        if isinstance(mod, M.SCDown):
            return self.emit(mod.cv2, self.emit(mod.cv1, x))
        if isinstance(mod, M.Upsample):
            roi = b.const(np.zeros(0, np.float32), "roi")
            scales = b.const(np.array([1.0, 1.0, mod.scale, mod.scale], np.float32), "scales")
            return b.node("Resize", [x, roi, scales], mode="nearest", coordinate_transformation_mode="asymmetric",
                          nearest_mode="floor")
        if isinstance(mod, M.Concat):
            return b.node("Concat", x, axis=mod.dim)
        if isinstance(mod, nn.MaxPool2d):
            if mod.ceil_mode or _ints(mod.dilation) != 1:
                raise NotImplementedError("ONNX export: MaxPool2d with ceil_mode or dilation")
            k, s, p = _ints(mod.kernel_size), _ints(mod.stride), _ints(mod.padding)
            return b.node("MaxPool", [x], kernel_shape=[k, k], strides=[s, s], pads=[p] * 4)
        if isinstance(mod, nn.ZeroPad2d):
            left, right, top, bottom = mod.padding
            pads = b.const(np.array([0, 0, top, left, 0, 0, bottom, right], np.int64), "pads")
            return b.node("Pad", [x, pads], mode="constant")
        if isinstance(mod, nn.Identity):
            return x
        if isinstance(mod, nn.Sequential):
            for m in mod:
                x = self.emit(m, x)
            return x
        if isinstance(mod, M.RepConv):  # fused: one 3x3 conv (+ SiLU)
            y = self.fused_conv(mod.weight, mod.bias, x, mod.s, 1, mod.g)
            return self.silu(y) if mod.act is True else y
        if isinstance(mod, M.RepNCSPELAN4):  # ELAN1 too
            y0 = self.emit(mod.cv1, x)
            ys = [self.slice_ch(y0, 0, mod.c), self.slice_ch(y0, mod.c, 2 * mod.c)]
            ys.append(self.emit(mod.cv2, ys[-1]))
            ys.append(self.emit(mod.cv3, ys[-1]))
            return self.emit(mod.cv4, b.node("Concat", ys, axis=1))
        if isinstance(mod, M.AConv):
            return self.emit(mod.cv1, self.avg_pool_2x1(x))
        if isinstance(mod, M.ADown):
            y = self.avg_pool_2x1(x)
            half = mod.cv1.conv.in_channels  # ADown splits the pooled input in half
            y1 = self.emit(mod.cv1, self.slice_ch(y, 0, half))
            pooled = b.node("MaxPool", [self.slice_ch(y, half, 2 * half)], kernel_shape=[3, 3], strides=[2, 2],
                            pads=[1, 1, 1, 1])
            return b.node("Concat", [y1, self.emit(mod.cv2, pooled)], axis=1)
        if isinstance(mod, M.CIB):
            y = self.emit(mod.cv1, x)
            return b.node("Add", [x, y]) if mod.add else y
        if isinstance(mod, M.RepVGGDW):  # fused: one 7x7 depthwise conv + bias + SiLU
            return self.silu(self.fused_conv(mod.weight, mod.bias, x, 1, 3, mod.c))
        if isinstance(mod, M.Attention):
            return self.emit_attention(mod, x)
        if isinstance(mod, M.PSABlock):
            y = self.emit_attention(mod.attn, x)
            x = b.node("Add", [x, y]) if mod.add else y
            y = self.emit(mod.ffn, x)
            return b.node("Add", [x, y]) if mod.add else y
        if isinstance(mod, (M.PSA, M.C2PSA)):
            y0 = self.emit(mod.cv1, x)
            a, bb = self.slice_ch(y0, 0, mod.c), self.slice_ch(y0, mod.c, 2 * mod.c)
            if isinstance(mod, M.C2PSA):
                for m in mod.m:
                    bb = self.emit(m, bb)
            else:
                bb = b.node("Add", [bb, self.emit_attention(mod.attn, bb)])
                bb = b.node("Add", [bb, self.emit(mod.ffn, bb)])
            return self.emit(mod.cv2, b.node("Concat", [a, bb], axis=1))
        if isinstance(mod, M.ABlock):
            x = b.node("Add", [x, self.emit_aattn(mod.attn, x)])
            return b.node("Add", [x, self.emit(mod.mlp, x)])
        if isinstance(mod, M.A2C2f):
            ys = [self.emit(mod.cv1, x)]
            for m in mod.m:
                ys.append(self.emit(m, ys[-1]))
            out = self.emit(mod.cv2, b.node("Concat", ys, axis=1))
            if mod.gamma is not None:
                g = b.const(_np(mod.gamma).reshape(1, -1, 1, 1), "gamma")
                out = b.node("Add", [x, b.node("Mul", [g, out])])
            return out
        if isinstance(mod, M.Classify):
            y = self.emit(mod.conv, b.node("Concat", x, axis=1) if isinstance(x, list) else x)
            y = b.node("Flatten", [b.node("GlobalAveragePool", [y])], axis=1)
            y = b.node("MatMul", [y, b.const(_np(mod.linear.weight).T, "lin_w")])  # (in, out)
            y = b.node("Add", [y, b.const(_np(mod.linear.bias), "lin_b")])
            return b.node("Softmax", [y], axis=1)
        raise NotImplementedError(
            f"ONNX export: module {type(mod).__name__} is not covered. The emitter covers the modules of the JAX "
            "package's ONNX emitter (Conv/C2f/C3/SPPF/Ghost/RepVGG/RepConv/ELAN/ADown/SCDown/CIB/PSA/C2PSA/AAttn/"
            "Upsample/Concat/MaxPool) under the Detect, v10, Segment, Pose, OBB and Classify heads")

    def slice_ch(self, x: str, start: int, end: int, axis: int = 1) -> str:
        b = self.b
        starts = b.const(np.array([start], np.int64), "starts")
        ends = b.const(np.array([end], np.int64), "ends")
        axes = b.const(np.array([axis], np.int64), "axes")
        return b.node("Slice", [x, starts, ends, axes])

    def avg_pool_2x1(self, x: str) -> str:
        return self.b.node("AveragePool", [x], kernel_shape=[2, 2], strides=[1, 1], pads=[0, 0, 0, 0])

    def spatial(self, x: str, lo: int, hi: int) -> str:
        """dims lo:hi of x's shape, read at run time (the exported-ONNX idiom for H and W)."""
        b = self.b
        return b.node("Slice", [b.node("Shape", [x]), b.const(np.array([lo], np.int64), f"s{lo}"),
                                b.const(np.array([hi], np.int64), f"s{hi}"), b.const(np.array([0], np.int64), "ax0")])

    def dfl_front(self, head: M.Detect, xs, imgsz: int, branches=None):
        """Shared decode front: branch maps -> flat (B, no, A) -> DFL expectation. Returns (dist (B, 4, A) in anchor
        units, class logits (B, nc, A), anchors (A, 2), strides (A, 1), A)."""
        b = self.b
        box_mods, cls_mods = branches or (head.cv2, head.cv3)
        reg = head.reg_max
        no = 4 * reg + head.nc
        flats, feat_shapes = [], []
        for i, x in enumerate(xs):
            m = b.node("Concat", [self.emit(box_mods[i], x), self.emit(cls_mods[i], x)], axis=1)  # (B, no, h, w)
            h = int(imgsz // head.stride[i])
            feat_shapes.append((h, h))
            flats.append(b.node("Reshape", [m, b.const(np.array([0, no, h * h], np.int64), "shape")]))
        flat = b.node("Concat", flats, axis=2)  # (B, no, A)
        anchors, strides = (t.numpy() for t in make_anchors(feat_shapes, head.stride))
        A = anchors.shape[0]
        box, cls = self.slice_ch(flat, 0, 4 * reg), self.slice_ch(flat, 4 * reg, no)
        box4 = b.node("Reshape", [box, b.const(np.array([0, 4, reg, A], np.int64), "shape")])  # (B, 4, reg, A)
        # DFL expectation sum_r prob[r]*r emitted the way the reference's DFL
        # module computes it (nn/modules/block.py:58): channel softmax over the
        # reg bins followed by a frozen 1x1 Conv whose weight is arange(reg).
        # Conv + channel-Softmax are the two best-supported ops in legacy
        # importers (OpenCV <4.7 C++ DNN rejects opset-13 ReduceSum and
        # asserts on 4-D MatMul with a 2-D constant).
        prob = b.node("Softmax", [b.node("Transpose", [box4], perm=[0, 2, 1, 3])], axis=1)  # (B, reg, 4, A)
        rng = b.const(np.arange(reg, dtype=np.float32).reshape(1, reg, 1, 1), "dfl_rng")
        ev = b.node("Conv", [prob, rng], strides=[1, 1], pads=[0, 0, 0, 0], group=1, dilations=[1, 1])  # (B, 1, 4, A)
        dist = b.node("Reshape", [ev, b.const(np.array([0, 4, A], np.int64), "shape")])  # (B, 4, A)
        return dist, cls, anchors, strides, A

    def emit_detect(self, head: M.Detect, xs, imgsz: int, branches=None) -> str:
        """Branch maps and the in-graph DFL decode -> (B, 4 + nc, A); `branches` (box, class) overrides the head's,
        for YOLOv10's one-to-one branch."""
        b = self.b
        dist, cls, anchors, strides, A = self.dfl_front(head, xs, imgsz, branches)
        anc = b.const(anchors.T.reshape(1, 2, A), "anchors")  # (1, 2, A) xy
        lt, rb = self.slice_ch(dist, 0, 2), self.slice_ch(dist, 2, 4)
        x1y1, x2y2 = b.node("Sub", [anc, lt]), b.node("Add", [anc, rb])
        cxy = b.node("Mul", [b.node("Add", [x1y1, x2y2]), b.const(np.array(0.5, np.float32), "half")])
        dbox = b.node("Concat", [cxy, b.node("Sub", [x2y2, x1y1])], axis=1)  # (B, 4, A) xywh
        # strides tiled to the full channel dim: legacy importers (OpenCV <4.7)
        # lower Mul-by-const to a Scale layer that cannot broadcast (1,1,A)
        # across the box channels
        dbox = b.node("Mul", [dbox, b.const(np.tile(strides.reshape(1, 1, A), (1, 4, 1)), "strides")])
        return b.node("Concat", [dbox, b.node("Sigmoid", [cls])], axis=1, hint="output")  # (B, 4 + nc, A)

    def emit_attention(self, at: M.Attention, x: str) -> str:
        """Spatial MHSA in NCHW: qkv conv -> per-head q^T k softmax -> v attn^T -> positional DW conv -> proj. H and W
        are read at run time through Shape."""
        b = self.b
        nh, kd, hd = at.num_heads, at.key_dim, at.head_dim
        per = kd * 2 + hd
        qkv = b.node("Reshape", [self.emit(at.qkv, x), b.const(np.array([0, nh, per, -1], np.int64), "shape")])
        q, k, vv = (self.slice_ch(qkv, lo, hi, axis=2) for lo, hi in ((0, kd), (kd, 2 * kd), (2 * kd, per)))
        attn = b.node("MatMul", [b.node("Transpose", [q], perm=[0, 1, 3, 2]), k])  # (B, nh, n, n)
        attn = b.node("Softmax", [b.node("Mul", [attn, b.const(np.array(at.scale, np.float32), "scale")])], axis=3)
        out = b.node("MatMul", [vv, b.node("Transpose", [attn], perm=[0, 1, 3, 2])])  # (B, nh, hd, n)
        # back to (B, C, H, W): H/W recovered from the block input's Shape
        hw = self.spatial(x, 2, 4)
        full = b.node("Concat", [b.const(np.array([0, nh * hd], np.int64), "lead"), hw], axis=0)
        out, vmap = b.node("Reshape", [out, full]), b.node("Reshape", [vv, full])
        return self.emit(at.proj, b.node("Add", [out, self.emit(at.pe, vmap)]))

    def emit_aattn(self, at: M.AAttn, x: str) -> str:
        """Area attention in NCHW: full attention within `area` horizontal stripes, the stripes folded into the batch
        dim through Shape arithmetic. (At an imgsz that is a multiple of the model's largest stride, every area
        attention's H*W divides by its area, so the module's whole-map fallback does not arise.)"""
        b = self.b
        nh, hd = at.nh, at.hd
        c = nh * hd
        area = at.area if at.area > 1 else 1
        qkv = b.node("Reshape", [self.emit(at.qkv, x), b.const(np.array([0, 3 * c, -1], np.int64), "shape")])
        qkv = b.node("Transpose", [qkv], perm=[0, 2, 1])  # (B, n, 3c)
        if area > 1:  # (B, n, 3c) -> (B * area, n / area, 3c)
            sh = b.node("Shape", [x])
            h_ = b.node("Slice", [sh, b.const(np.array([2], np.int64), "s2"), b.const(np.array([3], np.int64), "s3"),
                                  b.const(np.array([0], np.int64), "ax")])
            w_ = b.node("Slice", [sh, b.const(np.array([3], np.int64), "s3"), b.const(np.array([4], np.int64), "s4"),
                                  b.const(np.array([0], np.int64), "ax")])
            n_ = b.node("Mul", [h_, w_])
            n_div = b.node("Div", [n_, b.const(np.array([area], np.int64), "area")])
            shp = b.node("Concat", [b.const(np.array([-1], np.int64), "m1"), n_div,
                                    b.const(np.array([3 * c], np.int64), "c3")], axis=0)
            qkv = b.node("Reshape", [qkv, shp])
        qkv = b.node("Reshape", [qkv, b.const(np.array([0, -1, nh, 3 * hd], np.int64), "shape")])  # (bb, nn, nh, 3hd)
        q, k, vv = (self.slice_ch(qkv, i * hd, (i + 1) * hd, axis=3) for i in range(3))
        qt = b.node("Transpose", [q], perm=[0, 2, 1, 3])  # (bb, nh, nn, hd)
        kt = b.node("Transpose", [k], perm=[0, 2, 3, 1])  # (bb, nh, hd, nn)
        vt = b.node("Transpose", [vv], perm=[0, 2, 1, 3])  # (bb, nh, nn, hd)
        attn = b.node("Mul", [b.node("MatMul", [qt, kt]), b.const(np.array(hd**-0.5, np.float32), "scale")])
        attn = b.node("Softmax", [attn], axis=3)
        out = b.node("Transpose", [b.node("MatMul", [attn, vt])], perm=[0, 2, 1, 3])  # (bb, nn, nh, hd)
        # (bb, nn, nh, hd) -> (B, n, c): flatten heads, then unfold area back
        # into n BEFORE any transpose (area stripes are contiguous along n)
        hw = self.spatial(x, 2, 4)
        bnc = b.const(np.array([0, -1, c], np.int64), "bnc")
        merged, vmerged = b.node("Reshape", [out, bnc]), b.node("Reshape", [vv, bnc])  # (bb, nn, c)
        if area > 1:
            unfold = b.node("Concat", [b.const(np.array([-1], np.int64), "m1"), n_, b.const(np.array([c], np.int64), "cc")],
                            axis=0)
            merged, vmerged = b.node("Reshape", [merged, unfold]), b.node("Reshape", [vmerged, unfold])  # (B, n, c)
        full = b.node("Concat", [b.const(np.array([-1, c], np.int64), "lead"), hw], axis=0)  # (B, c, H, W)
        out = b.node("Reshape", [b.node("Transpose", [merged], perm=[0, 2, 1]), full])
        vmap = b.node("Reshape", [b.node("Transpose", [vmerged], perm=[0, 2, 1]), full])
        return self.emit(at.proj, b.node("Add", [out, self.emit(at.pe, vmap)]))

    def emit_proto(self, proto: M.Proto, x: str) -> str:
        """Mask prototypes: cv1 -> ConvTranspose(2, 2) -> cv2 -> cv3; the torch weight (in, out, 2, 2) is ONNX's."""
        b = self.b
        up = proto.upsample
        y = b.node("ConvTranspose", [self.emit(proto.cv1, x), b.const(_np(up.weight), "upW"), b.const(_np(up.bias), "upB")],
                   strides=[2, 2], pads=[0, 0, 0, 0])
        return self.emit(proto.cv3, self.emit(proto.cv2, y))

    def branch4(self, head: M.Detect, xs, cout: int, imgsz: int) -> str:
        """The per-level cv4 branch maps concatenated into (B, cout, A)."""
        b = self.b
        flats = []
        for i, x in enumerate(xs):
            h = int(imgsz // head.stride[i])
            flats.append(b.node("Reshape", [self.emit(head.cv4[i], x), b.const(np.array([0, cout, h * h], np.int64), "shape")]))
        return b.node("Concat", flats, axis=2)

    def emit_segment(self, head: M.Segment, xs, imgsz: int):
        """(output0, output1) = ((B, 4 + nc + nm, A), protos (B, nm, H/4, W/4))."""
        protos = self.emit_proto(head.proto, xs[0])
        mc = self.branch4(head, xs, head.nm, imgsz)
        return self.b.node("Concat", [self.emit_detect(head, xs, imgsz), mc], axis=1, hint="output"), protos

    def emit_pose(self, head: M.Pose, xs, imgsz: int) -> str:
        """(B, 4 + nc + nk, A) with the keypoints decoded to pixels."""
        b = self.b
        det = self.emit_detect(head, xs, imgsz)
        kpt = self.branch4(head, xs, head.nk, imgsz)  # (B, nk, A)
        K, D = head.kpt_shape
        anchors, strides = (t.numpy() for t in make_anchors([(int(imgsz // s),) * 2 for s in head.stride], head.stride))
        A = anchors.shape[0]
        y = b.node("Reshape", [kpt, b.const(np.array([0, K, D, A], np.int64), "shape")])  # (B, K, D, A)
        xy = self.slice_ch(y, 0, 2, axis=2)
        anc = b.const(anchors.T.reshape(1, 1, 2, A) - 0.5, "kpt_anc")
        sn = b.const(strides.reshape(1, 1, 1, A), "kpt_strides")
        xy = b.node("Mul", [b.node("Add", [b.node("Mul", [xy, b.const(np.array(2.0, np.float32), "two")]), anc]), sn])
        y = b.node("Concat", [xy, b.node("Sigmoid", [self.slice_ch(y, 2, 3, axis=2)])], axis=2) if D == 3 else xy
        pkpt = b.node("Reshape", [y, b.const(np.array([0, K * D, A], np.int64), "shape")])
        return b.node("Concat", [det, pkpt], axis=1, hint="output")

    def emit_obb(self, head: M.OBB, xs, imgsz: int) -> str:
        """(B, 4 + nc + 1, A): the rotated boxes (dist2rbox), the scores, the angle."""
        b = self.b
        sig = b.node("Sigmoid", [self.branch4(head, xs, head.ne, imgsz)])  # (B, 1, A)
        angle = b.node("Mul", [b.node("Sub", [sig, b.const(np.array(0.25, np.float32), "quarter")]),
                               b.const(np.array(np.pi, np.float32), "pi")])
        dist, cls, anchors, strides, A = self.dfl_front(head, xs, imgsz)
        # dist2rbox: rotate the (rb-lt)/2 offset by angle, add anchors; wh = lt+rb
        lt, rb = self.slice_ch(dist, 0, 2), self.slice_ch(dist, 2, 4)
        off = b.node("Mul", [b.node("Sub", [rb, lt]), b.const(np.array(0.5, np.float32), "half")])  # (B, 2, A)
        xf, yf = self.slice_ch(off, 0, 1), self.slice_ch(off, 1, 2)
        cos, sin = b.node("Cos", [angle]), b.node("Sin", [angle])
        xr = b.node("Sub", [b.node("Mul", [xf, cos]), b.node("Mul", [yf, sin])])
        yr = b.node("Add", [b.node("Mul", [xf, sin]), b.node("Mul", [yf, cos])])
        xy = b.node("Add", [b.node("Concat", [xr, yr], axis=1), b.const(anchors.T.reshape(1, 2, A), "anchors")])
        rbox = b.node("Mul", [b.node("Concat", [xy, b.node("Add", [lt, rb])], axis=1),
                              b.const(strides.reshape(1, 1, A), "strides")])
        return b.node("Concat", [rbox, b.node("Sigmoid", [cls]), angle], axis=1, hint="output")


def _value_info(name: str, dims) -> P.ValueInfoProto:
    shape = P.TensorShapeProto(dim=[P.Dimension(dim_value=int(d)) for d in dims])
    return P.ValueInfoProto(name=name, type=P.TypeProto(tensor_type=P.TensorType(elem_type=FLOAT, shape=shape)))


def export_onnx(model, path, imgsz: int = 640, batch: int = 1) -> str:
    """Write the fused, eval-mode `model` (a DetectionModel or a subclass) as an ONNX file at `path` for
    (batch, 3, imgsz, imgsz) inputs. Returns the path."""
    if any(isinstance(m, M.BatchNorm2d) for m in model.modules()):
        raise ValueError("ONNX export needs the fused model (DetectionModel.fuse())")
    b = Builder()
    em = Emitter(b)
    names, outputs = {}, []  # outputs: [(tensor name, public name, dims)]
    x0 = "images"
    for i, (mod, f) in enumerate(zip(model.model, model.froms)):
        xin = x0 if f == -1 else names[f] if isinstance(f, int) else [x0 if j == -1 else names[j] for j in f]
        if isinstance(mod, M.Detect):
            A = sum((imgsz // int(s)) ** 2 for s in mod.stride)
            if isinstance(mod, M.v10Detect):
                # NMS-free deployed branch: the decoded one-to-one maps. The reference
                # additionally bakes a top-k postprocess into the graph (head.py:150); here
                # top-k stays outside, as in the JAX package, so the artifact contract is
                # (B, 4+nc, A) like plain Detect
                outputs = [(em.emit_detect(mod, xin, imgsz, branches=(mod.one2one_cv2, mod.one2one_cv3)), "output0",
                            (batch, 4 + mod.nc, A))]
            elif isinstance(mod, M.Segment):
                out0, protos = em.emit_segment(mod, xin, imgsz)
                mh = 2 * (imgsz // int(mod.stride[0]))
                outputs = [(out0, "output0", (batch, 4 + mod.nc + mod.nm, A)), (protos, "output1", (batch, mod.nm, mh, mh))]
            elif isinstance(mod, M.Pose):
                outputs = [(em.emit_pose(mod, xin, imgsz), "output0", (batch, 4 + mod.nc + mod.nk, A))]
            elif isinstance(mod, M.OBB):
                outputs = [(em.emit_obb(mod, xin, imgsz), "output0", (batch, 4 + mod.nc + mod.ne, A))]
            else:
                outputs = [(em.emit_detect(mod, xin, imgsz), "output0", (batch, 4 + mod.nc, A))]
            break
        if isinstance(mod, M.Classify):
            outputs = [(em.emit(mod, xin), "output0", (batch, mod.linear.out_features))]
            break
        x0 = names[i] = em.emit(mod, xin)

    # the outputs by the reference's conventional names (output0, output1, ...)
    rename = {tname: public for tname, public, _ in outputs}
    for nd in b.nodes:
        nd.output = [rename.get(o, o) for o in nd.output]
        nd.input = [rename.get(o, o) for o in nd.input]
    graph = P.GraphProto(node=b.nodes, name="main", initializer=b.inits, input=[_value_info("images", (batch, 3, imgsz, imgsz))],
                         output=[_value_info(public, dims) for _, public, dims in outputs])
    mp = P.ModelProto(ir_version=IR_VERSION, producer_name="drone_yolo_tpu_torch", producer_version="0.1.0", graph=graph,
                      opset_import=[P.OperatorSetIdProto(version=OPSET)])
    path = Path(path)
    path.write_bytes(mp.SerializeToString())
    return str(path)

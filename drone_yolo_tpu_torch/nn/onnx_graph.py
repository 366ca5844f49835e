"""A reader and runner of ONNX graphs in torch: the counterpart of `cv2.dnn.readNetFromONNX` in the JAX AutoBackend.

`OnnxGraph(path, device)` parses the file with `export/onnx_pb.py`, puts the float initializers on
`device` once, and `graph(x)` runs the nodes in file order with torch functions, in float32,
freeing each value after its last use. It runs the op types that the ONNX emitters of this port and
of the JAX package write, with their opset-13 semantics: Conv and ConvTranspose (pads, strides,
dilations, groups), MaxPool, AveragePool, GlobalAveragePool, BatchNormalization (inference),
Add, Sub, Mul, Div, MatMul, Sigmoid, Relu, Sqrt, Cos, Sin, Softmax (its axis), Concat, Slice
(starts, ends, axes and steps as inputs; ends past the dim such as INT64_MAX clamp), Reshape (0
copies a dim, -1 is inferred), Transpose, Flatten, Shape, Resize (nearest, asymmetric, floor, from
`scales` or `sizes`), Pad (constant), ReduceSum (axes as an input) and ReduceMax. Integer values (shapes and their
arithmetic) stay on the host. Any other op type, attribute value or tensor type is refused by
name.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from drone_yolo_tpu_torch.export import onnx_pb as P

OPSETS = range(13, 18)  # the default domain's versions whose semantics for these ops are opset 13's
_DTYPES = {P.TensorProto.FLOAT: (np.float32, torch.float32), P.TensorProto.INT64: (np.int64, torch.int64)}
# op type -> the attributes it accepts (any other attribute is refused by name)
ATTRS = {
    "Conv": {"strides", "pads", "dilations", "group", "kernel_shape", "auto_pad"},
    "ConvTranspose": {"strides", "pads", "dilations", "group", "kernel_shape", "output_padding", "auto_pad"},
    "MaxPool": {"kernel_shape", "strides", "pads", "dilations", "ceil_mode", "storage_order", "auto_pad"},
    "AveragePool": {"kernel_shape", "strides", "pads", "ceil_mode", "count_include_pad", "auto_pad"},
    "GlobalAveragePool": set(), "Add": set(), "Sub": set(), "Mul": set(), "Div": set(), "MatMul": set(),
    "Sigmoid": set(), "Relu": set(), "Sqrt": set(), "Cos": set(), "Sin": set(), "Softmax": {"axis"},
    "Concat": {"axis"}, "Slice": set(), "Reshape": {"allowzero"}, "Transpose": {"perm"}, "Flatten": {"axis"},
    "Shape": set(), "Resize": {"mode", "coordinate_transformation_mode", "nearest_mode"},
    "Pad": {"mode"}, "ReduceSum": {"keepdims", "noop_with_empty_axes"}, "ReduceMax": {"axes", "keepdims"},
    "BatchNormalization": {"epsilon", "momentum", "training_mode"},
}


def _attr_value(a: P.AttributeProto):
    A = P.AttributeProto
    kind = {A.FLOAT: "f", A.INT: "i", A.STRING: "s", A.FLOATS: "floats", A.INTS: "ints"}.get(a.type)
    if kind is None:
        raise NotImplementedError(f"ONNX attribute {a.name!r} of type {a.type} is not supported")
    v = getattr(a, kind)
    return v.decode() if kind == "s" else v


def _tensor(t: P.TensorProto, device) -> torch.Tensor:
    """An initializer as a tensor: float on `device`, integers as int64 on the host."""
    if t.data_location:
        raise NotImplementedError(f"ONNX initializer {t.name!r}: external data is not supported")
    if t.data_type not in _DTYPES:
        raise NotImplementedError(f"ONNX initializer {t.name!r}: data type {t.data_type} is not supported")
    np_dtype, dtype = _DTYPES[t.data_type]
    if t.raw_data:
        arr = np.frombuffer(t.raw_data, np.dtype(np_dtype).newbyteorder("<"))
    else:
        arr = np.asarray(t.float_data if np_dtype == np.float32 else t.int64_data, np_dtype)
    n = math.prod(t.dims)
    if arr.size != n:
        raise ValueError(f"ONNX initializer {t.name!r}: {arr.size} values for dims {list(t.dims)}")
    out = torch.from_numpy(arr.astype(np_dtype).reshape(t.dims).copy()).to(dtype)
    return out.to(device) if dtype.is_floating_point else out


def _ints(v) -> list[int]:
    return [int(i) for i in (v.tolist() if isinstance(v, torch.Tensor) else v)]


def _spatial_pads(pads, nd: int = 2):
    """ONNX pads [b1, b2, e1, e2] -> (symmetric per-dim padding or None, F.pad order (e.g. left, right, top,
    bottom))."""
    pads = list(pads or [0] * 2 * nd)
    begin, end = pads[:nd], pads[nd:]
    torch_order = [p for i in reversed(range(nd)) for p in (begin[i], end[i])]
    return (begin if begin == end else None), torch_order


def _pool_input(x, attrs, pad_value):
    """The padded input and the torch padding of a pool: asymmetric pads become an explicit F.pad."""
    if attrs.get("auto_pad", "NOTSET") != "NOTSET":
        raise NotImplementedError(f"ONNX pool auto_pad={attrs['auto_pad']!r} is not supported")
    sym, order = _spatial_pads(attrs.get("pads"))
    k = attrs["kernel_shape"]
    if sym is not None and all(2 * p <= kk for p, kk in zip(sym, k)):
        return x, sym
    return F.pad(x, order, value=pad_value), [0, 0]


def _nearest_index(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """Resize's source index of each output index along one dim, nearest with the asymmetric transform and floor
    rounding (what both emitters write): floor(o / scale), computed in float64 as the spec's reference does."""
    return np.clip(np.floor(np.arange(n_out, dtype=np.float64) / scale), 0, n_in - 1).astype(np.int64)


def _slice(x: torch.Tensor, starts, ends, axes, steps) -> torch.Tensor:
    axes = _ints(axes) if axes is not None else list(range(len(_ints(starts))))
    steps = _ints(steps) if steps is not None else [1] * len(axes)
    for start, end, axis, step in zip(_ints(starts), _ints(ends), axes, steps):
        axis %= x.dim()
        n = x.shape[axis]
        if step == 0:
            raise ValueError("ONNX Slice: a step of 0")
        start, end = start + n if start < 0 else start, end + n if end < 0 else end
        if step > 0:
            start, end = min(max(start, 0), n), min(max(end, 0), n)
            x = x.narrow(axis, start, max(end - start, 0))[(slice(None),) * axis + (slice(None, None, step),)]
        else:
            start, end = min(max(start, 0), n - 1), min(max(end, -1), n - 1)
            idx = torch.arange(start, end, step, device=x.device)
            x = x.index_select(axis, idx)
    return x


def _reshape(x: torch.Tensor, shape, allowzero: int) -> torch.Tensor:
    shape = _ints(shape)
    if not allowzero:
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)


def _div(a, b):
    """ONNX Div: integer division truncates."""
    return a / b if a.dtype.is_floating_point else torch.div(a, b, rounding_mode="trunc")


class OnnxGraph:
    """An ONNX file (path or bytes) loaded on `device`: `graph(*inputs)` -> the list of its outputs in file order."""

    def __init__(self, source, device="cpu"):
        data = source if isinstance(source, (bytes, bytearray)) else Path(source).read_bytes()
        model = P.ModelProto.FromString(bytes(data))
        versions = {op.domain or "": op.version for op in model.opset_import}
        if set(versions) - {"", "ai.onnx"} or versions.get("", versions.get("ai.onnx")) not in OPSETS:
            raise NotImplementedError(f"ONNX opsets {versions}: the runner has the default domain's opsets "
                                      f"{OPSETS.start}-{OPSETS.stop - 1}")
        self.device = torch.device(device)
        g = model.graph
        self.consts = {t.name: _tensor(t, self.device) for t in g.initializer}
        self.input_names = [v.name for v in g.input if v.name not in self.consts]
        self.output_names = [v.name for v in g.output]
        self.nodes = []
        for nd in g.node:
            if nd.domain not in (None, "", "ai.onnx"):
                raise NotImplementedError(f"ONNX node {nd.name!r}: domain {nd.domain!r} is not supported")
            if nd.op_type not in ATTRS:
                raise NotImplementedError(f"ONNX op type {nd.op_type!r} (node {nd.name!r}) is not supported")
            attrs = {a.name: _attr_value(a) for a in nd.attribute}
            extra = set(attrs) - ATTRS[nd.op_type]
            if extra:
                raise NotImplementedError(f"ONNX {nd.op_type} attributes {sorted(extra)} (node {nd.name!r}) are not "
                                          "supported")
            self.nodes.append((nd.op_type, list(nd.input), list(nd.output), attrs))
        last = {}  # value name -> index of the last node that reads it
        for i, (_, ins, _, _) in enumerate(self.nodes):
            for n in ins:
                last[n] = i
        keep = set(self.output_names)
        self._free = [[n for n in ins if last.get(n) == i and n not in keep and n not in self.consts]
                      for i, (_, ins, _, _) in enumerate(self.nodes)]

    def __call__(self, *inputs: torch.Tensor) -> list[torch.Tensor]:
        if len(inputs) != len(self.input_names):
            raise ValueError(f"the graph takes {len(self.input_names)} inputs {self.input_names}, got {len(inputs)}")
        values = dict(self.consts)
        values.update({n: x.to(self.device, torch.float32) for n, x in zip(self.input_names, inputs)})
        with torch.no_grad():
            for (op, ins, outs, attrs), free in zip(self.nodes, self._free):
                args = [values[n] if n else None for n in ins]
                res = getattr(self, f"_{op}")(attrs, *args)
                for n, r in zip(outs, res if isinstance(res, tuple) else (res,)):
                    values[n] = r
                for n in free:
                    values.pop(n, None)
        return [values[n] for n in self.output_names]

    # -- the ops, by type -----------------------------------------------------------------------------------------------
    @staticmethod
    def _Conv(attrs, x, w, b=None):
        if attrs.get("auto_pad", "NOTSET") != "NOTSET":
            raise NotImplementedError(f"ONNX Conv auto_pad={attrs['auto_pad']!r} is not supported")
        if x.dim() != 4:
            raise NotImplementedError(f"ONNX Conv on a {x.dim()}-D input: the runner has 2-D convs")
        if "kernel_shape" in attrs and list(attrs["kernel_shape"]) != list(w.shape[2:]):
            raise ValueError(f"ONNX Conv kernel_shape {attrs['kernel_shape']} against weight {list(w.shape)}")
        sym, order = _spatial_pads(attrs.get("pads"))
        if sym is None:
            x, sym = F.pad(x, order), [0, 0]
        return F.conv2d(x, w, b, attrs.get("strides", [1, 1]), sym, attrs.get("dilations", [1, 1]), attrs.get("group", 1))

    @staticmethod
    def _ConvTranspose(attrs, x, w, b=None):
        if attrs.get("auto_pad", "NOTSET") != "NOTSET" or x.dim() != 4:
            raise NotImplementedError("ONNX ConvTranspose: the runner has 2-D, explicit-pad transposed convs")
        sym, _ = _spatial_pads(attrs.get("pads"))
        if sym is None:
            raise NotImplementedError(f"ONNX ConvTranspose with asymmetric pads {attrs['pads']}")
        return F.conv_transpose2d(x, w, b, attrs.get("strides", [1, 1]), sym, attrs.get("output_padding", [0, 0]),
                                  attrs.get("group", 1), attrs.get("dilations", [1, 1]))

    @staticmethod
    def _MaxPool(attrs, x):
        if attrs.get("storage_order", 0):
            raise NotImplementedError("ONNX MaxPool's Indices output (storage_order) is not supported")
        x, pad = _pool_input(x, attrs, float("-inf"))
        return F.max_pool2d(x, attrs["kernel_shape"], attrs.get("strides", [1, 1]), pad, attrs.get("dilations", [1, 1]),
                            bool(attrs.get("ceil_mode", 0)))

    @staticmethod
    def _AveragePool(attrs, x):
        include = bool(attrs.get("count_include_pad", 0))
        sym, _ = _spatial_pads(attrs.get("pads"))
        if sym is None and not include and any(attrs["pads"]):
            raise NotImplementedError("ONNX AveragePool with asymmetric pads that are not counted")
        x, pad = _pool_input(x, attrs, 0.0)
        return F.avg_pool2d(x, attrs["kernel_shape"], attrs.get("strides", [1, 1]), pad, bool(attrs.get("ceil_mode", 0)),
                            include)

    @staticmethod
    def _GlobalAveragePool(attrs, x):
        return x.mean(tuple(range(2, x.dim())), keepdim=True)

    @staticmethod
    def _BatchNormalization(attrs, x, scale, bias, mean, var):
        if attrs.get("training_mode", 0):
            raise NotImplementedError("ONNX BatchNormalization in training mode is not supported")
        return F.batch_norm(x, mean, var, scale, bias, False, 0.0, attrs.get("epsilon", 1e-5))

    _Add = staticmethod(lambda attrs, a, b: a + b)
    _Sub = staticmethod(lambda attrs, a, b: a - b)
    _Mul = staticmethod(lambda attrs, a, b: a * b)
    _Div = staticmethod(lambda attrs, a, b: _div(a, b))
    _MatMul = staticmethod(lambda attrs, a, b: torch.matmul(a, b))
    _Sigmoid = staticmethod(lambda attrs, x: torch.sigmoid(x))
    _Relu = staticmethod(lambda attrs, x: torch.relu(x))
    _Sqrt = staticmethod(lambda attrs, x: torch.sqrt(x))
    _Cos = staticmethod(lambda attrs, x: torch.cos(x))
    _Sin = staticmethod(lambda attrs, x: torch.sin(x))
    _Softmax = staticmethod(lambda attrs, x: torch.softmax(x, attrs.get("axis", -1)))
    _Transpose = staticmethod(lambda attrs, x: x.permute(attrs.get("perm", list(reversed(range(x.dim()))))))
    _Reshape = staticmethod(lambda attrs, x, shape: _reshape(x, shape, attrs.get("allowzero", 0)))
    _Slice = staticmethod(lambda attrs, x, starts, ends, axes=None, steps=None: _slice(x, starts, ends, axes, steps))

    _Concat = staticmethod(lambda attrs, *xs: torch.cat(xs, attrs["axis"]))

    @staticmethod
    def _Flatten(attrs, x):
        axis = attrs.get("axis", 1)
        return x.reshape(math.prod(x.shape[:axis + x.dim() if axis < 0 else axis]), -1)

    _Shape = staticmethod(lambda attrs, x: torch.tensor(list(x.shape), dtype=torch.int64))

    @staticmethod
    def _Resize(attrs, x, roi=None, scales=None, sizes=None):
        got = (attrs.get("mode", "nearest"), attrs.get("coordinate_transformation_mode", "half_pixel"),
               attrs.get("nearest_mode", "round_prefer_floor"))
        if got != ("nearest", "asymmetric", "floor"):
            raise NotImplementedError(f"ONNX Resize (mode, coordinate_transformation_mode, nearest_mode) = {got}: the "
                                      "runner has ('nearest', 'asymmetric', 'floor'), what the emitters write")
        if sizes is not None and sizes.numel():
            out = _ints(sizes)
            scale = [o / i for o, i in zip(out, x.shape)]
        elif scales is not None and scales.numel():
            scale = [float(s) for s in scales.tolist()]
            out = [int(math.floor(i * s)) for i, s in zip(x.shape, scale)]
        else:
            raise ValueError("ONNX Resize needs scales or sizes")
        if out[:2] != list(x.shape[:2]):
            raise NotImplementedError(f"ONNX Resize of the batch or channel dims: {list(x.shape)} -> {out}")
        for axis in range(2, x.dim()):
            idx = _nearest_index(x.shape[axis], out[axis], scale[axis])
            x = x.index_select(axis, torch.from_numpy(idx).to(x.device))
        return x

    @staticmethod
    def _Pad(attrs, x, pads, value=None):
        if attrs.get("mode", "constant") != "constant":
            raise NotImplementedError(f"ONNX Pad mode={attrs['mode']!r}: the runner has constant")
        pads = _ints(pads)
        nd = x.dim()
        order = [p for i in reversed(range(nd)) for p in (pads[i], pads[nd + i])]  # F.pad's: the last dim first
        return F.pad(x, order, value=float(value) if value is not None else 0.0)

    @staticmethod
    def _ReduceSum(attrs, x, axes=None):
        keep = bool(attrs.get("keepdims", 1))
        if axes is None or not axes.numel():
            return x if attrs.get("noop_with_empty_axes", 0) else x.sum(tuple(range(x.dim())), keepdim=keep)
        return x.sum(tuple(_ints(axes)), keepdim=keep)

    @staticmethod
    def _ReduceMax(attrs, x):
        axes = attrs.get("axes", list(range(x.dim())))
        return torch.amax(x, tuple(axes), keepdim=bool(attrs.get("keepdims", 1)))

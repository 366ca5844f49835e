"""Model YAML -> list of layers: the `[from, repeats, module, args]` row grammar of the v3, v5, v6, v8 (P2, P6, Ghost),
v9 (GELAN), v10, YOLO11 and YOLO12 families and their classifiers.

Counterpart of `drone_yolo_tpu/nn/build.py`: the same depth gain
`max(round(n * depth), 1)`, width gain `make_divisible(min(c2, max_channels) * width, 8)`
and n/s/m/l/x scale resolution. A `C3k2` or `A2C2f` row builds the head with
`legacy=False` (the depthwise class branch; `v10Detect` has it always); at scales m, l and x `C3k2` takes
C3k blocks, and at l and x `A2C2f` takes `residual` (its gamma) and mlp_ratio 1.2. A
`Classify` row's width is nc, unscaled (a layer whose width equals nc is never scaled, as
in the JAX package and Ultralytics); `ResNetLayer` rows pass unscaled, and a `TorchVision`
row declares its width by its first argument. A row that repeats a module which does not
count its own repeats (yolov3's `Bottleneck`, yolov6's `Conv`) builds an `nn.Sequential` of
them (`model.<i>.<j>...`); `CBLinear` rows give a tuple of unscaled widths, which `CBFuse`
rows pick from. A yaml's `activation: nn.ReLU()` makes every `Conv` whose activation is the
default a ReLU one, the head's too (`_activation`).
The model files are read by `load_yaml`, a reader for the subset of YAML they use,
so the port needs no YAML package.
"""

from __future__ import annotations

import ast
import math
import re
from pathlib import Path

from torch import nn

from drone_yolo_tpu_torch.cfg import MODEL_CFG_DIR
from drone_yolo_tpu_torch.nn import modules as M

REGISTRY = {
    "Conv": M.Conv,
    "DWConv": M.DWConv,
    "GhostConv": M.GhostConv,
    "Bottleneck": M.Bottleneck,
    "GhostBottleneck": M.GhostBottleneck,
    "C2": M.C2,
    "C2f": M.C2f,
    "C3": M.C3,
    "C3Ghost": M.C3Ghost,
    "C3k2": M.C3k2,
    "C2PSA": M.C2PSA,
    "PSA": M.PSA,
    "SCDown": M.SCDown,
    "CIB": M.CIB,
    "C2fCIB": M.C2fCIB,
    "RepVGGDW": M.RepVGGDW,
    "A2C2f": M.A2C2f,
    "SPP": M.SPP,
    "SPPF": M.SPPF,
    "RepVGGBlock": M.RepVGGBlock,
    "RepConv": M.RepConv,
    "RepCSP": M.RepCSP,
    "RepNCSPELAN4": M.RepNCSPELAN4,
    "ELAN1": M.ELAN1,
    "AConv": M.AConv,
    "ADown": M.ADown,
    "SPPELAN": M.SPPELAN,
    "CBLinear": M.CBLinear,
    "CBFuse": M.CBFuse,
    "Concat": M.Concat,
    "nn.Upsample": M.Upsample,
    "nn.Identity": nn.Identity,
    "Identity": nn.Identity,
    "nn.MaxPool2d": nn.MaxPool2d,
    "MaxPool2d": nn.MaxPool2d,
    "nn.ZeroPad2d": nn.ZeroPad2d,
    "ZeroPad2d": nn.ZeroPad2d,
    "nn.ConvTranspose2d": nn.ConvTranspose2d,
    "ConvTranspose2d": nn.ConvTranspose2d,
    "Detect": M.Detect,
    "v10Detect": M.v10Detect,
    "Pose": M.Pose,
    "Segment": M.Segment,
    "OBB": M.OBB,
    "Classify": M.Classify,
    "ResNetLayer": M.ResNetLayer,
    "TorchVision": M.TorchVision,
}
HEAD_MODULES = {M.Detect, M.v10Detect, M.Pose, M.Segment, M.OBB}  # take their levels' input widths as the last argument
BASE_MODULES = {M.Conv, M.DWConv, M.GhostConv, M.Bottleneck, M.GhostBottleneck, M.C2, M.C2f, M.C3, M.C3Ghost, M.C3k2,
                M.C2PSA, M.PSA, M.SCDown, M.CIB, M.C2fCIB, M.A2C2f, M.SPP, M.SPPF, M.RepVGGBlock, M.RepConv, M.RepCSP,
                M.RepNCSPELAN4, M.ELAN1, M.AConv, M.ADown, M.SPPELAN, M.Classify, nn.ConvTranspose2d}  # (c1, c2, ...)
REPEAT_MODULES = {M.C2, M.C2f, M.C3, M.C3Ghost, M.C3k2, M.C2PSA, M.C2fCIB, M.A2C2f, M.RepCSP}  # the repeat count is 3rd


# ---------------------------------------------------------------------------
# YAML subset: block mappings and lists by indentation, flow lists, scalars,
# quoted strings and comments. Scalars resolve as PyYAML's safe_load does.
# ---------------------------------------------------------------------------
_INT = re.compile(r"[-+]?[0-9]+$")
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+]?[0-9]+)?$")
_NULL = {"", "~", "null", "Null", "NULL"}
_BOOL = {"true": True, "True": True, "TRUE": True, "false": False, "False": False, "FALSE": False,
         "yes": True, "Yes": True, "YES": True, "no": False, "No": False, "NO": False,
         "on": True, "On": True, "ON": True, "off": False, "Off": False, "OFF": False}


def _scalar(s: str):
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s)
    if _FLOAT.match(s):
        return float(s)
    return s


def _flow(s: str, i: int = 0):
    """Parse one flow value starting at s[i]; returns (value, next index)."""
    while s[i] == " ":
        i += 1
    if s[i] == "[":
        out, i = [], i + 1
        while True:
            while s[i] == " ":
                i += 1
            if s[i] == "]":
                return out, i + 1
            item, i = _flow(s, i)
            out.append(item)
            while s[i] == " ":
                i += 1
            if s[i] == ",":
                i += 1
            elif s[i] != "]":
                raise ValueError(f"expected ',' or ']' at {i} in {s!r}")
    if s[i] in "'\"":
        j = s.index(s[i], i + 1)
        return s[i + 1 : j], j + 1
    j = i
    while j < len(s) and s[j] not in ",]":
        j += 1
    return _scalar(s[i:j]), j


def _value(s: str):
    v, i = _flow(s)
    if s[i:].strip():
        raise ValueError(f"trailing text after value in {s!r}")
    return v


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _block(lines, i: int, indent: int):
    """Parse the block of `lines[i:]` at `indent`; returns (value, next line index)."""
    if lines[i][1].startswith("-"):
        out = []
        while i < len(lines) and lines[i][0] == indent and lines[i][1].startswith("-"):
            out.append(_value(lines[i][1][1:]))
            i += 1
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        key, sep, rest = lines[i][1].partition(":")
        if not sep:
            raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
        i += 1
        if rest.strip():
            out[_scalar(key)] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (lines[i][0] == indent and lines[i][1].startswith("-"))):
            out[_scalar(key)], i = _block(lines, i, lines[i][0])
        else:
            out[_scalar(key)] = None
    return out, i


def load_yaml(text: str) -> dict:
    """Read the YAML subset that the model files use into a dict."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return {}
    data, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return data


# ---------------------------------------------------------------------------
# Model files
# ---------------------------------------------------------------------------
def make_divisible(x, divisor: int = 8) -> int:
    """Smallest multiple of divisor that is >= x."""
    return math.ceil(x / divisor) * divisor


def guess_model_scale(model_path) -> str:
    """The n/s/m/l/x scale letter of a name such as yolov8s-p2.yaml, or ''."""
    m = re.search(r"yolo[v]?\d+([nslmx])", Path(model_path).stem)
    return m.group(1) if m else ""


def yaml_model_load(path) -> dict:
    """Load a model yaml; a scale-suffixed name (yolov8s-p2.yaml) resolves to its unified file."""
    path = Path(path)
    stem = path.stem
    unified = re.sub(r"(\d+)([nslmx])(.+)?$", r"\1\3", stem)
    candidates = [path]
    if not path.exists():
        candidates += sorted(MODEL_CFG_DIR.rglob(f"{stem}.yaml")) + sorted(MODEL_CFG_DIR.rglob(f"{unified}.yaml"))
    for c in candidates:
        if Path(c).exists():
            d = load_yaml(Path(c).read_text(encoding="utf-8"))
            d["scale"] = guess_model_scale(stem)
            d["yaml_file"] = str(path)
            return d
    raise FileNotFoundError(f"model yaml '{path}' not found (searched {MODEL_CFG_DIR})")


def _activation(spec) -> str | None:
    """The Conv activation a yaml's `activation:` key names: None when absent, "relu" for ReLU. Any other is refused
    by name (the JAX package keeps SiLU for it without a word)."""
    if spec is None:
        return None
    if re.fullmatch(r"(torch\.)?(nn\.)?ReLU\((inplace\s*=\s*(True|False))?\)", str(spec).strip()):
        return "relu"
    raise ValueError(f"activation {spec!r} is not ported; nn.ReLU() is")


def parse_model(d: dict, ch: int = 3):
    """Build the layers of a model dict.

    Returns (modules, froms, save, nc, channels): the module of each row, its
    `from` field, the sorted indices of outputs needed later, the class count,
    and each layer's output channels.
    """
    nc = d.get("nc", 80)
    kpt_shape = d.get("kpt_shape")
    scales = d.get("scales")
    scale = d.get("scale") or (next(iter(scales)) if scales else None)
    depth, width, max_channels = d.get("depth_multiple", 1.0), d.get("width_multiple", 1.0), float("inf")
    if scales:
        if scale not in scales:
            scale = next(iter(scales))
        depth, width, max_channels = scales[scale]

    act = _activation(d.get("activation"))
    ch_list = [ch]
    modules, froms, save = [], [], []
    legacy = True  # the v8 head's class branch; a C3k2 or A2C2f row switches to the depthwise one
    for i, (f, n, mname, args) in enumerate(d["backbone"] + d["head"]):
        cls = REGISTRY.get(mname)
        if cls is None:
            raise KeyError(f"module '{mname}' is not ported yet (ported: {sorted(REGISTRY)})")
        args = list(args)
        for j, a in enumerate(args):
            if isinstance(a, str):
                if a == "nc":
                    args[j] = nc
                elif a == "kpt_shape":
                    args[j] = kpt_shape
                else:
                    try:
                        args[j] = ast.literal_eval(a)
                    except (ValueError, SyntaxError):
                        pass
        n_scaled = max(round(n * depth), 1) if n > 1 else n

        if cls in BASE_MODULES:
            c1, c2 = ch_list[f], args[0]
            if c2 != nc:  # as the JAX package: an output width equal to nc is not scaled
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [c1, c2, *args[1:]]
            if cls in REPEAT_MODULES:
                args.insert(2, n_scaled)
                n_scaled = 1
            if cls is M.C3k2:
                legacy = False
                if scale in ("m", "l", "x"):  # c3k
                    if len(args) > 3:
                        args[3] = True
                    else:
                        args.append(True)
            if cls is M.A2C2f:
                legacy = False
                if scale in ("l", "x"):  # residual, mlp_ratio
                    args.extend((True, 1.2))
        elif cls is M.ResNetLayer:  # the arguments pass through unscaled; a block's output is 4 c2, the stem's c2
            c2 = args[1] if args[3] else args[1] * 4
        elif cls is M.TorchVision:  # the output width is declared by the first argument, then dropped
            c2, args = args[0], args[1:]
        elif cls is M.Concat:
            c2 = sum(ch_list[x] for x in f)
        elif cls is M.CBLinear:  # the output is a tuple of the listed widths, unscaled
            c2, args = args[0], [ch_list[f], *args]
        elif cls is M.CBFuse:
            c2 = ch_list[f[-1]]
        elif cls in HEAD_MODULES:
            if cls is M.Segment and len(args) > 2:  # Segment(nc, nm, npr): npr is width-scaled, as the JAX package
                args[2] = make_divisible(min(args[2], max_channels) * width, 8)
            args = [*args, [ch_list[x] for x in f]]
            c2 = ch_list[f[0]]
        else:  # Upsample, Identity, MaxPool2d and ZeroPad2d keep their input's channels
            c2 = ch_list[f]

        if cls in HEAD_MODULES:
            module = cls(*args, legacy=legacy)
        elif n_scaled > 1:  # a module that does not count its repeats, stacked (the JAX package's `_RepeatSeq`)
            module = nn.Sequential(*(cls(*args) for _ in range(n_scaled)))
        else:
            module = cls(*args)
        if act is not None:
            for m in module.modules():
                if isinstance(m, M.Conv) and m.act is True:
                    m.act = act
        modules.append(module)
        froms.append(f)
        save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
        if i == 0:
            ch_list = []
        ch_list.append(c2)
    return modules, froms, sorted(set(save)), nc, ch_list

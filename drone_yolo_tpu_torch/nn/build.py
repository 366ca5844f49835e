"""Model YAML -> list of layers: the `[from, repeats, module, args]` row grammar of the v8 family.

Counterpart of `drone_yolo_tpu/nn/build.py`: the same depth gain
`max(round(n * depth), 1)`, width gain `make_divisible(min(c2, max_channels) * width, 8)`
and n/s/m/l/x scale resolution. The model files are read by `load_yaml`, a
reader for the subset of YAML they use, so the port needs no YAML package.
"""

from __future__ import annotations

import ast
import math
import re
from pathlib import Path

from drone_yolo_tpu_torch.cfg import MODEL_CFG_DIR
from drone_yolo_tpu_torch.nn import modules as M

REGISTRY = {
    "Conv": M.Conv,
    "DWConv": M.DWConv,
    "C2f": M.C2f,
    "SPPF": M.SPPF,
    "RepVGGBlock": M.RepVGGBlock,
    "Concat": M.Concat,
    "nn.Upsample": M.Upsample,
    "Detect": M.Detect,
}
BASE_MODULES = {M.Conv, M.DWConv, M.C2f, M.SPPF, M.RepVGGBlock}  # take (c1, c2, ...)
REPEAT_MODULES = {M.C2f}  # take the repeat count as their third argument


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


def parse_model(d: dict, ch: int = 3):
    """Build the layers of a model dict.

    Returns (modules, froms, save, nc, channels): the module of each row, its
    `from` field, the sorted indices of outputs needed later, the class count,
    and each layer's output channels.
    """
    nc = d.get("nc", 80)
    scales = d.get("scales")
    scale = d.get("scale") or (next(iter(scales)) if scales else None)
    depth, width, max_channels = d.get("depth_multiple", 1.0), d.get("width_multiple", 1.0), float("inf")
    if scales:
        if scale not in scales:
            scale = next(iter(scales))
        depth, width, max_channels = scales[scale]

    ch_list = [ch]
    modules, froms, save = [], [], []
    for i, (f, n, mname, args) in enumerate(d["backbone"] + d["head"]):
        cls = REGISTRY.get(mname)
        if cls is None:
            raise KeyError(f"module '{mname}' is not ported yet (ported: {sorted(REGISTRY)})")
        args = list(args)
        for j, a in enumerate(args):
            if isinstance(a, str):
                if a == "nc":
                    args[j] = nc
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
        elif cls is M.Concat:
            c2 = sum(ch_list[x] for x in f)
        elif cls is M.Detect:
            args = [*args, [ch_list[x] for x in f]]
            c2 = ch_list[f[0]]
        else:  # Upsample keeps its input's channels
            c2 = ch_list[f]
        if n_scaled != 1:
            raise ValueError(f"layer {i}: repeats of {mname} outside a repeat-aware module are not ported yet")

        modules.append(cls(*args))
        froms.append(f)
        save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
        if i == 0:
            ch_list = []
        ch_list.append(c2)
    return modules, froms, sorted(set(save)), nc, ch_list

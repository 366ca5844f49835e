"""JAX-package checkpoints in the port: the `drone_yolo_tpu.v1` npz and the weight bridge.

The npz holds the variables tree flattened with '/'-joined keys and a JSON
`__header__` that embeds the model's yaml dict, so a checkpoint loads with no
YAML parsing (format: `drone_yolo_tpu/engine/checkpoint.py`).

`from_jax_variables` maps a JAX variables tree to the port's `state_dict`:
HWIO kernels become OIHW, BN `scale/bias/mean/var` become
`weight/bias/running_mean/running_var`, RepVGG `dense/one/idbn` become
`rbr_dense/rbr_1x1/rbr_identity`, Proto's transposed conv `up` (a (2, 2, out, in) kernel) becomes
`upsample` (the torch (in, out, 2, 2) weight, the same transpose as a conv's; so does a yolov6
`nn.ConvTranspose2d` layer's), A2C2f's `gamma` keeps its name, GhostBottleneck's `g1/dw/g2/sc_dw/sc_pw`
become the reference's `conv.0/conv.1/conv.2/shortcut.0/shortcut.1`, a fused RepConv's `kernel/bias` its
own `weight/bias` (so does a fused RepVGGDW's; unfused, its `conv` and `conv1` keep their names), a fused
RepVGGBlock's (where the port model has one) its `rbr_reparam`, Classify's
`linear/kernel` (1280, nc) becomes the torch (nc, 1280) `linear.weight`, a TorchVision trunk's
`stem` and flat `blocks/<i>/cv1|cv2|down` become the reference's `m.0`, `m.1` and `m.<4 + layer>.<j>.conv1|bn1|
conv2|bn2|downsample` (a block with `down` after the first starts the next layer), and the sequences drop the JAX
`m` level under which a JAX `_Seq` (or `_RepeatSeq`) keeps its children: a node of the tree whose only key is `m`.
Those are the head's branches (Detect's `cv2.<i>`, `cv3.<i>`, v10Detect's `one2one_cv2.<i>` and `one2one_cv3.<i>`,
Pose's, Segment's and OBB's `cv4.<i>`), the sequences nested in them (the YOLO11/12 and v10 `cv3.<i>.<j>`), PSABlock's
and PSA's `ffn`, CIB's `cv1`, ABlock's `mlp`, A2C2f's pairs of ABlocks
(`m.<i>`), RepNCSPELAN4's `cv2` and `cv3`, and a repeated row of a module that does not count its repeats
(`model.<i>.<j>`: yolov3's Bottlenecks, yolov6's Convs). `_jax_path` puts the level back from the torch name
alone. Names are the reference torch names (`model.<i>....`), which
`drone_yolo_tpu/utils/torch_convert.py:convert_state_dict` maps back (a TorchVision trunk's only
`to_jax_variables`).
`from_jax_train_state` maps a whole JAX train state (params, optimizer state,
EMA, accumulated gradients) the same way.

The writer goes the other way: `to_jax_variables` is the inverse of
`from_jax_variables` (the port's copy of `convert_state_dict`), `save_checkpoint` writes
the `drone_yolo_tpu.v1` npz of `drone_yolo_tpu/engine/checkpoint.py:save_checkpoint`, and
`resume_state` flattens a train state into the JAX trainer's `resume_state.npz` layout
(`drone_yolo_tpu/engine/trainer.py:save_model`), which `read_resume_state` reads back, so
either package resumes from the other's file.
"""

from __future__ import annotations

import json
import re
from datetime import datetime, timezone
from pathlib import Path

import numpy as np
import torch

FORMAT = "drone_yolo_tpu.v1"
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var",
         "gamma": "gamma"}
_BRANCH = {"dense": "rbr_dense", "one": "rbr_1x1", "idbn": "rbr_identity", "up": "upsample",
           "g1": "conv.0", "dw": "conv.1", "g2": "conv.2", "sc_dw": "shortcut.0", "sc_pw": "shortcut.1"}
_BRANCH_JAX = {v: k for k, v in _BRANCH.items()}
_LEAF_JAX = {"running_mean": "mean", "running_var": "var", "bias": "bias", "gamma": "gamma"}
_NAMED_SEQS = ("ffn", "mlp", "cv1")  # PSABlock's, PSA's and ABlock's feed-forward sequences; CIB's cv1
_ELAN_SEQS = ("cv2", "cv3")  # RepNCSPELAN4's sequences; Detect's branch lists of the same names hold sequences


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {'a/b/c': leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_tree(flat: dict) -> dict:
    """{'a/b/c': leaf} -> nested dict; the inverse of flatten_tree."""
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _torch_names(tree: dict, prefix: list[str], reparam: set) -> dict:
    """A JAX variables (sub)tree under the torch path `prefix` -> {reference torch name: leaf}. A node whose only key
    is `m` is a JAX sequence: its `m` level has no torch counterpart. A node's own kernel and bias are a fused
    RepVGGBlock's (`rbr_reparam`) where the torch path is in `reparam`, else the module's own (a transposed conv's,
    a fused RepConv's)."""
    out = {}
    path = ".".join(["model", *prefix])
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_torch_names(v, prefix if k == "m" and len(tree) == 1 else [*prefix, _BRANCH.get(k, k)],
                                    reparam))
        else:
            out[".".join([path, *(["rbr_reparam"] if path in reparam else []), _LEAF[k]])] = v
    return out


# A TorchVision trunk: the JAX package's `stem` and flat `blocks` <-> the reference's `m.<i>` (torchvision's children:
# conv1, bn1, relu, maxpool, layer1..layer4), each block's `cv1`/`cv2`/`down` <-> conv1+bn1 / conv2+bn2 / downsample
_TV_STEM = {"conv": "0", "bn": "1"}
_TV_BLOCK = {("cv1", "conv"): "conv1", ("cv1", "bn"): "bn1", ("cv2", "conv"): "conv2", ("cv2", "bn"): "bn2",
             ("down", "conv"): "downsample.0", ("down", "bn"): "downsample.1"}
_TV_BLOCK_JAX = {v: k for k, v in _TV_BLOCK.items()}
_TV_FIRST_LAYER = 4  # m.4 is layer1


def _tv_stages(blocks: dict) -> dict:
    """A TorchVision trunk's flat JAX block index -> (torchvision layer, index in it): a block with `down` after the
    first starts the next layer."""
    out, layer, j = {}, 0, 0
    for bi in sorted(blocks, key=int):
        if "down" in blocks[bi] and int(bi) > 0:
            layer, j = layer + 1, 0
        out[bi] = (layer, j)
        j += 1
    return out


def _tv_to_torch(layer: str, tree: dict) -> dict:
    """The flat JAX variables of TorchVision layer `layer` -> {torch name: array}."""
    out = {}
    for key, a in flatten_tree(tree.get("stem", {})).items():
        part, leaf = key.split("/")
        out[f"model.{layer}.m.{_TV_STEM[part]}.{_LEAF[leaf]}"] = a
    stages = _tv_stages(tree.get("blocks", {}))
    for key, a in flatten_tree(tree.get("blocks", {})).items():
        bi, branch, part, leaf = key.split("/")
        li, j = stages[bi]
        out[f"model.{layer}.m.{_TV_FIRST_LAYER + li}.{j}.{_TV_BLOCK[branch, part]}.{_LEAF[leaf]}"] = a
    return out


def _tv_to_jax(names: list[str]) -> dict:
    """The torch names of one TorchVision layer -> {torch name: JAX path}, blocks numbered in order."""
    order = sorted({tuple(int(p) for p in n.split(".")[3:5]) for n in names if n.split(".")[3].isdigit()
                    and int(n.split(".")[3]) >= _TV_FIRST_LAYER})
    flat = {ij: str(bi) for bi, ij in enumerate(order)}
    out = {}
    for n in names:
        parts = n.split(".")
        layer, i, leaf = parts[1], int(parts[3]), parts[-1]
        if i < _TV_FIRST_LAYER:
            out[n] = [layer, "stem", "conv" if i == 0 else "bn"]
        else:
            out[n] = [layer, "blocks", flat[i, int(parts[4])], *_TV_BLOCK_JAX[".".join(parts[5:-1])]]
        is_conv = out[n][-1] == "conv"
        out[n].append({"weight": "kernel" if is_conv else "scale"}.get(leaf) or _LEAF_JAX[leaf])
    return out


def _is_torchvision(tree: dict) -> bool:
    return isinstance(tree, dict) and "stem" in tree and "blocks" in tree


def from_jax_variables(variables: dict, model=None) -> dict:
    """JAX variables tree (numpy leaves, unfused or fused) -> port state_dict of float32 tensors. A fused tree of a
    model with RepVGGBlocks needs the port `model` it is for: a fused RepVGGBlock's kernel and bias sit in the JAX
    tree as a plain module's do, and only the model's own RepVGGBlocks say where `rbr_reparam` goes."""
    from drone_yolo_tpu_torch.nn.modules import RepVGGBlock

    reparam = set() if model is None else {n for n, m in model.named_modules() if isinstance(m, RepVGGBlock)}
    flat = {}
    for layer, tree in variables.items():
        if _is_torchvision(tree):
            flat.update(_tv_to_torch(layer, tree))
        else:
            flat.update(_torch_names(tree, [layer], reparam))
    sd = {}
    for name, v in flat.items():
        a = np.array(v, np.float32)
        if a.ndim == 4:
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))  # HWIO -> OIHW
        elif a.ndim == 2:
            a = np.ascontiguousarray(a.T)  # a linear's (in, out) kernel -> the torch (out, in) weight
        sd[name] = torch.from_numpy(a)
    return sd


def _jax_path(name: str, ndim: int) -> list[str]:
    """Reference torch parameter name -> JAX variable path; the inverse of `_torch_names`. A torch index is a child of a
    JAX sequence, under its `m`, when it follows the layer's index (a repeated row), another index (a head branch's
    sequence, A2C2f's pair of ABlocks), `ffn`, `mlp` or `cv1` (CIB's), or `cv2`/`cv3` without a second index after it
    (RepNCSPELAN4's; Detect's `cv2.<i>` is a list of sequences)."""
    parts = name.split(".")
    if parts[0] != "model" or len(parts) < 3:
        raise ValueError(f"not a model parameter name: {name}")
    *path, leaf = parts[1:]
    out, j = [], 1
    while j < len(path):
        p = path[j]
        pair = ".".join(path[j:j + 2])
        if pair in _BRANCH_JAX:  # GhostBottleneck's stages
            out.append(_BRANCH_JAX[pair])
            j += 2
            continue
        if p == "rbr_reparam" and j == len(path) - 1:
            break  # a fused RepVGGBlock's kernel lives at the block
        prev, after = path[j - 1], path[j + 1] if j + 1 < len(path) else ""
        seq_child = j == 1 or prev.isdigit() or prev in _NAMED_SEQS or (prev in _ELAN_SEQS and not after.isdigit())
        if p.isdigit() and seq_child:
            out.append("m")
        out.append(_BRANCH_JAX.get(p, p))
        j += 1
    out.insert(0, path[0])
    if leaf == "weight":
        return out + ["kernel" if ndim in (2, 4) else "scale"]
    return out + [_LEAF_JAX[leaf]]


_TV_NAME = re.compile(r"model\.(\d+)\.m\.\d+\.\d+\.conv1\.")  # a BasicBlock of a TorchVision trunk


def to_jax_variables(state_dict: dict) -> dict:
    """Port state_dict -> JAX variables tree of float32 numpy arrays (OIHW kernels become HWIO, a linear's weight its
    (in, out) kernel)."""
    tv_layers = {m.group(1) for m in map(_TV_NAME.match, state_dict) if m}
    tv_paths = {}
    for layer in tv_layers:
        tv_paths.update(_tv_to_jax([n for n in state_dict if n.startswith(f"model.{layer}.m.")]))
    flat = {}
    for name, t in state_dict.items():
        a = t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)
        if a.ndim == 4:
            a = np.ascontiguousarray(a.transpose(2, 3, 1, 0))  # OIHW -> HWIO (a transposed conv's IOHW -> HWOI)
        elif a.ndim == 2:
            a = np.ascontiguousarray(a.T)
        flat["/".join(tv_paths.get(name) or _jax_path(name, a.ndim))] = a
    return unflatten_tree(flat)


def _jsonable(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, Path):
            v = str(v)
        elif isinstance(v, np.generic):
            v = v.item()
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        try:
            json.dumps(v)
        except TypeError:
            v = str(v)
        out[k] = v
    return out


def save_checkpoint(path, model, state_dict: dict, train_args: dict | None = None, meta: dict | None = None) -> Path:
    """Write `state_dict` (the model's layout, by name) as a `drone_yolo_tpu.v1` npz with `model`'s yaml, names
    and strides in the JSON header, plus `train_args` and `meta`."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(".npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    header = {
        "format": FORMAT,
        "task": model.task,
        "yaml": {k: v for k, v in model.yaml.items() if k != "yaml_file"},
        "names": {int(k): v for k, v in model.names.items()},
        "stride": [float(s) for s in model.head.stride],
        "train_args": _jsonable(train_args or {}),
        "date": datetime.now(timezone.utc).isoformat(),
        **_jsonable(meta or {}),
    }
    np.savez(path, __header__=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
             **flatten_tree(to_jax_variables(state_dict)))
    return path


def resume_state(ts: dict, epoch: int) -> dict:
    """A train state in `BaseTrainer.train_state`'s layout -> the flat arrays of the JAX trainer's
    `resume_state.npz`: params, opt (the SGD momentum tree, zeros for the BN statistics, or Adam's m, v and t),
    ema, step, count and epoch, by JAX names."""
    params = to_jax_variables(ts["params"])
    zeros = {k: torch.zeros_like(v) for k, v in ts["params"].items()}
    if "momentum" in ts["opt"]:
        opt = to_jax_variables({**zeros, **ts["opt"]["momentum"]})
    else:
        opt = {"m": to_jax_variables({**zeros, **ts["opt"]["m"]}), "v": to_jax_variables({**zeros, **ts["opt"]["v"]}),
               "t": np.int32(ts["opt"]["t"])}
    state = {"params": params, "opt": opt, "ema": to_jax_variables(ts["ema"]), "step": np.int32(ts["step"]),
             "count": np.int32(ts["count"]), "epoch": np.int32(epoch)}
    return flatten_tree(state)


def read_resume_state(path) -> tuple[dict, int]:
    """A `resume_state.npz` of either package -> (a train state in `BaseTrainer.train_state`'s layout with a zero
    accumulator, the epoch it was saved after)."""
    with np.load(path, allow_pickle=False) as data:
        tree = unflatten_tree({k: data[k] for k in data.files})
    tree["acc"] = {k: v for k, v in tree["params"].items()}  # the structure of params; zeroed below
    ts = from_jax_train_state(tree)
    ts["acc"] = {k: torch.zeros_like(v) for k, v in ts["acc"].items()}
    ts["count"] = int(np.asarray(tree.get("count", 0)))
    return ts, int(np.asarray(tree["epoch"]))


def from_jax_train_state(state: dict) -> dict:
    """JAX train state (`drone_yolo_tpu/engine/trainer.py`: params, opt, ema, acc, count, step) -> the layout of
    `engine.trainer.BaseTrainer.train_state`. The SGD momentum tree, the Adam moments, the EMA and the
    accumulator have the structure of the params and map by the same names; Adam's `t` is the step count."""
    opt = state["opt"]
    if isinstance(opt, dict) and set(opt) == {"m", "v", "t"}:
        opt = {"m": from_jax_variables(opt["m"]), "v": from_jax_variables(opt["v"]), "t": int(np.asarray(opt["t"]))}
    else:
        opt = {"momentum": from_jax_variables(opt)}
    return {"params": from_jax_variables(state["params"]), "opt": opt, "ema": from_jax_variables(state["ema"]),
            "acc": from_jax_variables(state["acc"]), "count": int(np.asarray(state["count"])),
            "step": int(np.asarray(state["step"]))}


def load_checkpoint(path):
    """Read a JAX-package checkpoint: returns (model, header).

    The model is built from the embedded yaml dict, fused if the checkpoint is,
    and holds the checkpoint's weights, names and strides.
    """
    from drone_yolo_tpu_torch.nn.model import TASK2MODELCLASS

    path = Path(path)
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        flat = {k: data[k] for k in data.files if k != "__header__"}
    if header.get("format") != FORMAT:
        raise ValueError(f"{path}: format {header.get('format')!r}, expected {FORMAT!r}")
    task = header.get("task", "detect")
    if task not in TASK2MODELCLASS:
        raise ValueError(f"{path}: task {task!r} is not ported yet")
    model = TASK2MODELCLASS[task](dict(header["yaml"]))
    if not any(k.endswith("/mean") for k in flat):  # folded weights carry no BN statistics
        model.fuse()
    model.load_state_dict(from_jax_variables(unflatten_tree(flat), model), strict=True)
    model.names = {int(k): v for k, v in header.get("names", {}).items()} or model.names
    if header.get("stride"):
        model.head.stride = [int(s) for s in header["stride"]]
    return model, header

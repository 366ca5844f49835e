"""JAX-package checkpoints in the port: the `drone_yolo_tpu.v1` npz and the weight bridge.

The npz holds the variables tree flattened with '/'-joined keys and a JSON
`__header__` that embeds the model's yaml dict, so a checkpoint loads with no
YAML parsing (format: `drone_yolo_tpu/engine/checkpoint.py`).

`from_jax_variables` maps a JAX variables tree to the port's `state_dict`:
HWIO kernels become OIHW, BN `scale/bias/mean/var` become
`weight/bias/running_mean/running_var`, RepVGG `dense/one/idbn` become
`rbr_dense/rbr_1x1/rbr_identity`, and the head's sequences drop the JAX `m`
level. Names are the reference torch names (`model.<i>....`), which
`drone_yolo_tpu/utils/torch_convert.py:convert_state_dict` maps back.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

FORMAT = "drone_yolo_tpu.v1"
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_BRANCH = {"dense": "rbr_dense", "one": "rbr_1x1", "idbn": "rbr_identity"}


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


def _torch_name(parts: list[str]) -> str:
    """JAX variable path (layer index first) -> reference torch parameter name."""
    *path, leaf = parts
    names = []
    for j, p in enumerate(path):
        if p == "m" and j >= 2 and path[j - 1].isdigit() and path[j - 2] in ("cv2", "cv3"):
            continue  # Detect's cv2/cv3 sequences keep their children under "m" in JAX
        names.append(_BRANCH.get(p, p))
    if len(path) == 1 and leaf in ("kernel", "bias"):
        names.append("rbr_reparam")  # a layer-level kernel is a fused RepVGGBlock
    return ".".join(["model", *names, _LEAF[leaf]])


def from_jax_variables(variables: dict) -> dict:
    """JAX variables tree (numpy leaves, unfused or fused) -> port state_dict of float32 tensors."""
    sd = {}
    for key, v in flatten_tree(variables).items():
        parts = key.split("/")
        a = np.array(v, np.float32)
        if parts[-1] == "kernel":
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))  # HWIO -> OIHW
        sd[_torch_name(parts)] = torch.from_numpy(a)
    return sd


def load_checkpoint(path):
    """Read a JAX-package checkpoint: returns (model, header).

    The model is built from the embedded yaml dict, fused if the checkpoint is,
    and holds the checkpoint's weights, names and strides.
    """
    from drone_yolo_tpu_torch.nn.model import DetectionModel

    path = Path(path)
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        flat = {k: data[k] for k in data.files if k != "__header__"}
    if header.get("format") != FORMAT:
        raise ValueError(f"{path}: format {header.get('format')!r}, expected {FORMAT!r}")
    if header.get("task", "detect") != "detect":
        raise ValueError(f"{path}: task {header['task']!r} is not ported yet")
    model = DetectionModel(dict(header["yaml"]))
    if not any(k.endswith("/mean") for k in flat):  # folded weights carry no BN statistics
        model.fuse()
    model.load_state_dict(from_jax_variables(unflatten_tree(flat)), strict=True)
    model.names = {int(k): v for k, v in header.get("names", {}).items()} or model.names
    if header.get("stride"):
        model.head.stride = [int(s) for s in header["stride"]]
    return model, header

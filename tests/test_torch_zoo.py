"""The YOLOv3, v5, v6, P6, Ghost and YOLOv9 (GELAN) yamls in the port against the JAX package, on the CPU in float32.

Every comparison starts from one set of weights that crosses by the bridge (`to_jax_variables` /
`from_jax_variables`), and every input is made from a numpy seed:

- each new block (C2, SPP, GhostConv, GhostBottleneck at stride 1 and 2, C3Ghost, RepConv, RepCSP, RepNCSPELAN4,
  ELAN1, AConv, ADown, SPPELAN, CBLinear, a repeated row, a yolov6 `nn.ConvTranspose2d`) in eval and train mode, and
  its VJP in train mode against `jax.vjp` (the input's and every parameter's gradient); the fused RepConv; CBFuse's
  half-pixel nearest resize on maps whose sizes do not divide;
- the layer plan of all 19 yamls (types, `from`s, widths, saves, strides, variable count) against the JAX build, and
  each yaml read by the port's reader as PyYAML reads it;
- fused and unfused whole-model forwards of one model of each group;
- the bridge both ways bitwise for every new module kind, fused trees too, against the JAX package's
  `convert_state_dict` (the reference's torch names), and the npz checkpoint and the resume state;
- one train step of a narrow yolov9c against the JAX `step_fn` within `REF_NOISE` (tests/test_torch_train.py),
  with both kernels' plain versions;
- `YOLO(...)` predicting and one train step for each of the 19 yamls, the stride-2 sites the kernel covers, the
  `activation:` override and its refusals, and a run with jax, cv2, PIL, yaml and sklearn blocked.
"""

import functools
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import s2_sites, synthetic_batch
from drone_yolo_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from drone_yolo_tpu.nn import build as JB
from drone_yolo_tpu.nn import modules as JM
from drone_yolo_tpu.nn.model import DetectionModel as JDetectionModel
from drone_yolo_tpu.nn.model import PoseModel as JPoseModel
from drone_yolo_tpu.nn.model import SegmentationModel as JSegmentationModel
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.cfg import MODEL_CFG_DIR
from drone_yolo_tpu_torch.engine.checkpoint import (flatten_tree, from_jax_train_state, from_jax_variables,
                                                    load_checkpoint, read_resume_state, resume_state, save_checkpoint,
                                                    to_jax_variables, unflatten_tree)
from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
from drone_yolo_tpu_torch.nn import modules as TM
from drone_yolo_tpu_torch.nn.build import load_yaml, parse_model, yaml_model_load
from drone_yolo_tpu_torch.nn.model import TASK2MODELCLASS, guess_model_task
from test_torch_modules import load_port, nchw, nhwc, randomize
from test_torch_predict import BLOCKER, REPO
from test_torch_train import LOSS_TOL, _close, _jax_step

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
JAX_MODELS = {"detect": JDetectionModel, "pose": JPoseModel, "segment": JSegmentationModel}
ZOO_YAMLS = ["v8/yolov8-p6.yaml", "v8/yolov8-pose-p6.yaml", "v8/yolov8-seg-p6.yaml", "v5/yolov5.yaml",
             "v5/yolov5-p6.yaml", "v3/yolov3.yaml", "v3/yolov3-spp.yaml", "v3/yolov3-tiny.yaml", "v6/yolov6.yaml",
             "v8/yolov8-ghost.yaml", "v8/yolov8-ghost-p2.yaml", "v8/yolov8-ghost-p6.yaml", "v9/yolov9t.yaml",
             "v9/yolov9s.yaml", "v9/yolov9m.yaml", "v9/yolov9c.yaml", "v9/yolov9c-seg.yaml", "v9/yolov9e.yaml",
             "v9/yolov9e-seg.yaml"]
BATCH, NC = 2, 2


def _model_name(path: str) -> str:
    """The scale-n name of a unified yaml (yolov8-p6.yaml -> yolov8n-p6.yaml); a single-model file's own name."""
    name = path.split("/")[1]
    if "scales" not in load_yaml((MODEL_CFG_DIR / path).read_text()):
        return name
    return re.sub(r"^(yolov\d)", r"\1n", name)


ZOO_MODELS = [_model_name(p) for p in ZOO_YAMLS]

BLOCKS = {
    "c2": lambda M: M.C2(16, 32, 2, True),
    "spp": lambda M: M.SPP(16, 24, (5, 9, 13)),
    "ghostconv_s2": lambda M: M.GhostConv(8, 16, 3, 2),
    "ghostbottleneck": lambda M: M.GhostBottleneck(16, 16),
    "ghostbottleneck_s2": lambda M: M.GhostBottleneck(16, 32, 3, 2),
    "c3ghost": lambda M: M.C3Ghost(16, 32, 2),
    "repconv": lambda M: M.RepConv(16, 24),
    "repcsp": lambda M: M.RepCSP(16, 16, 2),
    "repncspelan4": lambda M: M.RepNCSPELAN4(16, 32, 32, 16, 2),
    "elan1": lambda M: M.ELAN1(16, 32, 32, 16),
    "aconv": lambda M: M.AConv(16, 32),
    "adown": lambda M: M.ADown(16, 32),
    "sppelan": lambda M: M.SPPELAN(16, 32, 16),
    "cblinear": lambda M: M.CBLinear(16, [8, 16, 24]),
    # a repeated row (the JAX `_RepeatSeq`, an nn.Sequential in the port) and a yolov6 transposed conv with a bias
    "repeated_bottleneck": lambda M: (JB._RepeatSeq([M.Bottleneck(16, 16) for _ in range(2)]) if M is JM
                                      else torch.nn.Sequential(*(M.Bottleneck(16, 16) for _ in range(2)))),
    "convtranspose": lambda M: M.ConvTranspose2dRaw(16, 8, 2, 2, 0) if M is JM else torch.nn.ConvTranspose2d(16, 8, 2, 2, 0),
}
C1 = {"ghostconv_s2": 8}


def _lecun(tree):
    """`randomize`'s He-normal kernels scaled to LeCun-normal, so that deep blocks' outputs stay O(1)."""
    return {k: _lecun(v) if isinstance(v, dict) else (v * np.float32(0.5**0.5) if k == "kernel" else v)
            for k, v in tree.items()}


def _block_pair(name):
    jm, tm = BLOCKS[name](JM), BLOCKS[name](TM)
    jm.set_paths("0")
    variables = _lecun(randomize(jm.init(jax.random.PRNGKey(0)), np.random.default_rng(0)))
    load_port(tm, variables)
    return jm, tm, variables


def _outputs(y):
    return list(y) if isinstance(y, (tuple, list)) else [y]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name, train):
    """Each block's output within TOL of the JAX module's in eval and in train mode (batch statistics), and in train
    mode the gradients of the input and of every parameter against `jax.vjp` with the same cotangent."""
    jm, tm, variables = _block_pair(name)
    x = np.random.default_rng(1).standard_normal((2, 20, 18, C1.get(name, 16))).astype(np.float32)  # P5 of 640 px: 20 x 20
    fwd = lambda v, x: tuple(_outputs(jm(v, x, JM.Ctx(train=train, dtype=jnp.float32))))  # noqa: E731
    want, vjp = jax.vjp(fwd, variables, jnp.asarray(x))
    tm.train(train)
    xt = nchw(x).requires_grad_(True)
    with TM.collect_bn_stats() as stats:
        got = _outputs(tm(xt))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == (w.shape[0], w.shape[3], w.shape[1], w.shape[2])
        np.testing.assert_allclose(nhwc(g.detach()), np.asarray(w), **TOL)
    assert len(stats) == (sum(isinstance(m, TM.BatchNorm2d) for m in tm.modules()) if train else 0)
    if not train:
        return
    rng = np.random.default_rng(2)  # unit normals over sqrt(B * H * W): a parameter's gradient, a sum over positions, is O(1)
    cts = [(rng.standard_normal(w.shape) / np.sqrt(np.prod(w.shape[:3]))).astype(np.float32) for w in want]
    dv, dx = vjp(tuple(jnp.asarray(c) for c in cts))
    torch.autograd.backward(got, [nchw(c) for c in cts])
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(dx), **TOL)
    dv = {k.removeprefix("model.0."): v for k, v in from_jax_variables({"0": jax.tree_util.tree_map(np.asarray, dv)}).items()}
    params = dict(tm.named_parameters())
    assert params
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), dv[k].numpy(), **TOL, err_msg=k)


@pytest.mark.parametrize("name", ["repcsp", "repncspelan4", "repeated_bottleneck"])
def test_fused_block_matches_jax(name):
    """The fused form (RepConv's 1x1 padded into its 3x3, each BN folded) against the JAX `fuse_vars`, by the bridge."""
    jm, tm, variables = _block_pair(name)
    fused = jax.tree_util.tree_map(np.asarray, jm.fuse_vars(variables))
    for m in [m for kind in (TM.RepConv, TM.Conv) for m in tm.modules() if isinstance(m, kind)]:
        m.fuse()
    want = {k.removeprefix("model.0."): v for k, v in from_jax_variables({"0": fused}).items()}
    got = tm.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    x = np.random.default_rng(1).standard_normal((2, 10, 12, 16)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(tm.eval()(nchw(x))), np.asarray(jm(fused, jnp.asarray(x), JM.Ctx(dtype=jnp.float32))),
                                   **TOL)


def test_cbfuse_resizes_half_pixel_nearest_as_jax():
    """CBFuse picks `idx[i]` of each tuple, resizes it to the last input's size as `jax.image.resize(..., "nearest")`
    does (half-pixel centres: torch's "nearest-exact", not "nearest"), and sums in order; on sizes that do not
    divide, where the two rules part."""
    rng = np.random.default_rng(3)
    xs = [tuple(rng.standard_normal((2, h, w, 8)).astype(np.float32) for _ in range(2)) for h, w in ((3, 5), (4, 7))]
    last = rng.standard_normal((2, 7, 10, 8)).astype(np.float32)
    want = np.asarray(JM.CBFuse([1, 0])({}, [tuple(map(jnp.asarray, t)) for t in xs] + [jnp.asarray(last)], JM.Ctx()))
    got = TM.CBFuse([1, 0])([tuple(map(nchw, t)) for t in xs] + [nchw(last)])
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-6)
    plain = sum(torch.nn.functional.interpolate(nchw(t[i]), size=(7, 10)) for i, t in zip([1, 0], xs)) + nchw(last)
    assert not np.allclose(nhwc(plain), want)


@pytest.mark.parametrize("path", ZOO_YAMLS)
def test_layer_plan_matches_jax(path):
    """Each yaml (scale n where it has scales): read by the port as PyYAML reads it; the module types, `from`s,
    output widths, saved layers, strides and variable count of the JAX build (shapes by `jax.eval_shape`)."""
    import yaml

    text = (MODEL_CFG_DIR / path).read_text()
    assert load_yaml(text) == yaml.safe_load(text)
    assert text == (REPO / "drone_yolo_tpu" / "cfg" / "models" / path).read_text()
    name = _model_name(path)
    jmodel = _jax_model(name)
    with torch.device("meta"):  # shapes only: a full-width init of yolov3 or yolov9e on the CPU takes seconds
        tmodel = TASK2MODELCLASS[guess_model_task(name)](name)
    types = {"_RepeatSeq": "Sequential", "ConvTranspose2dRaw": "ConvTranspose2d"}
    assert [type(m).__name__ for m in tmodel.model] == [types.get(type(s.module).__name__, type(s.module).__name__)
                                                        for s in jmodel.layers]
    assert tmodel.froms == [s.f for s in jmodel.layers]
    assert tmodel.save == jmodel.save and tmodel.ch_list == jmodel.ch_list
    assert tmodel.head.stride == jmodel.head.stride
    shapes = jax.eval_shape(jmodel.init_raw, jax.random.PRNGKey(0))
    assert tmodel.param_count() == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))


@functools.lru_cache(maxsize=None)
def _jax_model(cfg, nc=None):
    return JAX_MODELS[guess_model_task(cfg)](cfg, nc=nc)


def _narrow(name: str, div: int = 4) -> dict:
    """A single-model yaml (the v9 files, which have no scales) with every width divided by `div` and each
    RepNCSPELAN4's depth 1: Conv, ADown, AConv and SPPELAN widths, RepNCSPELAN4's c2, c3, c4 and CBLinear's lists."""
    d = yaml_model_load(name)
    for row in d["backbone"] + d["head"]:
        mod, args = row[2], row[3]
        if mod in ("Conv", "ADown", "AConv", "SPPELAN", "RepNCSPELAN4", "ELAN1"):
            k = {"SPPELAN": 2, "RepNCSPELAN4": 3, "ELAN1": 3}.get(mod, 1)
            row[3] = [a // div for a in args[:k]] + args[k:]
            if mod == "RepNCSPELAN4":
                row[3][3] = 1
        elif mod == "CBLinear":
            row[3] = [[a // div for a in args[0]]]
        elif mod == "Segment":
            row[3] = [args[0], args[1] // div, args[2] // div]
    return d


def _pair(cfg, nc=None):
    """(port model, JAX model, JAX variables) from one port init with BN statistics drawn away from identity."""
    task = guess_model_task(cfg)
    port = TASK2MODELCLASS[task](cfg, nc=nc)
    port.init(0, imgsz=128)
    rng = np.random.default_rng(0)
    for k, v in port.state_dict().items():
        if k.endswith("running_mean"):
            v.copy_(torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32)))
        elif k.endswith("running_var"):
            v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
    ref = JAX_MODELS[task](cfg, nc=nc)
    return port.eval(), ref, to_jax_variables(port.state_dict())


# one model of each group; 128 px squares for the P6 models (two stride-64 cells), else a 96 x 64 batch
FORWARD_CASES = {"yolov8n-p6.yaml": 128, "yolov5n.yaml": 64, "yolov3-tiny.yaml": 64, "yolov6n.yaml": 64,
                 "yolov8n-ghost-p2.yaml": 64, "yolov9t.yaml": 64, "yolov9e-narrow": 64, "yolov9c-seg-narrow": 64,
                 "yolov8n-pose-p6.yaml": 128}


def _cfg(case: str):
    if case == "rows":
        return json.loads(json.dumps(ROWS_CFG))
    return _narrow(case.replace("-narrow", ".yaml")) if case.endswith("-narrow") else case


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_model_forward_matches_jax(case):
    """The decoded predictions and per-level maps of the port's model against the JAX model's, unfused and fused."""
    port, ref, variables = _pair(_cfg(case))
    size = FORWARD_CASES[case]
    x = np.random.default_rng(1).random((BATCH, size + (32 if size == 64 else 0), size, 3), dtype=np.float32)
    fused = ref.fuse(variables)
    apply = jax.jit(lambda v, x: ref.apply(v, x, ctx=JM.Ctx(dtype=jnp.float32)))
    for v in (variables, fused):
        want, want_aux = apply(v, jnp.asarray(x))
        with torch.no_grad():
            got, aux = port(nchw(x))
        assert got.shape == want.shape and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        maps, want_maps = (aux[0], want_aux[0]) if isinstance(aux, tuple) else (aux, want_aux)
        assert len(maps) == len(port.head.stride)
        for g, w in zip(maps, want_maps):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), **TOL)
        port.fuse()
    assert not any(isinstance(m, TM.BatchNorm2d) for m in port.modules())


# every new module kind: repeated rows and transposed convs (yolov6n), Ghost blocks (ghost-p2), ELAN1/RepConv/AConv
# (yolov9t), CBLinear (yolov9e), C2 and the P6 level (yolov8n-p6), SPP/ZeroPad2d/MaxPool2d take no variables; and
# "rows", the layers whose fused trees hold a kernel and bias of their own: a RepConv row, a 3x3 transposed conv row
# and a repeated RepVGGBlock row (a fused RepVGGBlock's weights go to its `rbr_reparam`, the others' to themselves)
BRIDGE_CASES = ["yolov6n.yaml", "yolov8n-ghost-p2.yaml", "yolov9t.yaml", "yolov9e-narrow", "yolov8n-p6.yaml", "rows"]
ROWS_CFG = {"nc": 2, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "RepConv", [16, 3, 1]],
                                  [-1, 1, "nn.ConvTranspose2d", [16, 3, 1, 1]], [-1, 2, "RepVGGBlock", [16, 3, 1]],
                                  [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [64, 3, 2]]],
            "head": [[[4, 5, 6], 1, "Detect", ["nc"]]]}


@pytest.mark.parametrize("case", BRIDGE_CASES)
def test_bridge_round_trips_bitwise(case, tmp_path):
    """A JAX variables tree (the structure of the JAX init, seeded normal leaves) -> state_dict -> JAX tree bitwise,
    strictly loadable into the port, equal to the JAX `convert_state_dict` of the state_dict (the reference torch
    names); the same for the fused tree into a fused model; the npz checkpoint read back by both packages; the resume
    state both ways."""
    cfg = _cfg(case)
    jmodel, task = JDetectionModel(cfg), guess_model_task(cfg)
    rng = np.random.default_rng(4)
    want = {k: np.abs(v) if k.endswith("/var") else v  # a positive variance, for the fused tree's folds
            for k, v in flatten_tree(jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                                                            jax.eval_shape(jmodel.init_raw, jax.random.PRNGKey(0)))).items()}
    tree = unflatten_tree(want)
    sd = from_jax_variables(tree)
    back = flatten_tree(to_jax_variables(sd))
    assert back.keys() == want.keys() and all(np.array_equal(back[k], want[k]) for k in want)
    conv = flatten_tree(convert_state_dict(jmodel, {k: v.numpy() for k, v in sd.items()}))
    assert conv.keys() == want.keys() and all(np.array_equal(conv[k], want[k]) for k in want)
    port = TASK2MODELCLASS[task](cfg)
    port.load_state_dict(sd, strict=True)

    fused_tree = jax.tree_util.tree_map(np.asarray, jmodel.fuse(tree))
    fused = TASK2MODELCLASS[task](cfg).fuse()
    fsd = from_jax_variables(fused_tree, fused)
    fused.load_state_dict(fsd, strict=True)
    fback = flatten_tree(to_jax_variables(fsd))
    fwant = flatten_tree(fused_tree)
    assert fback.keys() == fwant.keys() and all(np.array_equal(fback[k], fwant[k]) for k in fwant)

    path = save_checkpoint(tmp_path / "w.npz", port, port.state_dict())
    loaded = load_checkpoint(path)[0].state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in port.state_dict().items())
    jax_vars = flatten_tree(jax.tree_util.tree_map(np.asarray, jax_load_checkpoint(path)[1]))
    assert jax_vars.keys() == want.keys() and all(np.array_equal(jax_vars[k], want[k]) for k in want)
    loaded = load_checkpoint(save_checkpoint(tmp_path / "f.npz", fused, fused.state_dict()))[0].state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in fused.state_dict().items())

    ts = {"params": port.state_dict(), "opt": {"momentum": {n: p.detach() * 2 for n, p in port.named_parameters()}},
          "ema": port.state_dict(), "step": 3, "count": 0}
    np.savez(tmp_path / "resume_state.npz", **resume_state(ts, epoch=1))
    got, epoch = read_resume_state(tmp_path / "resume_state.npz")
    assert epoch == 1 and got["step"] == 3
    assert all(torch.equal(got["opt"]["momentum"][k], v) for k, v in ts["opt"]["momentum"].items())
    assert flatten_tree(unflatten_tree(resume_state(ts, 1))["params"]).keys() == want.keys()


def test_block_bridge_names():
    """GhostBottleneck at stride 2 (the reference's `conv.0/conv.1/conv.2/shortcut.0/shortcut.1`) and the fused RepConv
    of a RepCSP (its own weight and bias) both ways, bitwise."""
    for name, fuse in (("ghostbottleneck_s2", False), ("repcsp", True)):
        jm, tm, variables = _block_pair(name)
        if fuse:
            variables = jax.tree_util.tree_map(np.asarray, jm.fuse_vars(variables))
            for m in [m for kind in (TM.RepConv, TM.Conv) for m in tm.modules() if isinstance(m, kind)]:
                m.fuse()
        sd = from_jax_variables({"0": variables})
        tm.load_state_dict({k.removeprefix("model.0."): v for k, v in sd.items()}, strict=True)
        back, want = flatten_tree(to_jax_variables(sd)), flatten_tree({"0": variables})
        assert back.keys() == want.keys() and all(np.array_equal(back[k], want[k]) for k in want)
        assert {"model.0.conv.0.cv1.conv.weight", "model.0.shortcut.1.conv.weight"} <= set(sd) if not fuse else \
            {"model.0.m.0.cv1.weight", "model.0.m.0.cv1.bias"} <= set(sd)


def test_train_step_of_narrow_yolov9c_matches_jax_step_fn(tmp_path):
    """One SGD step from one init of a narrow yolov9c: the whole state (params, BN statistics, momentum, EMA) against
    the JAX step_fn, with `s2grad="cuda"` and `bnstats="cuda"` (their plain versions on CPU tensors)."""
    d = _narrow("yolov9c.yaml")
    cfg = tmp_path / "yolov9c-narrow.yaml"
    cfg.write_text("\n".join([f"nc: {d['nc']}"] + [line for part in ("backbone", "head")
                                                    for line in [f"{part}:"] + [f"  - {json.dumps(r)}" for r in d[part]]]))
    imgsz = 128
    port = TASK2MODELCLASS["detect"](str(cfg), nc=NC)
    port.init(0, imgsz=imgsz)
    ref = JDetectionModel(str(cfg), nc=NC)
    variables = to_jax_variables(port.state_dict())
    batch = synthetic_batch(np.random.default_rng(10), BATCH, imgsz, NC)
    trainer = BaseTrainer(overrides=dict(model=str(cfg), batch=BATCH, imgsz=imgsz, device="cpu", amp=False,
                                         optimizer="SGD", nbs=BATCH, s2grad="cuda", bnstats="cuda"),
                          train_loader=[batch], data={"nc": NC})
    trainer._setup_train()
    step_fn, state = _jax_step(ref, trainer, variables, "SGD")
    trainer.load_train_state(from_jax_train_state(state))
    start = from_jax_variables(variables)
    hyp = trainer._warmup_hyp(50, 0)
    state, _, items_j = step_fn(state, batch, *(jnp.float32(h) for h in hyp), target_sz=imgsz)
    _, items = trainer.train_step(batch, *hyp)
    np.testing.assert_allclose(items.numpy(), np.asarray(items_j), rtol=0, atol=LOSS_TOL)
    want, got = from_jax_train_state(state), trainer.train_state()
    names = sorted(dict(trainer.model.named_parameters()))
    buffers = sorted(set(want["params"]) - set(names))
    _close(got["params"], want["params"], names + buffers, base=start)
    _close(got["ema"], want["ema"], names + buffers, base=start)
    _close(got["opt"]["momentum"], want["opt"]["momentum"], names,
           base={k: 0 * v for k, v in want["opt"]["momentum"].items()})
    moved = [k for k in names if not np.array_equal(got["params"][k].numpy(), start[k].numpy())]
    assert len(moved) > 0.9 * len(names)


@pytest.mark.parametrize("name", ZOO_MODELS)
def test_yolo_predicts_and_trains_each_yaml(name):
    """`YOLO(name, device="cpu")` predicts a frame (for P6 models at 128 px, a multiple of the stride 64) and
    `BaseTrainer` takes one step with both kernels' plain versions: finite outputs and loss."""
    task = guess_model_task(name)
    imgsz = 128 if "p6" in name else 64
    frame = np.random.default_rng(0).integers(0, 256, (96, 160, 3), dtype=np.uint8)
    res = YOLO(name, device="cpu").predict(frame, imgsz=imgsz, conf=0.0, max_det=5, dtype="float32", verbose=False)[0]
    assert len(res.boxes) == 5 and np.isfinite(res.boxes.data).all()
    from drone_yolo_tpu_torch.models.yolo import TASK_MAP
    from chip_smoke import synthetic_pose_batch, synthetic_seg_batch

    rng = np.random.default_rng(1)
    batch, data = {"pose": (synthetic_pose_batch(rng, BATCH, imgsz, 1, 17), {"nc": 1, "kpt_shape": [17, 3]}),
                   "segment": (synthetic_seg_batch(rng, BATCH, imgsz, NC), {"nc": NC})}.get(
                       task, (synthetic_batch(rng, BATCH, imgsz, NC), {"nc": NC}))
    trainer = TASK_MAP[task]["trainer"](overrides=dict(model=name, batch=BATCH, imgsz=imgsz, nbs=BATCH, device="cpu",
                                                       amp=False, optimizer="SGD", s2grad="cuda", bnstats="cuda"),
                                        train_loader=[batch], data=data)
    (step,) = trainer.run_steps()
    assert np.isfinite(step["loss"]) and trainer.step == 1


# the dense k=3 stride-2 sites at 640 px by layer (the kernel covers them: even maps); AConv's and ADown's stride-2
# convs see the odd map of their 2x2 mean and are not sites, nor is yolov5's k=6 stem, nor a 5x5 depthwise conv
S2_LAYERS = {"yolov5n.yaml": ["1", "3", "5", "7", "18", "21"], "yolov3-tiny.yaml": [],
             "yolov8n-ghost-p2.yaml": ["0", "1", "3", "5", "7", "19", "22", "25"],
             "yolov8n-p6.yaml": ["0", "1", "3", "5", "7", "9", "21", "24", "27"], "yolov9t.yaml": ["0", "1"],
             "yolov6n.yaml": ["0", "1", "3", "5", "7", "20", "24"]}


@pytest.mark.parametrize("name", list(S2_LAYERS))
def test_stride2_sites(name):
    """The convs that `ops.conv_s2.covers` routes to the stride-2 kernel (all k=3), layer by layer."""
    model = TASK2MODELCLASS[guess_model_task(name)](name)
    sites = s2_sites(model, 1, 640)
    assert [s["name"].split(".")[1] for s in sites] == S2_LAYERS[name] and all(s["k"] == 3 for s in sites)


def test_activation_override_and_refusals():
    """yolov6's `activation: torch.nn.ReLU()` reaches every Conv whose activation is the default, the head's too, as
    the JAX walk does; any other activation, an unknown module and RepConv's identity branch are refused by name."""
    port = TASK2MODELCLASS["detect"]("yolov6n.yaml")
    acts = {m.act for m in port.modules() if isinstance(m, TM.Conv)}
    assert acts == {"relu"}
    assert all(m.act == "relu" for m in port.head.cv2[0][:2])
    jacts = {s.module.cv2[0].ms[0].act for s in JDetectionModel("yolov6n.yaml").layers[-1:]}
    assert jacts == {"relu"}
    d = yaml_model_load("yolov6n.yaml")
    for bad in ("nn.LeakyReLU(0.1)", "nn.SiLU()", "nn.ReLU6()"):
        with pytest.raises(ValueError, match="activation"):
            parse_model({**d, "activation": bad})
    with pytest.raises(KeyError, match="not ported"):
        parse_model({**d, "head": d["head"][:-1] + [[[19, 23, 27], 1, "WorldDetect", ["nc"]]]})
    with pytest.raises(NotImplementedError, match="RepConv"):
        TM.RepConv(16, 16, bn=True)


RUN_ZOO = BLOCKER + """
import json
import numpy as np, torch
torch.set_num_threads(1)
import chip_smoke
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
frame = np.random.default_rng(0).integers(0, 256, (96, 160, 3), dtype=np.uint8)
out = {}
for name in ("yolov9t.yaml", "yolov8n-ghost-p2.yaml"):
    res = YOLO(name, device="cpu").predict(frame, imgsz=64, conf=0.0, dtype="float32", verbose=False)
    batch = chip_smoke.synthetic_batch(np.random.default_rng(0), 2, 64, 2)
    t = BaseTrainer(overrides=dict(model=name, batch=2, imgsz=64, nbs=2, device="cpu", amp=False, optimizer="SGD",
                                   s2grad="cuda", bnstats="cuda"), train_loader=[batch], data={"nc": 2})
    out[name] = [len(res[0].boxes), t.run_steps()[0]["loss"]]
print(json.dumps({"out": out, "loaded": sorted(m for m in BLOCKED if sys.modules.get(m) is not None)}))
"""


def test_zoo_runs_without_jax_cv2_pil_yaml():
    """yolov9t and yolov8n-ghost-p2 predict and take a train step with jax, cv2, PIL, yaml and sklearn blocked."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", RUN_ZOO], cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == [] and all(n > 0 and np.isfinite(loss) for n, loss in out["out"].values())

"""YOLOv10, the NMS-free end-to-end detector, in the port against the JAX package, on the CPU in float32.

Every comparison starts from one set of weights that crosses by the bridge, and every input is made from a numpy seed:

- each new block (`SCDown`, `RepVGGDW` unfused and fused, `CIB` with and without its large kernel, `C2fCIB`, `PSA`) in
  eval and train mode, and `v10Detect` (its train dict of both heads, its eval detections, its bias priors) within
  rtol 1e-5 + atol 1e-4;
- the layer plans of the 7 yamls (modules, froms, widths, saves, strides, variable count) against the JAX build;
- the forwards of narrow yolov10n, s, m and b: the one-to-one maps within the same bar and, under scored weights, the
  same detections (the same classes in the same order, boxes and scores within the bar), fused too;
- the top-k's tie-break: equal scores keep the lower flat index, as `jax.lax.top_k`;
- `E2EDetectLoss` within 2e-3 of the JAX one, one train step of narrow yolov10n against the JAX `step_fn` within
  `REF_NOISE` (tests/test_torch_train.py), and a one-to-one loss alone leaving the trunk without gradient;
- the bridge both ways bitwise, unfused and fused (RepVGGDW's own kernel, CIB's `cv1` sequence, the one-to-one
  branches), the npz checkpoint in both packages and the resume state;
- `end2end_detections` against the JAX package's end-to-end branch, and `classes` applied as Ultralytics 8.3 does;
- `YOLO.predict|val|train` and `dyt-torch detect predict|val|train` on a v10 yaml with no NMS call, and a v10 run
  with jax, cv2, PIL, yaml and sklearn blocked.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import scored_weights, synthetic_batch
from drone_yolo_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from drone_yolo_tpu.nn import modules as JM
from drone_yolo_tpu.nn.model import DetectionModel as JDetectionModel
from drone_yolo_tpu.utils.loss import E2EDetectLoss as JE2EDetectLoss
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.cfg import MODEL_CFG_DIR, entrypoint
from drone_yolo_tpu_torch.data.utils import check_det_dataset
from drone_yolo_tpu_torch.engine.checkpoint import (flatten_tree, from_jax_train_state, from_jax_variables,
                                                    load_checkpoint, read_resume_state, resume_state, save_checkpoint,
                                                    to_jax_variables, unflatten_tree)
from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
from drone_yolo_tpu_torch.nn import modules as TM
from drone_yolo_tpu_torch.nn.build import load_yaml
from drone_yolo_tpu_torch.nn.model import DetectionModel, guess_model_task
from drone_yolo_tpu_torch.ops import nms as nms_ops
from drone_yolo_tpu_torch.utils.loss import E2EDetectLoss, v8DetectionLoss
from make_dataset import make_dataset
from test_torch_families import _lecun
from test_torch_modules import load_port, nchw, nhwc, randomize
from test_torch_predict import BLOCKER, REPO
from test_torch_train import LOSS_TOL, _close, _jax_step

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
EVAL = JM.Ctx(train=False, dtype=jnp.float32)
IMGSZ, BATCH, NC = 64, 2, 3
STEP_IMGSZ = 128  # at 64 px the P5 BNs normalize 8 values (2x2 maps): the JAX step's float32 noise passes REF_NOISE
V10_YAMLS = ["yolov10.yaml"] + [f"yolov10{s}.yaml" for s in "nsmblx"]

BLOCKS = {
    "scdown": lambda M: M.SCDown(16, 32, 3, 2),
    "repvggdw": lambda M: M.RepVGGDW(16),
    "cib": lambda M: M.CIB(16, 16, True, 0.5, False),
    "cib_lk": lambda M: M.CIB(16, 16, True, 0.5, True),
    "c2fcib": lambda M: M.C2fCIB(16, 32, 2, True, True),
    "psa": lambda M: M.PSA(128, 128),
}


def _block_pair(name):
    jm, tm = BLOCKS[name](JM), BLOCKS[name](TM)
    variables = _lecun(randomize(jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                                 np.random.default_rng(0)))
    load_port(tm, variables)
    c1 = next(m for m in tm.modules() if isinstance(m, torch.nn.Conv2d)).in_channels
    return jm, tm, variables, c1


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name, train):
    """Each block's output within the bar of the JAX module's, in eval mode and in train mode (batch statistics, one
    per BatchNorm)."""
    jm, tm, variables, c1 = _block_pair(name)
    x = np.random.default_rng(1).standard_normal((2, 8, 6, c1)).astype(np.float32)
    want = np.asarray(jm(variables, jnp.asarray(x), JM.Ctx(train=train, dtype=jnp.float32)))
    tm.train(train)
    with torch.no_grad(), TM.collect_bn_stats() as stats:
        got = nhwc(tm(nchw(x)))
    assert got.shape == want.shape
    assert len(stats) == (sum(isinstance(m, TM.BatchNorm2d) for m in tm.modules()) if train else 0)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["repvggdw", "cib_lk"])
def test_fused_repvggdw_matches_jax(name):
    """RepVGGDW fused (the 3x3 padded by 2 into the 7x7, each BN folded) against the JAX `fuse_vars`, by the bridge:
    the block's own weight and bias; and against its unfused self."""
    jm, tm, variables, c1 = _block_pair(name)
    fused = jax.tree_util.tree_map(np.asarray, jm.fuse_vars(variables))
    x = np.random.default_rng(2).standard_normal((2, 9, 7, c1)).astype(np.float32)
    with torch.no_grad():
        unfused = nhwc(tm.eval()(nchw(x)))
        for kind in (TM.RepVGGDW, TM.Conv):
            for m in [m for m in tm.modules() if isinstance(m, kind)]:
                m.fuse()
        got = nhwc(tm(nchw(x)))
    rep = next(m for m in tm.modules() if isinstance(m, TM.RepVGGDW))
    assert rep.conv is None and rep.weight.shape == (rep.c, 1, 7, 7)
    want = {k.removeprefix("model.0."): v for k, v in from_jax_variables({"0": fused}).items()}
    sd = tm.state_dict()
    assert sd.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, unfused, **TOL)
    tm.load_state_dict(want, strict=True)
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jm(fused, jnp.asarray(x), EVAL)), **TOL)


def _head_pair(nc=NC, ch=(16, 32, 64)):
    jm, tm = JM.v10Detect(nc, ch), TM.v10Detect(nc, ch)
    variables = _lecun(randomize(jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                                 np.random.default_rng(3)))
    load_port(tm, variables)
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal((BATCH, IMGSZ // s, IMGSZ // s, c)).astype(np.float32) for s, c in zip((8, 16, 32), ch)]
    return jm, tm.eval(), variables, xs


def test_v10detect_matches_jax():
    """The head in train mode (both heads' maps) and in eval mode (the top min(300, A) detections of the decoded
    one-to-one maps: the same classes in the same order, boxes and scores within the bar), and the bias priors of
    both heads."""
    jm, tm, variables, xs = _head_pair()
    head = jax.jit(lambda v, xs, train: jm(v, xs, JM.Ctx(train=train, dtype=jnp.float32)), static_argnums=2)
    want = head(variables, [jnp.asarray(x) for x in xs], True)
    with torch.no_grad(), TM.collect_bn_stats():
        got = tm.train().train_out([nchw(x) for x in xs])  # what the model's train-mode forward returns
    assert set(got) == set(want) == {"one2many", "one2one"}
    for key in got:
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), **TOL)
    dets_j, aux_j = head(variables, [jnp.asarray(x) for x in xs], False)
    with torch.no_grad():
        dets, aux = tm.eval()([nchw(x) for x in xs])
    a = sum((IMGSZ // s) ** 2 for s in (8, 16, 32))
    assert dets.shape == (BATCH, min(300, a), 6) == np.shape(dets_j)
    np.testing.assert_array_equal(dets[..., 5].numpy(), np.asarray(dets_j)[..., 5])
    np.testing.assert_allclose(dets.numpy(), np.asarray(dets_j), **TOL)
    for g, w in zip(aux["one2one"], aux_j["one2one"]):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), **TOL)
    tm.bias_init(IMGSZ)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jm.bias_init_vars(variables, IMGSZ)))
    got = flatten_tree(to_jax_variables({f"model.0.{k}": v for k, v in tm.state_dict().items()})["0"])
    assert got.keys() == want.keys()
    for k in want:
        if k.endswith("bias"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_topk_ties_keep_the_lower_flat_index():
    """With every one-to-one class logit equal, the scores of all (anchor, class) pairs tie: the head keeps the first
    k flat indices in order (anchor = idx // nc, class = idx % nc), as `jax.lax.top_k`, and the JAX head gives the
    same rows."""
    jm, tm, variables, xs = _head_pair()
    for i in range(3):
        variables["one2one_cv3"][str(i)]["m"]["2"]["kernel"][:] = 0.0
        variables["one2one_cv3"][str(i)]["m"]["2"]["bias"][:] = 0.5
    load_port(tm, variables)
    with torch.no_grad():
        dets, _ = tm.eval()([nchw(x) for x in xs])
    dets_j, _ = jm(variables, [jnp.asarray(x) for x in xs], EVAL)
    k = dets.shape[1]
    np.testing.assert_array_equal(dets[..., 5].numpy(), np.tile(np.arange(k) % NC, (BATCH, 1)))
    np.testing.assert_array_equal(dets[..., 5].numpy(), np.asarray(dets_j)[..., 5])
    np.testing.assert_allclose(dets.numpy(), np.asarray(dets_j), **TOL)
    boxes = dets[..., :4].reshape(BATCH, k // NC, NC, 4)  # anchor idx // nc: each anchor's box NC times in a row
    assert torch.equal(boxes, boxes[:, :, :1].expand_as(boxes))
    _, idx = jax.lax.top_k(jnp.zeros((1, 8)), 4)
    assert np.asarray(idx).tolist() == [[0, 1, 2, 3]]


@functools.lru_cache(maxsize=None)
def _jax_model(cfg, nc=None):
    return JDetectionModel(cfg, nc=nc)


@pytest.mark.parametrize("name", V10_YAMLS)
def test_layer_plan_matches_jax(name):
    """Each v10 yaml as PyYAML reads it; the port's layers against the JAX build: module names, froms, widths, saves,
    strides and the variable count; the task is detect."""
    import yaml

    text = (MODEL_CFG_DIR / "v10" / name).read_text()
    assert load_yaml(text) == yaml.safe_load(text)
    assert text == (REPO / "drone_yolo_tpu" / "cfg" / "models" / "v10" / name).read_text()
    jmodel = _jax_model(name)
    with torch.device("meta"):
        port = DetectionModel(name)
    assert guess_model_task(name) == "detect" and isinstance(port.head, TM.v10Detect)
    assert [type(m).__name__ for m in port.model] == [spec.type.removeprefix("nn.") for spec in jmodel.layers]
    assert port.froms == [spec.f for spec in jmodel.layers]
    shapes = jax.eval_shape(jmodel.init_raw, jax.random.PRNGKey(0))
    assert port.param_count() == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert port.head.stride == jmodel.head.stride
    assert port.save == jmodel.save and port.ch_list == jmodel.ch_list


def _narrow(tmp_path, letter):
    """yolov10<letter>.yaml with its width at 0.25 (depth and max_channels kept), as yolov10<letter>-narrow.yaml."""
    text = (MODEL_CFG_DIR / "v10" / f"yolov10{letter}.yaml").read_text()
    depth, _, max_channels = load_yaml(text)["scales"][letter]
    lines = [f"  {letter}: [{depth}, 0.25, {max_channels}]" if line.strip().startswith(f"{letter}:") else line
             for line in text.splitlines()]
    path = tmp_path / f"yolov10{letter}-narrow.yaml"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("v10")
    return {letter: _narrow(tmp, letter) for letter in "smb"} | {"n": "yolov10n.yaml"}


def _scored_pair(cfg):
    """(port model, JAX model, JAX variables) from one port init with `scored_weights` (LeCun-normal kernels, BN
    statistics away from identity, the class logits spread), so that the top-k is not decided by ties."""
    port = DetectionModel(cfg, nc=NC)
    port.init(0, imgsz=IMGSZ)
    port.load_state_dict(scored_weights(port.state_dict(), np.random.default_rng(0), -2.0, 3.0))
    return port.eval(), _jax_model(cfg, NC), to_jax_variables(port.state_dict())


@pytest.mark.parametrize("letter", ["n", "s", "m", "b"])
def test_model_forward_matches_jax(letter, narrow):
    """The detections and one-to-one maps of the port's model against the JAX model's, unfused and fused."""
    port, ref, variables = _scored_pair(narrow[letter])
    assert any(isinstance(m, TM.RepVGGDW) for m in port.modules()) == (letter in "ns")
    x = np.random.default_rng(1).random((BATCH, IMGSZ, IMGSZ, 3), dtype=np.float32)
    fused = jax.tree_util.tree_map(np.asarray, ref.fuse(variables))
    fn = jax.jit(lambda v, x: ref.apply(v, x, ctx=EVAL))
    for v in (variables, fused):
        want, want_aux = fn(v, jnp.asarray(x))
        with torch.no_grad():
            got, aux = port(nchw(x))
        assert got.shape == want.shape and torch.isfinite(got).all()
        np.testing.assert_array_equal(got[..., 5].numpy(), np.asarray(want)[..., 5])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for g, w in zip(aux["one2one"], want_aux["one2one"]):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), **TOL)
        port.fuse()


def _targets(batch):
    return {k: torch.from_numpy(batch[k]) for k in ("cls", "bboxes", "mask")}


def test_e2e_loss_matches_jax():
    """`E2EDetectLoss` on the train maps of narrow yolov10n: the loss and its items (the sums of the one-to-many,
    top 10, and one-to-one, top 1, losses) within 2e-3 of the JAX loss's."""
    port, ref, _ = _scored_pair("yolov10n.yaml")
    x = np.random.default_rng(5).random((BATCH, IMGSZ, IMGSZ, 3), dtype=np.float32)
    batch = synthetic_batch(np.random.default_rng(6), BATCH, IMGSZ, NC)
    with torch.no_grad(), TM.collect_bn_stats():
        out = port.train()(nchw(x))
    loss, items = E2EDetectLoss(port)(out, _targets(batch))
    many, _ = v8DetectionLoss(port, tal_topk=10)(out["one2many"], _targets(batch))
    one, _ = v8DetectionLoss(port, tal_topk=1)(out["one2one"], _targets(batch))
    assert torch.allclose(loss, many + one)
    jout = {k: [jnp.asarray(nhwc(m)) for m in v] for k, v in out.items()}
    jloss, jitems = JE2EDetectLoss(ref)(jout, {k: jnp.asarray(batch[k]) for k in ("cls", "bboxes", "mask")})
    np.testing.assert_allclose(items.numpy(), np.asarray(jitems), rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL)


def test_one2one_loss_leaves_the_trunk_without_gradient():
    """The one-to-one branches take the features detached: a loss on `one2one` alone gives gradient to those branches
    and to nothing before the head, nor to the one-to-many branches."""
    port, _, _ = _scored_pair("yolov10n.yaml")
    x = torch.from_numpy(np.random.default_rng(7).random((BATCH, 3, IMGSZ, IMGSZ), dtype=np.float32))
    batch = synthetic_batch(np.random.default_rng(8), BATCH, IMGSZ, NC)
    with TM.collect_bn_stats():
        out = port.train()(x)
    v8DetectionLoss(port, tal_topk=1)(out["one2one"], _targets(batch))[0].backward()
    head = len(port.model) - 1
    moved = {n: p.grad is not None and bool(p.grad.abs().sum() > 0) for n, p in port.named_parameters()}
    one2one = [n for n in moved if n.startswith(f"model.{head}.one2one_")]
    assert not any(v for n, v in moved.items() if n not in one2one)
    assert sum(moved[n] for n in one2one) > 0.5 * len(one2one)


def _jax_e2e_step(ref, trainer, variables):
    """`_jax_step` with the JAX trainer's criterion for a v10 head, `E2EDetectLoss` (`engine/trainer.py:137-142`)."""
    import test_torch_train

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_torch_train, "JaxLoss", JE2EDetectLoss)
        return _jax_step(ref, trainer, variables, "SGD")


def test_train_step_matches_jax_step_fn():
    """One SGD step of narrow yolov10n from one init: the whole state (params, BN statistics, momentum, EMA) against
    the JAX step_fn with `E2EDetectLoss`, with `s2grad="cuda"` and `bnstats="cuda"` (their plain versions here)."""
    cfg, imgsz = "yolov10n.yaml", STEP_IMGSZ
    port = DetectionModel(cfg, nc=NC)
    port.init(0, imgsz=imgsz)
    ref = _jax_model(cfg, NC)
    variables = to_jax_variables(port.state_dict())
    batch = synthetic_batch(np.random.default_rng(10), BATCH, imgsz, NC)
    trainer = BaseTrainer(overrides=dict(model=cfg, batch=BATCH, imgsz=imgsz, device="cpu", amp=False, optimizer="SGD",
                                         nbs=BATCH, s2grad="cuda", bnstats="cuda"),
                          train_loader=[batch], data={"nc": NC})
    trainer._setup_train()
    assert isinstance(trainer.criterion, E2EDetectLoss)
    step_fn, state = _jax_e2e_step(ref, trainer, variables)
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


@pytest.mark.parametrize("letter", ["n", "b"])
def test_bridge_round_trips_bitwise(letter, narrow, tmp_path):
    """A JAX variables tree (the structure of the JAX init, seeded normal leaves) -> state_dict -> JAX tree bitwise,
    equal to the JAX `convert_state_dict` of the state_dict, strictly loadable into the port; the fused tree into a
    fused model (RepVGGDW's kernel its own weight) and back; the npz checkpoint read back by both packages, fused and
    unfused; the resume state both ways. yolov10n's CIBs have RepVGGDW, narrow yolov10b's plain 3x3 depthwise Convs."""
    cfg = narrow[letter]
    jmodel = JDetectionModel(cfg)
    rng = np.random.default_rng(4)
    shapes = jax.eval_shape(jmodel.init_raw, jax.random.PRNGKey(0))
    want = {k: np.abs(v) if k.endswith("/var") else v  # a positive variance, for the fused tree's folds
            for k, v in flatten_tree(jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                                                            shapes)).items()}
    tree = unflatten_tree(want)
    sd = from_jax_variables(tree)
    assert any(".cv1.2." in k for k in sd) and any(".one2one_cv3.2.2." in k for k in sd)
    back = flatten_tree(to_jax_variables(sd))
    assert back.keys() == want.keys() and all(np.array_equal(back[k], want[k]) for k in want)
    conv = flatten_tree(convert_state_dict(jmodel, {k: v.numpy() for k, v in sd.items()}))
    assert conv.keys() == want.keys() and all(np.array_equal(conv[k], want[k]) for k in want)
    port = DetectionModel(cfg)
    port.load_state_dict(sd, strict=True)

    fused_tree = jax.tree_util.tree_map(np.asarray, jmodel.fuse(tree))
    fused = DetectionModel(cfg).fuse()
    fsd = from_jax_variables(fused_tree, fused)
    fused.load_state_dict(fsd, strict=True)
    assert any(k.endswith(".cv1.2.weight") for k in fsd) == (letter == "n")  # a fused RepVGGDW's own
    fback, fwant = flatten_tree(to_jax_variables(fsd)), flatten_tree(fused_tree)
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


def test_end2end_detections_as_jax_and_ultralytics():
    """Without `classes`: the JAX package's end-to-end branch (the first max_det rows, n_valid = the count above conf,
    the rest zeroed). With `classes`: Ultralytics 8.3's rows, those above conf and of the classes given, in order."""
    rng = np.random.default_rng(9)
    dets = rng.random((3, 40, 6)).astype(np.float32)
    dets[..., 4] = -np.sort(-rng.random((3, 40)), axis=1)
    dets[..., 5] = rng.integers(0, 4, (3, 40))
    dets[2, :, 4] = 0.1  # no row above conf
    conf, max_det = 0.3, 25
    got, n = nms_ops.end2end_detections(torch.from_numpy(dets), conf, max_det)
    want = dets[:, :max_det] * (dets[:, :max_det, 4:5] > conf)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(n.numpy(), (dets[:, :max_det, 4] > conf).sum(1))
    got, n = nms_ops.end2end_detections(torch.from_numpy(dets), conf, max_det, classes=[1, 3])
    for i in range(3):
        rows = dets[i][dets[i, :, 4] > conf][:max_det]
        rows = rows[np.isin(rows[:, 5], [1, 3])]
        assert int(n[i]) == len(rows)
        np.testing.assert_array_equal(got[i, : len(rows)].numpy(), rows)
        assert not got[i, len(rows):].any()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return str(make_dataset(tmp_path_factory.mktemp("v10data"), n_train=4, n_val=4, size=96, nc=2))


def test_yolo_predict_val_train_and_cli_without_nms(data, tmp_path, monkeypatch):
    """`YOLO("yolov10n.yaml")` trains one epoch with its validation, validates and predicts with no NMS call (the
    E2E criterion, the head's sorted detections); `classes` keeps those classes' rows; `dyt-torch detect
    train|val|predict` does the same; last.npz reads in the JAX reader."""
    calls = []
    keep = nms_ops.greedy_keep
    monkeypatch.setattr(nms_ops, "greedy_keep", lambda *a, **k: calls.append(1) or keep(*a, **k))
    model = YOLO("yolov10n.yaml", device="cpu")
    metrics = model.train(data=data, epochs=1, imgsz=IMGSZ, batch=BATCH, nbs=BATCH, workers=1, amp=False,
                          project=str(tmp_path), name="port", exist_ok=True, plots=False)
    assert isinstance(model.trainer.criterion, E2EDetectLoss) and len(metrics) == 5
    assert np.isfinite(model.trainer.epoch_stats[0]["loss_items"]).all()
    assert set(model.val(data=data, imgsz=IMGSZ, batch=BATCH, dtype="float32", workers=1)) == set(metrics)
    frame = np.random.default_rng(0).integers(0, 256, (72, 96, 3), dtype=np.uint8)
    r = model.predict(frame, imgsz=IMGSZ, conf=0.0, max_det=7, dtype="float32")[0]
    conf = r.boxes.conf
    assert len(r.boxes) == 7 and (np.diff(conf) <= 0).all()
    kept = model.predict(frame, imgsz=IMGSZ, conf=0.0, max_det=7, classes=[1], dtype="float32")[0]
    assert set(kept.boxes.cls.tolist()) <= {1.0}
    assert kept.boxes.data.tolist() == [row for row in r.boxes.data.tolist() if row[5] == 1.0]
    assert jax_load_checkpoint(model.trainer.wdir / "last.npz")[2]["task"] == "detect"

    entrypoint(f"detect train model=yolov10n.yaml data={data} epochs=1 imgsz={IMGSZ} batch={BATCH} nbs={BATCH} "
               f"workers=1 amp=False device=cpu plots=False project={tmp_path} name=cli exist_ok=True")
    last = tmp_path / "cli" / "weights" / "last.npz"
    entrypoint(f"detect val model={last} data={data} imgsz={IMGSZ} batch={BATCH} device=cpu dtype=float32 workers=1")
    entrypoint(f"detect predict model={last} source={check_det_dataset(data)['val']} imgsz={IMGSZ} conf=0.0 max_det=3 "
               f"device=cpu dtype=float32 save_txt=True project={tmp_path} name=pred exist_ok=True")
    labels = sorted((tmp_path / "pred" / "labels").glob("*.txt"))
    assert len(labels) == 4 and all(len(f.read_text().splitlines()) == 3 for f in labels)
    assert isinstance(load_checkpoint(last)[0].head, TM.v10Detect)
    assert calls == []


RUN_V10 = BLOCKER + """
import json
import numpy as np, torch
torch.set_num_threads(1)
import chip_smoke
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
frame = np.random.default_rng(0).integers(0, 256, (96, 160, 3), dtype=np.uint8)
res = YOLO("yolov10n.yaml", device="cpu").predict(frame, imgsz=64, conf=0.0, dtype="float32", verbose=False)
batch = chip_smoke.synthetic_batch(np.random.default_rng(0), 2, 64, 2)
t = BaseTrainer(overrides=dict(model="yolov10n.yaml", batch=2, imgsz=64, nbs=2, device="cpu", amp=False,
                               optimizer="SGD", s2grad="cuda", bnstats="cuda"), train_loader=[batch], data={"nc": 2})
out = [len(res[0].boxes), t.run_steps()[0]["loss"]]
print(json.dumps({"out": out, "loaded": sorted(m for m in BLOCKED if sys.modules.get(m) is not None)}))
"""


def test_v10_runs_without_jax_cv2_pil_yaml():
    """yolov10n predicts and takes a train step with jax, cv2, PIL, yaml and sklearn blocked."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", RUN_V10], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == [] and out["out"][0] > 0 and np.isfinite(out["out"][1])

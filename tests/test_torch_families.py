"""The YOLO11 and YOLO12 families in the port against the JAX package, on the CPU in float32.

Every comparison starts from one set of weights that crosses by the bridge (`to_jax_variables` /
`from_jax_variables`), and every input is made from a numpy seed:

- each new block (`C3k2` with and without C3k, `C2PSA`, `A2C2f` with and without area attention and with its
  residual gamma, `AAttn` with area 4 on a map that splits into 4 stripes and on one where the JAX package falls
  back to area 1) in eval and train mode within 1e-4;
- the forwards of yolo11n (detect, pose, segment, obb) and yolo12n (detect, segment), and the layer plan of all
  eight yamls at scale n (widths, saves, strides, variable count) against the JAX build;
- the scale-letter rows of the build, through two narrow yamls named for scales m and l: the m file takes C3k in
  every C3k2 and the l file gives A2C2f its gamma; their forwards against the JAX package;
- the bridge both ways bitwise (the nested head sequences, PSABlock's `ffn`, ABlock's `mlp`, A2C2f's pairs of
  ABlocks and gamma), the npz checkpoint and the resume state, and gamma's optimizer group (weight decay);
- the attention logits in float32 under bfloat16 autocast;
- one train step of yolo11n and one of yolo12n against the JAX `step_fn` within `REF_NOISE`
  (tests/test_torch_train.py), with both kernels' plain versions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import synthetic_batch
from drone_yolo_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from drone_yolo_tpu.nn import modules as JM
from drone_yolo_tpu.nn.model import DetectionModel as JDetectionModel
from drone_yolo_tpu.nn.model import OBBModel as JOBBModel
from drone_yolo_tpu.nn.model import PoseModel as JPoseModel
from drone_yolo_tpu.nn.model import SegmentationModel as JSegmentationModel
from drone_yolo_tpu.utils.optimizer import label_tree
from drone_yolo_tpu_torch.cfg import MODEL_CFG_DIR
from drone_yolo_tpu_torch.engine.checkpoint import (flatten_tree, from_jax_train_state, from_jax_variables,
                                                    load_checkpoint, read_resume_state, resume_state, save_checkpoint,
                                                    to_jax_variables, unflatten_tree)
from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
from drone_yolo_tpu_torch.nn import modules as TM
from drone_yolo_tpu_torch.nn.build import load_yaml
from drone_yolo_tpu_torch.nn.model import TASK2MODELCLASS, guess_model_task
from drone_yolo_tpu_torch.utils.optimizer import label_params
from test_torch_modules import load_port, nchw, nhwc, randomize
from test_torch_train import LOSS_TOL, _close, _jax_step  # _close adds REF_NOISE of each update to its atol

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)  # the forward bar (tests/test_torch_segment.py HEAD_TOL)
EVAL = JM.Ctx(train=False, dtype=jnp.float32)
JAX_MODELS = {"detect": JDetectionModel, "pose": JPoseModel, "segment": JSegmentationModel, "obb": JOBBModel}
FAMILY_YAMLS = [f"yolo{v}{t}.yaml" for v in (11, 12) for t in ("", "-pose", "-seg", "-obb")]
IMGSZ, BATCH, NC = 64, 2, 2

BLOCKS = {
    "c3k2": lambda M: M.C3k2(16, 32, 2, False, 0.25),
    "c3k2_c3k": lambda M: M.C3k2(32, 32, 1, True),
    "c2psa": lambda M: M.C2PSA(128, 128, 1),
    "a2c2f_area4": lambda M: M.A2C2f(64, 64, 1, True, 4),
    "a2c2f_residual": lambda M: M.A2C2f(64, 64, 1, True, 1, True, 1.2),
    "a2c2f_c3k": lambda M: M.A2C2f(96, 64, 2, False, -1),
    "aattn_area4": lambda M: M.AAttn(64, 2, 4),
}
# (H, W): 8 x 6 splits into 4 stripes of 12 positions; 5 x 6 (30 positions) does not, and is attended whole
SHAPES = {"divisible": (8, 6), "fallback": (5, 6)}
CASES = [(name, shape) for name in BLOCKS for shape in (SHAPES if "area4" in name else ["divisible"])]


def _lecun(tree):
    """`randomize`'s He-normal kernels scaled to LeCun-normal (std sqrt(1 / fan_in)). With He-normal kernels and BN
    statistics that do not normalize, A2C2f's outputs reach the hundreds, where float32 rounding alone (of either
    package, against a float64 run) passes the 1e-4 bar."""
    return {k: _lecun(v) if isinstance(v, dict) else (v * np.float32(0.5**0.5) if k == "kernel" else v)
            for k, v in tree.items()}


def _block_pair(name):
    jm, tm = BLOCKS[name](JM), BLOCKS[name](TM)
    variables = _lecun(randomize(jm.init(jax.random.PRNGKey(0)), np.random.default_rng(0)))
    load_port(tm, variables)
    c1 = next(m for m in tm.modules() if isinstance(m, torch.nn.Conv2d)).in_channels
    return jm, tm, variables, c1


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name,shape", CASES)
def test_block_matches_jax(name, shape, train):
    """Each block's output within 1e-4 of the JAX module's, in eval mode and in train mode (batch statistics)."""
    jm, tm, variables, c1 = _block_pair(name)
    x = np.random.default_rng(1).standard_normal((2, *SHAPES[shape], c1)).astype(np.float32)
    ctx = JM.Ctx(train=train, dtype=jnp.float32)
    want = np.asarray(jm(variables, jnp.asarray(x), ctx))
    tm.train(train)
    with torch.no_grad(), TM.collect_bn_stats() as stats:
        got = nhwc(tm(nchw(x)))
    assert got.shape == want.shape
    assert len(stats) == (sum(isinstance(m, TM.BatchNorm2d) for m in tm.modules()) if train else 0)
    np.testing.assert_allclose(got, want, **TOL)


def test_area_attention_stripes_and_fallback():
    """AAttn with area 4 attends within the 4 runs of row-major positions: on a divisible map, a change in the
    last stripe leaves the first stripe's attention output alone; on a map that does not divide, it reaches it."""
    tm = BLOCKS["aattn_area4"](TM).eval()
    load_port(tm, randomize(BLOCKS["aattn_area4"](JM).init(jax.random.PRNGKey(0)), np.random.default_rng(0)))
    tm.pe = torch.nn.Identity()  # the 7x7 positional conv mixes neighbours across stripes
    for shape, separate in ((SHAPES["divisible"], True), (SHAPES["fallback"], False)):
        x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 64, *shape)).astype(np.float32))
        x2 = x.clone()
        x2[:, :, -1, -1] += 1.0  # the last position, in the last stripe
        with torch.no_grad():
            a, b = (tm(t).flatten(2)[..., : shape[0] * shape[1] // 4] for t in (x, x2))
        assert torch.equal(a, b) == separate, shape


def test_attention_logits_stay_float32_under_autocast(monkeypatch):
    """`attention_softmax` returns float32 under bfloat16 autocast, equal to its result without autocast, and both
    attention blocks take their weights from it."""
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.standard_normal((2, 2, 16, 24)).astype(np.float32)) for _ in range(2))
    plain = TM.attention_softmax(q, k, 0.25)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = TM.attention_softmax(q, k, 0.25)
        assert (q.transpose(-2, -1) @ k).dtype == torch.bfloat16  # what autocast would have done
    assert got.dtype == torch.float32 and torch.equal(got, plain)

    seen, plain_softmax = [], TM.attention_softmax

    def recording(q, k, scale):
        out = plain_softmax(q, k, scale)
        seen.append((q.dtype, out.dtype))
        return out

    monkeypatch.setattr(TM, "attention_softmax", recording)
    x = torch.from_numpy(rng.standard_normal((1, 128, 4, 4)).astype(np.float32))
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        for block in (TM.C2PSA(128, 128, 1).eval(), TM.AAttn(64, 2, 4).eval()):
            y = block(x[:, : block.qkv.conv.in_channels] if isinstance(block, TM.AAttn) else x)
            assert y.dtype == torch.bfloat16
    assert [o for _, o in seen] == [torch.float32, torch.float32] and {d for d, _ in seen} == {torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _jax_model(cfg, nc=None):
    return JAX_MODELS[guess_model_task(cfg)](cfg, nc=nc)


def _pair(cfg, nc=None):
    """(port model, JAX model, JAX variables) from one port init with BN statistics drawn away from identity."""
    task = guess_model_task(cfg)
    port = TASK2MODELCLASS[task](cfg, nc=nc)
    port.init(0, imgsz=IMGSZ)
    sd = port.state_dict()
    rng = np.random.default_rng(0)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.copy_(torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32)))
        elif k.endswith("running_var") or k.endswith(".gamma"):
            v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
    return port.eval(), _jax_model(cfg, nc), to_jax_variables(port.state_dict())


def _check_forward(port, ref, variables):
    x = np.random.default_rng(1).random((BATCH, 96, 64, 3), dtype=np.float32)
    want, want_aux = jax.jit(lambda v, x: ref.apply(v, x, ctx=EVAL))(variables, jnp.asarray(x))
    with torch.no_grad():
        got, aux = port(nchw(x))
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    maps, want_maps = (aux[0], want_aux[0]) if isinstance(aux, tuple) else (aux, want_aux)
    for g, w in zip(maps, want_maps):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("cfg", ["yolo11n.yaml", "yolo11n-pose.yaml", "yolo11n-seg.yaml", "yolo11n-obb.yaml",
                                 "yolo12n.yaml", "yolo12n-seg.yaml"])
def test_model_forward_matches_jax(cfg):
    port, ref, variables = _pair(cfg)
    c3k = [i for i, m in enumerate(port.model) if isinstance(m, TM.C3k2) and isinstance(m.m[0], TM.C3k)]
    assert c3k == ([6, 8, 22] if cfg.startswith("yolo11") else [20])  # scale n: only the rows that set c3k
    assert not any(isinstance(m, TM.A2C2f) and m.gamma is not None for m in port.model)
    assert isinstance(port.head.cv3[0][0], torch.nn.Sequential)  # the depthwise class branch
    _check_forward(port, ref, variables)


@pytest.mark.parametrize("name", FAMILY_YAMLS)
def test_layer_plan_matches_jax(name):
    """Scale n of each family yaml: the output widths, saved layers, strides and variable count of the JAX build,
    and the yaml read by the port's reader as PyYAML reads it."""
    import yaml

    text = (MODEL_CFG_DIR / name[4:6] / name).read_text()
    assert load_yaml(text) == yaml.safe_load(text)
    cfg = name.replace(".yaml", "").replace(name[:6], name[:6] + "n") + ".yaml"
    jmodel = _jax_model(cfg)
    shapes = jax.eval_shape(jmodel.init_raw, jax.random.PRNGKey(0))
    tmodel = TASK2MODELCLASS[guess_model_task(cfg)](cfg)
    assert tmodel.param_count() == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert tmodel.head.stride == jmodel.head.stride
    assert tmodel.save == jmodel.save and tmodel.ch_list == jmodel.ch_list


def _narrow_yaml(tmp_path, family, letter):
    """A copy of the family's detect yaml, named yolo<family><letter>-tiny.yaml, whose `letter` row keeps its depth
    and max_channels but has width 0.25."""
    text = (MODEL_CFG_DIR / family / f"yolo{family}.yaml").read_text()
    depth, _, max_channels = load_yaml(text)["scales"][letter]
    lines = [f"  {letter}: [{depth}, 0.25, {max_channels}]" if line.strip().startswith(f"{letter}:") else line
             for line in text.splitlines()]
    path = tmp_path / f"yolo{family}{letter}-tiny.yaml"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def scale_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scales")
    return {"m": _narrow_yaml(tmp, "11", "m"), "l": _narrow_yaml(tmp, "12", "l")}


def test_scale_m_takes_c3k_everywhere(scale_files):
    port, ref, variables = _pair(scale_files["m"])
    c3k2 = [m for m in port.model if isinstance(m, TM.C3k2)]
    assert len(c3k2) == 8 and all(isinstance(b, TM.C3k) for m in c3k2 for b in m.m)
    assert [type(b).__name__ for b in ref.layers[2].module.m] == ["C3k"]
    _check_forward(port, ref, variables)


def test_scale_l_gives_a2c2f_its_gamma(scale_files):
    port, ref, variables = _pair(scale_files["l"])
    residual = [i for i, m in enumerate(port.model) if isinstance(m, TM.A2C2f) and m.gamma is not None]
    assert residual == [6, 8]  # the backbone's area-attention layers; the head's (a2=False) take none
    assert {k for k in flatten_tree(variables) if k.endswith("gamma")} == {"6/gamma", "8/gamma"}
    assert port.model[6].m[0][0].mlp[0].conv.out_channels == int(64 * 1.2)  # mlp_ratio 1.2 at scale l
    _check_forward(port, ref, variables)
    labels = flatten_tree(label_tree(variables))
    groups = label_params(port)
    assert labels["6/gamma"] == "decay" and "model.6.gamma" in groups["decay"]


@pytest.mark.parametrize("which", ["yolo11n-seg.yaml", "l"])
def test_bridge_round_trips_bitwise(which, scale_files, tmp_path):
    """A JAX variables tree (the structure of the JAX init, seeded normal leaves) -> state_dict -> JAX tree bitwise
    (nested sequences and gamma included), strictly loadable into the port; the npz checkpoint read back by both
    packages; the resume state both ways."""
    cfg = scale_files.get(which, which)
    task = guess_model_task(cfg)
    rng = np.random.default_rng(4)
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                                  jax.eval_shape(_jax_model(cfg).init, jax.random.PRNGKey(0)))
    sd = from_jax_variables(tree)
    back = flatten_tree(to_jax_variables(sd))
    want = flatten_tree(tree)
    assert back.keys() == want.keys()
    for k in want:
        assert np.array_equal(back[k], want[k]), k
    port = TASK2MODELCLASS[task](cfg)
    port.load_state_dict(sd, strict=True)
    nested = [k for k in sd if ".ffn.0." in k or ".mlp.1." in k or ".cv3.0.1.0." in k or k.endswith("gamma")]
    assert nested

    path = save_checkpoint(tmp_path / "w.npz", port, port.state_dict())
    loaded = load_checkpoint(path)[0].state_dict()
    for k, v in port.state_dict().items():
        assert torch.equal(loaded[k], v), k
    jax_vars = flatten_tree(jax.tree_util.tree_map(np.asarray, jax_load_checkpoint(path)[1]))
    assert jax_vars.keys() == want.keys() and all(np.array_equal(jax_vars[k], want[k]) for k in want)

    ts = {"params": port.state_dict(), "opt": {"momentum": {n: p.detach() * 2 for n, p in port.named_parameters()}},
          "ema": port.state_dict(), "step": 3, "count": 0}
    np.savez(tmp_path / "resume_state.npz", **resume_state(ts, epoch=1))
    got, epoch = read_resume_state(tmp_path / "resume_state.npz")
    assert epoch == 1 and got["step"] == 3
    for k, v in ts["opt"]["momentum"].items():
        assert torch.equal(got["opt"]["momentum"][k], v), k
    assert flatten_tree(unflatten_tree(resume_state(ts, 1))["params"]).keys() == want.keys()


@pytest.mark.parametrize("cfg", ["yolo11n.yaml", "yolo12n.yaml"])
def test_train_step_matches_jax_step_fn(cfg):
    """One SGD step from one init: the whole state (params, BN statistics, momentum, EMA) against the JAX step_fn,
    with `s2grad="cuda"` and `bnstats="cuda"` (their plain versions on CPU tensors)."""
    port = TASK2MODELCLASS["detect"](cfg, nc=NC)
    port.init(0, imgsz=IMGSZ)
    ref = JDetectionModel(cfg, nc=NC)
    variables = to_jax_variables(port.state_dict())
    batch = synthetic_batch(np.random.default_rng(10), BATCH, IMGSZ, NC)
    trainer = BaseTrainer(overrides=dict(model=cfg, batch=BATCH, imgsz=IMGSZ, device="cpu", amp=False, optimizer="SGD",
                                         nbs=BATCH, s2grad="cuda", bnstats="cuda"), train_loader=[batch], data={"nc": NC})
    trainer._setup_train()
    step_fn, state = _jax_step(ref, trainer, variables, "SGD")
    trainer.load_train_state(from_jax_train_state(state))
    start = from_jax_variables(variables)
    hyp = trainer._warmup_hyp(50, 0)
    state, _, items_j = step_fn(state, batch, *(jnp.float32(h) for h in hyp), target_sz=IMGSZ)
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

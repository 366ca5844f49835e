"""The port's train step against the JAX package's, on the CPU in float32.

One init (the port's seeded init of the flagship at scale n, nc 2, imgsz 64)
crosses to JAX through `convert_state_dict`; batches come from
`chip_smoke.synthetic_batch` (numpy, seeded). Held against the JAX package:
train-mode BatchNorm statistics and the running-stat merge, the TAL assignment
(masks and indices exactly, ties at the k-th place included), the loss items
(within 2e-3), and whole steps of the JAX `step_fn` itself, built by
`BaseTrainer._build_train_step` on a stub with only the attributes it reads:
params, optimizer state, EMA and BN statistics within rtol 1e-4 (the bar of
tests/test_conv_s2.py:98) and an absolute tolerance set by the JAX step's own
float32 error (`REF_NOISE`).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import synthetic_batch
from drone_yolo_tpu.engine.trainer import BaseTrainer as JaxTrainer
from drone_yolo_tpu.nn import modules as JM
from drone_yolo_tpu.nn.model import DetectionModel as JaxDetectionModel
from drone_yolo_tpu.utils.loss import v8DetectionLoss as JaxLoss
from drone_yolo_tpu.utils.optimizer import init_adam, init_momentum, label_tree
from drone_yolo_tpu.utils.tal import assign as jax_assign
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch.engine.checkpoint import from_jax_train_state, from_jax_variables
from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
from drone_yolo_tpu_torch.nn import modules as M
from drone_yolo_tpu_torch.nn.model import DetectionModel
from drone_yolo_tpu_torch.utils.loss import v8DetectionLoss
from drone_yolo_tpu_torch.utils.tal import assign

torch.set_num_threads(1)

FLAGSHIP_N = "yolov8n-p2-repvgg-sf.yaml"
IMGSZ, BATCH, NC = 64, 2, 2
STATE_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_conv_s2.py:98
LOSS_TOL = 2e-3  # the bar the JAX package holds its loss items to against the reference
# The JAX step's float32 gradients on the CPU differ from a float64 evaluation by up to 1.2e-3 of each tensor's
# largest gradient (the port's float32 gradients: 8.4e-5), mostly from XLA's float32 sums in the one-pass BN
# variance; `test_train_steps_match_jax_step_fn` measures both on its accumulation case. A step's state is held
# to rtol 1e-4 and atol 1e-5 + REF_NOISE x the tensor's largest entry (optimizer moments) or largest update
# (params, EMA): four times the measured error.
REF_NOISE = 5e-3


@pytest.fixture(scope="module")
def init():
    """(port model in train mode, JAX model, JAX variables) from one seeded init."""
    port = DetectionModel(FLAGSHIP_N, nc=NC)
    port.init(0, imgsz=IMGSZ)
    ref = JaxDetectionModel(FLAGSHIP_N, nc=NC)
    return port.train(), ref, convert_state_dict(ref, port.state_dict())


@pytest.fixture(scope="module")
def forward(init):
    """A synthetic batch and the JAX train-mode forward of it: (batch, head maps NHWC, BN statistics by path)."""
    _, ref, variables = init
    batch = synthetic_batch(np.random.default_rng(2), BATCH, IMGSZ, NC)

    def run(v, img):
        ctx = JM.Ctx(train=True, dtype=jnp.float32)
        return ref.apply(v, img, ctx=ctx), ctx.updates

    maps, updates = jax.jit(run)(variables, jnp.asarray(batch["img"].astype(np.float32) / 255.0))
    return batch, maps, updates


def _close(got: dict, want: dict, names=None, base: dict | None = None, **tol):
    """got[k] against want[k] for k in names; with `base`, atol grows by REF_NOISE x the largest |want - base|."""
    names = sorted(want) if names is None else names
    for k in names:
        w = np.asarray(want[k])
        kw = dict(tol or STATE_TOL)
        if base is not None:
            kw["atol"] = kw["atol"] + REF_NOISE * np.abs(w - np.asarray(base[k])).max()
        np.testing.assert_allclose(got[k].detach().cpu().numpy(), w, err_msg=k, **kw)


def test_bn_batch_statistics_and_merge(init, forward):
    """Train-mode BN: the biased one-pass statistics of `_bn_apply`, normalized output, and `merge_bn_updates`."""
    port, ref, variables = init
    batch, maps_j, updates = forward
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 5, 6, 7)) * 3 + 1).astype(np.float32)  # NHWC, 7 channels
    bn = {"scale": rng.uniform(0.5, 1.5, 7).astype(np.float32), "bias": rng.normal(0, 0.1, 7).astype(np.float32),
          "mean": np.zeros(7, np.float32), "var": np.ones(7, np.float32)}
    ctx = JM.Ctx(train=True, dtype=jnp.float32)
    y_j = JM._bn_apply({k: jnp.asarray(v) for k, v in bn.items()}, jnp.asarray(x), ctx, "bn")
    mod = M.BatchNorm2d(7).train()
    mod.load_state_dict({"weight": torch.from_numpy(bn["scale"]), "bias": torch.from_numpy(bn["bias"]),
                         "running_mean": torch.zeros(7), "running_var": torch.ones(7)})
    with M.collect_bn_stats() as stats:
        y = mod(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j).transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-5)
    mean, var = stats[mod]
    np.testing.assert_allclose(mean.numpy(), np.asarray(ctx.updates["bn"][0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(ctx.updates["bn"][1]), rtol=1e-5, atol=1e-6)
    assert torch.equal(mod.running_mean, torch.zeros(7))  # the forward writes no buffer
    with pytest.raises(RuntimeError, match="collect_bn_stats"):
        mod(torch.zeros(1, 7, 2, 2))

    # the whole model: train-mode maps, then the merge of every BN's statistics. The maps are held to a
    # float64 run of the port within 1e-4, and to the JAX package's within 1e-3: the one-pass variance
    # E[x^2] - E[x]^2 cancels, and XLA's float32 sums on the CPU leave the JAX maps up to 5.4e-4 from
    # float64 (the port's: 2.8e-5).
    merged = from_jax_variables(ref.merge_bn_updates(variables, updates))
    model = DetectionModel(FLAGSHIP_N, nc=NC)
    model.load_state_dict(port.state_dict())
    model.train()
    with M.collect_bn_stats() as stats:
        maps = model(torch.from_numpy(batch["img"].transpose(0, 3, 1, 2).astype(np.float32) / 255.0))
    assert len(stats) == len(updates)
    f64 = DetectionModel(FLAGSHIP_N, nc=NC)
    f64.load_state_dict(port.state_dict())
    with M.collect_bn_stats():
        maps64 = f64.double().train()(torch.from_numpy(batch["img"].transpose(0, 3, 1, 2) / 255.0))
    for got, want, exact in zip(maps, maps_j, maps64):
        np.testing.assert_allclose(got.detach().numpy(), exact.detach().numpy(), rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want).transpose(0, 3, 1, 2), rtol=0, atol=1e-3)
    model.merge_bn_updates(stats)
    _close(model.state_dict(), merged, [k for k in merged if "running" in k])


def _assign_case(rng, b, m, grid, nc, ties=False):
    ys, xs = np.meshgrid(np.arange(grid) + 0.5, np.arange(grid) + 0.5, indexing="ij")
    anc = (np.stack([xs, ys], -1).reshape(-1, 2) * 8).astype(np.float32)  # stride 8 pixels
    a, size = len(anc), grid * 8
    if ties:  # every anchor predicts one box with one score: anchors inside a GT tie, far more than topk of them
        scores = np.full((b, a, nc), 0.5, np.float32)
        pd = np.tile(np.array([size * 0.3, size * 0.3, size * 0.6, size * 0.6], np.float32), (b, a, 1))
        gt = np.tile(np.array([size * 0.25, size * 0.25, size * 0.7, size * 0.7], np.float32), (b, m, 1))
        gt[:, 2:] += size * 0.05  # GTs 0 and 1 are one box, 2 and 3 another: of equal CIoU the first wins
        return scores, pd, anc, rng.integers(0, nc, (b, m)).astype(np.float32), gt, np.ones((b, m), np.float32)
    else:
        scores = rng.random((b, a, nc)).astype(np.float32)
        c = anc[None] + rng.normal(0, 4, (b, a, 2))
        wh = rng.uniform(8, size / 3, (b, a, 2))
        pd = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
        xy = rng.uniform(0, size * 0.7, (b, m, 2))
        gt = np.concatenate([xy, xy + rng.uniform(8, size * 0.3, (b, m, 2))], -1).astype(np.float32)
    labels = rng.integers(0, nc, (b, m)).astype(np.float32)
    mask = (rng.random((b, m)) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    return scores, pd, anc, labels, gt * mask[..., None], mask


@pytest.mark.parametrize("b,m,grid,nc,ties", [(2, 8, 16, 3, False), (2, 32, 20, 80, False), (1, 6, 80, 4, False),
                                              (2, 4, 16, 2, True)])
def test_assign_matches_jax(b, m, grid, nc, ties):
    """Random cases (grid 80: 6400 anchors, where the JAX package pads anchors and takes its blocked top-k)
    and a case of ties at the k-th place: masks and GT indices exactly equal, targets within 1e-6."""
    case = _assign_case(np.random.default_rng(grid + m), b, m, grid, nc, ties)
    want = jax_assign(*(jnp.asarray(t) for t in case), topk=10, num_classes=nc)
    got = assign(*(torch.from_numpy(t) for t in case), topk=10, num_classes=nc)
    labels, boxes, scores, fg, idx = (t.numpy() for t in got)
    np.testing.assert_array_equal(fg, np.asarray(want[3]))
    np.testing.assert_array_equal(idx, np.asarray(want[4]))
    np.testing.assert_array_equal(labels, np.asarray(want[0]))
    np.testing.assert_allclose(boxes, np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(scores, np.asarray(want[2]), rtol=0, atol=1e-6)
    per_gt = np.stack([(idx == j) & fg for j in range(m)], 1).sum(-1)  # anchors per GT
    assert fg.any()
    if ties:
        assert per_gt[:, 0].min() > 10 and (per_gt[:, 1::2] == 0).all()  # all tied anchors admitted; first GT wins


def test_loss_items_match_jax(init, forward):
    """The loss on the same head maps (the JAX train forward's) and targets: items within 2e-3."""
    _, ref, _ = init
    batch, maps, _ = forward
    loss_j, items_j = JaxLoss(ref)(maps, {k: jnp.asarray(v) for k, v in batch.items() if k != "img"})
    port = DetectionModel(FLAGSHIP_N, nc=NC)
    crit = v8DetectionLoss(port)
    loss, items = crit([torch.from_numpy(np.array(f).transpose(0, 3, 1, 2)) for f in maps],
                       {k: torch.from_numpy(v) for k, v in batch.items() if k != "img"})
    assert np.abs(np.asarray(items_j)).min() > 1e-2  # every item carries signal
    print(f"loss items {items.tolist()}, JAX {np.asarray(items_j).tolist()}, "
          f"largest difference {float(np.abs(items.numpy() - np.asarray(items_j)).max())}")
    np.testing.assert_allclose(items.numpy(), np.asarray(items_j), rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=LOSS_TOL)


def _float64_grads(state_dict: dict, batch: dict) -> dict:
    """Gradients of the loss of the port's train-mode model, in float64 throughout, from `state_dict`."""
    model = DetectionModel(FLAGSHIP_N, nc=NC)
    model.load_state_dict(state_dict)
    model.double().train()
    with M.collect_bn_stats():
        maps = model(torch.from_numpy(batch["img"].transpose(0, 3, 1, 2) / 255.0))
    loss, _ = v8DetectionLoss(model)(maps, {k: torch.from_numpy(v).double() for k, v in batch.items() if k != "img"})
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters()}


def _jax_step(ref, trainer, variables, opt_name):
    """The JAX package's own step_fn, jitted by `_build_train_step` on a stub holding what it reads, and its initial state."""
    stub = types.SimpleNamespace(
        model=ref, criterion=JaxLoss(ref), accumulate=trainer.accumulate, opt_name=opt_name,
        weight_decay=trainer.weight_decay, device_aug=False, labels=label_tree(variables),
        args=types.SimpleNamespace(amp=False, imgsz=IMGSZ, multi_scale=False, seed=0, sp=1))
    JaxTrainer._build_train_step(stub)
    params = jax.tree_util.tree_map(jnp.asarray, variables)
    state = {"params": params, "opt": init_adam(params) if opt_name == "AdamW" else init_momentum(params),
             "ema": jax.tree_util.tree_map(lambda v: jnp.array(v, copy=True), params),
             "acc": jax.tree_util.tree_map(jnp.zeros_like, params), "count": jnp.zeros((), jnp.int32),
             "step": jnp.zeros((), jnp.int32)}
    return stub.train_step, state


@pytest.mark.parametrize("opt_name,nbs,steps", [("SGD", BATCH, 2), ("SGD", 2 * BATCH, 2), ("AdamW", BATCH, 1)])
def test_train_steps_match_jax_step_fn(init, opt_name, nbs, steps):
    """2 SGD steps (accumulate 1), 2 micro-steps with accumulate 2 (one optimizer step), 1 AdamW step, at the
    warmup's hyperparameters of batches 50 on: the whole state after them (params and BN statistics, optimizer
    state, EMA) against the JAX step's."""
    _, ref, variables = init
    loader = [synthetic_batch(np.random.default_rng(10 + i), BATCH, IMGSZ, NC) for i in range(steps)]
    trainer = BaseTrainer(overrides=dict(model=FLAGSHIP_N, batch=BATCH, imgsz=IMGSZ, device="cpu", amp=False,
                                         optimizer=opt_name, nbs=nbs, s2grad="cuda"), train_loader=loader, data={"nc": NC})
    trainer._setup_train()
    assert trainer.accumulate == nbs // BATCH
    step_fn, state = _jax_step(ref, trainer, variables, opt_name)
    trainer.load_train_state(from_jax_train_state(state))  # the port starts from the JAX state, by name
    start = from_jax_variables(variables)
    hyps = [trainer._warmup_hyp(50 + i, 0) for i in range(steps)]
    for batch, hyp in zip(loader, hyps):
        state, _, items_j = step_fn(state, batch, *(jnp.float32(h) for h in hyp), target_sz=IMGSZ)
        _, items = trainer.train_step(batch, *hyp)
        np.testing.assert_allclose(items.numpy(), np.asarray(items_j), rtol=0, atol=LOSS_TOL)
        if trainer.count:  # mid-accumulation: this batch's gradients, against each other and a float64 evaluation
            acc = from_jax_train_state(state)["acc"]
            names = sorted(dict(trainer.model.named_parameters()))
            _close(trainer.train_state()["acc"], acc, names, base={k: 0 * v for k, v in acc.items()})
            exact = _float64_grads(start, batch)
            err = {who: max(float((g[k].double() - exact[k]).abs().max() / exact[k].abs().max()) for k in names)
                   for who, g in (("jax", acc), ("port", trainer.train_state()["acc"]))}
            print(f"largest gradient error against float64, relative to each tensor's largest gradient: {err}")
            assert err["jax"] <= REF_NOISE / 2 and err["port"] <= REF_NOISE / 20

    want, got = from_jax_train_state(state), trainer.train_state()
    assert (got["count"], got["step"]) == (want["count"], want["step"]) == (0, steps // trainer.accumulate)
    names = sorted(dict(trainer.model.named_parameters()))
    buffers = sorted(set(want["params"]) - set(names))
    _close(got["params"], want["params"], buffers, base=start)  # BN running statistics
    _close(got["ema"], want["ema"], buffers, base=start)
    if opt_name == "AdamW":
        assert got["opt"]["t"] == want["opt"]["t"] == 1
        zero = {k: 0 * v for k, v in want["opt"]["m"].items()}
        _close(got["opt"]["m"], want["opt"]["m"], names, base=zero)
        _close(got["opt"]["v"], want["opt"]["v"], names, base=zero, rtol=1e-4, atol=0.0)
        # AdamW moves an entry by about lr x sign(gradient): where the JAX gradient lies within its own float32
        # error of 0 the sign is noise, and both packages may move it either way by at most the lr.
        lr_max = max(hyps[0][:2])
        for tree in ("params", "ema"):
            for k in names:
                m = want["opt"]["m"][k].numpy()
                sure = np.abs(m) > REF_NOISE * np.abs(m).max()
                g, w = got[tree][k].detach().numpy(), want[tree][k].numpy()
                tol = 1e-5 + REF_NOISE * np.abs(w - start[k].numpy()).max()
                np.testing.assert_allclose(g[sure], w[sure], rtol=1e-4, atol=tol, err_msg=f"{tree} {k}")
                assert np.abs(g - w).max() <= 2 * lr_max * (1 + 1e-4) + tol, f"{tree} {k}"
    else:
        _close(got["params"], want["params"], names, base=start)
        _close(got["ema"], want["ema"], names, base=start)
        _close(got["opt"]["momentum"], want["opt"]["momentum"], names, base={k: 0 * v for k, v in want["opt"]["momentum"].items()})
    # the step moved the parameters (a BN bias whose only consumer is a 1x1 conv into a train-mode BN has a zero
    # gradient: BN takes the per-channel shift back out)
    moved = [k for k in names if not np.array_equal(got["params"][k].numpy(), start[k].numpy())]
    assert len(moved) > 0.9 * len(names)


def test_trainer_runs_on_the_card_unless_told_otherwise():
    """The trainer's device is the CUDA card by default and an error without one; unknown keys are refused."""
    if torch.cuda.is_available():
        assert BaseTrainer(overrides=dict(model=FLAGSHIP_N)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BaseTrainer(overrides=dict(model=FLAGSHIP_N))
    assert BaseTrainer(overrides=dict(model=FLAGSHIP_N, device="cpu")).device.type == "cpu"
    with pytest.raises(KeyError, match="unsupported train arguments"):
        BaseTrainer(overrides=dict(model=FLAGSHIP_N, device="cpu", device_aug=True))

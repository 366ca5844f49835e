"""The port's BN statistics (`drone_yolo_tpu_torch/ops/bn_stats.py`) against the JAX package's, on the CPU.

`bn_stats` is the per-channel float32 sum and sum of squares over N, H and W that
train-mode BatchNorm takes its batch statistics from; on a CPU tensor its forward is
the plain version `bn_stats_reference` (the CUDA kernel is held against it on the card,
`tests/test_torch_cuda.py`). Held here against the Pallas TPU kernel itself,
`tools/bn_stat_probe.py:make_pallas_stats`, run on the CPU in TPU interpret mode; against
the mean and variance of `_bn_apply`; its backward against autograd of the plain
version; and one flagship train step with `bnstats="cuda"` against the stock step.

Tolerance, as on the card (`chip_smoke.BN_RTOL`, `BN_ATOL`): the two sum the same
values in float32 in different orders, so per channel |difference| <= 1e-5 x sum |x|
(for the sums) or x sum x^2 (for the sums of squares) + 1e-6.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import BN_ATOL, BN_RTOL, synthetic_batch
from drone_yolo_tpu.nn import modules as JM
from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
from drone_yolo_tpu_torch.nn import modules as M
from drone_yolo_tpu_torch.nn.model import DetectionModel
from drone_yolo_tpu_torch.ops import bn_stats as B
from drone_yolo_tpu_torch.ops import cuda_bnstats

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _probe():
    """`tools/bn_stat_probe.py`, imported by path (the tools directory is no package)."""
    spec = importlib.util.spec_from_file_location("bn_stat_probe", REPO / "tools" / "bn_stat_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_within(got_s, got_q, want_s, want_q, abs_sum, sq_sum):
    for got, want, scale in ((got_s, want_s, abs_sum), (got_q, want_q, sq_sum)):
        err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
        tol = BN_RTOL * np.asarray(scale, np.float64) + BN_ATOL
        assert (err <= tol).all(), f"largest error {err.max()}, over its tolerance by {(err / tol).max()}"


@pytest.mark.parametrize("shape", [(2, 32, 32, 128), (1, 16, 8, 16), (3, 48, 20, 64)])
def test_reference_matches_pallas_kernel(shape):
    """bf16 NHWC into the Pallas kernel (interpret mode), the same values NCHW into `bn_stats_reference`."""
    rng = np.random.default_rng(sum(shape))
    x_j = jnp.asarray((rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        s_j, q_j = jax.jit(_probe().make_pallas_stats(shape))(x_j)
    x = torch.from_numpy(np.asarray(x_j.astype(jnp.float32)).transpose(0, 3, 1, 2).copy()).to(torch.bfloat16)
    s, q = B.bn_stats_reference(x)
    assert s.dtype == q.dtype == torch.float32 and s.shape == (shape[3],)
    xf = x.float()
    _assert_within(s.numpy(), q.numpy(), np.asarray(s_j), np.asarray(q_j), xf.abs().sum((0, 2, 3)).numpy(),
                   xf.square().sum((0, 2, 3)).numpy())
    s_f, q_f = B.bn_stats(x)  # the Function's CPU forward is the plain version
    assert torch.equal(s_f, s) and torch.equal(q_f, q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_with_bnstats_matches_bn_apply(dtype):
    """Train-mode BatchNorm2d with bnstats="cuda" (the Function, plain forward on the CPU): its batch mean and
    biased one-pass variance and its output against `_bn_apply` on the same values."""
    rng = np.random.default_rng(7)
    dt = getattr(torch, dtype)
    x = torch.from_numpy((rng.standard_normal((2, 6, 5, 9)) * 3 + 1).astype(np.float32)).to(dt)
    bn = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32), "bias": rng.normal(0, 0.1, 6).astype(np.float32),
          "mean": np.zeros(6, np.float32), "var": np.ones(6, np.float32)}
    ctx = JM.Ctx(train=True, dtype=jnp.float32)
    y_j = JM._bn_apply({k: jnp.asarray(v) for k, v in bn.items()}, jnp.asarray(x.float().numpy().transpose(0, 2, 3, 1)), ctx, "bn")
    mod = M.BatchNorm2d(6).train()
    mod.bnstats = "cuda"
    mod.load_state_dict({"weight": torch.from_numpy(bn["scale"]), "bias": torch.from_numpy(bn["bias"]),
                         "running_mean": torch.zeros(6), "running_var": torch.ones(6)})
    with M.collect_bn_stats() as stats:
        y = mod(x)
    mean, var = stats[mod]
    np.testing.assert_allclose(mean.numpy(), np.asarray(ctx.updates["bn"][0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(ctx.updates["bn"][1]), rtol=1e-5, atol=1e-6)
    tol = dict(rtol=1e-5, atol=1e-5) if dt == torch.float32 else dict(rtol=2**-7, atol=2**-7)
    np.testing.assert_allclose(y.float().detach().numpy(), np.asarray(y_j).transpose(0, 3, 1, 2), **tol)


def test_backward_matches_autograd_of_plain():
    """gx = g_sum + 2 x g_sumsq: float64 by gradcheck, float32 and bf16 against autograd of the plain version."""
    rng = np.random.default_rng(3)
    x64 = torch.from_numpy(rng.standard_normal((2, 3, 4, 5))).requires_grad_()
    assert torch.autograd.gradcheck(B.bn_stats, (x64,))
    g_s, g_q = torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32))
    for dt, tol in ((torch.float32, dict(rtol=1e-6, atol=1e-6)), (torch.bfloat16, dict(rtol=2**-8, atol=1e-6))):
        x = torch.from_numpy((rng.standard_normal((2, 3, 7, 9)) + 0.3).astype(np.float32)).to(dt)
        xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
        torch.autograd.backward(B.bn_stats(xa), (g_s, g_q))
        torch.autograd.backward(B.bn_stats_reference(xb), (g_s, g_q))
        assert xa.grad.dtype == dt
        torch.testing.assert_close(xa.grad.float(), xb.grad.float(), **tol)


def test_train_step_with_bnstats_matches_stock(monkeypatch):
    """One flagship-n step (imgsz 64, batch 2, float32) with bnstats="cuda" against the stock step from the same
    init: the Function runs at all 77 train-mode BNs; the loss is equal, the state equal to float32 rounding."""
    calls = []
    monkeypatch.setattr(M, "bn_stats", lambda x: calls.append(x.shape) or B.bn_stats(x))
    loader = [synthetic_batch(np.random.default_rng(4), 2, 64, 2)]
    runs = {}
    for mode in ("cuda", None):
        trainer = BaseTrainer(overrides=dict(model="yolov8n-p2-repvgg-sf.yaml", batch=2, imgsz=64, nbs=2, device="cpu",
                                             amp=False, optimizer="SGD", bnstats=mode), train_loader=loader, data={"nc": 2})
        trainer._setup_train()
        loss, items = trainer.train_step(loader[0], *trainer._warmup_hyp(50, 0))
        runs[mode] = (float(loss), items, trainer.train_state())
        assert len(calls) == 77  # 77 calls in the bnstats step; the stock step adds none
    (loss_k, items_k, st_k), (loss_s, items_s, st_s) = runs["cuda"], runs[None]
    assert loss_k == loss_s and torch.equal(items_k, items_s)  # the same forward, operation for operation
    for tree in ("params", "ema"):
        for name, want in st_s[tree].items():
            torch.testing.assert_close(st_k[tree][name], want, rtol=1e-5, atol=1e-7, msg=f"{tree} {name}")
    for name, want in st_s["opt"]["momentum"].items():
        torch.testing.assert_close(st_k["opt"]["momentum"][name], want, rtol=1e-4, atol=1e-6, msg=name)


def test_kernel_wrapper_refuses_cpu_tensors():
    cuda_bnstats.reset_counts()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bnstats.bn_stats_cuda(torch.zeros(1, 2, 3, 3))
    assert cuda_bnstats.bn_stats_cuda.calls == cuda_bnstats.bn_stats_cuda.launches == 0
    with pytest.raises(ValueError, match="bnstats"):
        DetectionModel("yolov8n-p2-repvgg-sf.yaml", bnstats="triton")

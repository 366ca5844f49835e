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
import math
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


# small shapes whose channels take one run or several: runs of whole planes, runs that end inside a plane, odd sizes
PLAN_SHAPES = [(1, 3, 5, 7), (2, 3, 17, 33), (1, 16, 1, 1), (3, 5, 31, 31), (2, 130, 9, 11), (8, 2, 20, 20),
               (8, 4, 80, 80), (3, 2, 129, 131), (2, 3, 200, 300)]


def run_elements(shape, part: int, parts: int, chunk: int) -> np.ndarray:
    """Flat NCHW indices that block (c, part) reads, by the kernel's index arithmetic (`csrc/bn_stats.cu`), for every
    channel c: the run [part * chunk, min(part * chunk + chunk, N*H*W)) of the channel's values taken image after
    image, value e at image e // (H*W), offset e % (H*W)."""
    n, c, h, w = shape
    hw = h * w
    lo, hi = part * chunk, min(part * chunk + chunk, n * hw)
    e = np.arange(lo, hi)
    return ((e // hw)[None] * c + np.arange(c)[:, None]) * hw + (e % hw)[None]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_split_channel_covers_every_value_once(shape):
    """The runs of `split_channel` read every value of the tensor exactly once, each from its own channel; a run is
    a whole number of 16-byte vectors (8 values) and at most RUN values; the plan is memoised per size."""
    n, c, h, w = shape
    parts, chunk = cuda_bnstats.split_channel(n * h * w)
    assert chunk % cuda_bnstats.VEC == 0 and (parts - 1) * chunk < n * h * w <= parts * chunk
    assert chunk <= cuda_bnstats.RUN and parts == math.ceil(n * h * w / cuda_bnstats.RUN)
    seen = np.concatenate([run_elements(shape, p, parts, chunk) for p in range(parts)], 1)
    assert (seen // (h * w) % c == np.arange(c)[:, None]).all()  # each block stays in its channel
    np.testing.assert_array_equal(np.sort(seen.ravel()), np.arange(n * c * h * w))
    assert cuda_bnstats.split_channel(n * h * w) is cuda_bnstats.split_channel(n * h * w)


def test_split_channel_blocks_at_the_flagship_sites():
    """Runs span images: at the 20x20 and 40x40 sites (39 of 77) one block reads a whole channel of all 8 images and
    writes its sums itself; every block reads 6-32 KB of bf16; the 77 sites launch 28,848 blocks in all (130,944
    with one block per image plane and part)."""
    counts = {(8, 32, 320, 320): 1, (8, 64, 160, 160): 8, (8, 32, 160, 160): 4, (8, 16, 160, 160): 1,
              (8, 80, 160, 160): 2, (8, 128, 80, 80): 8, (8, 64, 80, 80): 11, (8, 32, 80, 80): 1, (8, 80, 80, 80): 2,
              (8, 256, 40, 40): 8, (8, 128, 40, 40): 9, (8, 64, 40, 40): 3, (8, 80, 40, 40): 2, (8, 512, 20, 20): 7,
              (8, 256, 20, 20): 6, (8, 64, 20, 20): 2, (8, 80, 20, 20): 2}
    assert sum(counts.values()) == 77
    blocks = whole = 0
    for (n, c, h, w), sites in counts.items():
        parts, chunk = cuda_bnstats.split_channel(n * h * w)
        assert 6 * 1024 <= 2 * chunk <= 32 * 1024
        assert (parts == 1) == (h <= 40)
        blocks += sites * parts * c
        whole += sites * (parts == 1)
    assert (blocks, whole) == (28848, 39)


def test_kernel_wrapper_refuses_cpu_tensors():
    cuda_bnstats.reset_counts()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bnstats.bn_stats_cuda(torch.zeros(1, 2, 3, 3))
    assert cuda_bnstats.bn_stats_cuda.calls == cuda_bnstats.bn_stats_cuda.launches == 0
    with pytest.raises(ValueError, match="bnstats"):
        DetectionModel("yolov8n-p2-repvgg-sf.yaml", bnstats="triton")

"""The port's stride-2 conv backward (`drone_yolo_tpu_torch/ops/conv_s2.py`) against the JAX package's.

On the CPU the backward is the plain version `s2_bwd_reference` (the CUDA kernel is
held against it on the card, `tests/test_torch_cuda.py`). Held here against the
JAX Pallas kernel `s2_bwd(..., interpret=True)` and against `jax.grad` of the JAX
`conv2d_s2`, at `tests/test_conv_s2.py`'s float32 tolerances, on its cases (layouts
transposed NHWC <-> NCHW); the grouped and odd-sized cases are not sites of the
kernel and keep stock autograd, which is held against the same JAX gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from drone_yolo_tpu.ops.conv_s2 import conv2d_s2 as jax_conv2d_s2
from drone_yolo_tpu.ops.pallas_s2bwd import s2_bwd as jax_s2_bwd
from chip_smoke import s2_sites
from drone_yolo_tpu_torch.nn import modules as M
from drone_yolo_tpu_torch.nn.model import DetectionModel
from drone_yolo_tpu_torch.ops import conv_s2, cuda_s2bwd

torch.set_num_threads(1)

# (k, p, groups, ci, co, h, w): the cases of tests/test_conv_s2.py (stem, backbone, RepVGG 1x1 branch,
# DWConv tap, grouped, odd) and of its Pallas test (ci=5, co=7, 12x20)
CASES = [
    (3, 1, 1, 3, 8, 16, 16),
    (3, 1, 1, 8, 16, 20, 20),
    (1, 0, 1, 8, 16, 16, 16),
    (3, 1, 8, 8, 8, 16, 16),
    (3, 1, 4, 8, 12, 14, 14),
    (3, 1, 1, 5, 7, 15, 15),
    (3, 1, 1, 5, 7, 12, 20),
]
DX_TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_conv_s2.py:115-116
DW_TOL = dict(rtol=1e-4, atol=1e-3)
# (b, ci, h, w, co, k): the flagship's 12 dense stride-2 sites at batch 8, 640 px (yolov8s-p2-repvgg-sf), then
# ragged shapes: one image, Ci = 3, odd Wo, Ci and Co off the tiles, 20x20 dy
FLAGSHIP_SITES = [
    (8, 3, 640, 640, 32, 3), (8, 32, 320, 320, 64, 3), (8, 32, 320, 320, 64, 1), (8, 64, 160, 160, 128, 3),
    (8, 64, 160, 160, 128, 1), (8, 128, 80, 80, 256, 3), (8, 128, 80, 80, 256, 1), (8, 256, 40, 40, 512, 3),
    (8, 256, 40, 40, 512, 1), (8, 64, 160, 160, 64, 3), (8, 128, 80, 80, 128, 3), (8, 256, 40, 40, 256, 3),
]
PLAN_SHAPES = FLAGSHIP_SITES + [(1, 3, 2, 34, 70, 1), (2, 5, 12, 20, 7, 3), (3, 40, 40, 40, 72, 1), (1, 96, 24, 48, 80, 3),
                                (2, 67, 10, 6, 130, 3), (1, 33, 64, 128, 16, 1)]


def _inputs(k, g, ci, co, h, w, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, ci, h, w)).astype(np.float32)
    wt = (rng.standard_normal((co, ci // g, k, k)) * 0.1).astype(np.float32)
    dy = rng.standard_normal((2, co, (h - 1) // 2 + 1, (w - 1) // 2 + 1))  # the output of k=3 p=1 and of k=1 p=0
    return x, wt, dy.astype(np.float32)


def _jax_grads(x, wt, dy, p, g):
    """jax.grad of sum(conv2d_s2(x, w) * dy), NHWC/HWIO, returned NCHW/OIHW."""
    xj, wj, dyj = jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(wt.transpose(2, 3, 1, 0)), jnp.asarray(dy.transpose(0, 2, 3, 1))
    gx, gw = jax.grad(lambda a, b: jnp.sum(jax_conv2d_s2(a, b, p, g) * dyj), (0, 1))(xj, wj)
    return np.asarray(gx).transpose(0, 3, 1, 2), np.asarray(gw).transpose(3, 2, 0, 1)


@pytest.mark.parametrize("k,p,g,ci,co,h,w", CASES)
def test_backward_matches_jax(k, p, g, ci, co, h, w):
    x, wt, dy = _inputs(k, g, ci, co, h, w)
    gx_j, gw_j = _jax_grads(x, wt, dy, p, g)
    mod = torch.nn.Conv2d(ci, co, k, 2, p, groups=g, bias=False)
    xt = torch.from_numpy(x)
    if not conv_s2.covers(mod, xt):  # grouped or odd: not a kernel site, stock autograd
        assert g != 1 or h % 2 or w % 2
        xt.requires_grad_(True)
        wt_t = torch.from_numpy(wt).requires_grad_(True)
        (F.conv2d(xt, wt_t, None, 2, p, groups=g) * torch.from_numpy(dy)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), gx_j, **DX_TOL)
        np.testing.assert_allclose(wt_t.grad.numpy(), gw_j, **DW_TOL)
        return
    dx, dw = conv_s2.s2_bwd_reference(xt, torch.from_numpy(wt), torch.from_numpy(dy), k)
    assert dx.dtype == torch.float32 and dw.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), gx_j, **DX_TOL)
    np.testing.assert_allclose(dw.numpy(), gw_j, **DW_TOL)
    dx_p, dw_p = jax_s2_bwd(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(wt.transpose(2, 3, 1, 0)),
                            jnp.asarray(dy.transpose(0, 2, 3, 1)), k=k, interpret=True)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_p).transpose(0, 3, 1, 2), **DX_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_p).transpose(3, 2, 0, 1), **DW_TOL)
    _, dw_only = conv_s2.s2_bwd_reference(xt, torch.from_numpy(wt), torch.from_numpy(dy), k, need_dx=False)
    assert _ is None and torch.equal(dw_only, dw)


@pytest.mark.parametrize("k,p,ci,co,h,w", [(3, 1, 3, 8, 16, 16), (3, 1, 5, 7, 12, 20), (1, 0, 8, 16, 16, 16)])
def test_function_matches_stock_autograd(k, p, ci, co, h, w):
    x, wt, dy = (torch.from_numpy(a) for a in _inputs(k, 1, ci, co, h, w, seed=3))
    grads = []
    for fn in (lambda a, b: F.conv2d(a, b, None, 2, p), lambda a, b: conv_s2.conv2d_s2(a, b, p)):
        a, b = x.clone().requires_grad_(True), wt.clone().requires_grad_(True)
        y = fn(a, b)
        (y * dy).sum().backward()
        grads.append((y.detach(), a.grad, b.grad))
    (y0, gx0, gw0), (y1, gx1, gw1) = grads
    assert torch.equal(y0, y1)  # the forward is the stock conv
    np.testing.assert_allclose(gx1.numpy(), gx0.numpy(), **DX_TOL)
    np.testing.assert_allclose(gw1.numpy(), gw0.numpy(), **DW_TOL)
    # an input that needs no gradient (the image at layer 0) gets no dx
    b = wt.clone().requires_grad_(True)
    (conv_s2.conv2d_s2(x, b, p) * dy).sum().backward()
    np.testing.assert_allclose(b.grad.numpy(), gw0.numpy(), **DW_TOL)


def test_function_under_bf16_autocast():
    """bf16 x and a float32 master w under autocast (the training configuration): the backward sees bf16
    x, w and dy; dx comes back bf16, dw float32; against a float32 oracle at tests/test_conv_s2.py:51-67's
    bf16 tolerances."""
    x, wt, dy = (torch.from_numpy(a) for a in _inputs(3, 1, 8, 16, 16, 16, seed=1))
    a, b = x.clone().requires_grad_(True), wt.clone().requires_grad_(True)
    (F.conv2d(a, b, None, 2, 1) * dy).sum().backward()
    xb = x.bfloat16().requires_grad_(True)
    w32 = wt.clone().requires_grad_(True)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = conv_s2.conv2d_s2(xb, w32, 1)
    assert y.dtype == torch.bfloat16
    (y.float() * dy.bfloat16().float()).sum().backward()
    assert xb.grad.dtype == torch.bfloat16 and w32.grad.dtype == torch.float32
    np.testing.assert_allclose(xb.grad.float().numpy(), a.grad.numpy(), rtol=0.05, atol=0.05)
    np.testing.assert_allclose(w32.grad.numpy(), b.grad.numpy(), rtol=0.05, atol=0.15)


def test_flagship_routes_exactly_its_dense_stride2_sites(monkeypatch):
    """s2grad="cuda" on the flagship (scale n): 8 k=3 sites (layers 0, 1, 3, 5, 7, 22, 25, 28; no dx at layer 0)
    and 4 k=1 sites (the RepVGG 1x1 branches of layers 1, 3, 5, 7); the grouped DWConv taps (11, 15, 19) stay stock.
    The same model with the default keeps every conv on stock autograd."""
    calls = []
    plain = conv_s2.s2_bwd_reference

    def spy(x, w, dy, k, need_dx=True):
        calls.append((k, tuple(x.shape), need_dx))
        return plain(x, w, dy, k, need_dx)

    monkeypatch.setattr(conv_s2, "s2_bwd_reference", spy)
    model = DetectionModel("yolov8n-p2-repvgg-sf.yaml", nc=2)
    model.init(0, imgsz=64)
    x = torch.from_numpy(np.random.default_rng(0).random((2, 3, 64, 64), np.float32))
    sites = {}
    for name, mod in model.named_modules():
        if isinstance(mod, M.Conv):
            mod.register_forward_pre_hook(lambda m, args, name=name: sites.__setitem__(name, conv_s2.covers(m.conv, args[0])))
    for mode, want in ((None, []), ("cuda", None)):
        model.set_s2grad(mode).train()
        calls.clear()
        with M.collect_bn_stats():
            maps = model(x)
        sum(m.float().square().mean() for m in maps).backward()
        if want is not None:
            assert calls == want
    covered = sorted(n for n, c in sites.items() if c)
    layers = sorted({int(n.split(".")[1]) for n in covered})
    assert layers == [0, 1, 3, 5, 7, 22, 25, 28]
    assert sorted(k for k, _, _ in calls) == [1] * 4 + [3] * 8
    assert [n for n in covered if n.endswith("rbr_1x1")] == [f"model.{i}.rbr_1x1" for i in (1, 3, 5, 7)]
    assert [need for _, shape, need in calls if shape[1] == 3] == [False]  # layer 0: the image needs no dx
    for i in (11, 15, 19):
        assert isinstance(model.model[i], M.DWConv) and sites[f"model.{i}"] is False
    with pytest.raises(ValueError, match="s2grad"):
        model.set_s2grad("pallas")


def test_flagship_sites_are_the_planned_shapes():
    """FLAGSHIP_SITES are the shapes chip_smoke traces from the flagship (batch 8, 640 px, meta device)."""
    sites = s2_sites(DetectionModel("yolov8s-p2-repvgg-sf.yaml", nc=80), 8, 640)
    assert [(*s["x"], s["w"][0], s["k"]) for s in sites] == FLAGSHIP_SITES


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,ci,h,w,co,k", PLAN_SHAPES)
def test_plan_covers_the_reduction(b, ci, h, w, co, k, dtype):
    """The split and tile plan: the splits' chunks cover the dw reduction exactly once (no empty split), in
    multiples of the float32 kernel's depth or in whole bf16 tiles of 64 pixel slots; the bf16 tiles are widths the
    source takes (8, 16, 32, 64, or the dy width when a multiple of 4 below 64) and cover the image with the fewest
    tiles; the workspace holds every split's partial dw."""
    ho, wo = h // 2, w // 2
    pl = cuda_s2bwd.plan(b, ci, h, w, co, k, dtype)
    assert pl.impl == cuda_s2bwd.IMPLS[dtype] and pl.ws_numel == pl.splits * co * ci * k * k
    assert 1 <= pl.splits <= 65535
    if dtype == torch.float32:
        assert pl.chunk % cuda_s2bwd.TILE_K == 0
        units = b * ho * wo
    else:
        rows, cols = cuda_s2bwd.tile_shape(ho, wo, cuda_s2bwd.DW_PIXELS)
        assert cols == pl.dw_cols and rows == cuda_s2bwd.DW_PIXELS // cols
        units = b * -(-ho // rows) * -(-wo // cols)
        widths = [c for c in (8, 16, 32, 64, wo) if c in (8, 16, 32, 64) or (wo % 4 == 0 and wo < 64)]
        for pixels, width in ((cuda_s2bwd.DW_PIXELS, pl.dw_cols), (cuda_s2bwd.dx_pixels(ci), pl.dx_cols)):
            assert width in widths and width <= pixels
            tiles = {c: -(-ho // (pixels // c)) * -(-wo // c) for c in widths}
            assert tiles[width] == min(tiles.values()) and tiles[width] * pixels >= ho * wo
        assert pl.chunk >= min(cuda_s2bwd.MIN_TILES, units)
    assert (pl.splits - 1) * pl.chunk < units <= pl.splits * pl.chunk


@pytest.mark.parametrize("k,ci,co,h,w", [(k, ci, co, h, w) for k, _, g, ci, co, h, w in CASES if g == 1 and h % 2 == w % 2 == 0])
def test_packed_weights_give_the_reference_dx(k, ci, co, h, w):
    """`pack_weights` lays w out per tap as (k*k, Ci, Co); dx from the packed weights, class by class as the bf16
    kernel sums it (`packed_dx_reference`), equals `s2_bwd_reference` and the Pallas kernel in interpret mode."""
    x, wt, dy = _inputs(k, 1, ci, co, h, w, seed=5)
    packed = cuda_s2bwd.pack_weights(torch.from_numpy(wt))
    assert packed.shape == (k * k, ci, co) and packed.is_contiguous()
    for ky in range(k):
        for kx in range(k):
            assert torch.equal(packed[ky * k + kx], torch.from_numpy(wt[:, :, ky, kx]).t())
    dx = cuda_s2bwd.packed_dx_reference(packed, torch.from_numpy(dy), k)
    dx_ref, _ = conv_s2.s2_bwd_reference(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(dy), k)
    np.testing.assert_allclose(dx.numpy(), dx_ref.numpy(), rtol=1e-6, atol=1e-6)  # the same products, float32 sums
    dx_p, _ = jax_s2_bwd(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(wt.transpose(2, 3, 1, 0)),
                         jnp.asarray(dy.transpose(0, 2, 3, 1)), k=k, interpret=True)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_p).transpose(0, 3, 1, 2), **DX_TOL)


def _misaligned(shape, dtype):
    """A contiguous CPU tensor whose data starts one element past an allocation's start."""
    return torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("case,error,match", [
    ("misaligned_x", ValueError, "aligned"), ("misaligned_dy", ValueError, "aligned"), ("float16", TypeError, "float32"),
    ("mixed", TypeError, "float32"), ("k5", ValueError, "k in"), ("odd_h", ValueError, "even"),
    ("cpu_bf16", ValueError, "CUDA device"), ("misaligned_f32_on_cpu", ValueError, "CUDA device")])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, error, match):
    """The CUDA wrapper raises before any launch: misaligned bf16 x or dy (the cp.async copies and the 16-byte dx
    stores need 16-byte aligned rows; no silent copy), other dtypes, mixed dtypes, k other than 1 or 3, odd H, and
    tensors off the card. A misaligned float32 input passes the alignment rule (the CUDA-core kernel reads
    elements) and is refused only for lying on the CPU."""
    bf = torch.bfloat16
    x, w, dy, k = torch.zeros(2, 4, 8, 8, dtype=bf), torch.zeros(6, 4, 3, 3, dtype=bf), torch.zeros(2, 6, 4, 4, dtype=bf), 3
    if case == "misaligned_x":
        x = _misaligned(x.shape, bf)
    elif case == "misaligned_dy":
        dy = _misaligned(dy.shape, bf)
    elif case == "float16":
        x, w, dy = x.half(), w.half(), dy.half()
    elif case == "mixed":
        w = w.float()
    elif case == "k5":
        k = 5
    elif case == "odd_h":
        x = torch.zeros(2, 4, 7, 8, dtype=bf)
    elif case == "misaligned_f32_on_cpu":
        x, w, dy = _misaligned(x.shape, torch.float32), w.float(), _misaligned(dy.shape, torch.float32)
    assert case not in ("misaligned_x", "misaligned_dy") or (x.data_ptr() % 16 or dy.data_ptr() % 16)
    calls = dict(cuda_s2bwd.s2_bwd_cuda.calls)
    with pytest.raises(error, match=match):
        cuda_s2bwd.s2_bwd_cuda(x, w, dy, k)
    assert cuda_s2bwd.s2_bwd_cuda.calls == calls

"""The port's CUDA kernels against their plain versions, a train step through them, the segment masks, the rotated
NMS and the classifiers' sites, on the card.

Every test here is marked `cuda` and skips without a CUDA device. The module
imports neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch; there the JAX-importing `tests/conftest.py` is skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import (S2_SUM_FLOOR, S2_TOL, bn_sites, bn_stats_errors, clustered_boxes, s2_site_inputs, s2_sites,
                        spread_weights, synthetic_batch, synthetic_obb_batch, synthetic_pose_batch, synthetic_seg_batch)
from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
from drone_yolo_tpu_torch.models.yolo.classify import ClassificationTrainer
from drone_yolo_tpu_torch.models.yolo.obb import OBBTrainer
from drone_yolo_tpu_torch.models.yolo.pose import PoseTrainer
from drone_yolo_tpu_torch.models.yolo.segment import SegmentationTrainer
from drone_yolo_tpu_torch.nn import modules as M
from drone_yolo_tpu_torch.nn.model import ClassificationModel, DetectionModel, OBBModel, PoseModel, SegmentationModel
from drone_yolo_tpu_torch.ops import conv_s2, cuda_bnstats, cuda_nms, cuda_s2bwd
from drone_yolo_tpu_torch.ops.masks import process_mask, scale_masks
from drone_yolo_tpu_torch.ops.bn_stats import bn_stats, bn_stats_reference
from drone_yolo_tpu_torch.ops.boxes import probiou
from drone_yolo_tpu_torch.ops.nms import (
    compact, greedy_keep, greedy_keep_reference, nms_rotated, non_max_suppression, select_candidates,
    suppression_words_reference, sweep_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("thr", [0.45, 0.7])
@pytest.mark.parametrize("k", [1, 64, 65, 128, 640, 1024])
def test_kernel_matches_plain(cuda_device, k, thr):
    """One call of the NMS kernels (the bitmask, then the sweep) at B=8 against the plain keep."""
    rng = np.random.default_rng(k)
    boxes = clustered_boxes(rng, 8, k).to(cuda_device)
    valid = torch.from_numpy(rng.random((8, k)) > 0.1).to(cuda_device)
    calls, launches = cuda_nms.greedy_keep_cuda.calls, cuda_nms.greedy_keep_cuda.launches
    got = greedy_keep(boxes, valid, thr)
    torch.cuda.synchronize()
    assert (cuda_nms.greedy_keep_cuda.calls, cuda_nms.greedy_keep_cuda.launches) == (calls + 1, launches + 2)
    assert torch.equal(got, greedy_keep_reference(boxes, valid, thr))
    if k > 1:
        assert 0 < int(got.sum()) < int(valid.sum())


@pytest.mark.parametrize("thr", [0.45, 0.7])
@pytest.mark.parametrize("b,k", [(8, 4096), (2, 8192), (1, 12288)])
def test_kernel_matches_plain_at_large_k(cuda_device, b, k, thr):
    """Validation's K = 4096 and beyond, one design for every K: a workspace of B * K * ceil(K/64) words (16.8 MB at
    B=8, K=4096; 18.9 MB at B=1, K=12288) from the caching allocator, two launches."""
    rng = np.random.default_rng(k)
    boxes = clustered_boxes(rng, b, k, clusters=48).to(cuda_device)
    valid = torch.from_numpy(rng.random((b, k)) > 0.1).to(cuda_device)
    launches = cuda_nms.greedy_keep_cuda.launches
    got = greedy_keep(boxes, valid, thr)
    torch.cuda.synchronize()
    assert cuda_nms.greedy_keep_cuda.launches == launches + 2
    assert torch.equal(got, greedy_keep_reference(boxes, valid, thr))
    assert 0 < int(got.sum()) < int(valid.sum())


@pytest.mark.parametrize("thr", [0.45, 0.7, -0.5])
@pytest.mark.parametrize("b,k", [(2, 1), (2, 63), (2, 64), (2, 65), (2, 640), (8, 1024), (1, 4096)])
def test_suppression_words_match_plain(cuda_device, b, k, thr):
    """The bitmask kernel alone against `suppression_words_reference`, bit for bit (bit 63 included; thr < 0 takes
    the division where inter == 0); `sweep_reference` over the kernel's words gives the two kernels' keep; a second
    call gives the same words."""
    rng = np.random.default_rng(k + 1)
    boxes = clustered_boxes(rng, b, k, clusters=12 if k <= 1024 else 48).to(cuda_device)
    valid = torch.from_numpy(rng.random((b, k)) > 0.1).to(cuda_device)
    launches = cuda_nms.suppression_words_cuda.launches
    words = cuda_nms.suppression_words_cuda(boxes, valid, thr)
    torch.cuda.synchronize()
    assert cuda_nms.suppression_words_cuda.launches == launches + 1
    assert words.shape == (b, k, -(-k // 64)) and words.dtype == torch.int64
    assert torch.equal(words, suppression_words_reference(boxes, valid, thr))
    assert torch.equal(words, cuda_nms.suppression_words_cuda(boxes, valid, thr))
    if k >= 1024:
        assert bool((words < 0).any())  # some row suppresses the last column of a block: bit 63, the sign bit
    assert torch.equal(sweep_reference(words, valid), greedy_keep(boxes, valid, thr))


@pytest.mark.parametrize("multi_label,pre_topk,nc,n_extra", [(False, 1024, 80, 0), (True, 4096, 80, 0),
                                                              (False, 1024, 1, 51)])
def test_nms_step_matches_plain_keep(cuda_device, multi_label, pre_topk, nc, n_extra):
    """The NMS step with the kernel against the step with the plain keep; the last case is a pose model's (one class,
    51 keypoint columns carried through the keep mask)."""
    rng = np.random.default_rng(9)
    preds = np.concatenate([rng.random((4, 3000, 2)) * 640, rng.uniform(4, 80, (4, 3000, 2)), rng.random((4, 3000, nc)) ** 4,
                            rng.random((4, 3000, n_extra)) * 640], -1)
    preds = torch.from_numpy(preds.astype(np.float32)).to(cuda_device)
    dets, n = non_max_suppression(preds, conf_thres=0.0, iou_thres=0.7, pre_topk=pre_topk, multi_label=multi_label, nc=nc)
    cand_boxes, top_scores, cls_idx, valid, off_boxes, extra = select_candidates(preds, 0.0, pre_topk, multi_label=multi_label,
                                                                                 nc=nc)
    assert valid.shape == (4, pre_topk) and dets.shape[2] == 6 + n_extra
    dets_ref, n_ref = compact(greedy_keep_reference(off_boxes, valid, 0.7), cand_boxes, top_scores, cls_idx, 300, extra)
    assert torch.equal(n, n_ref) and torch.equal(dets, dets_ref)


def _misaligned(shape, dtype, g, device):
    """A contiguous tensor whose data starts one element past an allocation's start, so its planes are misaligned."""
    n = int(np.prod(shape))
    return (torch.randn(n + 1, generator=g, device=device) * 2 + 0.5).to(dtype)[1:].view(shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,layout", [((1, 3, 5, 7), "contiguous"), ((2, 3, 17, 33), "misaligned"),
                                          ((1, 16, 1, 1), "contiguous"), ((3, 5, 31, 31), "misaligned"),
                                          ((8, 32, 80, 80), "contiguous"), ((2, 130, 9, 11), "channels_last"),
                                          ((8, 512, 20, 20), "contiguous")])
def test_bn_stats_kernel_matches_plain(cuda_device, shape, layout, dtype):
    """Odd shapes (C = 3, odd H*W, N = 1, one pixel), misaligned planes, a non-contiguous input and a 20x20 flagship
    site (one block a channel, across all 8 images), against `bn_stats_reference` at chip_smoke's tolerance (1e-5 of
    sum|x| or sum x^2, plus 1e-6); one launch a call; a second call bitwise equal."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(int(np.prod(shape)))
    if layout == "misaligned":
        x = _misaligned(shape, dt, g, cuda_device)
    else:
        x = (torch.randn(shape, generator=g, device=cuda_device) * 2 + 0.5).to(dt)
        if layout == "channels_last":
            x = x.contiguous(memory_format=torch.channels_last)
    cuda_bnstats.reset_counts()
    s, q = bn_stats(x)
    torch.cuda.synchronize()
    assert (cuda_bnstats.bn_stats_cuda.calls, cuda_bnstats.bn_stats_cuda.launches) == (1, 1)
    assert cuda_bnstats.bn_stats_cuda.copies == (layout == "channels_last")
    assert s.dtype == q.dtype == torch.float32 and s.shape == q.shape == (shape[1],)
    errs = bn_stats_errors(x, s, q)
    assert errs["sum_err_over_tol"] <= 1 and errs["sumsq_err_over_tol"] <= 1, errs
    s2, q2 = bn_stats(x)
    assert torch.equal(s, s2) and torch.equal(q, q2)  # partials summed in a fixed order: bitwise repeatable


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_stats_gradient_matches_autograd(cuda_device, dtype):
    """The Function's gx = g_sum + 2 x g_sumsq against autograd of the plain version: float32 to rounding, bf16
    within one bf16 step."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = (torch.randn(2, 7, 9, 13, generator=g, device=cuda_device) + 0.3).to(dt)
    g_s, g_q = torch.randn(7, generator=g, device=cuda_device), torch.randn(7, generator=g, device=cuda_device)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    s, q = bn_stats(xa)
    torch.autograd.backward((s, q), (g_s, g_q))
    s_p, q_p = bn_stats_reference(xb)
    torch.autograd.backward((s_p, q_p), (g_s, g_q))
    assert xa.grad.dtype == dt
    tol = dict(rtol=1e-6, atol=1e-6) if dt == torch.float32 else dict(rtol=2**-8, atol=1e-6)
    torch.testing.assert_close(xa.grad.float(), xb.grad.float(), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,k,ci,co,h,w,need_dx", [
    (2, 3, 3, 8, 16, 16, False), (2, 3, 8, 16, 20, 20, True), (2, 3, 5, 7, 12, 20, True), (2, 1, 8, 16, 16, 16, True),
    (2, 3, 67, 130, 10, 6, True), (2, 1, 3, 70, 2, 34, True),
    (1, 3, 3, 32, 40, 40, False),  # the image layer's Ci = 3 and Co = 32, no dx, 20x20 dy, one image
    (3, 3, 40, 32, 40, 40, True),  # Co = 32 with dx; Ci = 40 is 1.25 dx tiles of 32; three images
    (3, 1, 40, 72, 40, 40, True),  # k=1 with Ci and Co off every tile
    (1, 3, 96, 80, 24, 48, True),  # 64-channel dx tiles (Ci > 32), 1.5 of them; Co = 80; 12x24 dy
    (1, 1, 33, 16, 64, 128, True),  # Ci = 33: one channel into a second tile; 64-wide tiles
    (2, 3, 32, 64, 160, 160, True),  # model.1's channels at 80x80 dy: many split-K partials
])
def test_s2_kernel_matches_plain(cuda_device, b, k, ci, co, h, w, need_dx, dtype):
    """Small shapes, odd channel counts, ragged tiles and image edges, at chip_smoke.S2_TOL; bf16 through the
    tensor-core implementation, float32 through the CUDA-core one; dw and dx bitwise equal on a second call."""
    g = torch.Generator(device=cuda_device).manual_seed(ci * co + h)
    dt = getattr(torch, dtype)
    x = torch.randn(b, ci, h, w, generator=g, device=cuda_device).to(dt)
    wt = (torch.randn(co, ci, k, k, generator=g, device=cuda_device) * 0.1).to(dt)
    dy = torch.randn(b, co, h // 2, w // 2, generator=g, device=cuda_device).to(dt)
    name, impl = cuda_s2bwd.NAMES[k], cuda_s2bwd.IMPLS[dt]
    calls, impl_calls = dict(cuda_s2bwd.s2_bwd_cuda.calls), dict(cuda_s2bwd.s2_bwd_cuda.impl_calls[impl])
    dx, dw = conv_s2.s2_bwd(x, wt, dy, k, need_dx)
    torch.cuda.synchronize()
    assert cuda_s2bwd.s2_bwd_cuda.calls[name] == calls[name] + 1
    assert cuda_s2bwd.s2_bwd_cuda.impl_calls[impl][name] == impl_calls[name] + 1
    dx_p, dw_p = conv_s2.s2_bwd_reference(x, wt, dy, k, need_dx)
    assert dw.dtype == torch.float32
    torch.testing.assert_close(dw, dw_p, **S2_TOL[dtype]["dw"])
    if need_dx:
        assert dx.dtype == dt
        torch.testing.assert_close(dx.float(), dx_p.float(), **S2_TOL[dtype]["dx"])
    else:
        assert dx is None
    dx2, dw2 = conv_s2.s2_bwd(x, wt, dy, k, need_dx)
    assert torch.equal(dw2, dw) and (dx is None or torch.equal(dx2, dx))


@pytest.mark.parametrize("k", [3, 1])
def test_s2_kernel_dw_is_bitwise_repeatable(cuda_device, k):
    """bf16 at model.3's shape (batch 8, 64 -> 128 channels, 160x160 x): dw sums 62 split-K partials in a fixed
    order and has no atomics, so two calls give bitwise-equal dw (and dx); both within S2_TOL of the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(k)
    x = torch.randn(8, 64, 160, 160, generator=g, device=cuda_device).bfloat16()
    wt = (torch.randn(128, 64, k, k, generator=g, device=cuda_device) / (8 * k)).bfloat16()
    dy = torch.randn(8, 128, 80, 80, generator=g, device=cuda_device).bfloat16()
    assert cuda_s2bwd.plan(8, 64, 160, 160, 128, k, torch.bfloat16).splits > 1
    dx1, dw1 = cuda_s2bwd.s2_bwd_cuda(x, wt, dy, k)
    dx2, dw2 = cuda_s2bwd.s2_bwd_cuda(x, wt, dy, k)
    assert torch.equal(dw1, dw2) and torch.equal(dx1, dx2)
    dx_p, dw_p = conv_s2.s2_bwd_reference(x, wt, dy, k)
    tol = dict(S2_TOL["bfloat16"]["dw"])
    tol["atol"] += S2_SUM_FLOOR * float(dw_p.abs().max())
    torch.testing.assert_close(dw1, dw_p, **tol)
    torch.testing.assert_close(dx1.float(), dx_p.float(), **S2_TOL["bfloat16"]["dx"])


def test_s2_kernel_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros(1, 4, 6, 6, device=cuda_device)
    with pytest.raises(ValueError, match="even"):
        cuda_s2bwd.s2_bwd_cuda(x[..., :5], torch.zeros(8, 4, 3, 3, device=cuda_device), torch.zeros(1, 8, 3, 3, device=cuda_device), 3)
    with pytest.raises(TypeError, match="float32"):
        cuda_s2bwd.s2_bwd_cuda(x.half(), torch.zeros(8, 4, 3, 3, device=cuda_device).half(), torch.zeros(1, 8, 3, 3, device=cuda_device).half(), 3)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    with pytest.raises(ValueError, match="aligned"):  # bf16 x one element past an allocation's start
        cuda_s2bwd.s2_bwd_cuda(_misaligned((1, 4, 6, 6), torch.bfloat16, g, cuda_device),
                               torch.zeros(8, 4, 3, 3, device=cuda_device).bfloat16(),
                               torch.zeros(1, 8, 3, 3, device=cuda_device).bfloat16(), 3)


def test_train_step_with_the_kernel_matches_stock(cuda_device):
    """Flagship (scale n), imgsz 64, batch 2, float32 (TF32 off): 2 steps with s2grad="cuda" against 2 with stock
    autograd (cuDNN) from the same init; the kernel runs 8 k=3 and 4 k=1 times a step."""
    loader = [synthetic_batch(np.random.default_rng(i), 2, 64, 2) for i in range(2)]
    states = {}
    for mode in ("cuda", None):
        trainer = BaseTrainer(overrides=dict(model="yolov8n-p2-repvgg-sf.yaml", batch=2, imgsz=64, nbs=2, optimizer="SGD",
                                             amp=False, s2grad=mode), train_loader=loader, data={"nc": 2})
        cuda_s2bwd.reset_counts()
        steps = trainer.run_steps()
        assert cuda_s2bwd.s2_bwd_cuda.calls == ({"s2_bwd_k3": 16, "s2_bwd_k1": 8} if mode else {"s2_bwd_k3": 0, "s2_bwd_k1": 0})
        states[mode] = (steps, trainer.train_state())
    (steps_k, st_k), (steps_s, st_s) = states["cuda"], states[None]
    np.testing.assert_allclose([r["loss"] for r in steps_k], [r["loss"] for r in steps_s], rtol=1e-4)
    for name, want in st_s["params"].items():
        torch.testing.assert_close(st_k["params"][name], want, rtol=1e-4, atol=1e-5, msg=name)


def test_train_step_with_both_kernels_matches_stock(cuda_device):
    """Flagship (scale n), imgsz 64, batch 2, float32 (TF32 off): 2 steps with s2grad="cuda" and bnstats="cuda"
    against 2 stock steps from the same init; the BN-statistics kernel runs at all 77 train-mode BNs a step."""
    loader = [synthetic_batch(np.random.default_rng(i), 2, 64, 2) for i in range(2)]
    runs = {}
    for mode in ("cuda", None):
        trainer = BaseTrainer(overrides=dict(model="yolov8n-p2-repvgg-sf.yaml", batch=2, imgsz=64, nbs=2, optimizer="SGD",
                                             amp=False, s2grad=mode, bnstats=mode), train_loader=loader, data={"nc": 2})
        cuda_bnstats.reset_counts()
        steps = trainer.run_steps()
        assert cuda_bnstats.bn_stats_cuda.calls == cuda_bnstats.bn_stats_cuda.launches == (2 * 77 if mode else 0)
        runs[mode] = (steps, trainer.train_state())
    (steps_k, st_k), (steps_s, st_s) = runs["cuda"], runs[None]
    np.testing.assert_allclose([r["loss"] for r in steps_k], [r["loss"] for r in steps_s], rtol=1e-4)
    for name, want in st_s["params"].items():
        torch.testing.assert_close(st_k["params"][name], want, rtol=1e-4, atol=1e-5, msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [80, 40, 20])
def test_bn_stats_kernel_at_the_pose_branch(cuda_device, hw, dtype):
    """The BN inputs of yolov8s-pose's keypoint branch (cv4: c4 = max(128 // 4, 51) = 51 channels, not a multiple of
    8) at batch 8, 640 px, against `bn_stats_reference` at chip_smoke's tolerance; the channel's plan of runs reads
    each value once."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(hw)
    x = (torch.randn(8, 51, hw, hw, generator=g, device=cuda_device) * 2 + 0.5).to(dt)
    parts, chunk = cuda_bnstats.split_channel(8 * hw * hw)
    assert (parts - 1) * chunk < 8 * hw * hw <= parts * chunk and chunk % cuda_bnstats.VEC == 0
    cuda_bnstats.reset_counts()
    s, q = bn_stats(x)
    torch.cuda.synchronize()
    assert (cuda_bnstats.bn_stats_cuda.calls, cuda_bnstats.bn_stats_cuda.launches) == (1, 1)
    errs = bn_stats_errors(x, s, q)
    assert errs["sum_err_over_tol"] <= 1 and errs["sumsq_err_over_tol"] <= 1, errs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_s2_kernel_at_the_pose_sites(cuda_device, dtype):
    """yolov8s-pose's 7 dense k=3 stride-2 sites (layers 0, 1, 3, 5, 7, 16, 19; batch 8, 640 px) against the plain
    version at chip_smoke.S2_TOL plus S2_SUM_FLOOR of the largest entry, as chip_smoke's pose phase holds them."""
    sites = s2_sites(PoseModel("yolov8s-pose.yaml", nc=1), 8, 640)
    assert [s["name"].split(".")[1] for s in sites] == ["0", "1", "3", "5", "7", "16", "19"]
    assert all(s["k"] == 3 for s in sites) and [s["need_dx"] for s in sites] == [False] + [True] * 6
    dt = getattr(torch, dtype)
    for i, site in enumerate(sites):
        x, w, dy = s2_site_inputs(site, dt, seed=i)
        dx, dw = cuda_s2bwd.s2_bwd_cuda(x, w, dy, 3, site["need_dx"])
        torch.cuda.synchronize()
        dx_p, dw_p = conv_s2.s2_bwd_reference(x, w, dy, 3, site["need_dx"])
        pairs = [("dw", dw, dw_p)] + ([("dx", dx.float(), dx_p.float())] if site["need_dx"] else [])
        for what, got, want in pairs:
            tol = dict(S2_TOL[dtype][what])
            tol["atol"] += S2_SUM_FLOOR * float(want.abs().max())
            torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{site['name']} {what}: {m}")
        del x, w, dy, dx, dw, dx_p, dw_p


def test_pose_train_step_with_both_kernels_matches_stock(cuda_device):
    """yolov8n-pose (nc 1, 17 keypoints), imgsz 64, batch 2, float32 (TF32 off): 2 steps with s2grad="cuda" and
    bnstats="cuda" against 2 stock steps from the same init: 7 stride-2 calls and one BN-statistics call at every
    train-mode BN (the keypoint branch's included) a step."""
    loader = [synthetic_pose_batch(np.random.default_rng(i), 2, 64, 1, 17) for i in range(2)]
    n_bn = sum(isinstance(m, M.BatchNorm2d) for m in PoseModel("yolov8n-pose.yaml", nc=1).modules())
    runs = {}
    for mode in ("cuda", None):
        trainer = PoseTrainer(overrides=dict(model="yolov8n-pose.yaml", batch=2, imgsz=64, nbs=2, optimizer="SGD",
                                             amp=False, s2grad=mode, bnstats=mode), train_loader=loader,
                              data={"nc": 1, "kpt_shape": [17, 3]})
        cuda_s2bwd.reset_counts()
        cuda_bnstats.reset_counts()
        steps = trainer.run_steps()
        assert cuda_s2bwd.s2_bwd_cuda.calls == {"s2_bwd_k3": 14 if mode else 0, "s2_bwd_k1": 0}
        assert cuda_bnstats.bn_stats_cuda.calls == (2 * n_bn if mode else 0)
        runs[mode] = (steps, trainer.train_state())
    (steps_k, st_k), (steps_s, st_s) = runs["cuda"], runs[None]
    assert all(len(r["items"]) == 5 for r in steps_k)
    np.testing.assert_allclose([r["loss"] for r in steps_k], [r["loss"] for r in steps_s], rtol=1e-4)
    for name, want in st_s["params"].items():
        torch.testing.assert_close(st_k["params"][name], want, rtol=1e-4, atol=1e-5, msg=name)


@pytest.mark.parametrize("n,hm,wm,inp,orig", [(32, 160, 160, (640, 640), (1080, 1920)),
                                              (7, 120, 160, (480, 640), (97, 211)), (3, 160, 128, (640, 512), (640, 512))])
def test_scale_masks_on_the_card_matches_the_cpu(cuda_device, n, hm, wm, inp, orig):
    """The segment predictor's masks on the card (`process_mask`, then `scale_masks`' float bilinear resize to the
    frame) against the same functions on the CPU: within 1e-6 before the 0.5 threshold, equal after it except within
    1e-5 of 0.5."""
    g = torch.Generator().manual_seed(n)
    protos = torch.randn(32, hm, wm, generator=g)
    coeffs = torch.randn(n, 32, generator=g)
    xy = torch.rand(n, 2, generator=g) * torch.tensor([inp[1], inp[0]]) * 0.7
    boxes = torch.cat([xy, xy + 20 + torch.rand(n, 2, generator=g) * 200], 1)
    want = scale_masks(process_mask(protos, coeffs, boxes, inp), orig, inp)
    got = scale_masks(process_mask(protos.to(cuda_device), coeffs.to(cuda_device), boxes.to(cuda_device), inp), orig,
                      inp).cpu()
    assert got.shape == want.shape == (n, *orig)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    diff = (got > 0.5) != (want > 0.5)
    assert bool(((want[diff] - 0.5).abs() < 1e-5).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_stats_kernel_at_the_segment_inputs(cuda_device, dtype):
    """The 9 BN inputs of yolov8s-seg that the detect part lacks (Proto's (8, 128, 80, 80), (8, 128, 160, 160) and
    (8, 32, 160, 160), cv4's 32 channels at 80, 40 and 20) against `bn_stats_reference` at chip_smoke's tolerance."""
    sites = [b for b in bn_sites(SegmentationModel("yolov8s-seg.yaml", nc=80), 8, 640)
             if ".proto." in b["name"] or ".cv4." in b["name"]]
    assert sorted({b["x"] for b in sites}) == [(8, 32, 20, 20), (8, 32, 40, 40), (8, 32, 80, 80), (8, 32, 160, 160),
                                              (8, 128, 80, 80), (8, 128, 160, 160)]
    for i, site in enumerate(sites):
        g = torch.Generator(device=cuda_device).manual_seed(i)
        x = (torch.randn(site["x"], generator=g, device=cuda_device) * 2 + 0.5).to(getattr(torch, dtype))
        s, q = bn_stats(x)
        errs = bn_stats_errors(x, s, q)
        assert errs["sum_err_over_tol"] <= 1 and errs["sumsq_err_over_tol"] <= 1, (site, errs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_s2_kernel_at_the_segment_sites(cuda_device, dtype):
    """yolov8s-seg's 7 dense k=3 stride-2 sites (batch 8, 640 px) against the plain version, as chip_smoke's segment
    phase holds them."""
    sites = s2_sites(SegmentationModel("yolov8s-seg.yaml", nc=80), 8, 640)
    assert [s["name"].split(".")[1] for s in sites] == ["0", "1", "3", "5", "7", "16", "19"]
    dt = getattr(torch, dtype)
    for i, site in enumerate(sites):
        x, w, dy = s2_site_inputs(site, dt, seed=100 + i)
        dx, dw = cuda_s2bwd.s2_bwd_cuda(x, w, dy, 3, site["need_dx"])
        torch.cuda.synchronize()
        dx_p, dw_p = conv_s2.s2_bwd_reference(x, w, dy, 3, site["need_dx"])
        pairs = [("dw", dw, dw_p)] + ([("dx", dx.float(), dx_p.float())] if site["need_dx"] else [])
        for what, got, want in pairs:
            tol = dict(S2_TOL[dtype][what])
            tol["atol"] += S2_SUM_FLOOR * float(want.abs().max())
            torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{site['name']} {what}: {m}")
        del x, w, dy, dx, dw, dx_p, dw_p


def test_segment_train_step_with_both_kernels_matches_stock(cuda_device):
    """yolov8n-seg (nc 3), imgsz 64, batch 2, float32 (TF32 off): 2 steps with s2grad="cuda" and bnstats="cuda"
    against 2 stock steps from the same init: 7 stride-2 calls and 66 BN-statistics calls a step."""
    loader = [synthetic_seg_batch(np.random.default_rng(i), 2, 64, 3) for i in range(2)]
    runs = {}
    for mode in ("cuda", None):
        trainer = SegmentationTrainer(overrides=dict(model="yolov8n-seg.yaml", batch=2, imgsz=64, nbs=2,
                                                     optimizer="SGD", amp=False, s2grad=mode, bnstats=mode),
                                      train_loader=loader, data={"nc": 3})
        cuda_s2bwd.reset_counts()
        cuda_bnstats.reset_counts()
        steps = trainer.run_steps()
        assert cuda_s2bwd.s2_bwd_cuda.calls == {"s2_bwd_k3": 14 if mode else 0, "s2_bwd_k1": 0}
        assert cuda_bnstats.bn_stats_cuda.calls == (2 * 66 if mode else 0)
        runs[mode] = (steps, trainer.train_state())
    (steps_k, st_k), (steps_s, st_s) = runs["cuda"], runs[None]
    assert all(len(r["items"]) == 4 and r["items"][1] > 0 for r in steps_k)
    np.testing.assert_allclose([r["loss"] for r in steps_k], [r["loss"] for r in steps_s], rtol=1e-4)
    for name, want in st_s["params"].items():
        torch.testing.assert_close(st_k["params"][name], want, rtol=1e-4, atol=1e-5, msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_s2_kernel_at_the_obb_sites(cuda_device, dtype):
    """yolov8s-obb's 7 dense k=3 stride-2 sites at DOTA's training size (batch 8, 1024 px; layer 0's dw sums
    2,097,152 products) against the plain version, as chip_smoke's obb phase holds them."""
    sites = s2_sites(OBBModel("yolov8s-obb.yaml", nc=15), 8, 1024)
    assert [s["name"].split(".")[1] for s in sites] == ["0", "1", "3", "5", "7", "16", "19"]
    assert sites[0]["dy"] == (8, 32, 512, 512) and sites[4]["x"] == (8, 256, 64, 64)
    dt = getattr(torch, dtype)
    for i, site in enumerate(sites):
        x, w, dy = s2_site_inputs(site, dt, seed=200 + i)
        dx, dw = cuda_s2bwd.s2_bwd_cuda(x, w, dy, 3, site["need_dx"])
        torch.cuda.synchronize()
        dx_p, dw_p = conv_s2.s2_bwd_reference(x, w, dy, 3, site["need_dx"])
        pairs = [("dw", dw, dw_p)] + ([("dx", dx.float(), dx_p.float())] if site["need_dx"] else [])
        for what, got, want in pairs:
            tol = dict(S2_TOL[dtype][what])
            tol["atol"] += S2_SUM_FLOOR * float(want.abs().max())
            torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{site['name']} {what}: {m}")
        del x, w, dy, dx, dw, dx_p, dw_p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_stats_kernel_at_the_obb_inputs(cuda_device, dtype):
    """All 63 BN inputs of yolov8s-obb at batch 8, 1024 px (the largest (8, 32, 512, 512), 67.1 M values; the angle
    branch cv4's 6 of 32 channels at 128, 64 and 32) against `bn_stats_reference` at chip_smoke's tolerance."""
    sites = bn_sites(OBBModel("yolov8s-obb.yaml", nc=15), 8, 1024)
    assert len(sites) == 63 and sites[0]["x"] == (8, 32, 512, 512)
    assert sorted({b["x"] for b in sites if ".cv4." in b["name"]}) == [(8, 32, 32, 32), (8, 32, 64, 64),
                                                                       (8, 32, 128, 128)]
    for i, site in enumerate(sites):
        g = torch.Generator(device=cuda_device).manual_seed(i)
        x = (torch.randn(site["x"], generator=g, device=cuda_device) * 2 + 0.5).to(getattr(torch, dtype))
        s, q = bn_stats(x)
        errs = bn_stats_errors(x, s, q)
        assert errs["sum_err_over_tol"] <= 1 and errs["sumsq_err_over_tol"] <= 1, (site, errs)
        del x, s, q


def test_obb_train_step_with_both_kernels_matches_stock(cuda_device):
    """yolov8n-obb (nc 3), imgsz 64, batch 2, float32 (TF32 off): 2 steps with s2grad="cuda" and bnstats="cuda"
    against 2 stock steps from the same init: 7 stride-2 calls and 63 BN-statistics calls a step."""
    loader = [synthetic_obb_batch(np.random.default_rng(i), 2, 64, 3) for i in range(2)]
    runs = {}
    for mode in ("cuda", None):
        trainer = OBBTrainer(overrides=dict(model="yolov8n-obb.yaml", batch=2, imgsz=64, nbs=2, optimizer="SGD",
                                            amp=False, s2grad=mode, bnstats=mode), train_loader=loader, data={"nc": 3})
        cuda_s2bwd.reset_counts()
        cuda_bnstats.reset_counts()
        steps = trainer.run_steps()
        assert cuda_s2bwd.s2_bwd_cuda.calls == {"s2_bwd_k3": 14 if mode else 0, "s2_bwd_k1": 0}
        assert cuda_bnstats.bn_stats_cuda.calls == (2 * 63 if mode else 0)
        runs[mode] = (steps, trainer.train_state())
    (steps_k, st_k), (steps_s, st_s) = runs["cuda"], runs[None]
    assert all(len(r["items"]) == 3 and r["items"][0] > 0 for r in steps_k)
    np.testing.assert_allclose([r["loss"] for r in steps_k], [r["loss"] for r in steps_s], rtol=1e-4)
    for name, want in st_s["params"].items():
        torch.testing.assert_close(st_k["params"][name], want, rtol=1e-4, atol=1e-5, msg=name)


@pytest.mark.parametrize("multi_label,k,nc", [(False, 1024, 15), (True, 4096, 15), (True, 256, 3)])
def test_nms_rotated_on_the_card_matches_the_cpu(cuda_device, multi_label, k, nc):
    """`nms_rotated` on the card against the same call on the CPU: the same detections (gathered, so equal bit for bit)
    and counts, at the predictor's K = 1024 and the validator's K = 4096 with 15 classes (the (K, K)
    probiou of each image once). The threshold is the one of 0.3-0.7 whose nearest pair of the CPU's probiou is
    farthest from it (at least 2e-5, some 300 float32 steps at 0.7), so that float rounding on either side cannot
    flip a suppression."""
    rng = np.random.default_rng(k + nc)
    b, a = 2, max(k, 2000)
    preds = np.zeros((b, a, 4 + nc + 1), np.float32)
    centres = rng.uniform(50, 950, (k // 8, 2))
    preds[..., :2] = centres[rng.integers(0, len(centres), (b, a))] + rng.normal(0, 6, (b, a, 2))
    preds[..., 2:4] = rng.uniform(10, 60, (b, a, 2))
    preds[..., 4:4 + nc] = rng.choice([0.2, 0.4, 0.6, 0.8], (b, a, nc)) * rng.uniform(0.8, 1.0, (b, a, nc))
    preds[..., -1] = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (b, a))
    cpu = torch.from_numpy(preds)
    pairs = []
    for i in range(b):  # the candidates nms_rotated takes: the top K anchors by best class score
        idx = cpu[i, :, 4:4 + nc].amax(-1).sort(descending=True, stable=True).indices[:k]
        rb = torch.cat((cpu[i, idx, :4], cpu[i, idx, -1:]), -1)
        pairs.append(probiou(rb[:, None], rb[None]).flatten())
    pairs = torch.cat(pairs).sort().values
    grid = torch.linspace(0.3, 0.7, 401)
    at = torch.searchsorted(pairs, grid).clamp(1, len(pairs) - 1)
    gaps = torch.minimum((pairs[at] - grid).abs(), (pairs[at - 1] - grid).abs())
    thr, margin = float(grid[gaps.argmax()]), float(gaps.max())
    assert margin >= 2e-5, margin
    kw = dict(conf_thres=0.25, iou_thres=thr, max_det=300, pre_topk=k, nc=nc, multi_label=multi_label)
    want, want_n = nms_rotated(cpu, **kw)
    got, got_n = nms_rotated(cpu.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got_n.cpu(), want_n) and 0 < int(want_n.min())
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_s2_kernel_at_the_yolo11s_sites(cuda_device, dtype):
    """yolo11s's 7 dense k=3 stride-2 sites (layers 0, 1, 3, 5, 7 and head layers 17, 20; Ci -> Co 3 -> 32, 32 -> 64,
    128 -> 128, 256 -> 256, 256 -> 512, 128 -> 128, 256 -> 256; batch 8, 640 px) against the plain version, as
    chip_smoke's families phase holds them."""
    sites = s2_sites(DetectionModel("yolo11s.yaml"), 8, 640)
    assert [s["name"].split(".")[1] for s in sites] == ["0", "1", "3", "5", "7", "17", "20"]
    assert [(s["x"][1], s["w"][0]) for s in sites] == [(3, 32), (32, 64), (128, 128), (256, 256), (256, 512),
                                                       (128, 128), (256, 256)]
    dt = getattr(torch, dtype)
    for i, site in enumerate(sites):
        x, w, dy = s2_site_inputs(site, dt, seed=300 + i)
        dx, dw = cuda_s2bwd.s2_bwd_cuda(x, w, dy, 3, site["need_dx"])
        torch.cuda.synchronize()
        dx_p, dw_p = conv_s2.s2_bwd_reference(x, w, dy, 3, site["need_dx"])
        pairs = [("dw", dw, dw_p)] + ([("dx", dx.float(), dx_p.float())] if site["need_dx"] else [])
        for what, got, want in pairs:
            tol = dict(S2_TOL[dtype][what])
            tol["atol"] += S2_SUM_FLOOR * float(want.abs().max())
            torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{site['name']} {what}: {m}")
        del x, w, dy, dx, dw, dx_p, dw_p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_stats_kernel_at_the_yolo11s_inputs(cuda_device, dtype):
    """All 81 train-mode BN inputs of yolo11s at batch 8, 640 px (C2PSA's attention convs and the depthwise class
    branch among them) against `bn_stats_reference` at chip_smoke's tolerance."""
    sites = bn_sites(DetectionModel("yolo11s.yaml"), 8, 640)
    assert len(sites) == 81 and sum(".attn." in b["name"] for b in sites) == 3
    for i, site in enumerate(sites):
        g = torch.Generator(device=cuda_device).manual_seed(i)
        x = (torch.randn(site["x"], generator=g, device=cuda_device) * 2 + 0.5).to(getattr(torch, dtype))
        s, q = bn_stats(x)
        errs = bn_stats_errors(x, s, q)
        assert errs["sum_err_over_tol"] <= 1 and errs["sumsq_err_over_tol"] <= 1, (site, errs)
        del x, s, q


@pytest.mark.parametrize("model", ["yolo11s.yaml", "yolo12s.yaml"])
def test_family_train_step_with_both_kernels_matches_stock(cuda_device, model):
    """yolo11s and yolo12s (nc 2), imgsz 64, batch 2, float32 (TF32 off): 2 steps with s2grad="cuda" and
    bnstats="cuda" against 2 stock steps from the same init: 7 stride-2 calls and one BN-statistics call at every
    train-mode BN (the attention blocks' included) a step."""
    loader = [synthetic_batch(np.random.default_rng(i), 2, 64, 2) for i in range(2)]
    n_bn = sum(isinstance(m, M.BatchNorm2d) for m in DetectionModel(model, nc=2).modules())
    runs = {}
    for mode in ("cuda", None):
        trainer = BaseTrainer(overrides=dict(model=model, batch=2, imgsz=64, nbs=2, optimizer="SGD", amp=False,
                                             s2grad=mode, bnstats=mode), train_loader=loader, data={"nc": 2})
        cuda_s2bwd.reset_counts()
        cuda_bnstats.reset_counts()
        steps = trainer.run_steps()
        assert cuda_s2bwd.s2_bwd_cuda.calls == {"s2_bwd_k3": 14 if mode else 0, "s2_bwd_k1": 0}
        assert cuda_bnstats.bn_stats_cuda.calls == (2 * n_bn if mode else 0)
        runs[mode] = (steps, trainer.train_state())
    (steps_k, st_k), (steps_s, st_s) = runs["cuda"], runs[None]
    np.testing.assert_allclose([r["loss"] for r in steps_k], [r["loss"] for r in steps_s], rtol=1e-4)
    for name, want in st_s["params"].items():
        torch.testing.assert_close(st_k["params"][name], want, rtol=1e-4, atol=1e-5, msg=name)


ATTENTION_BLOCKS = {  # yolo11s's C2PSA (layer 10), yolo12s's A2C2f at P4 (layer 6, area 4) and P5 (layer 8), and an AAttn
    "c2psa": (lambda: M.C2PSA(256, 256, 1), (8, 256, 20, 20)),  # on a map whose 735 positions do not split into 4
    "a2c2f_area4": (lambda: M.A2C2f(256, 256, 2, True, 4), (8, 256, 40, 40)),
    "a2c2f_p5": (lambda: M.A2C2f(512, 512, 2, True, 1), (8, 512, 20, 20)),
    "aattn_fallback": (lambda: M.AAttn(128, 4, 4), (8, 128, 21, 35)),
}


@pytest.mark.parametrize("name", list(ATTENTION_BLOCKS))
def test_attention_block_bf16_on_the_card_matches_float32_on_the_cpu(cuda_device, name):
    """Each attention block in bf16 on the card (its logits and softmax in float32) against float32 on the CPU, weights
    by `spread_weights`: the largest error within 3% of the output's largest entry and the mean within 1.5% of its mean
    (bf16 on the CPU reads at most 1.1% and 0.7%)."""
    make, shape = ATTENTION_BLOCKS[name]
    block = make().eval()
    block.load_state_dict(spread_weights(block.state_dict(), np.random.default_rng(0)))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    with torch.no_grad():
        want = block(x)
        got = block.to(cuda_device, torch.bfloat16)(x.to(cuda_device, torch.bfloat16)).float().cpu()
    err = (got - want).abs()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert float(err.max()) <= 0.03 * float(want.abs().max()) and float(err.mean()) <= 0.015 * float(want.abs().mean())



# the classifiers' stride-2 sites at batch 64, 224 px: (name, k, Ci, Co, input H)
CLASSIFY_SITES = {
    "yolov8s-cls.yaml": [("model.0", 3, 3, 32, 224), ("model.1", 3, 32, 64, 112), ("model.3", 3, 64, 128, 56),
                         ("model.5", 3, 128, 256, 28), ("model.7", 3, 256, 512, 14)],
    "yolov8-cls-resnet50.yaml": [("model.2.blocks.0.cv2", 3, 128, 128, 56), ("model.2.blocks.0.short", 1, 256, 512, 56),
                                 ("model.3.blocks.0.cv2", 3, 256, 256, 28), ("model.3.blocks.0.short", 1, 512, 1024, 28),
                                 ("model.4.blocks.0.cv2", 3, 512, 512, 14), ("model.4.blocks.0.short", 1, 1024, 2048, 14)],
    "yolo11-cls-resnet18.yaml": [("model.0.m.5.0.conv1", 3, 64, 128, 56), ("model.0.m.5.0.downsample.0", 1, 64, 128, 56),
                                 ("model.0.m.6.0.conv1", 3, 128, 256, 28), ("model.0.m.6.0.downsample.0", 1, 128, 256, 28),
                                 ("model.0.m.7.0.conv1", 3, 256, 512, 14), ("model.0.m.7.0.downsample.0", 1, 256, 512, 14)],
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", list(CLASSIFY_SITES))
def test_s2_kernel_at_the_classify_sites(cuda_device, model, dtype):
    """The dense stride-2 sites of yolov8s-cls (5, k=3) and of the ResNet-50 and ResNet-18 trunks (3 k=3 and 3 k=1
    each: the 1x1 stride-2 kernel up to Co 2048 at 14 px) at batch 64, 224 px, against the plain version, as
    chip_smoke's classify phase holds them."""
    sites = s2_sites(ClassificationModel(model), 64, 224)
    assert [(s["name"], s["k"], s["x"][1], s["w"][0], s["x"][2]) for s in sites] == CLASSIFY_SITES[model]
    dt = getattr(torch, dtype)
    for i, site in enumerate(sites):
        x, w, dy = s2_site_inputs(site, dt, seed=700 + i)
        dx, dw = cuda_s2bwd.s2_bwd_cuda(x, w, dy, site["k"], site["need_dx"])
        torch.cuda.synchronize()
        dx_p, dw_p = conv_s2.s2_bwd_reference(x, w, dy, site["k"], site["need_dx"])
        pairs = [("dw", dw, dw_p)] + ([("dx", dx.float(), dx_p.float())] if site["need_dx"] else [])
        for what, got, want in pairs:
            tol = dict(S2_TOL[dtype][what])
            tol["atol"] += S2_SUM_FLOOR * float(want.abs().max())
            torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{site['name']} {what}: {m}")
        del x, w, dy, dx, dw, dx_p, dw_p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model,n_bn", [("yolov8s-cls.yaml", 26), ("yolov8-cls-resnet50.yaml", 54),
                                        ("yolo11-cls-resnet18.yaml", 21)])
def test_bn_stats_kernel_at_the_classify_inputs(cuda_device, model, n_bn, dtype):
    """Every train-mode BN input of the classifiers at batch 64, 224 px (ResNet-50's last: 2048 channels at 7 px)
    against `bn_stats_reference` at chip_smoke's tolerance."""
    sites = bn_sites(ClassificationModel(model), 64, 224)
    assert len(sites) == n_bn
    for i, site in enumerate(sites):
        g = torch.Generator(device=cuda_device).manual_seed(900 + i)
        x = (torch.randn(site["x"], generator=g, device=cuda_device) * 2 + 0.5).to(getattr(torch, dtype))
        s, q = bn_stats(x)
        errs = bn_stats_errors(x, s, q)
        assert errs["sum_err_over_tol"] <= 1 and errs["sumsq_err_over_tol"] <= 1, (site, errs)
        del x, s, q


@pytest.mark.parametrize("model,k3,k1", [("yolov8s-cls.yaml", 5, 0), ("yolo11-cls-resnet18.yaml", 3, 3),
                                         ("yolov8-cls-resnet50.yaml", 3, 3)])
def test_classify_train_step_with_both_kernels_matches_stock(cuda_device, model, k3, k1):
    """A classifier (nc 10, batch 4, 64 px) in float32 (TF32 off): 2 steps with s2grad="cuda" and bnstats="cuda"
    against 2 stock steps from the same init, every stride-2 site and train-mode BN through the kernels, counted, and
    the losses within 1e-4. Then one backward's gradients with the kernels and stock against a float64 evaluation
    (stock autograd): the kernels' largest error, relative to each tensor's largest gradient, within twice stock's.
    (ResNet-50's 2x2 maps at 64 px give BN 16 values a channel: both float32 paths part from float64 by up to 10% of
    a tensor's gradient, and two SGD steps amplify the difference past a fixed tolerance on the BN biases.)"""
    rng = np.random.default_rng(0)
    loader = [{"img": rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8), "cls": rng.integers(0, 10, 4).astype(np.int32)}
              for _ in range(2)]
    n_bn = sum(isinstance(m, M.BatchNorm2d) for m in ClassificationModel(model, nc=10).modules())
    losses = {}
    for mode in ("cuda", None):
        trainer = ClassificationTrainer(overrides=dict(model=model, batch=4, imgsz=64, nbs=4, optimizer="SGD", amp=False,
                                                       s2grad=mode, bnstats=mode), train_loader=loader, data={"nc": 10})
        cuda_s2bwd.reset_counts()
        cuda_bnstats.reset_counts()
        losses[mode] = [r["loss"] for r in trainer.run_steps()]
        assert cuda_s2bwd.s2_bwd_cuda.calls == ({"s2_bwd_k3": 2 * k3, "s2_bwd_k1": 2 * k1} if mode else
                                                {"s2_bwd_k3": 0, "s2_bwd_k1": 0})
        assert cuda_bnstats.bn_stats_cuda.calls == (2 * n_bn if mode else 0)
    np.testing.assert_allclose(losses["cuda"], losses[None], rtol=1e-4)

    base = ClassificationModel(model, nc=10)
    base.init(0, imgsz=64)
    img = torch.from_numpy(loader[0]["img"]).to(cuda_device).permute(0, 3, 1, 2) / 255.0
    cls = torch.from_numpy(loader[0]["cls"]).to(cuda_device)
    grads = {}
    for mode, dtype in (("float64", torch.float64), ("stock", torch.float32), ("kernels", torch.float32)):
        net = ClassificationModel(model, nc=10)
        net.load_state_dict(base.state_dict())
        net = net.to(cuda_device, dtype).train()
        if mode == "kernels":
            net.set_s2grad("cuda").set_bnstats("cuda")
        with M.collect_bn_stats():
            logits = net(img.to(dtype))
        torch.nn.functional.cross_entropy(logits, cls.long()).backward()
        grads[mode] = {n: p.grad.double() for n, p in net.named_parameters()}
    err = {mode: max(float((grads[mode][n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                     for n, g in grads["float64"].items()) for mode in ("stock", "kernels")}
    assert err["kernels"] <= 2 * err["stock"] + 1e-6, err


def test_gmc_on_the_card_matches_the_cpu(cuda_device):
    """BoT-SORT's motion compensation: each step on the card (card tensors in, card tensors out) equals the CPU's,
    corners, flow and status exactly, and the warps of a panning clip."""
    from chip_smoke import panning_frames
    from drone_yolo_tpu_torch.ops import flow
    from drone_yolo_tpu_torch.trackers.gmc import GMC

    frames, _ = panning_frames(np.random.default_rng(1), 6, (360, 640), 12, (12, 40), shift=(2.0, 8.0),
                               device=cuda_device)
    card, cpu = GMC(device=cuda_device), GMC(device="cpu")
    for f in frames:
        g_card, g_cpu = card.preprocess(torch.from_numpy(f).to(cuda_device)), cpu.preprocess(f)
        assert g_card.is_cuda and torch.equal(g_card.cpu(), g_cpu)
        k_card, k_cpu = flow.good_features_to_track(g_card), flow.good_features_to_track(g_cpu)
        assert k_card.is_cuda and torch.equal(k_card.cpu(), k_cpu)
        if cpu.prev_kpts is not None:
            (n_card, s_card), (n_cpu, s_cpu) = (flow.calc_optical_flow_pyr_lk(g.prev_frame, x, g.prev_kpts)
                                                for g, x in ((card, g_card), (cpu, g_cpu)))
            assert n_card.is_cuda and torch.equal(s_card.cpu(), s_cpu) and torch.equal(n_card.cpu(), n_cpu)
        w_card, w_cpu = card.apply(torch.from_numpy(f).to(cuda_device)), cpu.apply(f)
        np.testing.assert_allclose(w_card, w_cpu, rtol=0, atol=1e-6)


def test_tiled_merge_on_the_card_matches_the_cpu(cuda_device):
    """`tiled_inference`'s merge through the NMS kernel (one call, two launches) equals the plain merge on the CPU."""
    from drone_yolo_tpu_torch.ops import tiling

    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (700, 1000, 3), dtype=np.uint8)

    def forward(variables, batch):  # a box on each cell of a 5x5 grid of each crop, scored by its pixels
        b, _, h, w = batch.shape
        cells = batch[:, :, h // 10::h // 5, w // 10::w // 5][:, :, :5, :5].float()
        score = (cells[:, 0] * 0.5 + cells[:, 1] * 0.3 + cells[:, 2] * 0.2).flatten(1)
        ys, xs = torch.meshgrid(torch.arange(5.0), torch.arange(5.0), indexing="ij")
        x1, y1 = (xs.flatten() * w / 5 - w / 15).to(batch.device), (ys.flatten() * h / 5 - h / 15).to(batch.device)
        box = torch.stack([x1, y1, x1 + w * 4 / 15, y1 + h * 4 / 15], 1).expand(b, 25, 4)
        cls = (torch.arange(25, device=batch.device) % 3).float().expand(b, 25)
        return torch.cat([box, score[..., None], cls[..., None]], 2), torch.full((b,), 25, device=batch.device)

    calls, launches = cuda_nms.greedy_keep_cuda.calls, cuda_nms.greedy_keep_cuda.launches
    got = tiling.tiled_inference(forward, None, img, crop_size=256, gap=64, max_crop_batch=6, iou=0.5,
                                 device=cuda_device)
    assert (cuda_nms.greedy_keep_cuda.calls, cuda_nms.greedy_keep_cuda.launches) == (calls + 1, launches + 2)
    want = tiling.tiled_inference(forward, None, img, crop_size=256, gap=64, max_crop_batch=6, iou=0.5, device="cpu")
    assert 0 < len(got) < 25 * 20
    np.testing.assert_array_equal(got, want)

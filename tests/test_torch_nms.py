"""The port's NMS against the JAX package's, on the CPU.

The keep mask of `greedy_keep_reference` must equal, exactly, the
interpret-mode Pallas kernel, the JAX fixed point (`ops/nms.py:_greedy_keep`)
and a sequential numpy greedy; so must the composition of the plain versions
of the two CUDA kernels, `sweep_reference(suppression_words_reference(...))`.
The whole `non_max_suppression` must give equal counts and detections within
1e-5. The CUDA kernels are held against the plain versions in
`test_torch_cuda.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import clustered_boxes
from drone_yolo_tpu.ops.nms import _greedy_keep, _iou_matrix, class_mask
from drone_yolo_tpu.ops.nms import non_max_suppression as jax_nms
from drone_yolo_tpu.ops.pallas_nms import pallas_greedy_keep
from drone_yolo_tpu_torch.ops import cuda_nms
from drone_yolo_tpu_torch.ops.nms import (
    greedy_keep, greedy_keep_reference, non_max_suppression, suppression_words_reference, sweep_reference)

torch.set_num_threads(1)


def greedy_numpy(boxes, valid, thr):
    """Sequential greedy NMS, with the IoU arithmetic of the plain version."""
    keep = valid.copy()
    x1, y1, x2, y2 = boxes.T
    area = (x2 - x1) * (y2 - y1)
    for i in range(len(boxes)):
        if keep[i]:
            iw = np.maximum(np.minimum(x2[i], x2[i + 1 :]) - np.maximum(x1[i], x1[i + 1 :]), np.float32(0))
            ih = np.maximum(np.minimum(y2[i], y2[i + 1 :]) - np.maximum(y1[i], y1[i + 1 :]), np.float32(0))
            inter = iw * ih
            iou = inter / (area[i] + area[i + 1 :] - inter + np.float32(1e-7))
            keep[i + 1 :] &= ~(iou > np.float32(thr))
    return keep


@pytest.mark.parametrize("thr", [0.45, 0.7])
@pytest.mark.parametrize("k", [128, 256])
def test_greedy_keep_matches_pallas_and_jax_fixed_point(k, thr):
    rng = np.random.default_rng(k + int(thr * 100))
    boxes = clustered_boxes(rng, 2, k).numpy()
    valid = rng.random((2, k)) > 0.2

    got = greedy_keep(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    pallas = np.asarray(pallas_greedy_keep(jnp.asarray(boxes), jnp.asarray(valid), thr, interpret=True))
    upper = jnp.triu(jnp.ones((k, k), bool), 1)
    fixed_point = np.asarray(jax.vmap(lambda bx, v: _greedy_keep(upper & (_iou_matrix(bx) > thr), v))(jnp.asarray(boxes), jnp.asarray(valid)))
    sequential = np.stack([greedy_numpy(boxes[i], valid[i], thr) for i in range(2)])

    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, fixed_point)
    np.testing.assert_array_equal(got, sequential)
    assert 0 < got.sum() < valid.sum()  # the case both keeps and suppresses


@pytest.mark.parametrize("thr", [0.45, 0.7])
def test_greedy_keep_at_k4096_matches_jax_fixed_point(thr):
    """Validation's K = 4096 (beyond the Pallas kernel's K <= 1024): the plain keep against the JAX fixed point and
    a sequential numpy greedy."""
    rng = np.random.default_rng(4096 + int(thr * 100))
    k = 4096
    boxes = clustered_boxes(rng, 1, k, clusters=48).numpy()
    valid = rng.random((1, k)) > 0.1
    got = greedy_keep(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    upper = jnp.triu(jnp.ones((k, k), bool), 1)
    fixed_point = np.asarray(_greedy_keep(upper & (_iou_matrix(jnp.asarray(boxes[0])) > thr), jnp.asarray(valid[0])))
    np.testing.assert_array_equal(got[0], fixed_point)
    np.testing.assert_array_equal(got[0], greedy_numpy(boxes[0], valid[0], thr))
    assert 0 < got.sum() < valid.sum()


def pallas_keep(boxes, valid, thr):
    """The Pallas kernel in interpret mode at any K: it takes K in multiples of 128, so the candidates are padded
    with zero boxes that are not valid (a row that is not valid is never kept, so it suppresses nothing)."""
    b, k = valid.shape
    pad = -k % 128
    boxes_p = np.concatenate([boxes, np.zeros((b, pad, 4), boxes.dtype)], 1)
    valid_p = np.concatenate([valid, np.zeros((b, pad), bool)], 1)
    return np.asarray(pallas_greedy_keep(jnp.asarray(boxes_p), jnp.asarray(valid_p), thr, interpret=True))[:, :k]


@pytest.mark.parametrize("thr", [0.45, 0.7])
@pytest.mark.parametrize("k", [1, 63, 64, 65, 640, 1024])
def test_words_then_sweep_match_pallas_jax_and_numpy(k, thr):
    """The plain bitmask, then the plain sweep over it: equal to the Pallas kernel (interpret mode), the JAX fixed
    point, a sequential numpy greedy and `greedy_keep_reference`, at K around one and two 64-bit words and at
    predict's K = 1024; `valid` has gaps (about one candidate in five is not valid)."""
    rng = np.random.default_rng(10 * k + int(thr * 100))
    boxes = clustered_boxes(rng, 2, k, clusters=2 if k < 640 else 12).numpy()  # few clusters: small K overlaps too
    valid = rng.random((2, k)) > 0.2
    words = suppression_words_reference(torch.from_numpy(boxes), torch.from_numpy(valid), thr)
    assert words.shape == (2, k, -(-k // 64)) and words.dtype == torch.int64
    got = sweep_reference(words, torch.from_numpy(valid)).numpy()

    upper = jnp.triu(jnp.ones((k, k), bool), 1)
    fixed_point = np.asarray(jax.vmap(lambda bx, v: _greedy_keep(upper & (_iou_matrix(bx) > thr), v))(jnp.asarray(boxes), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, pallas_keep(boxes, valid, thr))
    np.testing.assert_array_equal(got, fixed_point)
    np.testing.assert_array_equal(got, np.stack([greedy_numpy(boxes[i], valid[i], thr) for i in range(2)]))
    np.testing.assert_array_equal(got, greedy_keep_reference(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy())
    if k >= 63:
        assert 0 < got.sum() < valid.sum()  # the case both keeps and suppresses


@pytest.mark.parametrize("thr", [0.45, 0.7, -0.5])
def test_suppression_words_reference_bits(thr):
    """Bit t of word [b, i, c] is `valid[i] and j > i and iou(i, j) > thr` for j = 64 c + t < K (numpy IoU), 0 past
    K; words left of a row's own block are 0; bit 63 is the int64 sign bit."""
    rng = np.random.default_rng(5)
    k = 150
    boxes = clustered_boxes(rng, 2, k, clusters=4).numpy()
    valid = rng.random((2, k)) > 0.2
    words = suppression_words_reference(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    bits = (words.view(np.uint64)[..., None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
    bits = bits.reshape(2, k, -1)[:, :, :k].astype(bool)
    assert not ((words.view(np.uint64)[..., None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)).reshape(2, k, -1)[:, :, k:].any()
    for b in range(2):
        x1, y1, x2, y2 = boxes[b].T
        area = (x2 - x1) * (y2 - y1)
        iw = np.maximum(np.minimum(x2[:, None], x2[None]) - np.maximum(x1[:, None], x1[None]), np.float32(0))
        ih = np.maximum(np.minimum(y2[:, None], y2[None]) - np.maximum(y1[:, None], y1[None]), np.float32(0))
        inter = iw * ih
        iou = inter / (area[:, None] + area[None] - inter + np.float32(1e-7))
        want = np.triu(iou > np.float32(thr), 1) & valid[b][:, None]
        np.testing.assert_array_equal(bits[b], want)
    rows = np.arange(k)
    assert (words[:, rows[:, None] // 64 > np.arange(words.shape[2])[None]] == 0).all()
    assert (words < 0).any() == bits[:, :, 63::64].any()


def test_sweep_reference_at_bit_63():
    """Row 0 suppresses column 63 (bit 63 of row 0's first word, a negative int64) and column 64 (the next word):
    with row 0 valid both go; with row 0 not valid, row 63 is kept and suppresses row 64."""
    k = 65
    boxes = np.stack([np.arange(k) * 100.0, np.zeros(k), np.arange(k) * 100.0 + 50, np.full(k, 50.0)], -1)
    boxes[63] = boxes[64] = boxes[0]
    boxes = np.stack([boxes, boxes]).astype(np.float32)
    valid = np.ones((2, k), bool)
    valid[1, 0] = False
    words = suppression_words_reference(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5)
    assert int(words[0, 0, 0]) == -(2**63) and int(words[0, 0, 1]) == 1 and int(words[1, 0, 0]) == 0
    want = valid.copy()
    want[0, [63, 64]] = False
    want[1, 64] = False
    got = sweep_reference(words, torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.stack([greedy_numpy(boxes[i], valid[i], 0.5) for i in range(2)]))


def blocked_sweep(words, valid):
    """The sweep kernel's algorithm (`csrc/greedy_nms.cu:nms_sweep`) in numpy: per 64-candidate block, the fixed point
    kept = base & ~OR(diagonal words of kept rows) from kept = base = valid & ~removed, then the kept rows' words
    folded into `removed` of every later block. Returns keep and the most fixed-point rounds a block took."""
    words = words.numpy().view(np.uint64)
    b, k, nb = words.shape
    keep, most_rounds = np.zeros((b, k), bool), 0
    for img in range(b):
        removed = np.zeros(nb, np.uint64)
        for cb in range(nb):
            rows = np.arange(cb * 64, min(k, cb * 64 + 64))
            live = sum((np.uint64(1) << np.uint64(t)) for t in range(len(rows)) if valid[img, rows[t]])
            base = np.uint64(live) & ~removed[cb]
            kept, prev, rounds = base, None, 0
            while kept != prev:
                prev, rounds = kept, rounds + 1
                sup = np.uint64(0)
                for t, i in enumerate(rows):
                    if (kept >> np.uint64(t)) & np.uint64(1):
                        sup |= words[img, i, cb]
                kept = base & ~sup
            most_rounds = max(most_rounds, rounds)
            for t, i in enumerate(rows):
                keep[img, i] = bool((kept >> np.uint64(t)) & np.uint64(1))
                if keep[img, i]:
                    removed[cb + 1:] |= words[img, i, cb + 1:]
    return keep, most_rounds


@pytest.mark.parametrize("k,clusters", [(63, 2), (130, 2), (200, 12), (640, 12)])
def test_blocked_fixed_point_sweep_matches_sweep_reference(k, clusters):
    """The kernel's block-by-block fixed point over the plain words gives `sweep_reference`'s keep, both thresholds;
    every case suppresses within some block (a second round), the denser ones along chains (three or more)."""
    rng = np.random.default_rng(k)
    boxes = clustered_boxes(rng, 2, k, clusters=clusters)
    valid = torch.from_numpy(rng.random((2, k)) > 0.2)
    for thr in (0.45, 0.7):
        words = suppression_words_reference(boxes, valid, thr)
        got, rounds = blocked_sweep(words, valid.numpy())
        np.testing.assert_array_equal(got, sweep_reference(words, valid).numpy())
        assert rounds >= (3 if thr == 0.45 and k < 640 else 2)


@pytest.mark.parametrize("b,k,mb", [(8, 1024, 1.0), (8, 4096, 16.0), (1, 12288, 18.0)])
def test_workspace_bytes(b, k, mb):
    """The bitmask's workspace: B * K * ceil(K/64) words of 8 bytes (in MiB)."""
    assert cuda_nms.workspace_bytes(b, k) == 8 * b * k * -(-k // 64) == mb * 2**20


def random_preds(rng, b, a, nc):
    """Decoded predictions: xywh boxes and skewed scores."""
    c = rng.random((b, a, 2)) * 160
    wh = rng.uniform(4, 60, (b, a, 2))
    scores = rng.random((b, a, nc)) ** 4
    return np.concatenate([c, wh, scores], -1).astype(np.float32)


NMS_CASES = {
    "default": dict(conf_thres=0.25, iou_thres=0.7),
    "conf0": dict(conf_thres=0.0, iou_thres=0.45),
    "agnostic": dict(conf_thres=0.1, iou_thres=0.5, agnostic=True),
    "classes": dict(conf_thres=0.1, iou_thres=0.6, classes=[0, 2]),
    "topk_below_anchors": dict(conf_thres=0.05, iou_thres=0.7, pre_topk=128, max_det=50),
    "max_det_above_k": dict(conf_thres=0.0, iou_thres=0.7, pre_topk=64, max_det=300),
}


@pytest.mark.parametrize("case", list(NMS_CASES))
def test_non_max_suppression_matches_jax(case):
    kw = dict(NMS_CASES[case])
    nc = 4
    preds = random_preds(np.random.default_rng(len(case)), 2, 400, nc)
    jax_kw = {k: v for k, v in kw.items() if k != "classes"}
    if "classes" in kw:
        jax_kw["classes"] = class_mask(kw["classes"], nc)
    dets_j, n_j = jax_nms(jnp.asarray(preds), nc=nc, **jax_kw)
    dets_t, n_t = non_max_suppression(torch.from_numpy(preds), **kw)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    assert dets_t.shape == dets_j.shape and n_t.dtype == torch.int32
    np.testing.assert_allclose(dets_t.numpy(), np.asarray(dets_j), rtol=1e-5, atol=1e-5)


def test_top_k_ties_take_the_lower_index_first():
    preds = np.zeros((1, 6, 6), np.float32)
    preds[0, :, :2] = np.arange(6)[:, None] * 100.0  # far apart
    preds[0, :, 2:4] = 10.0
    preds[0, :, 4] = [0.5, 0.9, 0.5, 0.9, 0.5, 0.5]
    dets_j, _ = jax_nms(jnp.asarray(preds), conf_thres=0.0, pre_topk=4, nc=2)
    dets_t, _ = non_max_suppression(torch.from_numpy(preds), conf_thres=0.0, pre_topk=4)
    np.testing.assert_array_equal(dets_t.numpy(), np.asarray(dets_j))


def test_kernel_wrapper_refuses_cpu_tensors():
    boxes, valid = torch.zeros(1, 8, 4), torch.ones(1, 8, dtype=torch.bool)
    cuda_nms.reset_counts()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_nms.greedy_keep_cuda(boxes, valid, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_nms.suppression_words_cuda(boxes, valid, 0.5)
    assert cuda_nms.greedy_keep_cuda.calls == cuda_nms.greedy_keep_cuda.launches == 0
    assert cuda_nms.suppression_words_cuda.launches == 0

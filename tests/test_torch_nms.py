"""The port's NMS against the JAX package's, on the CPU.

The keep mask of `greedy_keep_reference` must equal, exactly, the
interpret-mode Pallas kernel, the JAX fixed point (`ops/nms.py:_greedy_keep`)
and a sequential numpy greedy. The whole `non_max_suppression` must give equal
counts and detections within 1e-5. The CUDA kernel is held against the plain
version in `test_torch_cuda.py`.
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
from drone_yolo_tpu_torch.ops.nms import greedy_keep, non_max_suppression

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
    launches = cuda_nms.greedy_keep_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_nms.greedy_keep_cuda(boxes, valid, 0.5)
    assert cuda_nms.greedy_keep_cuda.launches == launches

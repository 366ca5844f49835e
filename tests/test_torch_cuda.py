"""The port's CUDA greedy-NMS kernel against its plain version, on the card.

Every test here is marked `cuda` and skips without a CUDA device. The module
imports neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch; there the JAX-importing `tests/conftest.py` is skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import clustered_boxes
from drone_yolo_tpu_torch.ops import cuda_nms
from drone_yolo_tpu_torch.ops.nms import compact, greedy_keep, greedy_keep_reference, non_max_suppression, select_candidates

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("thr", [0.45, 0.7])
@pytest.mark.parametrize("k", [1, 128, 640, 1024])
def test_kernel_matches_plain(cuda_device, k, thr):
    rng = np.random.default_rng(k)
    boxes = clustered_boxes(rng, 8, k).to(cuda_device)
    valid = torch.from_numpy(rng.random((8, k)) > 0.1).to(cuda_device)
    launches = cuda_nms.greedy_keep_cuda.launches
    got = greedy_keep(boxes, valid, thr)
    torch.cuda.synchronize()
    assert cuda_nms.greedy_keep_cuda.launches == launches + 1
    assert torch.equal(got, greedy_keep_reference(boxes, valid, thr))
    if k > 1:
        assert 0 < int(got.sum()) < int(valid.sum())


def test_kernel_refuses_k_above_1024(cuda_device):
    with pytest.raises(ValueError, match="K <= 1024"):
        greedy_keep(torch.zeros(1, 1025, 4, device=cuda_device), torch.ones(1, 1025, dtype=torch.bool, device=cuda_device), 0.5)


def test_nms_step_matches_plain_keep(cuda_device):
    rng = np.random.default_rng(9)
    preds = np.concatenate([rng.random((4, 3000, 2)) * 640, rng.uniform(4, 80, (4, 3000, 2)), rng.random((4, 3000, 80)) ** 4], -1)
    preds = torch.from_numpy(preds.astype(np.float32)).to(cuda_device)
    dets, n = non_max_suppression(preds, conf_thres=0.0, iou_thres=0.7, pre_topk=1024)
    cand_boxes, top_scores, cls_idx, valid, off_boxes = select_candidates(preds, 0.0, 1024)
    dets_ref, n_ref = compact(greedy_keep_reference(off_boxes, valid, 0.7), cand_boxes, top_scores, cls_idx, 300)
    assert torch.equal(n, n_ref) and torch.equal(dets, dets_ref)

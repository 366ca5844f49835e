"""Tiled inference and dataset tiling in the port against the JAX package's `ops/tiling.py`, on the CPU.

`get_windows`, `crop_windows` and `crop_labels` are integer-exact copies. `tiled_inference` runs one deterministic
fake detector on both packages, each in its own batch layout (the JAX package's (B, crop, crop, 3) numpy batch,
the port's (B, 3, crop, crop) tensor), whose detections read the crops' pixels, so every crop, the zero padding of
the last batch and the offsets back to the frame count; with distinct scores the merged detections are equal.
"""

import numpy as np
import pytest
import torch

from drone_yolo_tpu.ops import tiling as jax_tiling
from drone_yolo_tpu_torch import ops
from drone_yolo_tpu_torch.ops import nms, tiling

torch.set_num_threads(1)

SHAPES = [(2160, 3840), (1080, 1920), (700, 1000), (640, 640), (500, 300), (129, 1), (1, 1)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("crop,gap", [(640, 128), (256, 64), (300, 200)])
def test_get_windows_equal_to_jax(shape, crop, gap):
    got, want = tiling.get_windows(shape, crop, gap), jax_tiling.get_windows(shape, crop, gap)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_get_windows_4k_frame_has_32_windows_and_refuses_no_step():
    assert len(ops.get_windows((2160, 3840))) == 32
    with pytest.raises(ValueError, match="gap must be smaller"):
        tiling.get_windows((100, 100), 64, 64)


def test_crop_windows_and_labels_equal_to_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (300, 500, 3), dtype=np.uint8)
    wins = tiling.get_windows(img.shape[:2], 128, 32)
    np.testing.assert_array_equal(tiling.crop_windows(img, wins, 128), jax_tiling.crop_windows(img, wins, 128))
    np.testing.assert_array_equal(tiling.crop_windows(img, wins[:3], 200, 7),
                                  jax_tiling.crop_windows(img, wins[:3], 200, 7))
    xy = rng.uniform(0, 450, (60, 2))
    labels = np.concatenate([xy, xy + rng.uniform(2, 80, (60, 2))], 1).astype(np.float32)
    cls = rng.integers(0, 5, 60)
    for win in wins:
        for thr in (0.7, 0.3):
            got, want = tiling.crop_labels(labels, cls, win, thr), jax_tiling.crop_labels(labels, cls, win, thr)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[0].dtype == want[0].dtype
    empty = np.zeros((0, 4), np.float32)
    assert tiling.crop_labels(empty, cls[:0], wins[0])[0] is empty


def fake_detections(batch: np.ndarray, max_det: int = 20, nc: int = 3):
    """(B, h, w, 3) float32 crops in [0, 1] -> (dets (B, max_det, 6), n_valid (B,)): a box on each cell of a 5x5
    grid, grown by a third into its neighbours, scored by three of its pixels (as 24 bits), kept where the score
    exceeds 0.15; class by cell. The windows' step is no multiple of a cell, so two crops never score the same
    pixels alike (ties would let either package keep either member of a tie)."""
    b, h, w, _ = batch.shape
    px = np.rint(batch * 255).astype(np.int64)
    dets, n_valid = np.zeros((b, max_det, 6), np.float32), np.zeros(b, np.int64)
    ch, cw = h // 5, w // 5
    for i in range(b):
        rows = []
        for c in range(25):
            y0, x0 = (c // 5) * ch, (c % 5) * cw
            v = px[i, y0 + ch // 2, x0 + cw // 2, 0] * 65536 + px[i, y0 + 1, x0 + 2, 1] * 256 + px[i, y0 + 3, x0 + 1, 2]
            score = np.float32(v / 2**24)
            if score > 0.15:
                rows.append([x0 - cw / 3, y0 - ch / 3, x0 + cw * 4 / 3, y0 + ch * 4 / 3, score, c % nc])
        rows = sorted(rows, key=lambda r: -r[4])[:max_det]
        n_valid[i] = len(rows)
        if rows:
            dets[i, : len(rows)] = np.asarray(rows, np.float32)
    return dets, n_valid


def jax_forward(variables, batch):
    assert batch.dtype == np.float32 and batch.shape[-1] == 3
    return fake_detections(batch)


def port_forward(variables, batch):
    assert isinstance(batch, torch.Tensor) and batch.dtype == torch.float32 and batch.shape[1] == 3
    dets, n_valid = fake_detections(batch.permute(0, 2, 3, 1).numpy())
    return torch.from_numpy(dets), torch.from_numpy(n_valid)


@pytest.mark.parametrize("hw,crop,gap,batch,iou,max_det", [((700, 1000), 256, 64, 6, 0.5, 300),
                                                           ((480, 640), 192, 48, 16, 0.3, 300),
                                                           ((700, 1000), 256, 64, 3, 0.7, 25)])
def test_tiled_inference_equal_to_jax(hw, crop, gap, batch, iou, max_det):
    rng = np.random.default_rng(hw[0] + batch)
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    args = dict(crop_size=crop, gap=gap, max_crop_batch=batch, iou=iou, max_det=max_det)
    got = ops.tiled_inference(port_forward, None, img, device="cpu", **args)
    want = jax_tiling.tiled_inference(jax_forward, None, img, **args)
    dets, n_valid = fake_detections(jax_tiling.crop_windows(img, jax_tiling.get_windows(hw, crop, gap), crop) / 255.0)
    scores = np.concatenate([d[:n, 4] for d, n in zip(dets, n_valid)])
    assert len(np.unique(scores)) == len(scores)  # distinct scores: one keep set
    np.testing.assert_array_equal(got, want)
    n_windows = len(tiling.get_windows(hw, crop, gap))
    assert got.dtype == np.float32 and 0 < len(got) <= max_det
    assert n_windows % batch or batch == 16  # a zero-padded last batch in two cases
    merged = len(got) if max_det == 300 else None
    if merged is not None:
        assert merged < 16 * n_windows  # the merge suppressed the overlaps' duplicates


def test_tiled_inference_merge_keep_is_the_greedy_keep(monkeypatch):
    """The merge is one `greedy_keep` call over the score-sorted merged set, every row valid, boxes offset by class."""
    seen = []
    kernel = nms.greedy_keep

    def spy(boxes, valid, iou_thres):
        keep = kernel(boxes, valid, iou_thres)
        seen.append((boxes.clone(), valid.clone(), iou_thres, keep))
        return keep

    monkeypatch.setattr(nms, "greedy_keep", spy)
    img = np.random.default_rng(3).integers(0, 256, (400, 600, 3), dtype=np.uint8)
    out = tiling.tiled_inference(port_forward, None, img, crop_size=256, gap=64, max_crop_batch=4, iou=0.5,
                                 device="cpu")
    (boxes, valid, thr, keep), = seen
    assert boxes.shape[0] == 1 and bool(valid.all()) and thr == 0.5 and int(keep.sum()) == len(out)
    torch.testing.assert_close(keep, nms.greedy_keep_reference(boxes, valid, thr), rtol=0, atol=0)
    np.testing.assert_array_equal(out[:, :4] + out[:, 5:6] * nms.MAX_WH, boxes[0][keep[0]].numpy())
    assert np.all(np.diff(out[:, 4]) < 0)  # in score order
    blank = np.zeros((64, 64, 3), np.uint8)  # no detection in any crop
    assert tiling.tiled_inference(port_forward, None, blank, crop_size=64, gap=16, device="cpu").shape == (0, 6)

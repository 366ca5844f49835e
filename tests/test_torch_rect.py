"""Rectangular validation of the port against the JAX package's (ROADMAP.md queue 3 item 2).

- `set_rectangle`: on images of mixed aspect ratios (`tests/make_dataset.py:make_dataset_mixed`, and a set of 12
  distinct aspects that needs the merge to stay within `rect_max_shapes`) the port's dataset gives the JAX
  dataset's image order, `batch` and `batch_shapes`, and the same letterboxed batches.
- `YOLO.val(data=...)`, which validates in rectangular batches by default in both packages: the flagship at scale
  n (the port's seeded init redrawn by `chip_smoke.spread_weights`, class priors zeroed so that every candidate
  passes conf 0.001), float32 on the CPU, from one npz, over 2 landscape and 2 portrait images in batches of 2: P, R, mAP50, mAP50-95 within 1e-4, as
  `tests/test_torch_validate.py` holds the validator; each batch runs at its planned shape.
"""

import logging
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import spread_weights
from drone_yolo_tpu import YOLO as JaxYOLO
from drone_yolo_tpu.cfg import get_cfg as jax_get_cfg
from drone_yolo_tpu.data.build import build_yolo_dataset as jax_build
from drone_yolo_tpu.data.utils import check_det_dataset as jax_check
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.cfg import get_train_cfg, get_val_cfg
from drone_yolo_tpu_torch.data.build import build_yolo_dataset
from drone_yolo_tpu_torch.data.utils import check_det_dataset
from drone_yolo_tpu_torch.engine.validator import DetectionValidator
from drone_yolo_tpu_torch.nn.model import DetectionModel
from make_dataset import make_dataset_mixed

torch.set_num_threads(1)

FLAGSHIP_N = "yolov8n-p2-repvgg-sf.yaml"
NC = 2
METRIC_KEYS = ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)", "fitness")


def write_aspects(d, shapes) -> Path:
    """A val set of one random JPEG per (h, w) in `shapes`, each with one box of class i % NC; its data.yaml."""
    for split in ("train", "val"):
        (d / "images" / split).mkdir(parents=True)
        (d / "labels" / split).mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(shapes):
        cv2.imwrite(str(d / "images" / "val" / f"{i:02d}.jpg"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        (d / "labels" / "val" / f"{i:02d}.txt").write_text(f"{i % NC} 0.5 0.5 0.9 0.9\n")
    cv2.imwrite(str(d / "images" / "train" / "t.jpg"), np.zeros((64, 64, 3), np.uint8))
    (d / "data.yaml").write_text(f"path: {d}\ntrain: images/train\nval: images/val\nnames:\n  0: a\n  1: b\n")
    return d / "data.yaml"


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """{"mixed": the mixed-aspect yaml, "aspects": a yaml over 12 images of 12 distinct aspect ratios, "four": a yaml
    over 2 landscape and 2 portrait images}."""
    root = tmp_path_factory.mktemp("rect")
    return {"mixed": make_dataset_mixed(root / "mixed", n_val=8, nc=NC, seed=3, base=128),
            "aspects": write_aspects(root / "aspects", [(64, 160), (160, 64), (96, 160), (160, 96), (128, 160),
                                                        (160, 128), (160, 160), (48, 160), (160, 48), (112, 160),
                                                        (160, 112), (80, 160)]),
            "four": write_aspects(root / "four", [(64, 160), (160, 96), (96, 160), (160, 64)])}


@pytest.mark.parametrize("name,batch,imgsz,max_shapes", [("mixed", 4, 160, 8), ("mixed", 2, 128, 8),
                                                         ("aspects", 1, 320, 8), ("aspects", 2, 320, 3)])
def test_set_rectangle_matches_jax(datasets, name, batch, imgsz, max_shapes):
    yaml = str(datasets[name])
    jd, pd = jax_check(yaml), check_det_dataset(yaml)
    keys = dict(imgsz=imgsz, batch=batch, rect=True, rect_max_shapes=max_shapes)
    ref = jax_build(jax_get_cfg(overrides={**keys, "mode": "val"}), jd["val"], batch, jd, mode="val", stride=32)
    port = build_yolo_dataset(get_val_cfg(overrides=dict(keys, device="cpu")), pd["val"], batch, pd, mode="val", stride=32)
    assert port.rect and ref.rect
    assert port.im_files == ref.im_files
    np.testing.assert_array_equal(port.batch, ref.batch)
    np.testing.assert_array_equal(port.batch_shapes, ref.batch_shapes)
    assert len({tuple(s) for s in port.batch_shapes}) <= max_shapes
    if name == "aspects":  # 12 distinct aspects: more than max_shapes shapes before the merge
        unmerged = {tuple(np.ceil(np.array(s) * imgsz / 32 + 0.5).astype(int) * 32) for s in
                    [(h / w, 1) if h < w else (1, w / h) for h, w in (lb["shape"] for lb in port.labels)]}
        assert len(unmerged) > max_shapes
    for b in range(int(port.batch[-1]) + 1):
        idx = np.flatnonzero(port.batch == b)
        pb, rb = (ds.collate([ds[int(i)] for i in idx]) for ds in (port, ref))
        assert pb["img"].shape[1:3] == tuple(port.batch_shapes[b]) == rb["img"].shape[1:3]
        assert np.abs(pb["img"].astype(int) - rb["img"]).max() <= 1
        np.testing.assert_allclose(pb["bboxes"], rb["bboxes"], atol=1e-4)
        assert [(r, tuple(p)) for r, p in pb["ratio_pads"]] == [(r, tuple(p)) for r, p in rb["ratio_pads"]]


def test_rect_is_ignored_for_training(datasets, caplog):
    pd = check_det_dataset(str(datasets["mixed"]))
    with caplog.at_level(logging.WARNING, logger="drone_yolo_tpu_torch"):
        ds = build_yolo_dataset(get_train_cfg(overrides=dict(imgsz=128, rect=True, device="cpu")), pd["train"], 2, pd)
    assert not ds.rect and ds.batch_shapes is None and "rect=True ignored for training" in caplog.text


def test_yolo_val_matches_jax(datasets, tmp_path, monkeypatch):
    model = YOLO(FLAGSHIP_N, device="cpu")
    model.model = DetectionModel(FLAGSHIP_N, nc=NC)
    model.ensure_variables(imgsz=128)
    sd = spread_weights(model.model.state_dict(), np.random.default_rng(5))
    for i in range(len(model.model.head.cv3)):
        sd[f"model.{len(model.model.model) - 1}.cv3.{i}.2.bias"].zero_()
    model.model.load_state_dict(sd)
    model.save(tmp_path / "m.npz")
    shapes = []
    preprocess = DetectionValidator.preprocess
    monkeypatch.setattr(DetectionValidator, "preprocess", lambda self, b: shapes.append(b["img"].shape[1:3]) or
                        preprocess(self, b))
    args = dict(data=str(datasets["four"]), imgsz=96, batch=2, plots=False, verbose=False)
    port = YOLO(tmp_path / "m.npz", device="cpu")
    got = port.val(dtype="float32", workers=1, **args)
    ref = JaxYOLO(str(tmp_path / "m.npz")).val(**args)  # the JAX facade returns its DetMetrics
    fitness = ref.fitness() if callable(ref.fitness) else ref.fitness
    want = {**dict(zip(METRIC_KEYS, ref.mean_results())), "fitness": fitness}
    plan = port.validator.dataloader.dataset.batch_shapes
    assert [tuple(s) for s in plan] == shapes == [(96, 128), (128, 96)]  # each batch at its own planned shape
    print(f"YOLO.val: port {got}, JAX {want}")
    for k in METRIC_KEYS:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    assert got["metrics/mAP50-95(B)"] > 0

"""The port's file dataset and loader (`drone_yolo_tpu_torch/data/`) against the JAX package's, on one set of files.

`tests/make_dataset.py` writes the images with cv2; the JAX dataset decodes them with cv2, the
port with its own decoder. At the default hyperparameters, with mixup 0.5, and at the
ablation hyperparameters (`tools/flagship_parity.py:43-70`: flips only), for two epochs with
one and with three loader threads:

- the batch order (image files per batch) and `max_labels` are equal;
- per sample, the classes and the slot mask are equal and the boxes within 1e-4 px;
- images are within 1 per value (OpenCV's vectorised HSV -> RGB rounds differently from its
  scalar code, which the port follows; `tests/test_torch_image_ops.py`), and exactly equal
  where neither a warp nor HSV is applied (the ablation hyperparameters);
- validation batches (letterbox without enlarging, `ratio_pads`) are equal;
- `close_mosaic` turns the same transforms off;
- a `.cache.npz` label cache written by either package is read by the other.
"""

import numpy as np
import pytest

from make_dataset import make_dataset
from drone_yolo_tpu.cfg import get_cfg as jax_get_cfg
from drone_yolo_tpu.data.build import build_dataloader as jax_dataloader
from drone_yolo_tpu.data.build import build_yolo_dataset as jax_dataset
from drone_yolo_tpu.data.utils import check_det_dataset as jax_check
from drone_yolo_tpu_torch.cfg import get_train_cfg, get_val_cfg
from drone_yolo_tpu_torch.data.build import build_dataloader, build_yolo_dataset
from drone_yolo_tpu_torch.data.utils import check_det_dataset

IMGSZ, BATCH = 128, 4
ABLATION = dict(mosaic=0.0, mixup=0.0, copy_paste=0.0, scale=0.0, translate=0.0, degrees=0.0, shear=0.0, fliplr=0.5,
                flipud=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0)
HYPS = {"default": {}, "mixup": {"mixup": 0.5}, "ablation": ABLATION}


@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    return str(make_dataset(tmp_path_factory.mktemp("ds") / "ds", n_train=8, n_val=4, size=160, nc=4))


def _pair(data_yaml, hyp: dict, mode: str = "train", imgsz: int = IMGSZ):
    jd, pd = jax_check(data_yaml), check_det_dataset(data_yaml)
    ja = jax_get_cfg(overrides=dict(imgsz=imgsz, batch=BATCH, **hyp))
    pa = (get_train_cfg if mode == "train" else get_val_cfg)(overrides=dict(imgsz=imgsz, batch=BATCH, device="cpu", **hyp))
    return (jax_dataset(ja, jd[mode], BATCH, jd, mode=mode), build_yolo_dataset(pa, pd[mode], BATCH, pd, mode=mode),
            ja, pa)


def _compare(jb: dict, pb: dict, exact: bool) -> int:
    assert jb["im_files"] == pb["im_files"] and jb["ori_shapes"] == pb["ori_shapes"]
    np.testing.assert_array_equal(pb["cls"], jb["cls"])
    np.testing.assert_array_equal(pb["mask"], jb["mask"])
    np.testing.assert_allclose(pb["bboxes"], jb["bboxes"], rtol=0, atol=1e-4)
    assert pb["img"].shape == jb["img"].shape and pb["img"].dtype == np.uint8
    diff = np.abs(pb["img"].astype(int) - jb["img"])
    if exact:
        np.testing.assert_array_equal(pb["img"], jb["img"])
    assert diff.max() <= 1
    return int(diff.max())


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("hyp", sorted(HYPS))
def test_train_batches_match_jax(data_yaml, hyp, workers):
    js, ps, _, _ = _pair(data_yaml, HYPS[hyp])
    assert ps.max_labels == js.max_labels and len(ps) == len(js) == 8
    jl = jax_dataloader(js, BATCH, workers, shuffle=True, seed=0)
    pl = build_dataloader(ps, BATCH, workers, shuffle=True, seed=0)
    assert len(pl) == len(jl) == 2
    worst, n = 0, 0
    for epoch in range(2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        for jb, pb in zip(jl, pl):
            worst = max(worst, _compare(jb, pb, exact=hyp == "ablation"))
            n += 1
    assert n == 4
    print(f"{hyp}, {workers} workers: largest image difference {worst}")


def test_val_batches_match_jax(data_yaml):
    """Loaded at 80 (a factor of 2 of the 160 px files: INTER_AREA and the port's area resize agree exactly), then
    letterboxed without enlarging."""
    js, ps, _, _ = _pair(data_yaml, {}, mode="val", imgsz=80)
    jl = jax_dataloader(js, BATCH, 2, shuffle=False, drop_last=False)
    pl = build_dataloader(ps, BATCH, 2, shuffle=False, drop_last=False)
    batches = list(zip(jl, pl))
    assert len(batches) == 1
    for jb, pb in batches:
        _compare(jb, pb, exact=True)
        assert pb["ratio_pads"] == jb["ratio_pads"] and pb["ratio_pads"][0] == (1.0, (0.0, 0.0))


def test_close_mosaic_matches_jax(data_yaml):
    js, ps, ja, pa = _pair(data_yaml, {})
    js.close_mosaic(ja)
    ps.close_mosaic(pa)
    assert (pa.mosaic, pa.mixup, pa.copy_paste) == (ja.mosaic, ja.mixup, ja.copy_paste) == (0.0, 0.0, 0.0)
    assert [type(t).__name__ for t in ps.transforms.transforms] == [type(t).__name__ for t in js.transforms.transforms]
    jl, pl = jax_dataloader(js, BATCH, 2, seed=3), build_dataloader(ps, BATCH, 2, seed=3)
    jl.set_epoch(5)
    pl.set_epoch(5)
    for jb, pb in zip(jl, pl):
        _compare(jb, pb, exact=False)
        assert pb["img"].shape[1:3] == (IMGSZ, IMGSZ)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_label_cache_crosses_packages(tmp_path, writer):
    """The cache file written by one package is read, unchanged, by the other (its hash and version match)."""
    y = str(make_dataset(tmp_path / "ds", n_train=3, n_val=2, size=160, nc=4))
    first, second = (jax_dataset, build_yolo_dataset) if writer == "jax" else (build_yolo_dataset, jax_dataset)
    cfgs = {jax_dataset: jax_get_cfg(overrides=dict(imgsz=IMGSZ)),
            build_yolo_dataset: get_train_cfg(overrides=dict(imgsz=IMGSZ, device="cpu"))}
    data = {jax_dataset: jax_check(y), build_yolo_dataset: check_det_dataset(y)}
    a = first(cfgs[first], data[first]["train"], BATCH, data[first])
    cache = tmp_path / "ds" / "labels" / "train.cache.npz"
    stamp = cache.stat().st_mtime_ns
    b = second(cfgs[second], data[second]["train"], BATCH, data[second])
    assert cache.stat().st_mtime_ns == stamp  # read, not rewritten
    assert len(a.labels) == len(b.labels) == 3
    for la, lb in zip(a.labels, b.labels):
        assert la["im_file"] == lb["im_file"] and tuple(la["shape"]) == tuple(lb["shape"]) == (160, 160)
        np.testing.assert_array_equal(la["cls"], lb["cls"])
        np.testing.assert_array_equal(la["bboxes_n"], lb["bboxes_n"])

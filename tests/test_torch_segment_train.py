"""The port's segmentation training against the JAX package's, on the CPU in float32.

Datasets come from `tests/make_dataset.py:make_seg_dataset` (filled polygons with exact polygon labels, nc 3, 128 px).
Held against the JAX package (and so against cv2, which it calls) on the same inputs:

- `fill_poly` against `cv2.fillPoly` on random convex and concave polygons, polygons touching and crossing the
  image's edges and one pixel wide: every pixel; `polygon2mask`, `polygons2masks_overlap` and its order at mask
  ratios 1, 2 and 4: exactly;
- polygon labels (boxes from the polygons, a duplicate row dropped with its polygon) for `task=segment` and
  `task=detect`, and the label cache both ways;
- augmented batches under the same seeds through the loader for two epochs (mosaic, copy-paste, the affine's
  polygon path, flips): the collated index masks exactly, boxes within 1e-4 px; each polygon transform alone on one
  sample: polygons within 1e-4 px;
- `v8SegmentationLoss` items within 2e-3 with an image of more than `max_fg` = 128 foreground anchors, also with
  prototypes of another size than the masks (a multi-scale batch), whose resize is `jax.image.resize`'s nearest;
- the head's train output (coefficients and prototypes take gradients and BN statistics: 66 BN inputs);
- one train step against the JAX `step_fn` within `REF_NOISE`, and with `s2grad="cuda"`, `bnstats="cuda"` (their
  plain versions on the CPU) against the stock step; a multi-scale step;
- `YOLO(...).train` one epoch and its validation from one init against the JAX package's (EMA within
  `REF_NOISE + JAX_LOOP_NOISE`, loss items, metrics), `last.npz` in the JAX reader, and `dyt-torch segment
  train|val|predict`.
"""

import shutil
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import synthetic_seg_batch
from make_dataset import make_seg_dataset
from test_torch_trainloop import JAX_LOOP_NOISE, _ema_errors
from drone_yolo_tpu.cfg import get_cfg as jax_get_cfg
from drone_yolo_tpu.data import augment as JA
from drone_yolo_tpu.data import utils as JU
from drone_yolo_tpu.data.build import build_dataloader as jax_dataloader
from drone_yolo_tpu.data.build import build_yolo_dataset as jax_dataset
from drone_yolo_tpu.data.utils import check_det_dataset as jax_check
from drone_yolo_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from drone_yolo_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from drone_yolo_tpu.engine.model import YOLO as JaxYOLO
from drone_yolo_tpu.engine.trainer import BaseTrainer as JaxBaseTrainer
from drone_yolo_tpu.models.yolo.segment import SegmentationTrainer as JaxSegTrainer
from drone_yolo_tpu.nn.model import SegmentationModel as JaxSegModel
from drone_yolo_tpu.utils.loss import v8SegmentationLoss as JaxSegLoss
from drone_yolo_tpu.utils.optimizer import init_momentum, label_tree
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.cfg import entrypoint, get_train_cfg
from drone_yolo_tpu_torch.data import augment as A
from drone_yolo_tpu_torch.data import utils as U
from drone_yolo_tpu_torch.data.build import build_dataloader, build_yolo_dataset
from drone_yolo_tpu_torch.data.utils import check_det_dataset
from drone_yolo_tpu_torch.engine.checkpoint import from_jax_train_state, from_jax_variables, to_jax_variables
from drone_yolo_tpu_torch.models.yolo.segment import SegmentationTrainer, SegmentationValidator
from drone_yolo_tpu_torch.nn import modules as M
from drone_yolo_tpu_torch.nn.model import SegmentationModel
from drone_yolo_tpu_torch.ops.polygon import fill_poly
from drone_yolo_tpu_torch.utils.loss import v8SegmentationLoss

torch.set_num_threads(1)

SEG_N = "yolov8n-seg.yaml"
NC, BATCH, IMGSZ = 3, 2, 64
PT_ATOL = 1e-4  # px, the bar tests/test_torch_dataset.py holds boxes to
LOSS_TOL = 2e-3  # tests/test_torch_train.py
STATE_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_train.py
REF_NOISE = 5e-3  # tests/test_torch_train.py: four times the JAX step's measured float32 error
HYPS = {"default": {}, "copy_paste": {"copy_paste": 0.8, "degrees": 20.0, "shear": 3.0, "flipud": 0.5},
        "no_mosaic": {"mosaic": 0.0, "copy_paste": 1.0, "scale": 0.9, "translate": 0.3}}


def _polygons(kind: str, rng, w: int, h: int) -> list:
    k = int(rng.integers(3, 12))
    if kind == "convex":
        c, r = rng.uniform(0, [w, h]), rng.uniform(1, max(w, h) / 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        pts = c + np.stack([np.cos(ang), np.sin(ang)], 1) * r
    elif kind == "concave":
        c = rng.uniform(0, [w, h])
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        pts = c + np.stack([np.cos(ang), np.sin(ang)], 1) * rng.uniform(0.5, max(w, h) / 2, (k, 1))
    elif kind == "edge":  # vertices on and beyond the far edges (x = w, y = h), as clipped augmented polygons have
        pts = np.stack([rng.uniform(0, w + 0.999, k), rng.uniform(0, h + 0.999, k)], 1)
        pts[rng.random(k) < 0.4, 0] = w
        pts[rng.random(k) < 0.4, 1] = h
    elif kind == "thin":  # one pixel wide, vertical and horizontal slivers
        x0, y0 = rng.uniform(0, w), rng.uniform(0, h)
        pts = np.array([[x0, 0], [x0 + rng.uniform(0, 1.5), h], [x0 + rng.uniform(0, 1.5), rng.uniform(0, h)]])
        if rng.random() < 0.5:
            pts = np.array([[0, y0], [w, y0 + rng.uniform(0, 1.5)], [rng.uniform(0, w), y0 + rng.uniform(0, 1.5)]])
    else:  # outside: vertices anywhere around the image
        pts = rng.uniform(-15, [w + 15, h + 15], (k, 2))
    return [pts.astype(np.int32) for pts in [pts]]


@pytest.mark.parametrize("kind", ["convex", "concave", "edge", "thin", "outside"])
def test_fill_poly_matches_cv2(kind):
    rng = np.random.default_rng(len(kind))
    for _ in range(300):
        w, h = (int(v) for v in rng.integers(2, 70, 2))
        polys = _polygons(kind, rng, w, h) + (_polygons("convex", rng, w, h) if rng.random() < 0.2 else [])
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, polys, 3)
        got = fill_poly(np.zeros((h, w), np.uint8), polys, 3)
        assert np.array_equal(got, want), (w, h, [p.tolist() for p in polys])


@pytest.mark.parametrize("ratio", [1, 2, 4])
def test_polygon_masks_match_jax(ratio):
    rng = np.random.default_rng(ratio)
    for _ in range(40):
        h, w = (int(v) for v in rng.choice([64, 96, 128, 160], 2))
        segs = []
        for _ in range(int(rng.integers(1, 9))):
            kind = str(rng.choice(["convex", "concave", "edge", "thin"]))
            segs.append(np.clip(_polygons(kind, rng, w, h)[0], 0, [w, h]).astype(np.float32) + rng.random(2))
        np.testing.assert_array_equal(U.polygon2mask((h, w), [segs[0].reshape(-1)], 1, ratio),
                                      JU.polygon2mask((h, w), [segs[0].reshape(-1)], 1, ratio))
        got, got_order = U.polygons2masks_overlap((h, w), segs, ratio)
        want, want_order = JU.polygons2masks_overlap((h, w), segs, ratio)
        assert got.dtype == want.dtype and got.shape == (h // ratio, w // ratio)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_order, want_order)


@pytest.fixture(scope="module")
def seg_data(tmp_path_factory):
    """The yaml of a polygon set (nc 3, 128 px; one label file with a duplicate row)."""
    root = tmp_path_factory.mktemp("seg")
    yaml = make_seg_dataset(root / "d", n_val=4, nc=NC, seed=0, size=128, n_train=6)
    lab = root / "d" / "labels" / "val" / "val_0000.txt"
    rows = lab.read_text().splitlines()
    lab.write_text("\n".join(rows + rows[:1]) + "\n")
    return str(yaml)


def _pair(yaml: str, hyp: dict, task: str = "segment", mode: str = "train"):
    jd, pd = jax_check(yaml), check_det_dataset(yaml)
    ja = jax_get_cfg(overrides=dict(imgsz=IMGSZ, batch=BATCH, task=task, **hyp))
    pa = get_train_cfg(overrides=dict(imgsz=IMGSZ, batch=BATCH, device="cpu", task=task, **hyp))
    return jax_dataset(ja, jd[mode], BATCH, jd, mode=mode), build_yolo_dataset(pa, pd[mode], BATCH, pd, mode=mode)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_segment_labels_and_cache_match_jax(seg_data, writer):
    """Polygon labels equal (boxes from the polygons, the duplicate row dropped with its polygon) for task segment and
    detect; the cache written by one package is read unchanged by the other."""
    cache = check_det_dataset(seg_data)["path"] / "labels" / "val.cache.npz"
    if cache.exists():
        cache.unlink()
    order = ["jax", "port"] if writer == "jax" else ["port", "jax"]
    built = {}
    for who in order:
        stamp = cache.stat().st_mtime_ns if cache.exists() else None
        built[who] = _pair(seg_data, {}, mode="val")[0 if who == "jax" else 1]
        if stamp is not None:
            assert cache.stat().st_mtime_ns == stamp  # read, not rewritten
    j, p = built["jax"], built["port"]
    assert p.use_segments and len(p.labels) == len(j.labels) == 4
    for lj, lp in zip(j.labels, p.labels):
        np.testing.assert_array_equal(lp["cls"], lj["cls"])
        np.testing.assert_array_equal(lp["bboxes_n"], lj["bboxes_n"])
        assert len(lp["segments"]) == len(lj["segments"]) == len(lp["cls"]) > 0
        for a, b in zip(lp["segments"], lj["segments"]):
            np.testing.assert_array_equal(a, b)
    assert len(p.labels[0]["cls"]) == len(open(p.label_files[0]).read().splitlines()) - 1  # the duplicate dropped
    pb, jb = (ds.collate([ds[i] for i in range(len(ds))]) for ds in (p, j))
    np.testing.assert_array_equal(pb["masks"], jb["masks"])
    np.testing.assert_array_equal(pb["cls"], jb["cls"])
    np.testing.assert_allclose(pb["bboxes"], jb["bboxes"], rtol=0, atol=PT_ATOL)
    jd, pd = _pair(seg_data, {}, task="detect", mode="val")  # a detect dataset reads the polygons too
    assert not pd.use_segments and all(len(a["segments"]) == len(b["segments"]) for a, b in zip(pd.labels, jd.labels))


@pytest.mark.parametrize("task", ["segment", "detect"])
@pytest.mark.parametrize("hyp", sorted(HYPS))
def test_augmented_batches_match_jax(seg_data, hyp, task):
    """Two epochs of train batches (one loader thread): image files, classes, masks, boxes and index masks, and the
    images (within one level) except where the JAX package's copy-paste without mosaic has written into its loaded
    images (ROADMAP queue 3): the port's stay as decoded."""
    js, ps = _pair(seg_data, HYPS[hyp], task=task)
    assert ps.max_labels == js.max_labels
    jl, pl = jax_dataloader(js, BATCH, 1, shuffle=True, seed=0), build_dataloader(ps, BATCH, 1, shuffle=True, seed=0)
    n, instances = 0, 0
    for epoch in range(2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        for jb, pb in zip(jl, pl):
            assert jb["im_files"] == pb["im_files"]
            np.testing.assert_array_equal(pb["cls"], jb["cls"])
            np.testing.assert_array_equal(pb["mask"], jb["mask"])
            np.testing.assert_allclose(pb["bboxes"], jb["bboxes"], rtol=0, atol=PT_ATOL)
            if epoch == 0 or HYPS[hyp].get("mosaic", 1.0) > 0 or task == "detect":
                assert np.abs(pb["img"].astype(int) - jb["img"]).max() <= 1
            if task == "segment":
                assert pb["masks"].shape == (BATCH, IMGSZ // 4, IMGSZ // 4) and pb["masks"].dtype == np.int32
                np.testing.assert_array_equal(pb["masks"], jb["masks"])
                instances += int(pb["masks"].max(axis=(1, 2)).sum())
            else:
                assert "masks" not in pb
            n += 1
    assert n == 6 and (task == "detect" or instances > 0)
    for i in range(len(ps)):  # the loaded images are the decoded files, whatever was pasted into the samples
        np.testing.assert_array_equal(ps.load_image(i), _decoded(ps, i))
    if task == "segment" and hyp == "no_mosaic":  # the JAX package's pasted into its decode buffer
        assert any(not np.array_equal(js.load_image(i), _decoded(js, i)) for i in range(len(js)))


def test_segment_mixup_carries_the_polygons(seg_data):
    """With mixup the port's segment samples hold the second sample's polygons too, one per box, and collate into
    index masks of those instances. The JAX package drops them, and its collate fails (ROADMAP queue 3)."""
    js, ps = _pair(seg_data, {"mixup": 1.0, "mosaic": 0.0})
    ps.set_epoch(0, 0)
    samples = [ps[i] for i in range(len(ps))]
    assert all(len(s["segments"]) == len(s["bboxes"]) for s in samples)
    assert sum(len(s["cls"]) > len(lb["cls"]) for s, lb in zip(samples, ps.labels)) >= len(ps) // 2  # mixed in
    batch = ps.collate(samples[:BATCH])
    for i in range(BATCH):
        assert 0 < batch["masks"][i].max() <= batch["mask"][i].sum() == len(samples[i]["cls"])
    jl = jax_dataloader(js, BATCH, 1, shuffle=True, seed=0)
    jl.set_epoch(0)
    with pytest.raises(ValueError, match="could not broadcast"):
        next(iter(jl))


def _decoded(ds, i):
    """Image i of `ds` (either package's dataset) decoded and resized afresh, past its cache and decode buffer."""
    ram, buf = ds._ram, ds._buffer_ims
    ds._ram, ds._buffer_ims, keep = {}, {}, ds.max_buffer_length
    ds.max_buffer_length = 0
    try:
        return ds.load_image(i)
    finally:
        ds._ram, ds._buffer_ims, ds.max_buffer_length = ram, buf, keep


def _sample(rng):
    segs = [np.array([[10, 12], [60, 15], [55, 70], [12, 60]], np.float32),
            np.array([[40, 5], [90, 8], [70, 50]], np.float32) + rng.uniform(0, 1, 2).astype(np.float32),
            np.array([[0, 0], [3, 0], [3, 79], [0, 79]], np.float32)]
    boxes = np.array([[s[:, 0].min(), s[:, 1].min(), s[:, 0].max(), s[:, 1].max()] for s in segs], np.float32)
    return {"img": rng.integers(0, 256, (80, 100, 3), dtype=np.uint8), "cls": np.array([0.0, 1.0, 2.0], np.float32),
            "bboxes": boxes, "segments": segs}


def test_polygon_transforms_match_jax():
    """Each polygon transform alone on one sample: the affine's polygon path (boxes from the warped, clipped polygons,
    area threshold 0.01), both flips, letterbox, clip and copy-paste."""
    rng = np.random.default_rng(3)
    cases = [(A.RandomPerspective(degrees=40, translate=0.3, scale=0.5, shear=10),
              JA.RandomPerspective(degrees=40, translate=0.3, scale=0.5, shear=10)),
             (A.RandomFlip(1.0, "horizontal"), JA.RandomFlip(1.0, "horizontal")),
             (A.RandomFlip(1.0, "vertical"), JA.RandomFlip(1.0, "vertical")),
             (A.LetterBoxT((96, 64)), JA.LetterBoxT((96, 64))),
             (lambda s: A.clip_sample(s, (60, 70)), lambda s: JA.clip_sample(s, (60, 70))),
             (A.CopyPaste(1.0), JA.CopyPaste(1.0))]
    def copy(s):
        return {k: ([x.copy() for x in v] if k == "segments" else v.copy()) for k, v in s.items()}

    for i, (port_t, jax_t) in enumerate(cases):
        for seed in range(4):
            base = _sample(rng)
            A.seed_sample(seed, 0, i)
            got = port_t(copy(base))
            JA.seed_sample(seed, 0, i)
            want = jax_t(copy(base))
            np.testing.assert_array_equal(got["cls"], want["cls"])
            np.testing.assert_allclose(got["bboxes"], want["bboxes"], rtol=0, atol=PT_ATOL)
            assert len(got["segments"]) == len(want["segments"]) == len(got["cls"])
            for a, b in zip(got["segments"], want["segments"]):
                assert a.dtype == b.dtype
                np.testing.assert_allclose(a, b, rtol=0, atol=PT_ATOL)
            assert np.array_equal(got["img"], want["img"]) or i == 0  # the warp: ops/image.py within 1 of cv2
            if i == len(cases) - 1:
                assert len(got["cls"]) > len(base["cls"])  # something was pasted


def _seg_outputs(rng, b: int, imgsz: int, nc: int, proto_size: int):
    maps = [(rng.standard_normal((b, 64 + nc, imgsz // s, imgsz // s)) * 1.5).astype(np.float32) for s in (8, 16, 32)]
    a = sum(m.shape[2] * m.shape[3] for m in maps)
    return maps, rng.standard_normal((b, a, 32)).astype(np.float32), \
        rng.standard_normal((b, 32, proto_size, proto_size)).astype(np.float32)


def _crowded_seg_targets(rng, imgsz: int = 160, slots: int = 32) -> dict:
    """Image 0: 20 polygons of 28-40 px on a 5 x 4 grid (more than 128 foreground anchors); image 1: 3 overlapping
    ones of 16-60 px. Their overlap index mask at ratio 4 and the slots in its order."""
    out = {"cls": np.zeros((2, slots), np.float32), "bboxes": np.zeros((2, slots, 4), np.float32),
           "mask": np.zeros((2, slots), np.float32), "masks": np.zeros((2, imgsz // 4, imgsz // 4), np.int32)}
    grid = [np.array([x * 32 + 16, y * 40 + 20], float) for y in range(4) for x in range(5)]
    for i, n in enumerate((20, 3)):
        segs = []
        for j in range(n):
            if i == 0:
                c, r = grid[j], rng.uniform(14, 20, 2)
            else:
                c, r = rng.uniform(20, imgsz - 20, 2), rng.uniform(8, 30, 2)
            ang = np.linspace(0, 2 * np.pi, int(rng.integers(5, 9)), endpoint=False)
            segs.append((c + np.stack([np.cos(ang), np.sin(ang)], 1) * r).clip(0, imgsz).astype(np.float32))
        out["masks"][i], order = U.polygons2masks_overlap((imgsz, imgsz), segs, 4)
        out["bboxes"][i, :n] = np.array([[s[:, 0].min(), s[:, 1].min(), s[:, 0].max(), s[:, 1].max()]
                                         for s in segs], np.float32)[order]
        out["cls"][i, :n] = rng.integers(0, NC, n)[order]
        out["mask"][i, :n] = 1
    return out


@pytest.mark.parametrize("proto_size", [40, 23])
def test_seg_loss_matches_jax(proto_size):
    """v8SegmentationLoss on the same head outputs and targets: the 4 items within 2e-3 of JAX's. Image 0 has more
    than max_fg = 128 foreground anchors; prototypes of 23 px against 40 px masks take the multi-scale resize."""
    rng = np.random.default_rng(proto_size)
    maps, mc, protos = _seg_outputs(rng, 2, 160, NC, proto_size)
    targets = _crowded_seg_targets(rng)
    port, ref = SegmentationModel(SEG_N, nc=NC), JaxSegModel(SEG_N, nc=NC)
    crit = v8SegmentationLoss(port)
    t = {k: torch.from_numpy(v) for k, v in targets.items()}
    feats = [torch.from_numpy(m) for m in maps]
    fg = crit._detect_parts(feats, t)["fg_mask"].sum(1)
    assert int(fg[0]) > crit.max_fg == 128 and int(fg[1]) > 0
    loss, items = crit((feats, torch.from_numpy(mc), torch.from_numpy(protos)), t)
    loss_j, items_j = jax.jit(JaxSegLoss(ref).__call__)(
        ([jnp.asarray(m.transpose(0, 2, 3, 1)) for m in maps], jnp.asarray(mc),
         jnp.asarray(protos.transpose(0, 2, 3, 1))),
        {k: jnp.asarray(v) for k, v in targets.items()})
    print(f"protos {proto_size}: items {items.tolist()}, JAX {np.asarray(items_j).tolist()}")
    assert np.abs(np.asarray(items_j)).min() > 1e-2  # every item carries signal
    np.testing.assert_allclose(items.numpy(), np.asarray(items_j), rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=LOSS_TOL)


@pytest.mark.parametrize("size_in,size_out", [(40, 23), (16, 40), (40, 40), (33, 20)])
def test_nearest_exact_is_jax_nearest(size_in, size_out):
    """The loss's mask resize: `F.interpolate(mode="nearest-exact")` samples half-pixel centres as
    `jax.image.resize(method="nearest")`; torch's "nearest" does not."""
    om = np.random.default_rng(size_in).integers(0, 9, (2, size_in, size_in)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(om), (2, size_out, size_out), method="nearest"))
    got = F.interpolate(torch.from_numpy(om)[:, None], size=(size_out, size_out), mode="nearest-exact")[:, 0]
    np.testing.assert_array_equal(got.numpy(), want)
    if size_in * 2 != size_out and size_in != size_out:
        plain = F.interpolate(torch.from_numpy(om)[:, None], size=(size_out, size_out), mode="nearest")[:, 0]
        assert not np.array_equal(plain.numpy(), want)


def test_segment_head_trains_coefficients_and_protos():
    """In train mode the Segment head returns (maps, coefficients (B, A, 32), protos (B, 32, H/4, W/4)); the loss
    reaches cv4 and proto, whose BatchNorms take part in the batch statistics: 57 + 6 + 3 = 66."""
    model = SegmentationModel(SEG_N, nc=NC)
    model.init(0, imgsz=IMGSZ)
    model.train()
    batch = synthetic_seg_batch(np.random.default_rng(0), BATCH, IMGSZ, NC)
    with M.collect_bn_stats() as stats:
        out = model(torch.from_numpy(batch["img"].transpose(0, 3, 1, 2).astype(np.float32) / 255.0))
        maps, mc, protos = out
        assert mc.shape == (BATCH, 84, 32) and protos.shape == (BATCH, 32, 16, 16)
        loss, items = v8SegmentationLoss(model)(out, {k: torch.from_numpy(v) for k, v in batch.items() if k != "img"})
    loss.backward()
    assert items[1] > 0
    head = model.head
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in head.proto.parameters())
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in head.cv4[0].parameters())
    assert len(stats) == sum(isinstance(m, M.BatchNorm2d) for m in model.modules()) == 66


def _close(got: dict, want: dict, names, base: dict):
    for k in names:
        w = np.asarray(want[k])
        atol = STATE_TOL["atol"] + REF_NOISE * np.abs(w - np.asarray(base[k])).max()
        np.testing.assert_allclose(got[k].detach().cpu().numpy(), w, rtol=STATE_TOL["rtol"], atol=atol, err_msg=k)


def test_segment_train_step_matches_jax_step_fn():
    """One SGD step (warmup hyperparameters of batch 50) of SegmentationTrainer against the JAX step_fn over
    v8SegmentationLoss from one state: items within 2e-3; params, BN statistics, momentum and EMA within rtol 1e-4 and
    1e-5 + REF_NOISE of each tensor's largest update. Then the step with s2grad="cuda" and bnstats="cuda" (their plain
    versions on CPU tensors) from the same state; then a multi-scale step (the masks keep their size)."""
    batch = synthetic_seg_batch(np.random.default_rng(1), BATCH, IMGSZ, NC)
    model = SegmentationModel(SEG_N, nc=NC)
    model.init(0, imgsz=IMGSZ)
    ref = JaxSegModel(SEG_N, nc=NC)
    variables = convert_state_dict(ref, model.state_dict())
    start = from_jax_variables(variables)

    def port_trainer(**kw):
        t = SegmentationTrainer(overrides=dict(model=SEG_N, batch=BATCH, imgsz=IMGSZ, nbs=BATCH, device="cpu",
                                               amp=False, optimizer="SGD", **kw), train_loader=[batch], data={"nc": NC})
        t._setup_train()
        return t

    stock = port_trainer()
    assert isinstance(stock.criterion, v8SegmentationLoss) and stock.loss_names == JaxSegTrainer.loss_names
    stub = types.SimpleNamespace(
        model=ref, criterion=JaxSegLoss(ref), accumulate=1, opt_name="SGD", weight_decay=stock.weight_decay,
        device_aug=False, labels=label_tree(variables),
        args=types.SimpleNamespace(amp=False, imgsz=IMGSZ, multi_scale=False, seed=0, sp=1))
    JaxBaseTrainer._build_train_step(stub)
    params = jax.tree_util.tree_map(jnp.asarray, variables)
    state = {"params": params, "opt": init_momentum(params), "ema": jax.tree_util.tree_map(jnp.array, params),
             "acc": jax.tree_util.tree_map(jnp.zeros_like, params), "count": jnp.zeros((), jnp.int32),
             "step": jnp.zeros((), jnp.int32)}
    first = from_jax_train_state(jax.tree_util.tree_map(np.asarray, state))
    hyp = stock._warmup_hyp(50, 0)
    state, _, items_j = stub.train_step(state, batch, *(jnp.float32(h) for h in hyp), target_sz=IMGSZ)
    want = from_jax_train_state(state)
    names = sorted(dict(stock.model.named_parameters()))
    buffers = sorted(set(want["params"]) - set(names))
    for who, trainer in (("stock", stock), ("kernels", port_trainer(s2grad="cuda", bnstats="cuda"))):
        trainer.load_train_state(first)
        _, items = trainer.train_step(batch, *hyp)
        print(f"{who}: items {items.tolist()}, JAX {np.asarray(items_j).tolist()}")
        np.testing.assert_allclose(items.numpy(), np.asarray(items_j), rtol=0, atol=LOSS_TOL)
        got = trainer.train_state()
        assert (got["step"], got["count"]) == (want["step"], want["count"]) == (1, 0)
        _close(got["params"], want["params"], names + buffers, base=start)
        _close(got["ema"], want["ema"], names + buffers, base=start)
        _close(got["opt"]["momentum"], want["opt"]["momentum"], names, base={k: 0 * v for k, v in start.items()})
        if who == "stock":
            stock_state = {k: v.clone() for k, v in got["params"].items()}
        else:
            for k in names + buffers:
                torch.testing.assert_close(got["params"][k], stock_state[k], **STATE_TOL, msg=k)
    proto = [k for k in names if ".proto." in k]
    assert proto and all(not torch.equal(stock_state[k], start[k]) for k in proto)

    seen = {}
    real = stock.criterion.__call__
    stock.criterion = lambda out, b: (seen.update(img=b["img"].shape, masks=b["masks"].shape, protos=out[2].shape),
                                      real(out, b))[1]
    loss, items = stock.train_step(batch, 0.01, 0.01, 0.9, size=96)
    assert seen == {"img": (BATCH, 3, 96, 96), "masks": (BATCH, 16, 16), "protos": (BATCH, 32, 24, 24)}
    assert torch.isfinite(loss) and items.shape == (4,)


def test_yolo_segment_epoch_val_and_cli(seg_data, tmp_path, monkeypatch):
    """`YOLO(init.npz).train` one epoch and its EMA validation in both packages from one init, with copy-paste and
    flips and without the warps (the affine, mosaic's, HSV), whose images the two packages compute within one level
    of each other (the augmented batches are held above): the loss items within 2e-3, the final EMA within
    REF_NOISE + JAX_LOOP_NOISE of JAX's, the metrics within 1e-3; results.csv's columns, last.npz in the JAX reader;
    `dyt-torch segment train|val|predict`."""
    init = SegmentationModel(SEG_N, nc=NC)
    init.init(0, imgsz=IMGSZ)
    ref_model = JaxSegModel(SEG_N, nc=NC)
    start = init.state_dict()
    path = jax_save_checkpoint(tmp_path / "init.npz", ref_model, convert_state_dict(ref_model, start))
    hyps = dict(epochs=1, imgsz=IMGSZ, batch=BATCH, nbs=BATCH, workers=1, amp=False, optimizer="SGD", copy_paste=0.5,
                mosaic=0.0, scale=0.0, translate=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, flipud=0.5, close_mosaic=0,
                exist_ok=True, project=str(tmp_path), seed=0)
    port = YOLO(str(path), device="cpu")
    port_metrics = port.train(data=seg_data, name="port", **hyps)
    t = port.trainer
    assert isinstance(t, SegmentationTrainer)
    JaxYOLO(str(path)).train(data=seg_data, name="jax", plots=False, device="0", **hyps)
    rows = [r.split(",") for r in (tmp_path / "jax" / "results.csv").read_text().splitlines()]
    jax_cols = {c: float(v) for c, v in zip(rows[0], rows[1])}
    header = (t.save_dir / "results.csv").read_text().splitlines()[0].split(",")
    assert header == rows[0] and "train/seg_loss" in header
    np.testing.assert_allclose(t.epoch_stats[0]["loss_items"], [jax_cols[f"train/{n}"] for n in t.loss_names],
                               rtol=0, atol=LOSS_TOL)
    for k, v in port_metrics.items():
        assert abs(v - jax_cols[k]) <= 1e-3, (k, v, jax_cols[k])
    _, jvars, jheader = jax_load_checkpoint(tmp_path / "jax" / "weights" / "last.npz")
    err = _ema_errors(t.final_state, from_jax_variables(jax.tree_util.tree_map(np.asarray, jvars)), start)
    print(f"final EMA against JAX's, largest error beyond rtol 1e-4 and 1e-5 as a share of the largest update: {err}")
    assert err <= REF_NOISE + JAX_LOOP_NOISE
    _, pvars, pheader = jax_load_checkpoint(t.wdir / "last.npz")
    assert pheader["task"] == "segment"
    for k, v in to_jax_variables(t.final_state)["22"]["proto"]["up"].items():
        np.testing.assert_array_equal(np.asarray(pvars["22"]["proto"]["up"][k]), v)

    seen = []
    get_stats = SegmentationValidator.get_stats
    monkeypatch.setattr(SegmentationValidator, "get_stats", lambda self: seen.append(type(self)) or get_stats(self))
    entrypoint(f"segment train model={SEG_N} data={seg_data} epochs=1 imgsz={IMGSZ} batch={BATCH} nbs={BATCH} "
               f"workers=1 amp=False device=cpu project={tmp_path} name=cli exist_ok=True")
    cli = tmp_path / "cli"
    assert "train/seg_loss" in (cli / "results.csv").read_text().splitlines()[0] and seen == [SegmentationValidator]
    entrypoint(f"segment val model={cli / 'weights' / 'last.npz'} data={seg_data} imgsz={IMGSZ} batch={BATCH} "
               "device=cpu dtype=float32 workers=1")
    assert seen == [SegmentationValidator] * 2
    img_dir = check_det_dataset(seg_data)["val"]
    entrypoint(f"segment predict model={cli / 'weights' / 'last.npz'} source={img_dir} imgsz={IMGSZ} conf=0.0 "
               f"max_det=3 device=cpu dtype=float32 save_txt=True project={tmp_path} name=pred exist_ok=True")
    assert len(list((tmp_path / "pred" / "labels").glob("*.txt"))) == 4
    shutil.rmtree(tmp_path / "pred")

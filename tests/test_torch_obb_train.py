"""The port's oriented box training against the JAX package's, on the CPU in float32.

Datasets come from `tests/make_dataset.py:make_obb_dataset` (filled rotated rectangles, 4-corner polygon labels, nc 3,
128 px). Held against the JAX package on the same inputs:

- obb labels, collated batches under the same seeds through the loader for two epochs (mosaic, the affine's polygon
  path, flips): `segments_list` within 1e-4 px, draw for draw, and the trainer's `rboxes` from them (the JAX package
  through cv2.minAreaRect) within 1e-4 px and 1e-5 rad;
- `select_candidates_in_rotated_gts` and the rotated assigner: masks and indices exactly, target scores within 1e-5;
- `v8OBBLoss` items within 2e-3 of the JAX loss with the predicted angle in its predicted rotated box, and the
  difference from the JAX loss as it stands, which drops that angle (ROADMAP queue 3);
- the head's train output (the angle branch takes gradients and BN statistics: 63 BN inputs);
- one multi-scale train step against the JAX `step_fn` (the angle in the predicted box) within `REF_NOISE`, and with
  `s2grad="cuda"`, `bnstats="cuda"` (their plain versions on the CPU) against the stock step;
- where the port departs: a multi-scale step scales `rboxes` (the JAX step leaves them at the old scale, so it is
  given them scaled above), a batch in which no image has polygons trains on its axis-aligned boxes (the JAX trainer
  on zero boxes);
- `YOLO("yolov8n-obb.yaml").train/val/predict`, `last.npz` in the JAX reader, `dyt-torch obb train|val|predict`.
"""

import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_dataset import make_obb_dataset
from drone_yolo_tpu.cfg import get_cfg as jax_get_cfg
from drone_yolo_tpu.data.build import build_dataloader as jax_dataloader
from drone_yolo_tpu.data.build import build_yolo_dataset as jax_dataset
from drone_yolo_tpu.data.utils import check_det_dataset as jax_check
from drone_yolo_tpu.engine import trainer as JT
from drone_yolo_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from drone_yolo_tpu.engine.trainer import BaseTrainer as JaxBaseTrainer
from drone_yolo_tpu.models.yolo import obb as JOBB
from drone_yolo_tpu.nn.model import OBBModel as JaxOBBModel
from drone_yolo_tpu.ops import anchors as JANC
from drone_yolo_tpu.ops import boxes as JBOX
from drone_yolo_tpu.utils import tal as JTAL
from drone_yolo_tpu.utils.loss import v8OBBLoss as JaxOBBLoss
from drone_yolo_tpu.utils.optimizer import init_momentum, label_tree
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.cfg import entrypoint, get_train_cfg
from drone_yolo_tpu_torch.data.build import build_dataloader, build_yolo_dataset
from drone_yolo_tpu_torch.data.utils import check_det_dataset
from drone_yolo_tpu_torch.engine.checkpoint import from_jax_train_state, from_jax_variables
from drone_yolo_tpu_torch.models.yolo.obb import OBBTrainer, OBBValidator, rboxes_from_segments
from drone_yolo_tpu_torch.nn import modules as M
from drone_yolo_tpu_torch.nn.model import OBBModel
from drone_yolo_tpu_torch.utils import tal as TAL
from drone_yolo_tpu_torch.utils.loss import v8OBBLoss

torch.set_num_threads(1)

OBB_N = "yolov8n-obb.yaml"
NC, BATCH, IMGSZ = 3, 2, 64
PT_ATOL = 1e-4  # px, the bar tests/test_torch_dataset.py holds boxes to
RAD_ATOL = 1e-5
LOSS_TOL = 2e-3  # tests/test_torch_train.py
STATE_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_train.py
REF_NOISE = 5e-3  # tests/test_torch_train.py: four times the JAX step's measured float32 error
HYPS = {"default": {}, "warps": {"degrees": 30.0, "shear": 5.0, "flipud": 0.5, "scale": 0.7},
        "no_mosaic": {"mosaic": 0.0, "translate": 0.3, "degrees": 10.0}}


@pytest.fixture
def jax_angle_in_pred_box(monkeypatch):
    """The JAX `dist2rbox` with the angle appended, as the reference's `bbox_decode` gives the predicted rotated box:
    the JAX `v8OBBLoss` decodes the predicted box through it at call time."""
    plain = JANC.dist2rbox
    monkeypatch.setattr(JANC, "dist2rbox", lambda d, a, p, axis=-1: jnp.concatenate([plain(d, a, p, axis), a], -1))


@pytest.fixture(scope="module")
def obb_data(tmp_path_factory):
    """The yaml of a rotated-rectangle set (nc 3, 128 px)."""
    return str(make_obb_dataset(tmp_path_factory.mktemp("obb") / "d", n_val=4, nc=NC, seed=0, size=128, n_train=6))


def _pair(yaml: str, hyp: dict, mode: str = "train"):
    jd, pd = jax_check(yaml), check_det_dataset(yaml)
    ja = jax_get_cfg(overrides=dict(imgsz=IMGSZ, batch=BATCH, task="obb", **hyp))
    pa = get_train_cfg(overrides=dict(imgsz=IMGSZ, batch=BATCH, device="cpu", task="obb", **hyp))
    return jax_dataset(ja, jd[mode], BATCH, jd, mode=mode), build_yolo_dataset(pa, pd[mode], BATCH, pd, mode=mode)


def _jax_rboxes(batch: dict, monkeypatch) -> np.ndarray:
    """The JAX trainer's `rboxes` of a batch (its `preprocess_batch`, the device copy left out)."""
    monkeypatch.setattr(JT.BaseTrainer, "preprocess_batch", lambda self, b: b)
    return JOBB.OBBTrainer.__new__(JOBB.OBBTrainer).preprocess_batch(batch)["rboxes"]


def _port_rboxes(batch: dict) -> np.ndarray:
    t = OBBTrainer(overrides=dict(model=OBB_N, batch=BATCH, imgsz=IMGSZ, device="cpu"), train_loader=[batch],
                   data={"nc": NC})
    return t.preprocess_batch(batch)["rboxes"].numpy()


def _assert_segments_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=0, atol=PT_ATOL)


def _assert_rboxes_close(got, want):
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=PT_ATOL)
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=0, atol=RAD_ATOL)


def test_obb_labels_and_val_batch_match_jax(obb_data, monkeypatch):
    """Labels (4-point polygons, boxes their extent) and a letterboxed val batch: classes, boxes, `segments_list` and
    the trainer's `rboxes` from it."""
    js, ps = _pair(obb_data, {}, mode="val")
    assert ps.task == "obb" and not ps.use_segments
    for lj, lp in zip(js.labels, ps.labels):
        np.testing.assert_array_equal(lp["cls"], lj["cls"])
        np.testing.assert_array_equal(lp["bboxes_n"], lj["bboxes_n"])
        assert all(s.shape == (4, 2) for s in lp["segments"]) and len(lp["segments"]) == len(lj["segments"])
    jb, pb = (ds.collate([ds[i] for i in range(len(ds))]) for ds in (js, ps))
    np.testing.assert_array_equal(pb["cls"], jb["cls"])
    np.testing.assert_allclose(pb["bboxes"], jb["bboxes"], rtol=0, atol=PT_ATOL)
    _assert_segments_equal(pb["segments_list"], jb["segments_list"])
    assert "masks" not in pb and sum(map(len, pb["segments_list"])) == int(pb["mask"].sum())
    got, want = _port_rboxes(pb), _jax_rboxes(jb, monkeypatch)
    assert got.shape == want.shape == (len(ps), ps.max_labels, 5)
    _assert_rboxes_close(got, want)


@pytest.mark.parametrize("hyp", sorted(HYPS))
def test_augmented_obb_batches_match_jax(obb_data, hyp, monkeypatch):
    """Two epochs of train batches (one loader thread): image files, classes, boxes, the polygons draw for draw, and
    the rotated boxes the trainer makes from them."""
    js, ps = _pair(obb_data, HYPS[hyp])
    jl, pl = jax_dataloader(js, BATCH, 1, shuffle=True, seed=0), build_dataloader(ps, BATCH, 1, shuffle=True, seed=0)
    n, polygons = 0, 0
    for epoch in range(2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        for jb, pb in zip(jl, pl):
            assert jb["im_files"] == pb["im_files"]
            np.testing.assert_array_equal(pb["cls"], jb["cls"])
            np.testing.assert_allclose(pb["bboxes"], jb["bboxes"], rtol=0, atol=PT_ATOL)
            _assert_segments_equal(pb["segments_list"], jb["segments_list"])
            _assert_rboxes_close(_port_rboxes(pb), _jax_rboxes(jb, monkeypatch))
            polygons += sum(map(len, pb["segments_list"]))
            n += 1
    assert n == 6 and polygons > 0


def _crowded_rotated_targets(rng, imgsz: int = 160, slots: int = 24) -> dict:
    """Image 0: 20 rotated boxes of 24-40 px on a 5 x 4 grid; image 1: 3 overlapping ones of 16-60 px."""
    out = {"cls": np.zeros((2, slots), np.float32), "rboxes": np.zeros((2, slots, 5), np.float32),
           "mask": np.zeros((2, slots), np.float32), "bboxes": np.zeros((2, slots, 4), np.float32)}
    for i, n in enumerate((20, 3)):
        if i == 0:
            xy = np.array([[x * 32 + 16, y * 40 + 20] for y in range(4) for x in range(5)], float)
            wh = rng.uniform(24, 40, (n, 2))
        else:
            xy, wh = rng.uniform(30, imgsz - 30, (n, 2)), rng.uniform(16, 60, (n, 2))
        out["rboxes"][i, :n] = np.concatenate([xy, wh, rng.uniform(-np.pi / 2, 0, (n, 1))], 1)
        out["cls"][i, :n] = rng.integers(0, NC, n)
        out["mask"][i, :n] = 1
    return out


def test_rotated_assigner_matches_jax():
    """`assign_rotated` on predicted boxes near and far from the GT (some duplicated, so the top-k has ties): the
    candidates, labels, fg mask and GT indices exactly, target boxes and scores within 1e-5."""
    rng = np.random.default_rng(0)
    t = _crowded_rotated_targets(rng)
    ys, xs = np.mgrid[0:20, 0:20]
    anc = (np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32) + 0.5) * 8
    a = len(anc)
    src = t["rboxes"][:, rng.integers(0, 20, a)]
    pd = src + np.concatenate([rng.normal(0, 4, (2, a, 2)), rng.normal(0, 3, (2, a, 2)), rng.normal(0, 0.3, (2, a, 1))],
                              -1)
    pd[:, 1::7] = pd[:, 0:-1:7][:, : pd[:, 1::7].shape[1]]  # duplicated predictions: tied alignments
    pd = pd.astype(np.float32)
    scores = (1 / (1 + np.exp(-rng.normal(0, 2, (2, a, NC))))).astype(np.float32)
    args = (scores, pd, anc, t["cls"], t["rboxes"], t["mask"])
    want = JTAL.RotatedTaskAlignedAssigner(topk=10, num_classes=NC)(*(jnp.asarray(v) for v in args))
    got = TAL.RotatedTaskAlignedAssigner(topk=10, num_classes=NC)(*(torch.from_numpy(v) for v in args))
    names = ("target_labels", "target_rboxes", "target_scores", "fg_mask", "target_gt_idx")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name in ("target_rboxes", "target_scores"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    assert got[3].sum() > 40  # foreground anchors to compare
    cand = TAL.select_candidates_in_rotated_gts(torch.from_numpy(anc), torch.from_numpy(t["rboxes"]))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(JTAL.select_candidates_in_rotated_gts(
        jnp.asarray(anc), jnp.asarray(t["rboxes"]))))


def _obb_outputs(rng, b: int, imgsz: int, nc: int):
    maps = [(rng.standard_normal((b, 64 + nc, imgsz // s, imgsz // s)) * 1.5).astype(np.float32) for s in (8, 16, 32)]
    a = sum(m.shape[2] * m.shape[3] for m in maps)
    angle = ((1 / (1 + np.exp(-rng.standard_normal((b, a, 1)))) - 0.25) * np.pi).astype(np.float32)
    return maps, angle


def _losses(maps, angle, targets):
    port, ref = OBBModel(OBB_N, nc=NC), JaxOBBModel(OBB_N, nc=NC)
    t = {k: torch.from_numpy(v) for k, v in targets.items()}
    loss, items = v8OBBLoss(port)(([torch.from_numpy(m) for m in maps], torch.from_numpy(angle)), t)
    loss_j, items_j = jax.jit(JaxOBBLoss(ref).__call__)(
        ([jnp.asarray(m.transpose(0, 2, 3, 1)) for m in maps], jnp.asarray(angle)),
        {k: jnp.asarray(v) for k, v in targets.items()})
    return float(loss), items.numpy(), float(loss_j), np.asarray(items_j)


def test_obb_loss_matches_jax(jax_angle_in_pred_box):
    """v8OBBLoss on the same head outputs and targets: the 3 items within 2e-3 of JAX's with the predicted angle in
    the predicted rotated box."""
    rng = np.random.default_rng(1)
    maps, angle = _obb_outputs(rng, 2, 160, NC)
    loss, items, loss_j, items_j = _losses(maps, angle, _crowded_rotated_targets(rng))
    print(f"items {items.tolist()}, JAX {items_j.tolist()}")
    assert np.abs(items_j).min() > 1e-2  # every item carries signal
    np.testing.assert_allclose(items, items_j, rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(loss, loss_j, rtol=LOSS_TOL)


def test_jax_obb_loss_drops_the_predicted_angle():
    """The JAX loss as it stands decodes a 4-column predicted box, and its probiou then reads h^2 / 12 as the angle
    (JAX clamps the out-of-range index): its items differ from the port's, and its box loss does not change when the
    predicted angles are shifted with the centre offsets held (the port's does)."""
    rng = np.random.default_rng(1)
    b4 = jnp.asarray(np.abs(rng.normal(20, 5, (30, 4))).astype(np.float32))
    other = jnp.asarray(np.concatenate([rng.uniform(10, 30, (30, 4)), rng.uniform(0, 1, (30, 1))], 1), jnp.float32)
    as_angle = jnp.concatenate([b4, b4[:, 3:4] ** 2 / 12], -1)
    np.testing.assert_array_equal(np.asarray(JBOX.probiou(b4, other)), np.asarray(JBOX.probiou(as_angle, other)))
    maps, angle = _obb_outputs(rng, 2, 160, NC)
    targets = _crowded_rotated_targets(rng)
    _, items, _, items_j = _losses(maps, angle, targets)
    assert np.abs(items[0] - items_j[0]) > 5 * LOSS_TOL  # the box losses differ
    bins = np.arange(16, dtype=np.float32)[None, :, None, None]
    for m in maps:  # l == r and t == b everywhere: the angle no longer moves the centre, only the box's orientation;
        for side, d in ((0, 2.0), (1, 0.5), (2, 2.0), (3, 0.5)):  # elongated boxes, 4 x 1 cells, whose turn matters
            m[:, 16 * side:16 * side + 16] = -4.0 * (bins - d) ** 2
    turned = angle + np.float32(np.pi / 4)
    base, turned_items = _losses(maps, angle, targets), _losses(maps, turned, targets)
    assert base[3][0] == pytest.approx(turned_items[3][0], rel=1e-6)  # JAX: the same box loss
    assert abs(base[1][0] - turned_items[1][0]) > 10 * LOSS_TOL  # the port: another


def test_obb_head_trains_its_angle_branch():
    """In train mode the OBB head returns (maps, angles (B, A, 1)); the loss reaches cv4, whose BatchNorms take part
    in the batch statistics: 57 + 6 = 63."""
    model = OBBModel(OBB_N, nc=NC)
    model.init(0, imgsz=160)
    model.train()
    rng = np.random.default_rng(2)
    targets = {k: torch.from_numpy(v) for k, v in _crowded_rotated_targets(rng).items()}
    with M.collect_bn_stats() as stats:
        out = model(torch.from_numpy(rng.random((2, 3, 160, 160), dtype=np.float32)))
        maps, angle = out
        assert angle.shape == (2, 400 + 100 + 25, 1)
        loss, items = v8OBBLoss(model)(out, targets)
    loss.backward()
    assert items[0] > 0 and len(stats) == sum(isinstance(m, M.BatchNorm2d) for m in model.modules()) == 63
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in model.head.cv4[0].parameters())


def _obb_batch(rng, b: int = BATCH, imgsz: int = IMGSZ, slots: int = 32) -> dict:
    """A collate-format batch of 1-6 rotated rectangles an image, with `rboxes` and their axis-aligned extents."""
    out = {"img": rng.integers(0, 256, (b, imgsz, imgsz, 3), dtype=np.uint8), "cls": np.zeros((b, slots), np.float32),
           "bboxes": np.zeros((b, slots, 4), np.float32), "mask": np.zeros((b, slots), np.float32),
           "rboxes": np.zeros((b, slots, 5), np.float32)}
    for i in range(b):
        n = int(rng.integers(1, 7))
        r = np.concatenate([rng.uniform(12, imgsz - 12, (n, 2)), rng.uniform(6, 24, (n, 2)),
                            rng.uniform(-np.pi / 2, 0, (n, 1))], 1).astype(np.float32)
        out["rboxes"][i, :n], out["cls"][i, :n], out["mask"][i, :n] = r, rng.integers(0, NC, n), 1
        half = np.abs(np.stack([np.cos(r[:, 4]), np.sin(r[:, 4])], 1))
        ext = np.stack([half[:, 0] * r[:, 2] + half[:, 1] * r[:, 3], half[:, 1] * r[:, 2] + half[:, 0] * r[:, 3]], 1)
        out["bboxes"][i, :n] = np.concatenate([r[:, :2] - ext / 2, r[:, :2] + ext / 2], 1)
    return out


def _close(got: dict, want: dict, names, base: dict):
    for k in names:
        w = np.asarray(want[k])
        atol = STATE_TOL["atol"] + REF_NOISE * np.abs(w - np.asarray(base[k])).max()
        np.testing.assert_allclose(got[k].detach().cpu().numpy(), w, rtol=STATE_TOL["rtol"], atol=atol, err_msg=k)


class _RboxesTrainer(OBBTrainer):
    """The trainer on batches that carry their `rboxes` already (the same inputs for both packages' steps)."""

    def preprocess_batch(self, batch: dict) -> dict:
        return super(OBBTrainer, self).preprocess_batch(batch)


def test_obb_train_step_matches_jax_step_fn(jax_angle_in_pred_box):
    """One SGD step (warmup hyperparameters of batch 50) of OBBTrainer against the JAX step_fn over v8OBBLoss (with
    the predicted angle in the predicted box) from one state: items within 2e-3; params, BN statistics, momentum and
    EMA within rtol 1e-4 and 1e-5 + REF_NOISE of each tensor's largest update. Then the step with s2grad="cuda" and
    bnstats="cuda" (their plain versions on CPU tensors) from the same state.

    The step is a multi-scale one (64 -> 96 px), which shows the departure: the port scales `rboxes` with the image
    (cx, cy, w, h by 1.5, the angle as it was), the JAX step scales `bboxes` and `keypoints` only, so the JAX step is
    given the rotated boxes scaled already, and its loss sees them as given (recorded by a callback)."""
    batch = _obb_batch(np.random.default_rng(3))
    scaled = {**batch, "rboxes": batch["rboxes"] * np.array([1.5, 1.5, 1.5, 1.5, 1.0], np.float32)}
    model = OBBModel(OBB_N, nc=NC)
    model.init(0, imgsz=IMGSZ)
    ref = JaxOBBModel(OBB_N, nc=NC)
    variables = convert_state_dict(ref, model.state_dict())
    start = from_jax_variables(variables)

    def port_trainer(**kw):
        t = _RboxesTrainer(overrides=dict(model=OBB_N, batch=BATCH, imgsz=IMGSZ, nbs=BATCH, device="cpu", amp=False,
                                          optimizer="SGD", **kw), train_loader=[batch], data={"nc": NC})
        t._setup_train()
        return t

    stock = port_trainer()
    assert isinstance(stock.criterion, v8OBBLoss) and stock.loss_names == JOBB.OBBTrainer.loss_names
    rec, crit = {}, JaxOBBLoss(ref)

    def recording(out, targets):
        jax.debug.callback(lambda r, b: rec.update(rb=np.asarray(r), bb=np.asarray(b)), targets["rboxes"],
                           targets["bboxes"])
        return crit(out, targets)

    stub = types.SimpleNamespace(
        model=ref, criterion=recording, accumulate=1, opt_name="SGD", weight_decay=stock.weight_decay,
        device_aug=False, labels=label_tree(variables),
        args=types.SimpleNamespace(amp=False, imgsz=IMGSZ, multi_scale=True, seed=0, sp=1))
    JaxBaseTrainer._build_train_step(stub)
    params = jax.tree_util.tree_map(jnp.asarray, variables)
    state = {"params": params, "opt": init_momentum(params), "ema": jax.tree_util.tree_map(jnp.array, params),
             "acc": jax.tree_util.tree_map(jnp.zeros_like, params), "count": jnp.zeros((), jnp.int32),
             "step": jnp.zeros((), jnp.int32)}
    first = from_jax_train_state(jax.tree_util.tree_map(np.asarray, state))
    hyp = stock._warmup_hyp(50, 0)
    state, _, items_j = stub.train_step(state, scaled, *(jnp.float32(h) for h in hyp), target_sz=96)
    want = from_jax_train_state(state)
    np.testing.assert_allclose(rec["bb"], batch["bboxes"] * 1.5, rtol=1e-6, atol=1e-5)  # the JAX step scaled these
    np.testing.assert_array_equal(rec["rb"], scaled["rboxes"])  # and left these as given
    names = sorted(dict(stock.model.named_parameters()))
    buffers = sorted(set(want["params"]) - set(names))
    for who, trainer in (("stock", stock), ("kernels", port_trainer(s2grad="cuda", bnstats="cuda"))):
        trainer.load_train_state(first)
        seen = {}
        real = trainer.criterion.__call__
        trainer.criterion = lambda out, b: (seen.update(img=b["img"].shape, rb=b["rboxes"].clone()), real(out, b))[1]
        _, items = trainer.train_step(batch, *hyp, size=96)
        assert seen["img"] == (BATCH, 3, 96, 96)
        np.testing.assert_allclose(seen["rb"].numpy(), scaled["rboxes"], rtol=1e-6, atol=1e-5)
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
    cv4 = [k for k in names if ".cv4." in k]
    assert cv4 and all(not torch.equal(stock_state[k], start[k]) for k in cv4 if ".cv4.0." in k)  # positives' level


def test_multi_scale_step_scales_rboxes():
    """A multi-scale step (64 -> 96 px) hands the loss `rboxes` with cx, cy, w, h scaled by 1.5 and the angle as it
    was, with the boxes scaled alike."""
    batch = _obb_batch(np.random.default_rng(4))
    trainer = _RboxesTrainer(overrides=dict(model=OBB_N, batch=BATCH, imgsz=IMGSZ, nbs=BATCH, device="cpu", amp=False,
                                            optimizer="SGD"), train_loader=[batch], data={"nc": NC})
    trainer._setup_train()
    seen = {}
    real = trainer.criterion.__call__
    trainer.criterion = lambda out, b: (seen.update(img=b["img"].shape, rb=b["rboxes"].clone(),
                                                    bb=b["bboxes"].clone()), real(out, b))[1]
    loss, items = trainer.train_step(batch, 0.01, 0.01, 0.9, size=96)
    assert seen["img"] == (BATCH, 3, 96, 96) and torch.isfinite(loss) and items.shape == (3,)
    want = batch["rboxes"] * np.array([1.5, 1.5, 1.5, 1.5, 1.0], np.float32)
    np.testing.assert_allclose(seen["rb"].numpy(), want, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(seen["bb"].numpy(), batch["bboxes"] * 1.5, rtol=1e-6, atol=1e-5)


def test_batch_without_polygons_trains_on_its_boxes(monkeypatch):
    """No image of the batch has polygons (labels without them): the port's rboxes are the axis-aligned boxes at
    angle 0, the JAX trainer's zeros (it falls back only when the batch has no `segments_list`); a batch with some
    polygons gets them from the polygons in both, zero rows for its images without."""
    batch = _obb_batch(np.random.default_rng(5))
    del batch["rboxes"]
    batch["segments_list"] = [[], []]
    got, want = _port_rboxes(batch), _jax_rboxes(batch, monkeypatch)
    live = batch["mask"] > 0
    b = batch["bboxes"][live]
    np.testing.assert_allclose(got[live], np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2, b[:, 2] - b[:, 0],
                                                    b[:, 3] - b[:, 1], 0 * b[:, 0]], 1), rtol=1e-6)
    assert not want.any()
    seg = np.array([[10, 10], [30, 14], [28, 24], [8, 20]], np.float32)
    batch["segments_list"] = [[seg], []]
    got, want = _port_rboxes(batch), _jax_rboxes(batch, monkeypatch)
    _assert_rboxes_close(got, want)
    _assert_rboxes_close(got[0, :1], rboxes_from_segments([seg]))
    assert not got[1].any() and not got[0, 1:].any()


def test_yolo_obb_train_val_predict_and_cli(obb_data, tmp_path, monkeypatch):
    """`YOLO("yolov8n-obb.yaml").train` one epoch with its validation, `val` of the result, `predict` with oriented
    boxes, last.npz in the JAX reader (task obb); `dyt-torch obb train|val|predict`."""
    model = YOLO(OBB_N, device="cpu")
    metrics = model.train(data=obb_data, epochs=1, imgsz=IMGSZ, batch=BATCH, nbs=BATCH, workers=1, amp=False,
                          project=str(tmp_path), name="port", exist_ok=True)
    t = model.trainer
    assert isinstance(t, OBBTrainer) and set(metrics) == {"metrics/precision(B)", "metrics/recall(B)",
                                                          "metrics/mAP50(B)", "metrics/mAP50-95(B)", "fitness"}
    header = (t.save_dir / "results.csv").read_text().splitlines()[0].split(",")
    assert [f"train/{n}" for n in ("box_loss", "cls_loss", "dfl_loss")] == header[1:4]
    assert np.isfinite(t.epoch_stats[0]["loss_items"]).all()
    assert set(model.val(data=obb_data, imgsz=IMGSZ, batch=BATCH, dtype="float32", workers=1)) == set(metrics)
    r = model.predict(np.zeros((72, 96, 3), np.uint8), imgsz=IMGSZ, conf=0.0, max_det=3, dtype="float32")[0]
    assert r.obb.data.shape == (3, 7) and r.obb.xyxyxyxy.shape == (3, 4, 2) and r.boxes is None
    _, _, header = jax_load_checkpoint(t.wdir / "last.npz")
    assert header["task"] == "obb"

    seen = []
    get_stats = OBBValidator.get_stats
    monkeypatch.setattr(OBBValidator, "get_stats", lambda self: seen.append(type(self)) or get_stats(self))
    entrypoint(f"obb train model={OBB_N} data={obb_data} epochs=1 imgsz={IMGSZ} batch={BATCH} nbs={BATCH} "
               f"workers=1 amp=False device=cpu project={tmp_path} name=cli exist_ok=True")
    cli = tmp_path / "cli"
    assert "train/box_loss" in (cli / "results.csv").read_text().splitlines()[0] and seen == [OBBValidator]
    entrypoint(f"obb val model={cli / 'weights' / 'last.npz'} data={obb_data} imgsz={IMGSZ} batch={BATCH} "
               "device=cpu dtype=float32 workers=1")
    assert seen == [OBBValidator] * 2
    img_dir = check_det_dataset(obb_data)["val"]
    entrypoint(f"obb predict model={cli / 'weights' / 'last.npz'} source={img_dir} imgsz={IMGSZ} conf=0.0 "
               f"max_det=3 device=cpu dtype=float32 save_txt=True project={tmp_path} name=pred exist_ok=True")
    labels = sorted((tmp_path / "pred" / "labels").glob("*.txt"))
    assert len(labels) == 4 and all(len(r.split()) == 9 for r in labels[0].read_text().splitlines())
    shutil.rmtree(tmp_path / "pred")

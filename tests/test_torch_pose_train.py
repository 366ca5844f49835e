"""The port's pose training and validation against the JAX package's, on the CPU in float32.

Datasets come from `tests/make_dataset.py:make_pose_dataset` (4 keypoints a box, nc 2, 128 px), with visibilities
0, 1 and 2 drawn into the labels, a non-identity `flip_idx` in the yaml (a flip that does not remap fails), and a
copy whose labels have no visibility column (ndim 2). Held against the JAX package on the same inputs:

- labels and the label cache (both ways), for ndim 3 and 2;
- augmented batches under the same seeds, through the loader for two epochs (mosaic, affine, mixup, both flips):
  keypoints within 1e-4 px, visibility exactly, classes, masks and boxes as `tests/test_torch_dataset.py` holds
  them; each keypoint transform alone on one sample;
- `v8PoseLoss` items within 2e-3 for nk 17 and 4 on seeded head outputs, with an image of more than `max_fg` = 128
  foreground anchors;
- `kpt_iou` and `PoseMetrics` on random stats, exactly;
- `PoseValidator` on fed predictions (GT boxes and keypoints planted), exactly, and end to end on bridged weights
  within 1e-4, in square batches and through `YOLO.val`'s rect batches;
- one pose train step against the JAX `step_fn` within `REF_NOISE` (tests/test_torch_train.py), and the port's step
  with `s2grad="cuda"` and `bnstats="cuda"` (their plain versions on the CPU) against its stock step;
- a multi-scale step scaling the keypoints' x and y as the JAX step does;
- `YOLO(...).train` and `.val`, `results.csv`'s columns, `last.npz` read by the JAX package, the resume state taken
  over bitwise by the port and by the JAX trainer, and `dyt-torch pose train|val`.
"""

import shutil
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import spread_weights, synthetic_pose_batch
from make_dataset import make_pose_dataset
from drone_yolo_tpu import YOLO as JaxYOLO
from drone_yolo_tpu.cfg import get_cfg as jax_get_cfg
from drone_yolo_tpu.data import augment as JA
from drone_yolo_tpu.data.build import build_dataloader as jax_dataloader
from drone_yolo_tpu.data.build import build_yolo_dataset as jax_dataset
from drone_yolo_tpu.data.utils import check_det_dataset as jax_check
from drone_yolo_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from drone_yolo_tpu.engine.trainer import BaseTrainer as JaxBaseTrainer
from drone_yolo_tpu.models.yolo.pose import OKS_SIGMA_NP
from drone_yolo_tpu.models.yolo.pose import PoseTrainer as JaxPoseTrainer
from drone_yolo_tpu.models.yolo.pose import PoseValidator as JaxPoseValidator
from drone_yolo_tpu.nn import modules as JM
from drone_yolo_tpu.nn.model import PoseModel as JaxPoseModel
from drone_yolo_tpu.ops.nms import non_max_suppression as jax_nms
from drone_yolo_tpu.utils import metrics as JMET
from drone_yolo_tpu.utils.loss import v8PoseLoss as JaxPoseLoss
from drone_yolo_tpu.utils.optimizer import init_momentum, label_tree
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.cfg import entrypoint, get_train_cfg, get_val_cfg
from drone_yolo_tpu_torch.data import augment as A
from drone_yolo_tpu_torch.data.build import build_dataloader, build_yolo_dataset
from drone_yolo_tpu_torch.data.utils import check_det_dataset
from drone_yolo_tpu_torch.engine.checkpoint import from_jax_train_state, from_jax_variables, to_jax_variables
from drone_yolo_tpu_torch.models.yolo.pose import PoseTrainer, PoseValidator
from drone_yolo_tpu_torch.nn import modules as M
from drone_yolo_tpu_torch.nn.model import PoseModel
from drone_yolo_tpu_torch.utils import metrics as MET
from drone_yolo_tpu_torch.utils.loss import v8PoseLoss

torch.set_num_threads(1)

POSE_N = "yolov8n-pose.yaml"
NK, NC, BATCH, IMGSZ = 4, 2, 2, 64
FLIP_IDX = [2, 1, 0, 3]  # make_pose_dataset's points lie at 0, 90, 180 and 270 degrees: a mirror swaps 0 and 2
KPT_ATOL = 1e-4  # px, the bar tests/test_torch_dataset.py holds boxes to
LOSS_TOL = 2e-3  # tests/test_torch_train.py
STATE_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_train.py
REF_NOISE = 5e-3  # tests/test_torch_train.py: four times the JAX step's measured float32 error
VAL_ARGS = dict(conf=0.001, iou=0.7, max_det=300, pre_nms_topk=4096)
HYPS = {"default": {}, "mixup_flipud": {"mixup": 1.0, "flipud": 0.5}, "rotate_shear": {"degrees": 30.0, "shear": 5.0,
                                                                                        "scale": 0.9, "translate": 0.3}}


def _relabel(root, ndim: int, seed: int) -> None:
    """Visibilities 2, 1 or 0 drawn for every point of `root`'s labels; with ndim 2 the column dropped."""
    rng = np.random.default_rng(seed)
    for f in sorted(root.glob("labels/*/*.txt")):
        rows = []
        for line in f.read_text().splitlines():
            v = line.split()
            pts = [v[5 + 3 * j: 8 + 3 * j] for j in range(NK)]
            for p in pts:
                p[2] = str(rng.choice([2, 1, 0], p=[0.6, 0.2, 0.2]))
            rows.append(" ".join(v[:5] + [x for p in pts for x in (p if ndim == 3 else p[:2])]))
        f.write_text("\n".join(rows) + "\n")
    y = root / "data.yaml"
    text = "".join(f"path: {root.resolve()}\n" if line.startswith("path:") else line + "\n"
                   for line in y.read_text().splitlines())
    y.write_text(text.replace(f"kpt_shape: [{NK}, 3]", f"kpt_shape: [{NK}, {ndim}]")
                 .replace(f"flip_idx: {list(range(NK))}", f"flip_idx: {FLIP_IDX}"))


@pytest.fixture(scope="module")
def pose_data(tmp_path_factory):
    """{3: the yaml of a pose set with visibilities, 2: the same images with x, y only, "rect": a val set of four
    aspect ratios}."""
    root = tmp_path_factory.mktemp("pose")
    make_pose_dataset(root / "d3", n_val=4, nc=NC, seed=0, size=128, nkpt=NK, n_train=6)
    shutil.copytree(root / "d3", root / "d2")
    for ndim in (3, 2):
        _relabel(root / f"d{ndim}", ndim, seed=ndim)
        assert f"flip_idx: {FLIP_IDX}" in (root / f"d{ndim}" / "data.yaml").read_text()
    rect = root / "rect"
    rng = np.random.default_rng(1)
    for split in ("train", "val"):
        (rect / "images" / split).mkdir(parents=True)
        (rect / "labels" / split).mkdir(parents=True)
    for i, (h, w) in enumerate([(64, 160), (160, 96), (96, 160), (160, 64)]):
        cv2.imwrite(str(rect / "images" / "val" / f"{i}.jpg"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        rows = []
        for j in range(2):
            c, bw, bh = rng.uniform(0.3, 0.7, 2), *rng.uniform(0.2, 0.5, 2)
            pts = c + (rng.random((NK, 2)) - 0.5) * [bw, bh]
            rows.append(" ".join(map(str, [j % NC, *c, bw, bh, *np.concatenate([pts, np.full((NK, 1), 2)], 1).ravel()])))
        (rect / "labels" / "val" / f"{i}.txt").write_text("\n".join(rows) + "\n")
    cv2.imwrite(str(rect / "images" / "train" / "t.jpg"), np.zeros((64, 64, 3), np.uint8))
    (rect / "data.yaml").write_text(f"path: {rect}\ntrain: images/train\nval: images/val\nkpt_shape: [{NK}, 3]\n"
                                    f"flip_idx: {FLIP_IDX}\nnames:\n  0: a\n  1: b\n")
    return {3: str(root / "d3" / "data.yaml"), 2: str(root / "d2" / "data.yaml"), "rect": str(rect / "data.yaml")}


def _pair(yaml: str, hyp: dict, mode: str = "train", imgsz: int = IMGSZ):
    jd, pd = jax_check(yaml), check_det_dataset(yaml)
    ja = jax_get_cfg(overrides=dict(imgsz=imgsz, batch=BATCH, task="pose", **hyp))
    pa = (get_train_cfg if mode == "train" else get_val_cfg)(overrides=dict(imgsz=imgsz, batch=BATCH, device="cpu",
                                                                            task="pose", **hyp))
    return jax_dataset(ja, jd[mode], BATCH, jd, mode=mode), build_yolo_dataset(pa, pd[mode], BATCH, pd, mode=mode)


def _same_keypoints(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=KPT_ATOL)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("ndim", [3, 2])
def test_labels_and_cache_match_jax(pose_data, ndim, writer):
    """Labels (with keypoints, ndim 2 given visibility 1) equal; the cache written by one package is read unchanged by
    the other."""
    yaml = pose_data[ndim]
    cache = next(iter(check_det_dataset(yaml)["path"].glob("labels/val.cache.npz")), None)
    if cache is not None:
        cache.unlink()
    order = [(jax_dataset, "jax"), (build_yolo_dataset, "port")]
    if writer == "port":
        order.reverse()
    built = {}
    for _, who in order:
        stamp = cache.stat().st_mtime_ns if cache is not None and cache.exists() else None
        built[who] = _pair(yaml, {}, mode="val")[0 if who == "jax" else 1]
        cache = check_det_dataset(yaml)["path"] / "labels" / "val.cache.npz"
        if stamp is not None:
            assert cache.stat().st_mtime_ns == stamp  # read, not rewritten
    j, p = built["jax"], built["port"]
    assert p.kpt_shape == j.kpt_shape == [NK, ndim] and p.flip_idx == j.flip_idx == FLIP_IDX
    assert len(p.labels) == len(j.labels) == 4
    for lj, lp in zip(j.labels, p.labels):
        assert lj["im_file"] == lp["im_file"]
        np.testing.assert_array_equal(lp["cls"], lj["cls"])
        np.testing.assert_array_equal(lp["bboxes_n"], lj["bboxes_n"])
        np.testing.assert_array_equal(lp["keypoints"], lj["keypoints"])
        assert lp["keypoints"].shape[1:] == (NK, 3)
        if ndim == 2:
            assert (lp["keypoints"][..., 2] == 1).all()
    pb, jb = (ds.collate([ds[i] for i in range(len(ds))]) for ds in (p, j))
    _same_keypoints(pb["keypoints"], jb["keypoints"])
    np.testing.assert_allclose(pb["bboxes"], jb["bboxes"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("hyp", sorted(HYPS))
def test_augmented_batches_match_jax(pose_data, hyp):
    """Two epochs of train batches (one loader thread): image files, classes, masks, boxes and keypoints."""
    js, ps = _pair(pose_data[3], HYPS[hyp])
    assert ps.max_labels == js.max_labels
    jl, pl = jax_dataloader(js, BATCH, 1, shuffle=True, seed=0), build_dataloader(ps, BATCH, 1, shuffle=True, seed=0)
    n, zeroed = 0, 0
    for epoch in range(2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        for jb, pb in zip(jl, pl):
            assert jb["im_files"] == pb["im_files"]
            np.testing.assert_array_equal(pb["cls"], jb["cls"])
            np.testing.assert_array_equal(pb["mask"], jb["mask"])
            np.testing.assert_allclose(pb["bboxes"], jb["bboxes"], rtol=0, atol=1e-4)
            assert pb["keypoints"].shape == (BATCH, ps.max_labels, NK, 3) and pb["keypoints"].dtype == np.float32
            _same_keypoints(pb["keypoints"], jb["keypoints"])
            assert np.abs(pb["img"].astype(int) - jb["img"]).max() <= 1
            live = pb["keypoints"][pb["mask"] > 0]
            zeroed += int((live[..., 2] == 0).sum())
            n += 1
    assert n == 6 and zeroed > 0


def test_keypoint_transforms_match_jax():
    """Each transform alone on one sample with points inside, on the edge and outside the frame: flips (with and
    without flip_idx), the affine (points it moves out keep their coordinates, visibility 0), letterbox, clip,
    mosaic's and mixup's concatenation order."""
    rng = np.random.default_rng(3)

    def sample():
        boxes = np.array([[10, 12, 60, 70], [40, 5, 90, 50], [0, 0, 3, 100]], np.float32)
        k = np.concatenate([rng.uniform(-5, 105, (3, NK, 2)), rng.choice([0.0, 1.0, 2.0], (3, NK, 1))], -1)
        return {"img": rng.integers(0, 256, (80, 100, 3), dtype=np.uint8), "cls": np.array([0.0, 1.0, 1.0], np.float32),
                "bboxes": boxes, "keypoints": k.astype(np.float32)}

    cases = [(A.RandomFlip(1.0, "horizontal", FLIP_IDX), JA.RandomFlip(1.0, "horizontal", FLIP_IDX)),
             (A.RandomFlip(1.0, "horizontal"), JA.RandomFlip(1.0, "horizontal")),
             (A.RandomFlip(1.0, "vertical", FLIP_IDX), JA.RandomFlip(1.0, "vertical", FLIP_IDX)),
             (A.RandomPerspective(degrees=40, translate=0.3, scale=0.5, shear=10),
              JA.RandomPerspective(degrees=40, translate=0.3, scale=0.5, shear=10)),
             (A.LetterBoxT((96, 64)), JA.LetterBoxT((96, 64))),
             (lambda s: A.clip_sample(s, (60, 70)), lambda s: JA.clip_sample(s, (60, 70)))]
    for i, (port_t, jax_t) in enumerate(cases):
        base = sample()
        A.seed_sample(0, 0, i)
        got = port_t({k: v.copy() for k, v in base.items()})
        JA.seed_sample(0, 0, i)
        want = jax_t({k: v.copy() for k, v in base.items()})
        np.testing.assert_array_equal(got["cls"], want["cls"])
        np.testing.assert_allclose(got["bboxes"], want["bboxes"], rtol=0, atol=1e-4)
        _same_keypoints(got["keypoints"], want["keypoints"])
        assert np.array_equal(got["img"], want["img"]) or i == 3  # the warp: ops/image.py within 1 of cv2
        if i == 0:  # the remap moved point 0's mirror image into slot 2
            np.testing.assert_allclose(got["keypoints"][:, 2, 0], 100 - base["keypoints"][:, 0, 0], atol=1e-4)
        if i == 3:
            assert (got["keypoints"][..., 2] == 0).sum() > (base["keypoints"][..., 2] == 0).sum()


def _seeded_outputs(rng, b: int, imgsz: int, nk: int, nc: int):
    """Head outputs of a pose model: per level (B, 64 + nc, H, W) maps (DFL logits, class logits) and (B, A, nk * 3)
    raw keypoints, seeded normals."""
    maps = [(rng.standard_normal((b, 64 + nc, imgsz // s, imgsz // s)) * 1.5).astype(np.float32) for s in (8, 16, 32)]
    a = sum(m.shape[2] * m.shape[3] for m in maps)
    return maps, (rng.standard_normal((b, a, nk * 3)) * 0.5).astype(np.float32)


def _crowded_targets(rng, nk: int, imgsz: int = 160, slots: int = 32) -> dict:
    """Image 0: a 5 x 4 grid of 20 boxes of 32 x 40 px (10 top-k anchors each: more than 128 foreground anchors);
    image 1: 3 random boxes. Keypoints inside the boxes, visibility 2, 1 or 0."""
    boxes = np.zeros((2, slots, 4), np.float32)
    mask = np.zeros((2, slots), np.float32)
    grid = [[x * 32, y * 40, x * 32 + 32, y * 40 + 40] for y in range(4) for x in range(5)]
    boxes[0, :20], mask[0, :20] = grid, 1
    xy = rng.uniform(0, imgsz * 0.6, (3, 2))
    boxes[1, :3], mask[1, :3] = np.concatenate([xy, xy + rng.uniform(20, 60, (3, 2))], 1), 1
    u = rng.random((2, slots, nk, 2))
    kxy = boxes[:, :, None, :2] + u * (boxes[:, :, None, 2:] - boxes[:, :, None, :2])
    vis = rng.choice([2.0, 1.0, 0.0], (2, slots, nk, 1), p=[0.6, 0.2, 0.2])
    kpts = (np.concatenate([kxy, vis], -1) * mask[:, :, None, None]).astype(np.float32)
    return {"cls": np.zeros((2, slots), np.float32), "bboxes": boxes, "mask": mask, "keypoints": kpts}


@pytest.mark.parametrize("nk", [17, 4])
def test_pose_loss_matches_jax(nk):
    """v8PoseLoss on the same head outputs and targets: the 5 items within 2e-3 of JAX's (COCO sigmas for 17 points,
    uniform for 4); image 0 has more than max_fg = 128 foreground anchors, so the cap decides which carry the
    keypoint losses."""
    rng = np.random.default_rng(nk)
    maps, kpt = _seeded_outputs(rng, 2, 160, nk, 1)
    targets = _crowded_targets(rng, nk)
    port = PoseModel(POSE_N, nc=1, data_kpt_shape=(nk, 3))
    ref = JaxPoseModel(POSE_N, nc=1, data_kpt_shape=(nk, 3))
    crit = v8PoseLoss(port)
    t = {k: torch.from_numpy(v) for k, v in targets.items()}
    feats = [torch.from_numpy(m) for m in maps]
    fg = crit._detect_parts(feats, t)["fg_mask"].sum(1)
    assert int(fg[0]) > crit.max_fg == 128 and int(fg[1]) > 0
    loss, items = crit((feats, torch.from_numpy(kpt)), t)
    loss_j, items_j = jax.jit(JaxPoseLoss(ref).__call__)(
        ([jnp.asarray(m.transpose(0, 2, 3, 1)) for m in maps], jnp.asarray(kpt)), {k: jnp.asarray(v) for k, v in targets.items()})
    print(f"nk {nk}: items {items.tolist()}, JAX {np.asarray(items_j).tolist()}")
    assert np.abs(np.asarray(items_j)).min() > 1e-2  # every item carries signal
    np.testing.assert_allclose(items.numpy(), np.asarray(items_j), rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=LOSS_TOL)


def test_kpt_iou_and_pose_metrics_match_jax():
    rng = np.random.default_rng(0)
    gt = np.concatenate([rng.uniform(0, 100, (5, 17, 2)), rng.choice([0.0, 1.0, 2.0], (5, 17, 1))], -1)
    pred = gt[rng.integers(0, 5, 9)][..., :2] + rng.normal(0, 4, (9, 17, 2))
    area = rng.uniform(100, 2000, 5)
    for nk in (17, 4):
        got = MET.kpt_iou(gt[:, :nk], pred[:, :nk], area, MET.kpt_sigmas(nk))
        want = JMET.kpt_iou(gt[:, :nk], pred[:, :nk], area, OKS_SIGMA_NP if nk == 17 else np.ones(nk) / nk)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)
        assert got.shape == (5, 9) and 0 < got.max() <= 1
    n = 200
    stats = (rng.random((n, 10)) < 0.6, rng.random((n, 10)) < 0.4, rng.random(n), rng.integers(0, 3, n),
             rng.integers(0, 3, 150))
    got, want = MET.PoseMetrics({0: "a", 1: "b", 2: "c"}), JMET.PoseMetrics({0: "a", 1: "b", 2: "c"})
    got.process(*stats)
    want.process(*stats)
    assert got.keys == want.keys and len(got.keys) == 8
    np.testing.assert_array_equal(got.mean_results(), want.mean_results())
    assert got.fitness == want.fitness == got.box.fitness() + got.pose.fitness()
    np.testing.assert_array_equal(got.maps, want.maps)


class _Facade:
    def __init__(self, model, variables):
        self.model, self.variables = model, variables

    def ensure_variables(self, imgsz=640, seed=0):
        return self.variables


class _FedJax(JaxPoseValidator):
    def __init__(self, preds, **kw):
        super().__init__(**kw)
        self.fed = list(preds)

    def _forward(self, shape):
        a = self.args
        return lambda variables, x: jax_nms(self.fed.pop(0), conf_thres=a.conf, iou_thres=a.iou, max_det=a.max_det,
                                            pre_topk=a.pre_nms_topk, nc=self.nc, multi_label=True)


class _FedPort(PoseValidator):
    def __init__(self, preds, *a, **kw):
        super().__init__(*a, **kw)
        self.fed = list(preds)

    def forward(self, x):
        return self.fed.pop(0)


@pytest.fixture(scope="module")
def val_case(pose_data):
    """(port model, JAX model, JAX variables, square val batches from the JAX dataset at imgsz 96) on spread
    weights with the class priors zeroed (scores O(1): every candidate passes conf 0.001)."""
    jd = jax_check(pose_data[3])
    cfg = jax_get_cfg(overrides={"imgsz": 96, "task": "pose", "mode": "val", "rect": False})
    batches = list(jax_dataloader(jax_dataset(cfg, jd["val"], 4, jd, mode="val"), 4, 0, shuffle=False,
                                  drop_last=False))
    port = PoseModel(POSE_N, nc=NC, data_kpt_shape=(NK, 3))
    port.init(0, imgsz=96)
    sd = spread_weights(port.state_dict(), np.random.default_rng(5))
    for i in range(len(port.head.cv3)):
        sd[f"model.{len(port.model) - 1}.cv3.{i}.2.bias"].zero_()
    port.load_state_dict(sd)
    ref = JaxPoseModel(POSE_N, nc=NC, data_kpt_shape=(NK, 3))
    return port, ref, convert_state_dict(ref, port.state_dict()), batches


def _plant(preds: np.ndarray, batch: dict, rng) -> np.ndarray:
    """Each GT box and its keypoints planted at a random anchor, jittered by up to ~10% of the box, at a score of 0.5-1 for
    its class (80%) or another; keypoint visibilities high where the GT's are labelled."""
    out = preds.copy()
    for i in range(len(out)):
        live = batch["mask"][i] > 0
        gt, cls, kp = batch["bboxes"][i][live], batch["cls"][i][live].astype(int), batch["keypoints"][i][live]
        anchors = rng.choice(out.shape[1], len(gt), replace=False)
        wh = gt[:, 2:] - gt[:, :2]
        xy = (gt[:, :2] + gt[:, 2:]) / 2 + rng.normal(0, 0.05, (len(gt), 2)) * wh
        out[i, anchors, :4] = np.concatenate([xy, wh * rng.uniform(0.9, 1.1, (len(gt), 2))], 1)
        out[i, anchors, 4 + np.where(rng.random(len(gt)) < 0.8, cls, (cls + 1) % NC)] = rng.uniform(0.5, 1.0, len(gt))
        pk = kp.copy()
        pk[..., :2] += rng.normal(0, 0.08, pk[..., :2].shape) * wh[:, None, :]
        pk[..., 2] = np.where(kp[..., 2] > 0, 0.9, 0.1)
        out[i, anchors, 4 + NC:] = pk.reshape(len(gt), -1)
    return out


def _jax_args(**kw):
    return dict(VAL_ARGS, imgsz=96, batch=4, half=False, plots=False, save_json=False, verbose=False, task="pose",
                mode="val", **kw)


def test_pose_validator_matches_jax_on_fed_predictions(val_case, tmp_path):
    port, ref, variables, batches = val_case
    fused = ref.fuse(variables)
    fwd = jax.jit(lambda v, x: ref.apply(v, x, ctx=JM.Ctx(train=False, dtype=jnp.float32))[0])
    rng = np.random.default_rng(6)
    preds = [_plant(np.asarray(fwd(fused, jnp.asarray(b["img"].astype(np.float32) / 255.0))), b, rng) for b in batches]
    assert preds[0].shape[2] == 4 + NC + NK * 3
    want = _FedJax(preds, dataloader=batches, save_dir=tmp_path, args=_jax_args())(model=_Facade(ref, variables))
    val = _FedPort([torch.from_numpy(p) for p in preds], batches,
                   args=dict(VAL_ARGS, imgsz=96, device="cpu", dtype="float32", verbose=False))
    got = val(model=port)
    print(f"fed predictions: port {got}, JAX {want}")
    assert got == want and len(got) == 9
    assert 0.1 < got["metrics/mAP50-95(B)"] < 0.9 and 0.1 < got["metrics/mAP50-95(P)"] < 0.9  # something to find


@pytest.mark.parametrize("batches_of", ["square", "rect"])
def test_pose_validator_matches_jax_end_to_end(val_case, pose_data, tmp_path, batches_of):
    """Each package's own forward on the same weights (float32): the 8 metrics and fitness within 1e-4. square: the
    validators over the JAX dataset's batches; rect: `YOLO.val` of one npz (rect batches of 2, each at its shape)."""
    port, ref, variables, batches = val_case
    if batches_of == "square":
        jax_val = JaxPoseValidator(dataloader=batches, save_dir=tmp_path, args=_jax_args())
        want = jax_val(model=_Facade(ref, variables))
        val = PoseValidator(batches, args=dict(VAL_ARGS, imgsz=96, device="cpu", dtype="float32", verbose=False))
        got = val(model=port)
        assert sum(len(c) for c in val.stats["conf"]) > 0
    else:
        facade = YOLO(POSE_N, device="cpu")
        facade.model, facade.initialized = port, True
        facade.save(tmp_path / "m.npz")
        args = dict(data=pose_data["rect"], imgsz=96, batch=2, plots=False, verbose=False)
        p = YOLO(tmp_path / "m.npz", device="cpu")
        got = p.val(dtype="float32", workers=1, **args)
        r = JaxYOLO(str(tmp_path / "m.npz")).val(**args)
        want = {**dict(zip(r.keys, r.mean_results())), "fitness": r.fitness() if callable(r.fitness) else r.fitness}
        assert [tuple(s) for s in p.validator.dataloader.dataset.batch_shapes] == [(96, 128), (128, 96)]
    print(f"end to end ({batches_of}): port {got}, JAX {want}")
    assert set(got) == set(want) and len(got) == 9
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])


def test_pose_head_trains_its_keypoint_branch():
    """In train mode the Pose head returns (maps, raw keypoints (B, A, nk)); the loss reaches cv4, and
    cv4's BatchNorms take part in the batch statistics."""
    model = PoseModel(POSE_N, nc=1, data_kpt_shape=(NK, 3))
    model.init(0, imgsz=IMGSZ)
    model.train()
    batch = synthetic_pose_batch(np.random.default_rng(0), BATCH, IMGSZ, 1, NK)
    with M.collect_bn_stats() as stats:
        out = model(torch.from_numpy(batch["img"].transpose(0, 3, 1, 2).astype(np.float32) / 255.0))
        maps, kpt = out
        assert [m.shape[2] for m in maps] == [8, 4, 2] and kpt.shape == (BATCH, 84, NK * 3)
        loss, _ = v8PoseLoss(model)(out, {k: torch.from_numpy(v) for k, v in batch.items() if k != "img"})
    loss.backward()
    cv4 = model.head.cv4  # every level is in the graph; at 64 px the foreground anchors lie on level 0 (stride 8)
    assert all(p.grad is not None for p in cv4.parameters())
    assert all(p.grad.abs().sum() > 0 for p in cv4[0].parameters())
    assert sum(isinstance(m, M.BatchNorm2d) for m in cv4.modules()) == 6
    assert len(stats) == sum(isinstance(m, M.BatchNorm2d) for m in model.modules())


def _close(got: dict, want: dict, names, base: dict):
    for k in names:
        w = np.asarray(want[k])
        atol = STATE_TOL["atol"] + REF_NOISE * np.abs(w - np.asarray(base[k])).max()
        np.testing.assert_allclose(got[k].detach().cpu().numpy(), w, rtol=STATE_TOL["rtol"], atol=atol, err_msg=k)


def test_pose_train_step_matches_jax_step_fn():
    """One SGD step (warmup hyperparameters of batch 50) of PoseTrainer against the JAX step_fn over v8PoseLoss from
    one state: items within 2e-3; params, BN statistics, momentum and EMA within rtol 1e-4 and 1e-5 + REF_NOISE of
    each tensor's largest update. Then the port's step with s2grad="cuda" and bnstats="cuda" (their plain versions on
    CPU tensors) from the same state: the same state within the same bar."""
    batch = synthetic_pose_batch(np.random.default_rng(1), BATCH, IMGSZ, 1, NK)
    model = PoseModel(POSE_N, nc=1, data_kpt_shape=(NK, 3))
    model.init(0, imgsz=IMGSZ)
    ref = JaxPoseModel(POSE_N, nc=1, data_kpt_shape=(NK, 3))
    variables = convert_state_dict(ref, model.state_dict())
    start = from_jax_variables(variables)

    def port_trainer(**kw):
        t = PoseTrainer(overrides=dict(model=POSE_N, batch=BATCH, imgsz=IMGSZ, nbs=BATCH, device="cpu", amp=False,
                                       optimizer="SGD", **kw), train_loader=[batch], data={"nc": 1, "kpt_shape": [NK, 3]})
        t._setup_train()
        return t

    stock = port_trainer()
    assert isinstance(stock.criterion, v8PoseLoss) and stock.loss_names == JaxPoseTrainer.loss_names
    stub = types.SimpleNamespace(
        model=ref, criterion=JaxPoseLoss(ref), accumulate=1, opt_name="SGD", weight_decay=stock.weight_decay,
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
    level0 = [k for k in names if ".cv4.0." in k]  # the keypoint branch trains (the batch's foreground is on level 0)
    assert level0 and all(not torch.equal(stock_state[k], start[k]) for k in level0)


def test_multi_scale_step_scales_keypoints():
    """`multi_scale`: the criterion sees the batch resized to 96 with boxes and keypoints' x, y times 1.5 and the
    visibility unchanged, as the JAX step's `concatenate([kp[..., :2] * scale, kp[..., 2:]])`."""
    batch = synthetic_pose_batch(np.random.default_rng(0), BATCH, IMGSZ, 1, NK)
    trainer = PoseTrainer(overrides=dict(model=POSE_N, batch=BATCH, imgsz=IMGSZ, nbs=BATCH, device="cpu", amp=False,
                                         multi_scale=True), train_loader=[batch], data={"nc": 1, "kpt_shape": [NK, 3]})
    trainer._setup_train()
    seen = {}
    real = trainer.criterion.__call__
    trainer.criterion = lambda out, b: (seen.update(img=b["img"].shape, kpts=b["keypoints"].clone()), real(out, b))[1]
    loss, items = trainer.train_step(batch, 0.01, 0.01, 0.9, size=96)
    kp = jnp.asarray(batch["keypoints"])
    want = jnp.concatenate([kp[..., :2] * (96 / IMGSZ), kp[..., 2:]], axis=-1)
    assert seen["img"] == (BATCH, 3, 96, 96) and torch.isfinite(loss) and items.shape == (5,)
    np.testing.assert_allclose(seen["kpts"].numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def test_yolo_pose_train_val_checkpoints_and_cli(pose_data, tmp_path, monkeypatch):
    """`YOLO(...).train` one epoch, then `.val`: results.csv has the JAX trainer's columns; last.npz loads in the JAX
    package with the trained EMA and a (4, 3) head; the resume state resumes the port bitwise and the JAX trainer with
    equal arrays; `dyt-torch pose train` and `pose val` run the pose trainer and validator."""
    common = dict(imgsz=IMGSZ, batch=BATCH, nbs=BATCH, workers=1, amp=False, optimizer="SGD", exist_ok=True,
                  project=str(tmp_path))
    m = YOLO(POSE_N, device="cpu")
    metrics = m.train(data=pose_data[3], epochs=1, name="p", **common)
    t = m.trainer
    assert isinstance(t, PoseTrainer) and m.model.head.kpt_shape == (NK, 3) and m.model.nc == NC
    header = (t.save_dir / "results.csv").read_text().splitlines()[0].split(",")
    assert header == ["epoch", *(f"train/{n}" for n in JaxPoseTrainer.loss_names), "lr", *JMET.PoseMetrics().keys,
                      "fitness"]
    assert set(metrics) == set(header[7:])
    again = m.val(data=pose_data[3], imgsz=IMGSZ, batch=BATCH, dtype="float32", workers=1)
    assert set(again) == set(metrics) and isinstance(m.validator, PoseValidator)

    jmodel, jvars, jheader = jax_load_checkpoint(t.wdir / "last.npz")
    assert jheader["task"] == "pose" and tuple(jmodel.head.kpt_shape) == (NK, 3) and jmodel.nc == NC
    want = to_jax_variables(t.final_state)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(jvars)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[k]), flat_want[k], err_msg=str(k))

    final = t.train_state()
    back = PoseTrainer(overrides=dict(model=POSE_N, data=pose_data[3], epochs=2, device="cpu", name="r",
                                      resume=str(t.wdir / "resume_state.npz"), **common))
    back._setup_train()
    got = back.train_state()
    assert back.start_epoch == 1 and (got["step"], got["count"]) == (final["step"], final["count"])
    for part in ("params", "ema"):
        for k, v in final[part].items():
            assert torch.equal(got[part][k], v.detach()), f"{part} {k}"
    for k, v in final["opt"]["momentum"].items():
        assert torch.equal(got["opt"]["momentum"][k], v), k
    jt = JaxPoseTrainer(overrides=dict(model=POSE_N, data=pose_data[3], epochs=2, name="j", task="pose", plots=False,
                                       resume=str(t.wdir / "resume_state.npz"), device="0", **common))
    jt._setup_train()
    js = from_jax_train_state({**jax.tree_util.tree_map(np.asarray, jax.device_get(jt.state)),
                               "acc": jax.device_get(jt.state["params"])})
    assert jt.start_epoch == 1 and js["step"] == final["step"]
    for k, v in final["params"].items():
        assert torch.equal(js["params"][k], v.detach()), k

    seen = []
    get_stats = PoseValidator.get_stats
    monkeypatch.setattr(PoseValidator, "get_stats", lambda self: seen.append(type(self)) or get_stats(self))
    entrypoint(f"pose train model={POSE_N} data={pose_data[2]} epochs=1 imgsz={IMGSZ} batch={BATCH} nbs={BATCH} "
               f"workers=1 amp=False device=cpu project={tmp_path} name=cli exist_ok=True")
    cli = tmp_path / "cli"
    assert "train/pose_loss" in (cli / "results.csv").read_text().splitlines()[0] and seen == [PoseValidator]
    entrypoint(f"pose val model={cli / 'weights' / 'last.npz'} data={pose_data[2]} imgsz={IMGSZ} batch={BATCH} "
               "device=cpu dtype=float32 workers=1")
    assert seen == [PoseValidator, PoseValidator]

"""The port's oriented box ops, model, NMS, results, predictor and validator against the JAX package's, on the CPU in
float32.

`yolov8n-obb.yaml` (nc 3) from one set of weights (the port's seeded init, class logits that follow the image by
`chip_smoke.scored_weights`), crossed to JAX by `convert_state_dict`. Held against the JAX package (and through it
against cv2):

- `probiou` (both branches, and its gradient), `dist2rbox` (relative), `xywhr2xyxyxyxy` and `regularize_rboxes`
  within 1e-6;
- `min_area_rect` against `cv2.minAreaRect` on 2,400 seeded point sets: random, integer, clipped, exactly collinear
  and repeated points, rotated rectangles at random and exact angles (0, 45, 90 degrees), clipped to the frame and
  rounded, axis-aligned integer rectangles: centre and size within 1e-4 px and the angle within 1e-5 rad (so the same
  w, h branch), most of them bit for bit; `xyxyxyxy2xywhr` and the trainer's rotated boxes against the JAX functions;
- the OBB head's decoded output and angles within 1e-4 (eval), its maps and angles (train) within 1e-4 of a float64
  run and 1e-3 of JAX's; the weight bridge both ways;
- `nms_rotated` keep sets exactly equal to JAX's, best class and multi-label, on boxes built with tied scores and
  overlaps near the threshold;
- `OBB` in `Results` (corners, normalised corners, extent) and `verbose`; where the port departs (ROADMAP queue 3):
  `save_txt` writes corner rows where JAX writes nothing, `summary` gives the corners, a frame without detections
  has an empty `OBB`;
- `OBBPredictor` through both facades on frames of mixed shapes; `OBBMetrics`; `OBBValidator` on fed predictions
  exactly and end to end (`YOLO.val`, rect batches) within 1e-4;
- the task's registration and the refusal of `YOLO.track` for an obb model.
"""

import math

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import scored_weights, spread_weights
from make_dataset import make_obb_dataset
from drone_yolo_tpu import YOLO as JaxYOLO
from drone_yolo_tpu.cfg import get_cfg as jax_get_cfg
from drone_yolo_tpu.data.build import build_dataloader as jax_dataloader
from drone_yolo_tpu.data.build import build_yolo_dataset as jax_dataset
from drone_yolo_tpu.data.utils import check_det_dataset as jax_check
from drone_yolo_tpu.engine import results as jax_results
from drone_yolo_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from drone_yolo_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from drone_yolo_tpu.models.yolo import obb as JOBB
from drone_yolo_tpu.nn import modules as JM
from drone_yolo_tpu.nn.model import OBBModel as JaxOBBModel
from drone_yolo_tpu.nn.model import guess_model_task as jax_guess_task
from drone_yolo_tpu.ops import anchors as JANC
from drone_yolo_tpu.ops import boxes as JBOX
from drone_yolo_tpu.ops import convert as JCONV
from drone_yolo_tpu.ops.nms import nms_rotated as jax_nms_rotated
from drone_yolo_tpu.utils import metrics as JMET
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.engine import results
from drone_yolo_tpu_torch.engine.checkpoint import flatten_tree, from_jax_variables, to_jax_variables
from drone_yolo_tpu_torch.models.yolo import TASK_MAP
from drone_yolo_tpu_torch.models.yolo.obb import OBBPredictor, OBBValidator, rboxes_from_segments
from drone_yolo_tpu_torch.nn import modules as M
from drone_yolo_tpu_torch.nn.model import TASK2MODELCLASS, OBBModel, guess_model_task
from drone_yolo_tpu_torch.ops import rotated as R
from drone_yolo_tpu_torch.ops.anchors import dist2rbox
from drone_yolo_tpu_torch.ops.boxes import probiou
from drone_yolo_tpu_torch.ops.nms import nms_rotated
from drone_yolo_tpu_torch.utils import metrics as MET

torch.set_num_threads(1)

OBB_N = "yolov8n-obb.yaml"
NC = 3
HEAD_TOL = dict(rtol=1e-5, atol=1e-4)
OP_TOL = 1e-6
RECT_PX, RECT_RAD = 1e-4, 1e-5  # min_area_rect against cv2: centre and size, angle
PREDICT = dict(imgsz=128, conf=0.25, dtype="float32", verbose=False)
BOX_TOL = 1e-3  # px in the original frame, as tests/test_torch_predict.py
VAL_ARGS = dict(conf=0.001, iou=0.7, max_det=300, pre_nms_topk=256)


def _rboxes(rng, n: int, lo: float = 0.0) -> np.ndarray:
    """n rotated boxes: centres in 0-100, sizes lo-40, angles in [-pi/2, pi)."""
    return np.concatenate([rng.uniform(0, 100, (n, 2)), rng.uniform(lo, 40, (n, 2)),
                           rng.uniform(-np.pi / 2, np.pi, (n, 1))], 1).astype(np.float32)


@pytest.mark.parametrize("ciou", [False, True])
def test_probiou_and_its_gradient_match_jax(ciou):
    """Pairwise probiou of 64 x 64 boxes (some near-degenerate, 1e-3 px sides) within 1e-6, and its gradient with
    respect to both box sets within 5e-5 of the largest (float32 sums of 64 terms through log and sqrt of
    near-singular covariances)."""
    rng = np.random.default_rng(int(ciou))
    a, b = _rboxes(rng, 64, lo=1.0), _rboxes(rng, 64, lo=1.0)
    a[:4, 2:4] = 1e-3
    pairwise = jax.jit(lambda x, y: JBOX.probiou(x[:, None], y[None], CIoU=ciou))
    want = np.asarray(pairwise(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    got = probiou(ta[:, None], tb[None], CIoU=ciou)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=OP_TOL)
    assert (want > 0.3).sum() > 50 and (want < 0.01).sum() > 50  # overlapping and apart pairs
    got.sum().backward()
    ga, gb = jax.jit(jax.grad(lambda x, y: pairwise(x, y).sum(), argnums=(0, 1)))(jnp.asarray(a), jnp.asarray(b))
    for g, w in ((ta.grad, ga), (tb.grad, gb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=5e-5 * np.abs(np.asarray(w)).max())


def test_dist2rbox_corners_and_regularize_match_jax():
    rng = np.random.default_rng(3)
    dist = rng.uniform(0, 15, (2, 50, 4)).astype(np.float32)
    angle = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (2, 50, 1)).astype(np.float32)
    anchors = rng.uniform(0, 20, (50, 2)).astype(np.float32)
    want = np.asarray(JANC.dist2rbox(jnp.asarray(dist), jnp.asarray(angle), jnp.asarray(anchors)[None]))
    got = dist2rbox(torch.from_numpy(dist), torch.from_numpy(angle), torch.from_numpy(anchors)[None]).numpy()
    np.testing.assert_allclose(got, want, rtol=OP_TOL, atol=OP_TOL)  # pixel-scale values of up to ~35
    boxes = _rboxes(rng, 200)
    boxes[:20, 4] = np.pi / 2 * rng.integers(-1, 3, 20)  # exactly on the swap boundaries
    np.testing.assert_allclose(R.xywhr2xyxyxyxy(boxes), JCONV.xywhr2xyxyxyxy(boxes), rtol=0, atol=OP_TOL)
    np.testing.assert_allclose(R.regularize_rboxes(boxes), JCONV.regularize_rboxes(boxes), rtol=0, atol=OP_TOL)


def _point_sets(n: int = 2400):
    """Seeded point sets (float32, (k, 2)) of 12 kinds; see the module docstring."""
    rng = np.random.default_rng(2024)
    for t in range(n):
        kind, k = t % 12, int(rng.integers(1, 9))
        if kind == 0:
            pts = rng.uniform(0, 100, (k, 2))
        elif kind == 1:
            pts = rng.integers(0, 6, (k, 2)).astype(float)
        elif kind == 2:  # clipped to the frame's edges
            pts = np.clip(rng.uniform(-20, 120, (k, 2)), 0, 100)
        elif kind == 3:  # exactly collinear: steps of a small integer vector, or one image edge
            step = rng.integers(-3, 4, 2)
            pts = rng.integers(0, 50, 2) + rng.integers(0, 8, (k, 1)) * step
            if rng.random() < 0.3:
                pts = np.stack([np.full(k, 63.0), rng.uniform(0, 63, k)], 1)[:, :: 1 if rng.random() < 0.5 else -1]
        elif kind == 4:  # repeated points
            base = rng.uniform(0, 100, (max(k // 2, 1), 2))
            pts = base[rng.integers(0, len(base), k)]
        elif kind in (5, 6, 7, 8, 9):  # rotated rectangles: random, exact angles, squares, clipped, rounded
            c, (w, h) = rng.uniform(10, 90, 2), rng.uniform(1, 50, 2)
            ang = rng.uniform(0, np.pi)
            if kind == 6:
                ang = float(rng.choice([0, np.pi / 4, np.pi / 2, 3 * np.pi / 4, np.pi, -np.pi / 4]))
            if kind == 7:
                w, ang = h, float(rng.choice([0, np.pi / 4, np.pi / 2]))
            dx, dy = np.array([-w, w, w, -w]) / 2, np.array([-h, -h, h, h]) / 2
            pts = c + np.stack([dx * np.cos(ang) - dy * np.sin(ang), dx * np.sin(ang) + dy * np.cos(ang)], 1)
            if kind == 8:
                pts = np.clip(pts, 1, 62)
            if kind == 9:
                pts = np.round(pts)
        elif kind == 10:  # axis-aligned integer rectangles, vertices in any order
            (x1, y1), (w, h) = rng.integers(0, 50, 2), rng.integers(0, 30, 2)
            pts = np.array([[x1, y1], [x1 + w, y1], [x1 + w, y1 + h], [x1, y1 + h]], float)[rng.permutation(4)]
        else:  # make_obb_dataset's labels: a rotated rectangle clipped to [1, size - 2], 6 decimals of the size
            size = 256
            c, (w, h) = rng.uniform(0.25, 0.75, 2) * size, rng.uniform(size / 8, size / 4, 2)
            ang = rng.uniform(0, np.pi)
            dx, dy = np.array([-w, w, w, -w]) / 2, np.array([-h, -h, h, h]) / 2
            pts = np.clip(c + np.stack([dx * np.cos(ang) - dy * np.sin(ang), dx * np.sin(ang) + dy * np.cos(ang)], 1),
                          1, size - 2)
            pts = np.round(pts / size, 6) * size
        yield kind, pts.astype(np.float32)


def test_min_area_rect_matches_cv2():
    """2,400 point sets: the rectangle and its (w, h, angle) branch equal cv2's within 1e-4 px and 1e-5 rad, the
    hull equal to `cv2.convexHull`'s point for point, and at least 95% of the rectangles bit for bit. Then 300
    nearly collinear sets, of which 47 hulls still differ from OpenCV 5.0's (counted below)."""
    exact, n = 0, 0
    for kind, pts in _point_sets():
        want = cv2.minAreaRect(pts)
        got = R.min_area_rect(pts)
        hull = cv2.convexHull(pts, clockwise=False, returnPoints=True).reshape(-1, 2)
        np.testing.assert_array_equal(R.convex_hull(pts), hull, err_msg=f"kind {kind}: {pts.tolist()}")
        msg = f"kind {kind}: {pts.tolist()}: got {got}, cv2 {want}"
        assert max(abs(got[0][0] - want[0][0]), abs(got[0][1] - want[0][1])) <= RECT_PX, msg
        assert max(abs(got[1][0] - want[1][0]), abs(got[1][1] - want[1][1])) <= RECT_PX, msg
        assert abs(math.radians(got[2] - want[2])) <= RECT_RAD and -90 <= got[2] < 0, msg
        exact += got == want
        n += 1
    print(f"bit for bit: {exact} of {n}")
    assert n == 2400 and exact >= 0.95 * n

    # 300 nearly collinear sets (3 to 8 points of a random line, rounded to float32): the open fault of ROADMAP
    # queue 3. 253 hulls equal OpenCV 5.0's point for point, and their rectangles agree in centre and long side;
    # 47 differ (OpenCV 5.0 keeps other points of such sets than Sklansky's scan does, by a rule not yet found),
    # and the port's hull of one of those repeats a point, which gives a nan rectangle. Held exactly, so that a
    # change either way shows.
    rng = np.random.default_rng(0)
    differ = 0
    for _ in range(300):
        k = int(rng.integers(3, 9))
        p0, ang = rng.uniform(0, 256, 2), rng.uniform(0, np.pi)
        pts = (p0 + rng.uniform(-80, 80, k)[:, None] * np.array([np.cos(ang), np.sin(ang)])).astype(np.float32)
        got, want = R.min_area_rect(pts), cv2.minAreaRect(pts)
        hull, cv_hull = R.convex_hull(pts), cv2.convexHull(pts, clockwise=False, returnPoints=True).reshape(-1, 2)
        if hull.shape != cv_hull.shape or not np.array_equal(hull, cv_hull):
            differ += 1
            continue
        msg = f"{pts.tolist()}: got {got}, cv2 {want}"
        assert max(abs(got[0][0] - want[0][0]), abs(got[0][1] - want[0][1])) <= RECT_PX, msg
        assert abs(max(got[1]) - max(want[1])) <= RECT_PX, msg
    assert differ == 47
    for pts, want in (([[0, 0], [10, 0], [10, 5], [0, 5]], ((5, 2.5), (5, 10), -90.0)),
                      ([[5, 0], [10, 5], [5, 10], [0, 5]], ((5, 5.000000476837158), (7.071068286895752,) * 2, -45.0))):
        assert R.min_area_rect(np.array(pts, np.float32)) == want
    got = R.min_area_rect(np.array([[0, 0], [10, -1], [11, 4], [1, 5]], np.float32))
    np.testing.assert_allclose([*got[0], *got[1], got[2]], [5.5, 2.0, 10.547, 5.075, -5.711], atol=1e-3)


def test_rotated_boxes_from_polygons_match_jax():
    """`xyxyxyxy2xywhr` and the trainer's polygon -> rotated box (`rboxes_from_segments`) against the JAX functions,
    which call cv2: within 1e-4 px and 1e-5 rad."""
    polys = [pts for kind, pts in _point_sets(600) if len(pts) == 4]
    corners = np.stack(polys)
    for got, want in ((R.xyxyxyxy2xywhr(corners), JCONV.xyxyxyxy2xywhr(corners)),
                      (rboxes_from_segments(polys), JOBB._rboxes_from_segments(polys))):
        assert got.shape == want.shape == (len(polys), 5) and got.dtype == np.float32
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=RECT_PX)
        np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0, atol=RECT_RAD)


@pytest.fixture(scope="module")
def obb_pair():
    """(port facade, JAX facade) with one set of weights."""
    port = YOLO(OBB_N, device="cpu")
    port.model = OBBModel(OBB_N, nc=NC)
    port.ensure_variables(imgsz=128)
    port.model.load_state_dict(scored_weights(port.model.state_dict(), np.random.default_rng(0), -2.0, 30.0))
    ref = JaxYOLO(OBB_N)
    ref.model = JaxOBBModel(OBB_N, nc=NC)
    ref.variables = convert_state_dict(ref.model, port.model.state_dict())
    return port, ref


def test_obb_head_matches_jax(obb_pair):
    """Eval: (B, A, 4 + nc + 1) decoded rotated boxes, scores and angles within 1e-4; the angles in
    [-pi/4, 3pi/4). Train (batch statistics of 57 + 6 BN inputs): the maps and the angles within 1e-4 of a float64
    run and 1e-3 of JAX's."""
    port, ref = obb_pair
    x = np.random.default_rng(1).random((2, 96, 128, 3), dtype=np.float32)
    ctx = JM.Ctx(train=False, dtype=jnp.float32)
    want, (_, want_ang) = jax.jit(lambda v, x: ref.model.apply(v, x, ctx=ctx))(ref.variables, jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got, (maps, got_ang) = port.model(xt)
    assert got.shape == want.shape == (2, 252, 4 + NC + 1) and got_ang.shape == (2, 252, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HEAD_TOL)
    np.testing.assert_allclose(got_ang.numpy(), np.asarray(want_ang), **HEAD_TOL)
    np.testing.assert_array_equal(got[..., -1].numpy(), got_ang[..., 0].numpy())
    assert -math.pi / 4 <= float(got_ang.min()) and float(got_ang.max()) < 3 * math.pi / 4
    assert port.model.head.cv4[0][0].conv.out_channels == max(16, 1)  # c4 = max(ch[0] // 4, ne): 64 // 4
    # train mode on the seeded init: batch statistics of 57 + 6 BN inputs; the maps and angles held to a float64 run
    # of the port within 1e-4 and to the JAX package's within 1e-3, as tests/test_torch_train.py holds the flagship's
    # (the one-pass variance E[x^2] - E[x]^2 cancels, and XLA's float32 sums leave the JAX maps the farther)
    model = OBBModel(OBB_N, nc=NC)
    model.init(1, imgsz=128)
    variables = convert_state_dict(ref.model, model.state_dict())
    model.train()
    with M.collect_bn_stats() as stats:
        tmaps, tang = model(xt)
    assert len(stats) == sum(isinstance(m, M.BatchNorm2d) for m in model.modules()) == 57 + 6
    assert tang.shape == (2, 252, 1) and tang.requires_grad
    with M.collect_bn_stats():
        maps64, ang64 = model.double()(xt.double())

    def train_fwd(v, x):
        return ref.model.apply(v, x, ctx=JM.Ctx(train=True, dtype=jnp.float32))

    want_maps, want_tang = jax.jit(train_fwd)(variables, jnp.asarray(x))
    for got, exact, want in zip([*tmaps, tang], [*maps64, ang64], [*want_maps, want_tang]):
        got, exact = got.detach().numpy(), exact.detach().numpy()
        want = np.asarray(want) if got.ndim == 3 else np.asarray(want).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got, exact, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_obb_bridge_and_npz(obb_pair, tmp_path):
    """The bridge both ways through the JAX `convert_state_dict` (cv4's last conv a plain Conv2d with a bias), an npz
    of the JAX package loaded by the port as an obb model, and the port's npz read by the JAX package."""
    port, ref = obb_pair
    tree = convert_state_dict(ref.model, port.model.state_dict())
    sd = from_jax_variables(tree)
    assert sd.keys() == port.model.state_dict().keys() and any(k.endswith(".cv4.0.2.bias") for k in sd)
    assert all(torch.equal(sd[k], v) for k, v in port.model.state_dict().items())
    back = flatten_tree(to_jax_variables(sd))
    assert back.keys() == flatten_tree(tree).keys()
    for k, v in flatten_tree(tree).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    path = jax_save_checkpoint(tmp_path / "obb.npz", ref.model, ref.variables)
    loaded = YOLO(str(path), device="cpu")
    assert loaded.task == "obb" and isinstance(loaded.model, OBBModel) and loaded.model.nc == NC
    x = torch.rand(1, 3, 96, 96, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        np.testing.assert_array_equal(loaded.model(x)[0].numpy(), port.model(x)[0].numpy())
    port.save(tmp_path / "port.npz")
    jmodel, _, header = jax_load_checkpoint(tmp_path / "port.npz")
    assert header["task"] == "obb" and type(jmodel).__name__ == "OBBModel"


def _nms_preds(rng, b: int = 2, a: int = 400, nc: int = NC) -> np.ndarray:
    """Decoded-prediction rows (cx, cy, w, h, nc scores, angle): clusters of boxes jittered around a few centres (so
    probiou spans the threshold), scores on a coarse grid (many ties, across and within anchors), some below conf."""
    centres = rng.uniform(20, 180, (12, 2))
    out = np.zeros((b, a, 4 + nc + 1), np.float32)
    pick = rng.integers(0, len(centres), (b, a))
    out[..., :2] = centres[pick] + rng.normal(0, 4, (b, a, 2))
    out[..., 2:4] = rng.uniform(10, 30, (b, a, 2))
    out[..., 4:4 + nc] = rng.choice([0.1, 0.3, 0.5, 0.5, 0.7, 0.9], (b, a, nc))
    out[..., -1] = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (b, a))
    return out


@pytest.mark.parametrize("multi_label", [False, True])
@pytest.mark.parametrize("iou", [0.3, 0.5, 0.7])
def test_nms_rotated_matches_jax(multi_label, iou):
    """Fast rotated NMS: the kept detections (boxes, scores, classes, order and counts) exactly equal to JAX's; the
    probiou of the candidate pairs spans the threshold."""
    rng = np.random.default_rng(int(iou * 10) + 100 * multi_label)
    preds = _nms_preds(rng)
    kw = dict(conf_thres=0.25, iou_thres=iou, max_det=300, pre_topk=256, nc=NC, multi_label=multi_label)
    want, want_n = jax_nms_rotated(jnp.asarray(preds), **kw)
    got, got_n = nms_rotated(torch.from_numpy(preds), **kw)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (2, min(300, 256 * (NC if multi_label else 1)), 7) and 0 < int(got_n.min())
    assert int(got_n.max()) < 256 * (NC if multi_label else 1)  # something suppressed
    rb = torch.from_numpy(np.concatenate([preds[0, :256, :4], preds[0, :256, -1:]], 1))
    pairs = probiou(rb[:, None], rb[None])
    assert bool(((pairs - iou).abs() < 0.02).any())  # overlaps near the threshold are there to decide


def test_nms_rotated_class_filter():
    """`classes` keeps the candidates of the listed classes only (the JAX `nms_rotated` has no such filter); without it
    the result is JAX's."""
    preds = _nms_preds(np.random.default_rng(9))
    got, n = nms_rotated(torch.from_numpy(preds), conf_thres=0.25, iou_thres=0.5, max_det=300, pre_topk=256, nc=NC,
                         classes=[1])
    kept = torch.cat([got[i, : int(n[i])] for i in range(len(n))])
    assert len(kept) and set(kept[:, 6].tolist()) == {1.0}


def test_obb_results_match_jax_where_they_agree_and_depart_where_jax_fails(tmp_path):
    """The OBB properties and `verbose` equal to JAX's; `save_txt` writes 'cls x1 y1 ... x4 y4 [conf]' rows normalised
    (JAX: nothing), `summary` the four corners (JAX: cx, cy, w, h under corner names, the angle over the height),
    `save_crop` nothing (as JAX), and a frame without detections has an empty OBB (JAX: None)."""
    rng = np.random.default_rng(5)
    data = np.concatenate([_rboxes(rng, 6, lo=2.0) + [[50, 30, 0, 0, 0]], rng.uniform(0.3, 1, (6, 1)),
                           rng.integers(0, NC, (6, 1))], 1).astype(np.float32)
    img = np.zeros((120, 200, 3), np.uint8)
    names = {0: "plane", 1: "ship", 2: "vehicle"}
    got = results.Results(img, "a.jpg", names, obb=data)
    want = jax_results.Results(img, "a.jpg", names, obb=data)
    for prop in ("xywhr", "conf", "cls", "xyxyxyxy", "xyxyxyxyn", "xyxy"):
        np.testing.assert_allclose(getattr(got.obb, prop), getattr(want.obb, prop), rtol=0, atol=1e-4, err_msg=prop)
    assert got.obb.id is None and got.verbose() == want.verbose() and len(got) == len(want) == 6
    assert len(got[1:3].obb) == 2
    got.save_txt(tmp_path / "port.txt", save_conf=True)
    want.save_txt(tmp_path / "jax.txt", save_conf=True)
    assert not (tmp_path / "jax.txt").exists()
    rows = [list(map(float, r.split())) for r in (tmp_path / "port.txt").read_text().splitlines()]
    assert len(rows) == 6 and all(len(r) == 10 for r in rows)
    corners = got.obb.xyxyxyxyn.reshape(6, 8)
    np.testing.assert_allclose(np.array(rows)[:, 1:9], corners, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.array(rows)[:, 0], data[:, 6])
    np.testing.assert_allclose(np.array(rows)[:, 9], data[:, 5], rtol=1e-5)
    summary = got.summary(normalize=True)
    assert [s["box"] for s in summary][0].keys() == {f"{a}{i}" for i in range(1, 5) for a in "xy"}
    np.testing.assert_allclose([[s["box"][f"{a}{i}"] for i in range(1, 5) for a in "xy"] for s in summary], corners,
                               atol=1e-5)
    assert set(want.summary(normalize=True)[0]["box"]) == {"x1", "y1", "x2", "y2", "r"}  # cx, cy, w, h, angle / h
    assert got.save_crop(tmp_path / "crops", "a") == [] and not (tmp_path / "crops").exists()
    empty = results.Results(img, "b.jpg", names, obb=np.zeros((0, 7), np.float32))
    assert len(empty.obb) == 0 and empty.verbose() == "(no detections), " and empty.summary() == []
    assert jax_results.Results(img, "b.jpg", names, obb=np.zeros((0, 7), np.float32)).obb is None


@pytest.mark.parametrize("shapes", [[(100, 140)], [(100, 140), (90, 60), (128, 128)]])
def test_obb_predictor_matches_jax(obb_pair, shapes):
    """The predictor through both facades: the same detections (cx, cy, w, h within 1e-3 px of the original frame,
    angles and scores within 1e-5), cx, cy unclipped and angles unregularized as JAX leaves them."""
    port, ref = obb_pair
    rng = np.random.default_rng(len(shapes))
    frames = [rng.integers(0, 256, (*s, 3), dtype=np.uint8) for s in shapes]
    got, want = port.predict(source=frames, **PREDICT), ref.predict(source=frames, **PREDICT)
    assert isinstance(port.predictor, OBBPredictor)
    for g, w in zip(got, want):
        assert g.orig_shape == w.orig_shape and g.boxes is None and len(g.obb) == len(w.obb) > 0
        np.testing.assert_allclose(g.obb.xywhr[:, :4], w.obb.xywhr[:, :4], rtol=0, atol=BOX_TOL)
        np.testing.assert_allclose(g.obb.data[:, 4:], w.obb.data[:, 4:], rtol=0, atol=1e-5)


def test_obb_metrics_match_jax():
    rng = np.random.default_rng(0)
    n = 200
    stats = (rng.random((n, 10)) < 0.6, rng.random(n), rng.integers(0, 3, n), rng.integers(0, 3, 150))
    got, want = MET.OBBMetrics({0: "a", 1: "b", 2: "c"}), JMET.OBBMetrics({0: "a", 1: "b", 2: "c"})
    got.process(*stats)
    want.process(*stats)
    assert got.keys == want.keys and len(got.keys) == 4 and got.task == want.task == "obb"
    np.testing.assert_array_equal(got.mean_results(), want.mean_results())
    assert got.fitness == want.fitness
    np.testing.assert_array_equal(got.maps, want.maps)


class _Facade:
    def __init__(self, model, variables):
        self.model, self.variables = model, variables

    def ensure_variables(self, imgsz=640, seed=0):
        return self.variables


class _FedJax(JOBB.OBBValidator):
    def __init__(self, fed, **kw):
        super().__init__(**kw)
        self.fed = list(fed)

    def _forward(self, shape):
        a = self.args

        def fn(variables, x):
            return jax_nms_rotated(jnp.asarray(self.fed.pop(0)), conf_thres=a.conf, iou_thres=a.iou,
                                   max_det=a.max_det, pre_topk=a.pre_nms_topk, nc=self.nc, multi_label=True)
        return fn


class _FedPort(OBBValidator):
    def __init__(self, fed, *a, **kw):
        super().__init__(*a, **kw)
        self.fed = list(fed)

    def forward(self, x):
        return torch.from_numpy(self.fed.pop(0))


@pytest.fixture(scope="module")
def val_case(tmp_path_factory):
    """(port model, JAX model, JAX variables, square val batches from the JAX dataset at imgsz 96, the dataset yaml)
    on spread weights with the class priors zeroed (scores O(1): every candidate passes conf 0.001)."""
    root = tmp_path_factory.mktemp("obb_val")
    yaml = str(make_obb_dataset(root / "d", n_val=4, nc=NC, seed=0, size=128, n_train=2))
    jd = jax_check(yaml)
    cfg = jax_get_cfg(overrides={"imgsz": 96, "task": "obb", "mode": "val", "rect": False})
    batches = list(jax_dataloader(jax_dataset(cfg, jd["val"], 4, jd, mode="val"), 4, 0, shuffle=False,
                                  drop_last=False))
    port = OBBModel(OBB_N, nc=NC)
    port.init(0, imgsz=96)
    sd = spread_weights(port.state_dict(), np.random.default_rng(5))
    for i in range(len(port.head.cv3)):
        sd[f"model.{len(port.model) - 1}.cv3.{i}.2.bias"].zero_()
    port.load_state_dict(sd)
    ref = JaxOBBModel(OBB_N, nc=NC)
    return port, ref, convert_state_dict(ref, port.state_dict()), batches, yaml


def _plant(preds, batch, rng):
    """Each GT polygon's rotated box planted at a random anchor, jittered (centre up to ~10% of its size, size
    0.9-1.1, angle +-0.1 rad or a quarter turn with w and h swapped), a score of 0.5-1 for its class (80%) or
    another."""
    out = preds.copy()
    for i in range(len(out)):
        live = batch["mask"][i] > 0
        cls = batch["cls"][i][live].astype(int)
        gt = JOBB._rboxes_from_segments(batch["segments_list"][i])[: len(cls)]
        n = len(gt)
        anchors = rng.choice(out.shape[1], n, replace=False)
        r = gt.copy()
        r[:, :2] += rng.normal(0, 0.05, (n, 2)) * gt[:, 2:4]
        r[:, 2:4] *= rng.uniform(0.9, 1.1, (n, 2))
        r[:, 4] += rng.normal(0, 0.1, n)
        turn = rng.random(n) < 0.3
        r[turn] = r[turn][:, [0, 1, 3, 2, 4]] + [0, 0, 0, 0, np.pi / 2]
        out[i, anchors, :4], out[i, anchors, -1] = r[:, :4], r[:, 4]
        out[i, anchors, 4 + np.where(rng.random(n) < 0.8, cls, (cls + 1) % NC)] = rng.uniform(0.5, 1.0, n)
    return out


def _jax_args(**kw):
    return dict(VAL_ARGS, imgsz=96, batch=4, half=False, plots=False, save_json=False, verbose=False, task="obb",
                mode="val", **kw)


def test_obb_validator_matches_jax_on_fed_predictions(val_case, tmp_path):
    """Planted predictions through both validators: the GT rotated boxes from the batch's polygons, probiou matching in
    the letterboxed frame: the 4 metrics and fitness equal."""
    port, ref, variables, batches, _ = val_case
    fused = ref.fuse(variables)
    fwd = jax.jit(lambda v, x: ref.apply(v, x, ctx=JM.Ctx(train=False, dtype=jnp.float32))[0])
    rng = np.random.default_rng(6)
    fed = [_plant(np.asarray(fwd(fused, jnp.asarray(b["img"].astype(np.float32) / 255.0))), b, rng) for b in batches]
    assert fed[0].shape[2] == 4 + NC + 1 and all(len(s) for b in batches for s in b["segments_list"])
    want = _FedJax(fed, dataloader=batches, save_dir=tmp_path, args=_jax_args())(model=_Facade(ref, variables))
    port_args = dict(VAL_ARGS, imgsz=96, device="cpu", dtype="float32", verbose=False)
    got = _FedPort(fed, batches, args=port_args)(model=port)
    print(f"fed predictions: port {got}, JAX {want}")
    assert got == want and len(got) == 5
    assert 0.1 < got["metrics/mAP50-95(B)"] < 0.9  # something to find


@pytest.mark.parametrize("batches_of", ["square", "rect"])
def test_obb_validator_matches_jax_end_to_end(val_case, tmp_path, batches_of):
    """Each package's own forward on the same weights (float32): the metrics and fitness within 1e-4. square: the
    validators over the JAX dataset's batches; rect: `YOLO.val` of one npz (rect batches of 2)."""
    port, ref, variables, batches, yaml = val_case
    if batches_of == "square":
        want = JOBB.OBBValidator(dataloader=batches, save_dir=tmp_path, args=_jax_args())(model=_Facade(ref, variables))
        val = OBBValidator(batches, args=dict(VAL_ARGS, imgsz=96, device="cpu", dtype="float32", verbose=False))
        got = val(model=port)
        assert sum(len(c) for c in val.stats["conf"]) > 0
    else:
        facade = YOLO(OBB_N, device="cpu")
        facade.model, facade.initialized = port, True
        facade.save(tmp_path / "m.npz")
        args = dict(data=yaml, imgsz=96, batch=2, plots=False, verbose=False, pre_nms_topk=256)
        got = YOLO(tmp_path / "m.npz", device="cpu").val(dtype="float32", workers=1, **args)
        r = JaxYOLO(str(tmp_path / "m.npz")).val(**args)
        want = {**dict(zip(r.keys, r.mean_results())), "fitness": r.fitness() if callable(r.fitness) else r.fitness}
    print(f"end to end ({batches_of}): port {got}, JAX {want}")
    assert set(got) == set(want) and len(got) == 5
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])


def test_obb_task_registration_and_refusals(obb_pair):
    port, _ = obb_pair
    for cfg in ("yolov8n-obb.yaml", "yolov8s-obb.yaml", "yolov8n-seg.yaml", "yolov8n-pose.yaml"):
        assert guess_model_task(cfg) == jax_guess_task(cfg)
    assert port.task == "obb" and TASK2MODELCLASS["obb"] is OBBModel
    assert {k: v.__name__ for k, v in TASK_MAP["obb"].items()} == {
        "trainer": "OBBTrainer", "validator": "OBBValidator", "predictor": "OBBPredictor"}
    s = YOLO("yolov8s-obb.yaml", device="cpu")
    assert s.model.nc == 15 and s.model.head.stride == [8, 16, 32] and s.model.head.cv4[0][0].conv.out_channels == 32
    with pytest.raises(NotImplementedError, match="tracking an obb model"):
        port.track(np.zeros((64, 64, 3), np.uint8))

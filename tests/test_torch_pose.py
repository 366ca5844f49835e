"""The port's pose model against the JAX package's, on the CPU in float32.

`yolov8n-pose.yaml` (nc 1, kpt_shape [17, 3]) from one set of weights (the port's
seeded init with kernels spread and class logits that follow the image,
`chip_smoke.scored_weights`), crossed to JAX by `convert_state_dict`. Held against the
JAX package: the Pose head's decoded output and raw keypoints within 1e-4, the weight
bridge and the fuse over `cv4`, NMS with extra columns (keep exactly, columns within
1e-5), `Results` with keypoints and tracks, and `PosePredictor` through the facades on
mixed frame shapes (boxes within 1e-3 px, keypoints within 1e-4 px).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import clustered_boxes, scored_weights
from drone_yolo_tpu import YOLO as JaxYOLO
from drone_yolo_tpu.engine import results as jax_results
from drone_yolo_tpu.engine.checkpoint import save_checkpoint
from drone_yolo_tpu.nn import modules as JM
from drone_yolo_tpu.nn.model import guess_model_task as jax_guess_task
from drone_yolo_tpu.ops.nms import non_max_suppression as jax_nms
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.engine import results
from drone_yolo_tpu_torch.engine.checkpoint import flatten_tree, from_jax_variables, to_jax_variables
from drone_yolo_tpu_torch.models.yolo.pose import PosePredictor
from drone_yolo_tpu_torch.nn.model import guess_model_task
from drone_yolo_tpu_torch.ops.nms import non_max_suppression

torch.set_num_threads(1)

POSE_N = "yolov8n-pose.yaml"
POSE_GAIN, POSE_BIAS = 30.0, -2.0  # class logits of the n-scale pose model at 128 px: most anchors above 0.25
HEAD_TOL = dict(rtol=1e-5, atol=1e-4)
PREDICT = dict(imgsz=128, conf=0.25, dtype="float32", verbose=False)
BOX_TOL = 1e-3  # px in the original frame, as tests/test_torch_predict.py
KPT_TOL = 1e-4  # px in the original frame


@pytest.fixture(scope="module")
def pose_pair():
    """(port facade, JAX facade) with one set of weights."""
    port = YOLO(POSE_N, device="cpu")
    port.ensure_variables(imgsz=128)
    port.model.load_state_dict(scored_weights(port.model.state_dict(), np.random.default_rng(0), POSE_BIAS, POSE_GAIN))
    ref = JaxYOLO(POSE_N)
    ref.variables = convert_state_dict(ref.model, port.model.state_dict())
    return port, ref


def jax_forward(ref, variables, x_nhwc):
    return ref.model.apply(variables, jnp.asarray(x_nhwc), ctx=JM.Ctx(train=False, dtype=jnp.float32))


def test_pose_head_matches_jax(pose_pair):
    port, ref = pose_pair
    x = np.random.default_rng(1).random((2, 128, 160, 3), dtype=np.float32)
    want, (_, want_kpt) = jax_forward(ref, ref.variables, x)
    with torch.no_grad():
        got, (_, got_kpt) = port.model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == want.shape == (2, 420, 4 + 1 + 51)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HEAD_TOL)
    np.testing.assert_allclose(got_kpt.numpy(), np.asarray(want_kpt), **HEAD_TOL)
    vis = got[..., 5:].unflatten(-1, (17, 3))[..., 2]
    assert bool(((vis > 0) & (vis < 1)).all())  # the visibility went through the sigmoid


def test_pose_fuse_covers_cv4(pose_pair):
    """The port's fuse folds the BNs of cv4 as the JAX package's, and the fused model predicts as the unfused one."""
    port, ref = pose_pair
    fused = YOLO(POSE_N, device="cpu")
    fused.model.load_state_dict(port.model.state_dict())
    fused.initialized = True
    fused.fuse()
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, ref.model.fuse(ref.variables)), fused.model)
    got = fused.model.state_dict()
    assert got.keys() == want.keys() and any(".cv4." in k for k in got)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    x = torch.rand(1, 3, 96, 128, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        np.testing.assert_allclose(fused.model(x)[0].numpy(), port.model(x)[0].numpy(), **HEAD_TOL)


def test_pose_bridge_both_ways_and_npz(pose_pair, tmp_path):
    port, ref = pose_pair
    tree = convert_state_dict(ref.model, port.model.state_dict())
    sd = from_jax_variables(tree)
    assert sd.keys() == port.model.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in port.model.state_dict().items())
    back = flatten_tree(to_jax_variables(sd))
    assert back.keys() == flatten_tree(tree).keys()
    for k, v in flatten_tree(tree).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    jax_init = jax.tree_util.tree_map(np.asarray, ref.model.init(jax.random.PRNGKey(3), imgsz=128))
    again = flatten_tree(to_jax_variables(from_jax_variables(jax_init)))
    for k, v in flatten_tree(jax_init).items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
    path = save_checkpoint(tmp_path / "pose.npz", ref.model, ref.variables)
    loaded = YOLO(str(path), device="cpu")
    assert loaded.task == "pose" and loaded.model.head.kpt_shape == (17, 3)
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        np.testing.assert_array_equal(loaded.model(x)[0].numpy(), port.model(x)[0].numpy())


def nms_preds(rng, b, a, nc, n_extra):
    """(B, A, 4 + nc + n_extra) float32: clustered xywh boxes, scores, then extra columns."""
    xyxy = clustered_boxes(rng, b, a, n_cls=1).numpy()
    xywh = np.concatenate([(xyxy[..., :2] + xyxy[..., 2:]) / 2, xyxy[..., 2:] - xyxy[..., :2]], -1)
    return np.concatenate([xywh, rng.random((b, a, nc)) ** 2, rng.uniform(-50, 250, (b, a, n_extra))], -1).astype(np.float32)


@pytest.mark.parametrize("nc,n_extra,multi_label,pre_topk", [(1, 51, False, 1024), (1, 51, True, 1024),
                                                             (3, 34, False, 512), (3, 51, True, 256)])
def test_nms_with_extra_columns_matches_jax(nc, n_extra, multi_label, pre_topk):
    preds = nms_preds(np.random.default_rng(nc + n_extra), 2, 700, nc, n_extra)
    kw = dict(conf_thres=0.05, iou_thres=0.5, max_det=pre_topk, pre_topk=pre_topk, nc=nc, multi_label=multi_label)
    want, want_n = jax_nms(jnp.asarray(preds), **kw)
    got, got_n = non_max_suppression(torch.from_numpy(preds), **kw)
    k = min(pre_topk, 700 * (nc if multi_label else 1))
    assert got.shape == tuple(want.shape) == (2, k, 6 + n_extra)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    scores = preds[..., 4:4 + nc] if multi_label else preds[..., 4:4 + nc].max(-1)
    n_cand = np.minimum((scores.reshape(2, -1) > 0.05).sum(1), pre_topk)
    assert (0 < got_n.numpy()).all() and (got_n.numpy() < n_cand).all()  # NMS kept some and suppressed some
    np.testing.assert_array_equal(got[..., 4:6].numpy(), np.asarray(want)[..., 4:6])  # the same kept candidates
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # each kept row's extra columns are those of the anchor its box came from
    xyxy = np.concatenate([preds[..., :2] - preds[..., 2:4] / 2, preds[..., :2] + preds[..., 2:4] / 2], -1)
    for i in range(2):
        for row in got[i, : int(got_n[i])].numpy()[:20]:
            anchor = np.flatnonzero((np.abs(xyxy[i] - row[:4]).max(1) < 1e-4))
            assert any(np.array_equal(preds[i, j, 4 + nc:], row[6:]) for j in anchor)


@pytest.mark.parametrize("shapes", [[(96, 160), (80, 160)], [(128, 128), (128, 128)], [(120, 90)]])
def test_pose_predictor_matches_jax(pose_pair, shapes):
    port, ref = pose_pair
    rng = np.random.default_rng(len(shapes) + shapes[0][0])
    frames = [rng.integers(0, 256, (*s, 3), dtype=np.uint8) for s in shapes]
    got, want = port.predict(source=frames, **PREDICT), ref.predict(source=frames, **PREDICT)
    assert isinstance(port.predictor, PosePredictor)
    for g, w in zip(got, want):
        assert g.orig_shape == w.orig_shape and len(g.boxes) == len(w.boxes) > 0
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, rtol=0, atol=BOX_TOL)
        np.testing.assert_allclose(g.boxes.conf, w.boxes.conf, rtol=1e-4, atol=1e-7)
        assert g.keypoints.data.shape == w.keypoints.data.shape == (len(w.boxes), 17, 3)
        np.testing.assert_allclose(g.keypoints.xy, w.keypoints.xy, rtol=0, atol=KPT_TOL)
        np.testing.assert_allclose(g.keypoints.conf, w.keypoints.conf, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(g.keypoints.xyn, w.keypoints.xyn, rtol=0, atol=KPT_TOL / min(g.orig_shape))


def test_results_match_jax():
    rng = np.random.default_rng(6)
    img = np.zeros((90, 160, 3), np.uint8)
    det = np.concatenate([rng.uniform(0, 90, (5, 4)), rng.random((5, 1)), rng.integers(0, 3, (5, 1))], 1).astype(np.float32)
    trk = np.concatenate([det[:, :4], np.arange(1, 6)[:, None], det[:, 4:]], 1).astype(np.float32)
    kpts = rng.uniform(0, 90, (5, 17, 3)).astype(np.float32)
    for boxes in (det, trk):
        g = results.Results(img, "a.jpg", {0: "p"}, boxes=boxes, keypoints=kpts)
        w = jax_results.Results(img, "a.jpg", {0: "p"}, boxes=boxes, keypoints=kpts)
        assert g.boxes.is_track == w.boxes.is_track == (boxes.shape[1] == 7) and len(g) == len(w) == 5
        for attr in ("xyxy", "conf", "cls", "xywh"):
            np.testing.assert_array_equal(getattr(g.boxes, attr), getattr(w.boxes, attr))
        if boxes.shape[1] == 7:
            np.testing.assert_array_equal(g.boxes.id, w.boxes.id)
        else:
            assert g.boxes.id is None and w.boxes.id is None
        for attr in ("xy", "xyn", "conf"):
            np.testing.assert_array_equal(getattr(g.keypoints, attr), getattr(w.keypoints, attr))
    g = results.Results(img, "a.jpg", {}, boxes=det)
    g.update(boxes=trk, keypoints=kpts[0])  # one instance keeps its instance dimension
    assert g.boxes.is_track and g.keypoints.data.shape == (1, 17, 3)
    assert results.Keypoints(kpts[..., :2], (90, 160)).conf is None
    with pytest.raises(ValueError, match="6 or 7 columns"):
        results.Boxes(np.zeros((2, 5)), (90, 160))


def test_pose_facade_task_and_refusals(pose_pair):
    port, _ = pose_pair
    for cfg in ("yolov8n-pose.yaml", "yolov8s-pose.yaml", "yolov8n-p2-repvgg-sf.yaml", "yolov8s.yaml"):
        assert guess_model_task(cfg) == jax_guess_task(cfg)
    assert port.task == "pose" and YOLO("yolov8n.yaml", device="cpu").task == "detect"
    # train and val of a pose model are ported (tests/test_torch_pose_train.py): a missing dataset is the refusal left
    with pytest.raises(FileNotFoundError, match="'data.yaml' not found"):
        port.train(data="data.yaml")
    with pytest.raises(FileNotFoundError, match="'data.yaml' not found"):
        port.val(data="data.yaml")


def test_pose_predict_without_detections(pose_pair):
    """A frame with no detection gives an empty Boxes and no keypoints; the JAX PosePredictor hands Boxes the
    (0, 57) rows and fails its 6-or-7-column check there (ROADMAP.md queue 3)."""
    port, ref = pose_pair
    frame = np.zeros((96, 160, 3), np.uint8)
    r = port.predict(source=frame, **{**PREDICT, "conf": 0.999})[0]
    assert len(r.boxes) == 0 and r.boxes.data.shape == (0, 6) and r.keypoints is None
    fresh = JaxYOLO(POSE_N)  # a new JAX predictor: it compiles conf into its step at the first call of each shape
    fresh.variables = ref.variables
    with pytest.raises(AssertionError, match="6 or 7 columns"):
        fresh.predict(source=frame, **{**PREDICT, "conf": 0.999})

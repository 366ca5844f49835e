"""BoT-SORT and its camera-motion compensation in the port against the JAX package and cv2, on the CPU.

- `KalmanFilterXYWH`, `gating_distance` of both filters and `embedding_distance`: bitwise equal to the JAX ones on
  seeded measurements;
- `BOTSORT` with gmc_method none, with one fixed warp injected in both packages, and with one stub ReID encoder in
  both: bitwise-equal tracks on seeded detection streams (`chip_smoke.detection_stream`);
- the motion compensation's steps against cv2 5.0: grey and the half-scale resize bit-equal; the corner response
  within 1e-6 of the map's largest value; `goodFeaturesToTrack`'s corner lists (each point in place, 99.5% at
  least, the misses counted; a constructed tie); the pyramid bit-equal to `buildOpticalFlowPyramid`; the tracker's
  status on 99% of points and positions within 1e-3 px where both track (one-level single-point calls too);
  `estimateAffinePartial2D` within 1e-4 on (a, b) and 1e-2 px on (tx, ty) with equal inlier masks;
- `GMC.apply` against the JAX GMC over a seeded panning and turning clip (`chip_smoke.panning_frames`): within 1e-3
  on the linear part and 0.02 px on the translation;
- `YOLO.track` with no tracker named (BoT-SORT) and `DroneVideoPipeline(tracker="botsort.yaml")` against the JAX
  facade and pipeline over that clip: the same ids, centres within 1e-2 px; the callback gives the tracker every
  frame; the ORB, SIFT and ECC methods refused by name.
"""

import math
import types

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import detection_stream, panning_frames, scored_weights
from drone_yolo_tpu import YOLO as JaxYOLO
from drone_yolo_tpu.apps.pipeline import DroneVideoPipeline as JaxPipeline
from drone_yolo_tpu.trackers import bot_sort as jax_bs
from drone_yolo_tpu.trackers import matching as jax_matching
from drone_yolo_tpu.trackers.byte_tracker import STrack as JaxSTrack
from drone_yolo_tpu.trackers.gmc import GMC as JaxGMC
from drone_yolo_tpu.trackers.kalman_filter import KalmanFilterXYAH as JaxXYAH
from drone_yolo_tpu.trackers.kalman_filter import KalmanFilterXYWH as JaxXYWH
from drone_yolo_tpu.utils import yaml_load
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.apps import DroneVideoPipeline
from drone_yolo_tpu_torch.cfg import TRACKER_CFG_DIR
from drone_yolo_tpu_torch.engine.results import Results
from drone_yolo_tpu_torch.ops import flow
from drone_yolo_tpu_torch.ops.image import bgr_to_gray_u8
from drone_yolo_tpu_torch.ops.letterbox import resize_linear_u8
from drone_yolo_tpu_torch.trackers import bot_sort, matching, track
from drone_yolo_tpu_torch.trackers.byte_tracker import STrack
from drone_yolo_tpu_torch.trackers.gmc import GMC
from drone_yolo_tpu_torch.trackers.kalman_filter import KalmanFilterXYAH, KalmanFilterXYWH

torch.set_num_threads(1)

FLAGSHIP_N = "yolov8n-p2-repvgg-sf.yaml"
CLIP_HW = (160, 160)  # square at imgsz: no letterbox border, whose constant pixels tie neighbouring anchors' scores
TRACK = dict(imgsz=160, iou=0.3, dtype="float32", verbose=False)
CENTRE_TOL = 1e-2  # px
CORNER_SHARE, STATUS_SHARE, LK_TOL = 0.995, 0.99, 1e-3
AB_TOL, T_TOL = 1e-4, 1e-2
GMC_LIN_TOL, GMC_T_TOL = 1e-3, 0.02


def botsort_args(**kw):
    return types.SimpleNamespace(**{**yaml_load(TRACKER_CFG_DIR / "botsort.yaml"), **kw})


def ground(h: int, w: int, seed: int) -> np.ndarray:
    """A grey frame of flat-coloured rectangles over smooth shading and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    g = 100 + 40 * np.sin(xx / 7.3 + seed) + 30 * np.cos(yy / 5.1) + rng.normal(0, 12, (h, w))
    for _ in range(20):
        x, y = rng.integers(0, w - 20), rng.integers(0, h - 20)
        g[y:y + rng.integers(3, 20), x:x + rng.integers(3, 20)] = rng.integers(0, 256)
    return np.clip(g, 0, 255).astype(np.uint8)


def moved(g: np.ndarray, dx: float, dy: float, deg: float) -> np.ndarray:
    h, w = g.shape
    m = cv2.getRotationMatrix2D((w / 2, h / 2), deg, 1.0)
    m[:, 2] += (dx, dy)
    return cv2.warpAffine(g, m, (w, h), borderMode=cv2.BORDER_REFLECT)


# -- Kalman filters and matching -----------------------------------------------------------------------------------

@pytest.mark.parametrize("port_cls,jax_cls", [(KalmanFilterXYAH, JaxXYAH), (KalmanFilterXYWH, JaxXYWH)])
def test_kalman_filters_bitwise_equal_to_jax(port_cls, jax_cls):
    rng = np.random.default_rng(0)
    port, ref = port_cls(), jax_cls()
    z = np.array([300.0, 200.0, 0.5 if port_cls is KalmanFilterXYAH else 40.0, 80.0])
    states = [port.initiate(z), ref.initiate(z)]
    for step in range(40):
        z = z + rng.normal(0, 2, 4) * np.array([1, 1, 0.01 if port_cls is KalmanFilterXYAH else 1, 1])
        meas = z[None] + rng.normal(0, 3, (6, 4))
        out = []
        for kf, (mean, cov) in zip((port, ref), states):
            mean, cov = kf.predict(mean, cov)
            gate = kf.gating_distance(mean, cov, meas), kf.gating_distance(mean, cov, meas, only_position=True)
            proj = kf.project(mean, cov)
            if step % 5 != 4:  # a missed measurement now and then
                mean, cov = kf.update(mean, cov, z)
            out.append(((mean, cov), gate, proj))
        (sp, gp, pp), (sr, gr, pr) = out
        for a, b in zip((*sp, *gp, *pp), (*sr, *gr, *pr)):
            np.testing.assert_array_equal(a, b)
        states = [sp, sr]


def test_embedding_distance_bitwise_equal_to_jax():
    rng = np.random.default_rng(1)
    tracks = [types.SimpleNamespace(smooth_feat=rng.normal(size=32).astype(np.float32)) for _ in range(7)]
    dets = [types.SimpleNamespace(curr_feat=rng.normal(size=32).astype(np.float32)) for _ in range(5)]
    dets.append(types.SimpleNamespace(curr_feat=tracks[2].smooth_feat * 3))  # the same direction: distance 0
    got, want = matching.embedding_distance(tracks, dets), jax_matching.embedding_distance(tracks, dets)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and got.min() >= 0 and got[2, -1] < 1e-6
    assert matching.embedding_distance([], dets).shape == (0, 6)


# -- BOTSORT --------------------------------------------------------------------------------------------------------

class StubEncoder:
    """A deterministic appearance feature of each box: a fixed projection of its (x, y, w, h)."""

    def __init__(self):
        self.proj = np.random.default_rng(9).normal(size=(4, 16))

    def inference(self, img, xywhs):
        return np.tanh(np.asarray(xywhs, np.float64)[:, :4] @ self.proj / 100.0)


def state(tracker):
    return [[(t.track_id, t.state, t.frame_id, t.start_frame, t.is_activated) for t in lst]
            for lst in (tracker.tracked_stracks, tracker.lost_stracks, tracker.removed_stracks)]


WARP = np.array([[math.cos(0.004), -math.sin(0.004), 3.5], [math.sin(0.004), math.cos(0.004), -2.25]], np.float32)


@pytest.mark.parametrize("case", ["gmc_none", "fixed_warp", "reid"])
def test_botsort_bitwise_equal_to_jax(case):
    stream = detection_stream(np.random.default_rng(4))
    args = botsort_args(gmc_method="none", with_reid=case == "reid")
    port, ref = bot_sort.BOTSORT(args, frame_rate=30, device="cpu"), jax_bs.BOTSORT(args, frame_rate=30)
    STrack.reset_id()
    JaxSTrack.reset_id()
    img = None
    if case == "fixed_warp":
        port.gmc.apply = ref.gmc.apply = lambda frame: WARP.copy()
        img = np.zeros((4, 4, 3), np.uint8)  # any frame: the warp is fixed
    if case == "reid":
        port.encoder = ref.encoder = StubEncoder()
    n_tracks = []
    for i, (boxes, scores, cls) in enumerate(stream):
        got, want = port.update(boxes, scores, cls, img), ref.update(boxes, scores, cls, img)
        np.testing.assert_array_equal(got, want, err_msg=f"frame {i}")
        assert state(port) == state(ref), i
        for a, b in zip(port.tracked_stracks + port.lost_stracks, ref.tracked_stracks + ref.lost_stracks):
            np.testing.assert_array_equal(a.mean, b.mean)
            np.testing.assert_array_equal(a.covariance, b.covariance)
            if case == "reid":
                np.testing.assert_array_equal(a.smooth_feat, b.smooth_feat)
        n_tracks.append(len(got))
    assert max(n_tracks) >= 20 and len(port.removed_stracks) > 0
    port.reset()
    assert port.frame_id == 0 and not port.tracked_stracks and not port.gmc.initialized


def test_gmc_methods_refused_by_name_and_none_accepted():
    for method in ("orb", "sift", "ecc"):
        with pytest.raises(NotImplementedError, match=f"gmc_method '{method}' is not ported"):
            bot_sort.BOTSORT(botsort_args(gmc_method=method), device="cpu")
    for method in ("none", "nosuch"):  # the identity, as in the JAX package
        g = bot_sort.BOTSORT(botsort_args(gmc_method=method), device="cpu").gmc
        np.testing.assert_array_equal(g.apply(np.zeros((64, 64, 3), np.uint8)), JaxGMC(method).apply(None))


# -- the motion compensation's steps against cv2 ------------------------------------------------------------------

def test_gray_and_half_resize_bit_equal_to_cv2():
    rng = np.random.default_rng(2)
    for h, w in ((320, 480), (321, 481), (7, 9)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        gray = bgr_to_gray_u8(torch.from_numpy(img)).numpy()
        np.testing.assert_array_equal(gray, cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
        half = resize_linear_u8(torch.from_numpy(gray)[None, :, :, None], (h // 2, w // 2))[0, :, :, 0].numpy()
        np.testing.assert_array_equal(half, cv2.resize(gray, (w // 2, h // 2)))
        np.testing.assert_array_equal(GMC(device="cpu").preprocess(img).numpy(), half)


def test_corner_response_and_corners_match_cv2():
    misses = total = 0
    for i, (h, w) in enumerate(((160, 240), (100, 133), (320, 480), (37, 31))):
        g = ground(h, w, i)
        want = cv2.cornerMinEigenVal(g, 3, 3)
        got = flow.corner_min_eigen_val(torch.from_numpy(g)).numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), (h, w)
        kw = cv2.goodFeaturesToTrack(g, maxCorners=1000, qualityLevel=0.01, minDistance=1, blockSize=3,
                                     useHarrisDetector=False, k=0.04)
        kg = flow.good_features_to_track(torch.from_numpy(g))
        assert kg.shape == kw.shape and kg.dtype == torch.float32, (h, w)
        misses += int((~(kg.numpy() == kw).all(-1)).sum())
        total += len(kw)
    assert total > 2500 and misses <= (1 - CORNER_SHARE) * total, f"{misses} of {total} corners differ from cv2's"
    assert flow.good_features_to_track(torch.full((32, 32), 90, dtype=torch.uint8)) is None  # no corner at all


def test_corner_ties_break_as_cv2():
    """Equal responses: the later pixel in row-major order first, as cv2 sorts them."""
    g = np.full((40, 60), 50, np.uint8)
    for y, x in ((8, 40), (8, 10), (25, 25), (30, 50)):  # equal squares: equal corner responses
        g[y:y + 6, x:x + 6] = 200
    want = cv2.goodFeaturesToTrack(g, 1000, 0.01, 1, blockSize=3)
    got = flow.good_features_to_track(torch.from_numpy(g)).numpy()
    resp = cv2.cornerMinEigenVal(g, 3, 3)[want[:, 0, 1].astype(int), want[:, 0, 0].astype(int)]
    assert len(np.unique(resp)) < len(resp)  # ties there are
    np.testing.assert_array_equal(got, want)


def test_pyramid_and_optical_flow_match_cv2():
    n_pts = n_status = n_both = 0
    worst = 0.0
    for i, ((h, w), (dx, dy, deg)) in enumerate((((160, 240), (3.3, -2.7, 0.3)), ((320, 480), (-6.0, 4.5, -0.2)),
                                                  ((240, 320), (0.4, 9.0, 0.0)))):
        g0 = ground(h, w, 10 + i)
        g1 = moved(g0, dx, dy, deg)
        n, pyr = cv2.buildOpticalFlowPyramid(g0, (21, 21), 3, withDerivatives=False)
        mine = flow.build_pyramid(torch.from_numpy(g0))
        assert len(mine) == n + 1
        for level, want in enumerate(pyr):
            np.testing.assert_array_equal(mine[level][flow.WIN:-flow.WIN, flow.WIN:-flow.WIN].numpy(), want)
        pts = cv2.goodFeaturesToTrack(g0, 1000, 0.01, 1, blockSize=3)
        pts = np.concatenate([pts, np.float32([[[-30, 5]], [[w + 40.0, h / 2]], [[3.5, 2.25]]])])  # out of the frame
        nw, sw, _ = cv2.calcOpticalFlowPyrLK(g0, g1, pts, None)
        ng, sg = (t.numpy() for t in flow.calc_optical_flow_pyr_lk(torch.from_numpy(g0), torch.from_numpy(g1),
                                                                    torch.from_numpy(pts)))
        both = (sw[:, 0] == 1) & (sg[:, 0] == 1)
        n_pts += len(pts)
        n_status += int((sw == sg).sum())
        n_both += int(both.sum())
        worst = max(worst, float(np.abs(ng - nw)[both].max()))
        assert sg[-3:-1, 0].tolist() == [0, 0] == sw[-3:-1, 0].tolist()
    assert n_status >= STATUS_SHARE * n_pts and n_both > 0.9 * n_pts
    assert worst <= LK_TOL, worst


def test_one_point_one_level_flow_matches_cv2():
    g0 = ground(64, 96, 20)
    g1 = moved(g0, 1.3, -0.8, 0.0)
    for x, y in ((40.0, 30.0), (10.25, 50.5), (80.75, 5.0), (0.0, 0.0)):
        pts = np.float32([[[x, y]]])
        nw, sw, _ = cv2.calcOpticalFlowPyrLK(g0, g1, pts, None, maxLevel=0)
        ng, sg = flow.calc_optical_flow_pyr_lk(torch.from_numpy(g0), torch.from_numpy(g1), torch.from_numpy(pts),
                                               max_level=0)
        assert sg.item() == sw.item(), (x, y)
        if sw.item():
            assert np.abs(ng.numpy() - nw).max() <= LK_TOL, (x, y)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimate_affine_partial_2d_matches_cv2(seed):
    rng = np.random.default_rng(seed)
    for n in (3, 7, 60, 400):
        src = rng.uniform(0, 480, (n, 1, 2)).astype(np.float32)
        a = rng.uniform(-0.01, 0.01)
        s = 1 + rng.uniform(-0.01, 0.01)
        m = np.array([[s * math.cos(a), -s * math.sin(a), rng.uniform(-10, 10)],
                      [s * math.sin(a), s * math.cos(a), rng.uniform(-10, 10)]])
        dst = (src @ m[:, :2].T + m[:, 2]).astype(np.float32) + rng.normal(0, 0.5, (n, 1, 2)).astype(np.float32)
        out = rng.random(n) < 0.3
        dst[out] += rng.uniform(-50, 50, (int(out.sum()), 1, 2)).astype(np.float32)
        mw, iw = cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)
        mg, ig = flow.estimate_affine_partial_2d(torch.from_numpy(src), torch.from_numpy(dst))
        np.testing.assert_array_equal(ig.numpy(), iw)
        assert np.abs(mg[:, :2] - mw[:, :2]).max() <= AB_TOL and np.abs(mg[:, 2] - mw[:, 2]).max() <= T_TOL, n
    one = np.float32([[[1, 2]]])
    with pytest.raises(cv2.error, match="At least 2 points"):
        cv2.estimateAffinePartial2D(one, one, method=cv2.RANSAC)
    with pytest.raises(ValueError, match="at least 2 point pairs"):
        flow.estimate_affine_partial_2d(torch.from_numpy(one), torch.from_numpy(one))
    same = np.zeros((5, 1, 2), np.float32)  # every pair degenerate: no model in either
    assert cv2.estimateAffinePartial2D(same, same, method=cv2.RANSAC)[0] is None
    assert flow.estimate_affine_partial_2d(torch.from_numpy(same), torch.from_numpy(same))[0] is None


def test_ransac_subsets_are_opencv_draws():
    """The best 2-point model before refinement, from the subsets the port draws, is cv2's with refineIters=0."""
    rng = np.random.default_rng(5)
    n = 300
    src = rng.uniform(0, 480, (n, 1, 2)).astype(np.float32)
    dst = src + np.float32([3, -2]) + rng.normal(0, 1.0, (n, 1, 2)).astype(np.float32)
    dst[rng.random(n) < 0.4] += np.float32([40, 25])
    mw, iw = cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC, refineIters=0)
    s, d = torch.from_numpy(src).reshape(-1, 2), torch.from_numpy(dst).reshape(-1, 2)
    sub = torch.from_numpy(flow.ransac_subsets(n))
    models = flow._two_point_models(s.double()[sub], d.double()[sub])
    best = flow.ransac_best(flow._inliers(models, s, d).sum(1).tolist(), n)
    a, b, tx, ty = models[best].tolist()
    np.testing.assert_array_equal(np.array([[a, -b, tx], [b, a, ty]]), mw)


# -- GMC and tracking over a panning clip --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clip():
    return panning_frames(np.random.default_rng(6), 16, CLIP_HW, 12, (10, 30), shift=(1.0, 5.0))


def test_gmc_matches_jax_over_a_panning_clip():
    frames, motions = panning_frames(np.random.default_rng(7), 12, (240, 320), 10, (8, 30), shift=(2.0, 8.0))
    port, ref = GMC(device="cpu"), JaxGMC()
    for i, f in enumerate(frames):
        got, want = port.apply(f), ref.apply(f)
        assert got.dtype == np.float32 and got.shape == (2, 3)
        assert np.abs(got[:, :2] - want[:, :2]).max() <= GMC_LIN_TOL, i
        assert np.abs(got[:, 2] - want[:, 2]).max() <= GMC_T_TOL, i
        if i:
            assert np.abs(got[:, 2] - motions[i][:, 2]).max() < 2.0, i  # the camera's motion, roughly
    port.reset_params()
    assert not port.initialized and port.prev_frame is None


def test_gmc_branches_match_jax():
    """A first frame without corners is stored only when it has corners; a frame without corners gives the
    identity and is not stored; too few tracked points warn and give the identity."""
    flat = np.full((96, 128, 3), 90, np.uint8)
    textured = np.stack([ground(96, 128, 30)] * 3, -1)
    for seq in ((flat, textured, flat, textured), (textured, flat, textured)):
        port, ref = GMC(device="cpu"), JaxGMC()
        for f in seq:
            np.testing.assert_allclose(port.apply(f), ref.apply(f), atol=1e-6)
            assert port.initialized == ref.initialized
            assert (port.prev_kpts is None) == (ref.prev_kpts is None)


def _bridged_pair():
    port = YOLO(FLAGSHIP_N, device="cpu")
    port.ensure_variables(imgsz=TRACK["imgsz"])
    port.model.load_state_dict(scored_weights(port.model.state_dict(), np.random.default_rng(0), -7.0, 30.0))
    ref = JaxYOLO(FLAGSHIP_N)
    ref.variables = convert_state_dict(ref.model, port.model.state_dict())
    return port, ref


def _assert_same_tracks(got, want, i):
    assert (got.boxes is None) == (want.boxes is None), i
    if want.boxes is None:
        return 0
    np.testing.assert_array_equal(got.boxes.id, want.boxes.id, err_msg=f"frame {i}")
    np.testing.assert_allclose(got.boxes.xywh[:, :2], want.boxes.xywh[:, :2], rtol=0, atol=CENTRE_TOL,
                               err_msg=f"frame {i}")
    return len(got.boxes)


def test_yolo_track_default_botsort_and_pipeline_match_jax(clip):
    frames, _ = clip
    port, ref = _bridged_pair()
    tracked = []
    STrack.reset_id()
    JaxSTrack.reset_id()
    for i, f in enumerate(frames):  # no tracker named: BoT-SORT with sparseOptFlow in both
        got, want = port.track(source=[f], persist=True, **TRACK)[0], ref.track(source=[f], persist=True, **TRACK)[0]
        tracked.append(_assert_same_tracks(got, want, i))
    assert isinstance(port.predictor.trackers[0], bot_sort.BOTSORT) and port.predictor.trackers[0].gmc.initialized
    assert isinstance(ref.predictor.trackers[0], jax_bs.BOTSORT)
    assert sum(t > 0 for t in tracked) >= len(frames) - 1 and max(tracked) >= 10
    warp = port.predictor.trackers[0].gmc
    assert warp.prev_frame.shape == (CLIP_HW[0] // 2, CLIP_HW[1] // 2)

    for m in (port, ref):  # new trackers and ids, as for a new video
        m.predictor.__dict__.pop("trackers", None)
        m.overrides.update(dtype="float32", iou=0.3)
    STrack.reset_id()
    JaxSTrack.reset_id()
    p_pipe = DroneVideoPipeline(port, None, None, imgsz=TRACK["imgsz"], conf=0.25, tracker="botsort.yaml")
    r_pipe = JaxPipeline(ref, None, None, imgsz=TRACK["imgsz"], conf=0.25, tracker="botsort.yaml")
    n_ids = set()
    for i, f in enumerate(frames):
        got, want = p_pipe.step(f), r_pipe.step(f)
        assert sorted(got["tracks"]) == sorted(want["tracks"]), i
        for tid, (x, y) in want["tracks"].items():
            assert abs(got["tracks"][tid][0] - x) <= CENTRE_TOL and abs(got["tracks"][tid][1] - y) <= CENTRE_TOL
        n_ids |= set(got["tracks"])
    assert len(n_ids) >= 10 and isinstance(port.predictor.trackers[0], bot_sort.BOTSORT)


def test_every_frame_reaches_the_motion_compensation():
    """Frames with no boxes, or only boxes of no height, still reach GMC (the JAX callback gives it orig_img)."""
    calls = []
    stub = types.SimpleNamespace(args=types.SimpleNamespace(tracker="botsort.yaml"), dataset=None,
                                 device=torch.device("cpu"))
    track.on_predict_start(stub, persist=True)
    stub.trackers[0].gmc.apply = lambda img: calls.append(img.shape) or np.eye(2, 3, dtype=np.float32)
    img = np.zeros((48, 64, 3), np.uint8)
    flat_box = np.array([[5, 40, 30, 40, 0.9, 0]], np.float32)
    for boxes in (None, flat_box, np.array([[5, 5, 30, 40, 0.9, 0]], np.float32)):
        stub.results = [Results(img, "f.jpg", {0: "a"}, boxes=boxes)]
        track.on_predict_postprocess_end(stub, persist=True)
    assert calls == [(48, 64, 3)] * 3 and stub.trackers[0].frame_id == 3
    assert len(stub.trackers[0].tracked_stracks) == 1  # the third frame's box: a new, unconfirmed track
    stub.frames = torch.from_numpy(img)[None]  # the predictor's upload takes the place of orig_img
    track.on_predict_postprocess_end(stub, persist=True)
    assert len(calls) == 4

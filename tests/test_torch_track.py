"""The port's tracking against the JAX package's, on the CPU.

ByteTrack, its Kalman filter and its matching are numpy/scipy in both packages: the same
detection streams (seeded, 48 targets over 120 frames with births, deaths, missed
detections, low-score detections and clutter) must give bitwise-equal tracks frame by
frame. `YOLO.track` runs the flagship at scale n (imgsz 128, float32) from one set of
weights (`chip_smoke.scored_weights`: spread kernels, class logits that follow the image)
over 128x128 frames of moving textured rectangles (`chip_smoke.moving_frames`) in both
facades: the same track ids, boxes within 1e-3 px.
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import detection_stream, moving_frames, scored_weights
from drone_yolo_tpu import YOLO as JaxYOLO
from drone_yolo_tpu.trackers import byte_tracker as jax_bt
from drone_yolo_tpu.trackers import matching as jax_matching
from drone_yolo_tpu.trackers.kalman_filter import KalmanFilterXYAH as JaxKalman
from drone_yolo_tpu.utils import yaml_load
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.trackers import byte_tracker, matching
from drone_yolo_tpu_torch.trackers.kalman_filter import KalmanFilterXYAH
from drone_yolo_tpu_torch.cfg import TRACKER_CFG_DIR
from drone_yolo_tpu_torch.trackers.track import load_tracker_cfg

torch.set_num_threads(1)

JAX_TRACKERS = Path(__file__).resolve().parents[1] / "drone_yolo_tpu" / "cfg" / "trackers"
FLAGSHIP_N = "yolov8n-p2-repvgg-sf.yaml"
# NMS at IoU 0.3 leaves ~35 boxes a frame; at the default 0.7 ~200 overlapping random-weight boxes remain, among
# which float32 rounding in either package decides near-ties of the keep mask and of the assignment. Square frames
# at imgsz: no letterbox border, whose constant pixels give neighbouring anchors equal scores (ties in the sort).
TRACK = dict(imgsz=128, iou=0.3, tracker="bytetrack.yaml", dtype="float32", verbose=False)
BOX_TOL = 1e-3  # px in the original frame, as tests/test_torch_predict.py
DET_GAIN, DET_BIAS = 30.0, -7.0  # class logits of the n-scale flagship at 128 px: ~90% of anchors above 0.25


def tracker_args(**kw):
    return types.SimpleNamespace(**{**yaml_load(TRACKER_CFG_DIR / "bytetrack.yaml"), **kw})


def state(tracker):
    """The ids of the tracker's tracked, lost and removed tracks, with their states and frame ids."""
    return [[(t.track_id, t.state, t.frame_id, t.start_frame, t.is_activated) for t in lst]
            for lst in (tracker.tracked_stracks, tracker.lost_stracks, tracker.removed_stracks)]


@pytest.mark.parametrize("seed,fuse", [(0, True), (1, True), (2, True), (0, False)])
def test_bytetrack_bitwise_equal_to_jax(seed, fuse):
    stream = detection_stream(np.random.default_rng(seed))
    args = tracker_args(fuse_score=fuse)
    port, ref = byte_tracker.BYTETracker(args, frame_rate=30), jax_bt.BYTETracker(args, frame_rate=30)
    byte_tracker.STrack.reset_id()  # each package's id counter, shared by its trackers
    jax_bt.STrack.reset_id()
    ids = set()
    for f, (boxes, scores, cls) in enumerate(stream):
        got = port.update(boxes.copy(), scores.copy(), cls.copy())
        want = ref.update(boxes.copy(), scores.copy(), cls.copy())
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f"frame {f}")
        assert state(port) == state(ref), f
        ids |= set(got[:, 4].astype(int).tolist()) if len(got) else set()
    assert len(ids) >= 40  # births and deaths: many tracks came and went
    assert len(port.removed_stracks) > 0 and len(port.lost_stracks) + len(port.removed_stracks) > 10


def test_track_ids_restart_per_tracker():
    """The id counter is shared by every tracker of a package and reset by a new tracker and by `reset`."""
    stream = detection_stream(np.random.default_rng(3), n_frames=5)
    args = tracker_args()
    for bt in (byte_tracker, jax_bt):
        a = bt.BYTETracker(args)
        first = [a.update(*fr) for fr in stream]
        a.reset()
        again = [a.update(*fr) for fr in stream]
        assert all(np.array_equal(x, y) for x, y in zip(first, again))
        bt.BYTETracker(args)
        assert bt.STrack._count == 0


def test_kalman_filter_equal_to_jax():
    rng = np.random.default_rng(4)
    port, ref = KalmanFilterXYAH(), JaxKalman()
    for _ in range(20):
        meas = np.array([rng.uniform(0, 1000), rng.uniform(0, 700), rng.uniform(0.3, 3), rng.uniform(10, 200)])
        m1, c1 = port.initiate(meas)
        m2, c2 = ref.initiate(meas)
        for _ in range(5):
            m1, c1 = port.predict(m1, c1)
            m2, c2 = ref.predict(m2, c2)
            z = m1[:4] + rng.normal(0, 2, 4)
            m1, c1 = port.update(m1, c1, z)
            m2, c2 = ref.update(m2, c2, z)
            for a, b in zip((m1, c1, *port.project(m1, c1)), (m2, c2, *ref.project(m2, c2))):
                assert a.dtype == b.dtype == np.float64
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(0, 0), (0, 5), (6, 0), (7, 7), (9, 4), (3, 12)])
def test_linear_assignment_equal_to_jax(shape):
    cost = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    for thresh in (0.3, 0.8):
        got, want = matching.linear_assignment(cost, thresh), jax_matching.linear_assignment(cost, thresh)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_iou_distance_and_fuse_score_equal_to_jax():
    rng = np.random.default_rng(5)
    boxes, scores, cls = detection_stream(rng, n_frames=1, n_targets=30)[0]
    xywh = np.concatenate([(boxes[:, :2] + boxes[:, 2:]) / 2, boxes[:, 2:] - boxes[:, :2]], 1)
    a = [byte_tracker.STrack(x, s, c) for x, s, c in zip(xywh, scores, cls)]
    b = [jax_bt.STrack(x, s, c) for x, s, c in zip(xywh, scores, cls)]
    other = boxes[::-1] + rng.normal(0, 3, boxes.shape).astype(np.float32)
    for x, y in ((a, b), (list(boxes), list(boxes)), ([], []), (a[:3], b[:3])):
        got, want = matching.iou_distance(x, list(other)), jax_matching.iou_distance(y, list(other))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(matching.fuse_score(got, a[: got.shape[1]]),
                                      jax_matching.fuse_score(want, b[: want.shape[1]]))


def test_tracker_cfg_reader(tmp_path):
    """bytetrack.yaml as the JAX package reads it; a user's yaml by path; BoT-SORT refused by name."""
    cfg = load_tracker_cfg("bytetrack.yaml")
    assert vars(cfg) == yaml_load(JAX_TRACKERS / "bytetrack.yaml")
    own = tmp_path / "mine.yaml"
    own.write_text("tracker_type: bytetrack\ntrack_high_thresh: 0.5 # high\ntrack_low_thresh: 0.2\n"
                   "new_track_thresh: 0.6\ntrack_buffer: 60\nmatch_thresh: 0.9\nfuse_score: False\n")
    assert vars(load_tracker_cfg(own)) == yaml_load(own)
    with pytest.raises(ValueError, match="not ported yet"):
        load_tracker_cfg(JAX_TRACKERS / "botsort.yaml")
    with pytest.raises(FileNotFoundError):
        load_tracker_cfg("nosuch.yaml")


@pytest.fixture(scope="module")
def track_pair():
    """(port facade, JAX facade, frames) with one set of weights."""
    port = YOLO(FLAGSHIP_N, device="cpu")
    port.ensure_variables(imgsz=128)
    port.model.load_state_dict(scored_weights(port.model.state_dict(), np.random.default_rng(0), DET_BIAS, DET_GAIN))
    ref = JaxYOLO(FLAGSHIP_N)
    ref.variables = convert_state_dict(ref.model, port.model.state_dict())
    return port, ref, moving_frames(np.random.default_rng(1), 8, (128, 128), 24)


def test_yolo_track_matches_jax(track_pair):
    port, ref, frames = track_pair
    n_tracked = []
    for i, frame in enumerate(frames):
        got = port.track(source=[frame], persist=True, **TRACK)[0]
        want = ref.track(source=[frame], persist=True, **TRACK)[0]
        assert (got.boxes is None) == (want.boxes is None), i
        if want.boxes is None:
            continue
        assert got.boxes.is_track and got.boxes.data.shape == want.boxes.data.shape, i
        np.testing.assert_array_equal(got.boxes.id, want.boxes.id, err_msg=f"frame {i}")
        np.testing.assert_allclose(got.boxes.xyxy, want.boxes.xyxy, rtol=0, atol=BOX_TOL, err_msg=f"frame {i}")
        np.testing.assert_allclose(got.boxes.conf, want.boxes.conf, rtol=1e-4, atol=1e-7)
        np.testing.assert_array_equal(got.boxes.cls, want.boxes.cls)
        n_tracked.append(len(got.boxes))
    assert len(n_tracked) >= len(frames) - 1 and max(n_tracked) >= 20  # tracks from the second frame on
    assert port.predictor.args.conf == 0.1


def test_zero_height_boxes_are_not_tracked():
    """A detection clipped to zero height at the frame's edge: the port leaves it out of the tracker; the JAX
    package's tracker takes it, gets an infinite aspect ratio, and stops on NaN costs a frame later (ROADMAP.md
    queue 3)."""
    from drone_yolo_tpu.engine.results import Results as JaxResults
    from drone_yolo_tpu.trackers import track as jax_track

    from drone_yolo_tpu_torch.engine.results import Results
    from drone_yolo_tpu_torch.trackers import track

    img = np.zeros((90, 160, 3), np.uint8)
    boxes = np.array([[10, 10, 40, 50, 0.9, 0], [60, 90, 100, 90, 0.8, 0]], np.float32)  # the second: no height
    for pkg, results_cls, fails in ((track, Results, False), (jax_track, JaxResults, True)):
        stub = types.SimpleNamespace(args=types.SimpleNamespace(tracker="bytetrack.yaml"), dataset=None)
        try:
            for _ in range(3):
                stub.results = [results_cls(img, "f.jpg", {0: "a"}, boxes=boxes + np.float32([1, 0, 1, 0, 0, 0]))]
                pkg.on_predict_postprocess_end(stub, persist=True)
        except ValueError as e:
            assert fails and "invalid numeric entries" in str(e)
            continue
        assert not fails and stub.results[0].boxes.is_track and stub.results[0].boxes.id.tolist() == [1.0]

"""The port's analytics apps (`drone_yolo_tpu_torch/solutions/`), the Annotator's solution primitives and
`apply_color_map` against the JAX package and cv2, on the CPU.

- `ops/draw.py:apply_color_map` equal to `cv2.applyColorMap` for OpenCV 5.0's 22 colormaps at every level.
- Each solution primitive of the port's Annotator against the JAX one's: bit for bit outside the text boxes, within
  `TEXT_MEAN_TOL` inside them, and bit for bit against the JAX drawing with the port's glyphs
  (`tests/test_torch_plotting.py:assert_equal_but_glyphs`).
- On the same weights: one random init of the flagship at 128 px (n scale, `chip_smoke.scored_weights`), bridged to
  JAX, float32, NMS at IoU 0.3, ByteTrack (set through each facade's `overrides`), over the same moving frames. Each
  tracking app of the port, driven by the port facade, against the JAX app driven by the JAX facade: the same track
  ids and every count, region count, queue count, pair, parking occupancy, alarm state and series exactly; speeds and
  distances within what the two packages' boxes differ by (1e-3 px, as tests/test_torch_track.py holds them).
- The same apps fed the same seeded tracks (boxes that move 3-12 px a frame, so that they cross the lines and the
  regions' edges, inside the frame: the JAX `Heatmap` raises on a box past the right or bottom edge, see
  `test_heatmap_past_the_edge`; the random-weight detector's own tracks barely move), and `AIGym` and
  `InstanceSegmentation` fed the same seeded keypoints and masks: every output exactly, the heatmap's float32 map bit
  for bit, every returned frame as the drawings above.
- The JAX package's own fake-model cases (line crossing, the mouse selection of `DistanceCalculation`) and its
  fake-UI run of `Inference` (with `chip_smoke.fake_streamlit`), on the port; the port's frame source over an MJPEG
  AVI, its refusals and the upload's suffix.
"""

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import fake_streamlit, moving_frames, scored_weights
from drone_yolo_tpu import YOLO as JaxYOLO
from drone_yolo_tpu import solutions as JS
from drone_yolo_tpu.engine.results import Boxes as JaxBoxes
from drone_yolo_tpu.engine.results import Results as JaxResults
from drone_yolo_tpu.trackers.byte_tracker import STrack as JaxSTrack
from drone_yolo_tpu.utils import plotting as JP
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch import solutions as PS
from drone_yolo_tpu_torch.data.avi import AviReader
from drone_yolo_tpu_torch.engine.results import Boxes, Results
from drone_yolo_tpu_torch.ops import draw
from drone_yolo_tpu_torch.solutions.distance_calculation import EVENT_LBUTTONDOWN, EVENT_RBUTTONDOWN
from drone_yolo_tpu_torch.solutions.inference_app import FrameCapture
from drone_yolo_tpu_torch.trackers.byte_tracker import STrack
from drone_yolo_tpu_torch.utils import plotting as PP
from test_torch_plotting import assert_equal_but_glyphs, label_boxes, port_glyphs

torch.set_num_threads(1)

HW = (128, 128)
FRAMES = 3
REPLAY_FRAMES = 5
DET = ("yolov8n-p2-repvgg-sf.yaml", -9.0, 30.0)  # ~10 tracks a frame
OVERRIDES = {"dtype": "float32", "iou": 0.3, "tracker": "bytetrack.yaml", "imgsz": HW[0]}
BOX_TOL = 1e-3  # px: the two packages' boxes (tests/test_torch_track.py)
NAMES = {i: f"class{i}" for i in range(80)}
MID = [(24, 24), (104, 24), (104, 104), (24, 104)]
# TrackZone's zone, a pentagon (fill_poly's sloped edges). On the frames blacked out outside the square MID, the two
# packages' float32 detectors part on one box near conf 0.25 in the third frame (0.2448 in JAX's NMS, dropped in the
# port's), as any two float32 forwards that sum in different orders may; inside this zone they do not
ZONE = [(20, 30), (100, 10), (118, 80), (64, 120), (8, 90)]
SLOTS = [[(x, y), (x + 32, y), (x + 32, y + 32), (x, y + 32)] for y in range(0, 128, 32) for x in range(0, 128, 32)]
# (app, keyword arguments): every tracking app, each with its region or its parameters at 128 px
APPS = {
    "line": ("ObjectCounter", dict(region=[(0, 64), (128, 64)])),
    "polygon": ("ObjectCounter", dict(region=MID)),
    "regions": ("RegionCounter", dict(regions={"left": [(0, 0), (64, 0), (64, 128), (0, 128)],
                                               "right": [(64, 0), (128, 0), (128, 128), (64, 128)]})),
    "region_dict": ("RegionCounter", dict(region={"top": [(0, 0), (128, 0), (128, 64), (0, 64)]})),
    "queue": ("QueueManager", dict(region=MID)),
    "speed": ("SpeedEstimator", dict(meters_per_pixel=0.1, fps=25.0)),
    "distance": ("DistanceCalculation", dict(meters_per_pixel=0.1)),
    "heatmap": ("Heatmap", dict()),
    "heatmap_jet": ("Heatmap", dict(colormap=cv2.COLORMAP_JET)),
    "parking": ("ParkingManagement", dict(parking_regions=SLOTS)),
    "alarm": ("SecurityAlarm", dict(records=8, on_alarm=lambda n: None)),
    "zone": ("TrackZone", dict(region=ZONE)),
    "analytics": ("Analytics", dict()),
}
FLOATS = {"speeds", "distance_m"}  # outputs computed from box coordinates


def text_mask(calls, shape):
    """The text boxes of the recorded `put_text` calls [(text, org, font_scale)]."""
    m = np.zeros(shape[:2], bool)
    for text, org, sf in calls:
        m |= label_boxes(shape, round(sf * 3), [(text, org)])
    return m


@pytest.fixture
def record_text(monkeypatch):
    """The port's put_text calls, recorded."""
    calls, put_text = [], draw.put_text

    def recording(img, text, org, font_scale, *a, **kw):
        calls.append((text, (int(org[0]), int(org[1])), font_scale))
        return put_text(img, text, org, font_scale, *a, **kw)

    monkeypatch.setattr(draw, "put_text", recording)
    return calls


def equal_outputs(got: dict, want: dict, floats_tol: float | None = None):
    assert got.keys() == want.keys()
    for k in got:
        if k in ("im0", "heatmap"):
            continue
        if floats_tol is not None and k in FLOATS:
            g, w = got[k], want[k]
            if isinstance(w, dict):
                assert g.keys() == w.keys(), k
                g, w = list(g.values()), list(w.values())
            np.testing.assert_allclose(np.asarray(g, float), np.asarray(w, float), rtol=0, atol=floats_tol, err_msg=k)
        else:
            assert got[k] == want[k], k


# -- colormaps and the Annotator's primitives ---------------------------------------------------------------------
@pytest.mark.parametrize("colormap", range(22))
def test_apply_color_map_equals_cv2(colormap):
    levels = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(draw.apply_color_map(levels, colormap), cv2.applyColorMap(levels, colormap))
    img = np.random.default_rng(colormap).integers(0, 256, (40, 70), dtype=np.uint8)
    np.testing.assert_array_equal(draw.apply_color_map(img[..., None], colormap), cv2.applyColorMap(img, colormap))
    name = next(n for n in dir(cv2) if n.startswith("COLORMAP_") and getattr(cv2, n) == colormap)
    assert getattr(draw, name) == colormap


def test_apply_color_map_refuses_color_images():
    with pytest.raises(ValueError, match="one-channel uint8"):
        draw.apply_color_map(np.zeros((4, 4, 3), np.uint8), 0)
    with pytest.raises(ValueError, match="0..21"):
        draw.apply_color_map(np.zeros((4, 4), np.uint8), 22)


PRIMITIVES = {
    "draw_region": lambda a: a.draw_region([(10, 12), (120, 30), (90, 100), (-5, 80)], color=(104, 0, 123),
                                           thickness=4),
    "draw_centroid_and_tracks": lambda a: a.draw_centroid_and_tracks([(5.5, 7.2), (20.1, 30.9), (60.7, 33.3),
                                                                      (80.2, 90.8)], color=(0, 200, 255),
                                                                     track_thickness=3),
    "label_box": lambda a: a._label_box((70.6, 50.2), "car 12", (255, 0, 0), (255, 255, 255), margin=7),
    "queue_counts_display": lambda a: a.queue_counts_display("Queue Counts : 3", points=MID),
    "display_objects_labels": lambda a: a.display_objects_labels(a.im, "left: 4", (255, 255, 255), (104, 0, 123), 40.5,
                                                                 90.2),
    "display_analytics": lambda a: a.display_analytics(a.im, {"Occupancy": 3, "Available": 13, "class7": "IN 1 OUT 0"}),
    "plot_angle_and_count_and_stage": lambda a: a.plot_angle_and_count_and_stage("147.3", 2, "up", (30.7, 40.2)),
    "plot_distance_and_line": lambda a: a.plot_distance_and_line(57.123, ((20.5, 100.2), (110.9, 70.1))),
    "visioneye": lambda a: a.visioneye([30, 40, 70, 90], (5, 120)),
}


@pytest.mark.parametrize("name", PRIMITIVES)
@pytest.mark.parametrize("lw", [2, 3])
def test_annotator_primitives_equal_jax(name, lw, record_text):
    img = np.random.default_rng([lw, len(name)]).integers(0, 256, (130, 150, 3), dtype=np.uint8)
    port, ref, ref_pg = (cls(img.copy(), line_width=lw) for cls in (PP.Annotator, JP.Annotator, JP.Annotator))
    PRIMITIVES[name](port)
    PRIMITIVES[name](ref)
    port_glyphs(PRIMITIVES[name], ref_pg)
    assert_equal_but_glyphs(port.result(), ref.result(), ref_pg.result(), text_mask(record_text, img.shape), name)
    assert (name == "draw_region" or name == "draw_centroid_and_tracks" or name == "visioneye") != bool(record_text)
    pts = [(3.0, 4.0), (10.0, 4.0), (10.0, 20.0)]
    assert PP.Annotator.estimate_pose_angle(*pts) == JP.Annotator.estimate_pose_angle(*pts)


# -- the apps on the same weights ---------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    """(port facade, JAX facade, frames): one set of weights."""
    name, bias, gain = DET
    port = YOLO(name, device="cpu")
    port.ensure_variables(imgsz=HW[0])
    port.model.load_state_dict(scored_weights(port.model.state_dict(), np.random.default_rng(0), bias, gain))
    port.overrides.update(OVERRIDES)
    ref = JaxYOLO(name)
    ref.variables = convert_state_dict(ref.model, port.model.state_dict())
    ref.overrides.update(OVERRIDES)
    return port, ref, moving_frames(np.random.default_rng(2), FRAMES, HW, 12)


def new_trackers(*facades):
    for m in facades:
        if m.predictor is not None and hasattr(m.predictor, "trackers"):
            del m.predictor.trackers
    STrack.reset_id()
    JaxSTrack.reset_id()


@pytest.mark.parametrize("case", [c for c in APPS if c != "heatmap_jet"])
def test_apps_on_the_models_equal_jax(case, models):
    port_model, ref_model, frames = models
    app, kw = APPS[case]
    new_trackers(port_model, ref_model)
    got, want = getattr(PS, app)(model=port_model, **kw), getattr(JS, app)(model=ref_model, **kw)
    for f in frames:
        g = got.process(f)
        if app == "Heatmap" and past_the_edge(got.boxes, f.shape):
            with pytest.raises(ValueError, match="broadcast"):  # the JAX map's slice is smaller than the bump there
                want.process(f)
            return
        w = want.process(f)
        assert got.track_ids == want.track_ids and len(got.track_ids) > 0
        np.testing.assert_allclose(got.boxes, want.boxes, rtol=0, atol=BOX_TOL)
        equal_outputs(g, w, floats_tol=0.1 * 25 * 3.6 * BOX_TOL * 2)  # a speed: mpp x fps x 3.6 x two centres' error
        assert g["im0"].shape == w["im0"].shape and g["im0"].dtype == np.uint8


def past_the_edge(boxes, shape) -> bool:
    """Whether a box's bump reaches past the map's bottom or right edge, where the JAX heatmap raises."""
    for x1, y1, x2, y2 in np.asarray(boxes)[:, :4].astype(int):
        if max(y1, 0) + max(y2 - y1, 1) > shape[0] or max(x1, 0) + max(x2 - x1, 1) > shape[1]:
            return True
    return False


def moving_tracks(rng, n_frames: int, n: int = 9):
    """Each frame's track rows [x1, y1, x2, y2, id, conf, cls] of `n` boxes that move 3-12 px a frame inside the
    frame (clipped to it), born and ending at random frames."""
    xy, wh = rng.uniform(8, 100, (n, 2)), rng.uniform(6, 28, (n, 2))
    vel = rng.uniform(3, 12, (n, 2)) * rng.choice([-1, 1], (n, 2))
    start, stop = rng.integers(0, 2, n), rng.integers(n_frames - 1, n_frames + 1, n)
    cls, conf = rng.integers(0, 4, n), rng.uniform(0.3, 1, n)
    rows = []
    for f in range(n_frames):
        on = np.flatnonzero((start <= f) & (f < stop))
        p = xy[on] + vel[on] * f
        box = np.clip(np.concatenate([p, p + wh[on]], 1), 0, np.array(HW[::-1] * 2) - 1)
        rows.append(np.concatenate([box, on[:, None] + 1, conf[on, None], cls[on, None]], 1).astype(np.float32))
    return rows


class FakeModel:
    """A facade that replays results: `track` and `predict` return the next of `results`."""

    names = NAMES

    def __init__(self, results):
        self.results = iter(results)

    def track(self, source=None, **kw):
        return [next(self.results)]

    predict = track


def replay(package: str, frames, rows):
    """Each frame's Results of the package ([x1, y1, x2, y2, id, conf, cls] rows, or (boxes, extra) pairs)."""
    res_cls, boxes_cls = (Results, Boxes) if package == "port" else (JaxResults, JaxBoxes)
    out = []
    for f, r in zip(frames, rows):
        if isinstance(r, tuple):
            out.append(res_cls(f, "f.jpg", NAMES, boxes=r[0], **r[1]))
        else:
            res = res_cls(f, "f.jpg", NAMES)
            res.boxes = boxes_cls(r, f.shape[:2])
            out.append(res)
    return out


def run_three(app, kw, frames, rows, record_text):
    """The port's app and two JAX apps (cv2's glyphs; the port's glyphs) over the same replayed results: per frame
    (port output, JAX output, JAX output with the port's glyphs, the port's text boxes)."""
    apps = [getattr(pkg, app)(model=FakeModel(replay(name, frames, rows)), **kw)
            for pkg, name in ((PS, "port"), (JS, "jax"), (JS, "jax"))]
    out = []
    for f in frames:
        record_text.clear()
        g = apps[0].process(f)
        mask = text_mask(record_text, f.shape)
        out.append((g, apps[1].process(f), port_glyphs(apps[2].process, f), mask))
    return out


@pytest.fixture(scope="module")
def replay_frames():
    return moving_frames(np.random.default_rng(5), REPLAY_FRAMES, HW, 6)


@pytest.mark.parametrize("case", APPS)
def test_apps_replayed_equal_jax(case, replay_frames, record_text):
    app, kw = APPS[case]
    outs = run_three(app, kw, replay_frames, moving_tracks(np.random.default_rng(1), REPLAY_FRAMES), record_text)
    for i, (g, w, wpg, mask) in enumerate(outs):
        equal_outputs(g, w)
        if app == "Heatmap":
            assert g["heatmap"].dtype == np.float32 and g["heatmap"].max() > 0
            np.testing.assert_array_equal(g["heatmap"], w["heatmap"])
        assert_equal_but_glyphs(g["im0"], w["im0"], wpg["im0"], mask, f"{case} frame {i}")
    last = outs[-1][0]
    if app == "ObjectCounter":
        assert last["in_count"] + last["out_count"] > 0  # the tracks cross the line and the polygon's edges
    elif app == "SpeedEstimator":
        assert len(last["speeds"]) > 5
    elif app == "QueueManager":
        assert last["queue_count"] > 0


def people(rng, n_frames: int, n: int = 3):
    """Boxes (x1, y1, x2, y2, conf, cls) and 17 keypoints (x, y, conf) of `n` people whose right elbow (keypoint 8)
    swings so that the angle at it crosses 90 and 145 degrees."""
    out = []
    for f in range(n_frames):
        kp = rng.uniform(10, 110, (n, 17, 3))
        kp[..., 2] = rng.uniform(0.3, 1, (n, 17))
        ang = np.radians([60 + 110 * ((f + p) % 2) for p in range(n)])
        kp[:, 6, :2], kp[:, 8, :2] = [[40, 40]] * n, [[60, 60]] * n
        kp[:, 10, 0], kp[:, 10, 1] = 60 + 30 * np.cos(ang + np.radians(225)), 60 + 30 * np.sin(ang + np.radians(225))
        boxes = np.concatenate([kp[:, :, :2].min(1), kp[:, :, :2].max(1), rng.uniform(0.3, 1, (n, 1)),
                                np.zeros((n, 1))], 1)
        out.append((boxes.astype(np.float32), {"keypoints": kp.astype(np.float32)}))
    return out


@pytest.mark.parametrize("app", ["AIGym", "InstanceSegmentation"])
def test_predict_apps_replayed_equal_jax(app, replay_frames, record_text):
    frames = replay_frames
    rng = np.random.default_rng(4)
    if app == "AIGym":
        rows = people(rng, len(frames))
    else:
        rows = []
        for _ in frames:
            xy, wh = rng.uniform(0, 100, (5, 2)), rng.uniform(8, 40, (5, 2))
            boxes = np.concatenate([xy, xy + wh, rng.uniform(0.3, 1, (5, 1)), rng.integers(0, 8, (5, 1))], 1)
            rows.append((boxes.astype(np.float32), {"masks": rng.random((5, *HW)) > 0.7}))
    outs = run_three(app, {}, frames, rows, record_text)
    for i, (g, w, wpg, mask) in enumerate(outs):
        equal_outputs(g, w)
        assert_equal_but_glyphs(g["im0"], w["im0"], wpg["im0"], mask, f"{app} frame {i}")
    if app == "AIGym":
        assert sum(outs[-1][0]["counts"].values()) > 0 and set(outs[-1][0]["stages"].values()) <= {"up", "down"}


def test_heatmap_past_the_edge():
    """A track box past the right or bottom edge: the JAX heatmap raises (its slice of the map is smaller than the
    bump); the port cuts the bump at the edge. Inside the frame both add the same bump."""
    img = np.zeros((60, 80, 3), np.uint8)
    rows = [np.array([[50.7, 30.2, 95.1, 70.9, 1, 0.9, 0], [-10.5, -6.0, 20.2, 18.9, 2, 0.8, 1]], np.float32)]
    got = PS.Heatmap(model=FakeModel(replay("port", [img], rows))).process(img)["heatmap"]
    with pytest.raises(ValueError, match="broadcast"):
        JS.Heatmap(model=FakeModel(replay("jax", [img], rows))).process(img)
    inside = JS.Heatmap(model=FakeModel(replay("jax", [img], [rows[0][1:]]))).process(img)["heatmap"]
    h, w = 70 - 30, 95 - 50
    yy, xx = np.mgrid[0:h, 0:w]
    bump = np.exp(-(((yy - h / 2) / (h / 2 + 1e-6)) ** 2 + ((xx - w / 2) / (w / 2 + 1e-6)) ** 2)).astype(np.float32)
    want = inside.copy()
    want[30:, 50:] += bump[:30, :30]
    np.testing.assert_array_equal(got, want)


# -- the JAX package's fake-model cases on the port -----------------------------------------------------------------
class Tracked:
    """A facade whose `track` returns the result set in `r`."""

    names = {0: "person"}
    r = None

    def track(self, source=None, **kw):
        return [self.r]


def one_result(package: str, rows):
    res = (Results if package == "port" else JaxResults)(np.zeros((100, 100, 3), np.uint8), "f.jpg", {0: "person"})
    res.boxes = (Boxes if package == "port" else JaxBoxes)(np.array(rows, np.float32), (100, 100))
    return res


def test_object_counter_line_crossing():
    fakes = Tracked(), Tracked()
    got, want = PS.ObjectCounter(model=fakes[0], region=[(0, 50), (100, 50)]), \
        JS.ObjectCounter(model=fakes[1], region=[(0, 50), (100, 50)])
    for y in (30, 45, 60, 75):  # crosses the line at y = 50
        fakes[0].r, fakes[1].r = one_result("port", [[10, y - 5, 20, y + 5, 7, 0.9, 0]]), \
            one_result("jax", [[10, y - 5, 20, y + 5, 7, 0.9, 0]])
        out = got.process(np.zeros((100, 100, 3), np.uint8))
        equal_outputs(out, want.process(np.zeros((100, 100, 3), np.uint8)))
    assert got.in_count + got.out_count == 1
    assert out["classwise"]["person"]["IN"] + out["classwise"]["person"]["OUT"] == 1


def test_distance_calculation_mouse_selection():
    assert (EVENT_LBUTTONDOWN, EVENT_RBUTTONDOWN) == (cv2.EVENT_LBUTTONDOWN, cv2.EVENT_RBUTTONDOWN)
    fake = Tracked()
    fake.r = one_result("port", [[10, 10, 30, 30, 1, 0.9, 0], [60, 60, 90, 90, 2, 0.9, 0], [40, 5, 50, 15, 3, 0.9, 0]])
    dc = PS.DistanceCalculation(model=fake, meters_per_pixel=0.1)
    assert dc.attach_window() is False  # no window without HighGUI
    frame = np.zeros((100, 100, 3), np.uint8)
    assert dc.process(frame)["pair"] == [1, 2]  # the first two tracks
    dc.mouse_event_for_distance(EVENT_LBUTTONDOWN, 45, 10)  # the box of track 3
    dc.mouse_event_for_distance(EVENT_LBUTTONDOWN, 20, 20)  # the box of track 1
    out = dc.process(frame)
    assert out["pair"] == [3, 1] and abs(out["distance_m"] - np.hypot(25, 10) * 0.1) < 1e-6
    dc.mouse_event_for_distance(EVENT_RBUTTONDOWN, 0, 0)  # clears the picks
    assert dc.process(frame)["pair"] == [1, 2]


# -- the browser app -----------------------------------------------------------------------------------------------
class FakeCap:
    def __init__(self, source):
        self.n = 2  # two frames, then the end

    def isOpened(self):
        return self.n > 0

    def read(self):
        self.n -= 1
        if self.n < 0:
            return False, None
        return True, np.full((64, 80, 3), 128, np.uint8)

    def release(self):
        self.n = 0


def test_inference_app_under_fakes():
    """The JAX package's fake-UI run: both panes get both frames, the annotated one an HWC image."""
    st = fake_streamlit({"Enable Tracking": "No"})  # the webcam, the first model, tracking off
    PS.Inference(st_module=st, capture_factory=FakeCap, model="yolov8n.yaml", device="cpu").inference()
    assert len(st.panes[0].frames) == 2 and len(st.panes[1].frames) == 2
    assert st.panes[1].frames[0].ndim == 3


def test_inference_app_reads_an_uploaded_avi(tmp_path, monkeypatch):
    """The default frame source over an uploaded MJPEG AVI: the upload keeps its suffix, every frame reaches both
    panes as the port's AVI reader decodes it; a webcam and undecoded containers are refused by name."""
    clip = tmp_path / "clip.avi"
    writer = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (80, 64))
    for f in range(3):
        writer.write(np.full((64, 80, 3), 50 * f + 20, np.uint8))
    writer.release()

    class Upload:
        name = "Clip.AVI"

        def read(self):
            return clip.read_bytes()

    monkeypatch.chdir(tmp_path)
    st = fake_streamlit({"Video": "video", "Enable Tracking": "No"}, Upload())
    PS.Inference(st_module=st, model="yolov8n.yaml", device="cpu").inference()
    with AviReader(tmp_path / "drone_yolo_upload.avi") as reader:
        want = [reader.frame(i) for i in range(len(reader))]
    assert len(want) == 3 and len(st.panes[1].frames) == 3
    for got, w in zip(st.panes[0].frames, want):
        np.testing.assert_array_equal(got, w)
    assert st.messages == [("warning", "Failed to read frame.")]  # the end of the clip, as the JAX loop ends
    st = fake_streamlit({"Video": "video", "Enable Tracking": "No"})  # nothing uploaded: nothing to open
    PS.Inference(st_module=st, model="yolov8n.yaml", device="cpu").inference()
    assert st.messages == [("error", "Could not open source.")] and not st.panes[0].frames
    with pytest.raises(NotImplementedError, match="webcam 0"):
        FrameCapture(0)
    (tmp_path / "c.mp4").write_bytes(b"\0" * 16)
    with pytest.raises(NotImplementedError, match=r"\.mp4 videos are not decoded"):
        FrameCapture(str(tmp_path / "c.mp4"))
    with pytest.raises(ImportError, match="streamlit"):
        PS.Inference(model="yolov8n.yaml")


def test_solutions_export_the_jax_names():
    assert PS.__all__ == JS.__all__
    assert all(hasattr(PS, n) for n in PS.__all__)

"""The port's drone-video application layer against the JAX package's, on the CPU.

Geo conversion and the analytics are numpy/scipy in both packages: equal results. The
pipeline (`DroneVideoPipeline`: the flagship at scale n tracking, the n-scale pose model,
a GeoConverter) runs in both packages from one set of weights per model
(`chip_smoke.scored_weights`) over 128x128 frames of moving textured rectangles, in
float32 with NMS at IoU 0.3 (set through each facade's `overrides`; see
tests/test_torch_track.py for why): the same track ids and smoothed centres each step, the
same pose detections, and the same CSV rows within the CSV's own rounding. `run` over a
printf-pattern JPEG sequence equals `step` over the decoded frames, and the port runs
the whole path with jax, the JAX package, cv2, PIL, yaml, sklearn, matplotlib and streamlit blocked: tracking,
pose, the pipeline over a JPEG sequence and over an MJPEG AVI, the command line (predict over a
directory of JPEG, PNG and AVI, track, both with save=True, which draws; val), the gait study and two analytics apps.
"""

import csv
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import moving_frames, scored_weights
from drone_yolo_tpu import YOLO as JaxYOLO
from drone_yolo_tpu.apps import analytics as jax_analytics
from drone_yolo_tpu.apps import geo as jax_geo
from drone_yolo_tpu.apps.pipeline import DroneVideoPipeline as JaxPipeline
from drone_yolo_tpu.trackers.byte_tracker import STrack as JaxSTrack
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.apps import analytics, geo
from drone_yolo_tpu_torch.apps.pipeline import DroneVideoPipeline
from drone_yolo_tpu_torch.trackers.byte_tracker import STrack
from make_dataset import make_dataset

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FRAMES = 8
HW = (128, 128)
DET = ("yolov8n-p2-repvgg-sf.yaml", -7.0, 30.0)  # (yaml, class bias, class gain): see tests/test_torch_track.py
POSE = ("yolov8n-pose.yaml", -2.0, 30.0)  # see tests/test_torch_pose.py
OVERRIDES = {"dtype": "float32", "iou": 0.3}
GEO = dict(lat=31.2304, lon=121.4737, altitude_m=60.0, yaw_deg=30.0, pitch_deg=80.0, image_width_px=128,
           image_height_px=128)
CENTRE_TOL = 1e-3  # px: smoothed track centres


@pytest.mark.parametrize("cfg", [GEO, dict(GEO, lat=-33.86, lon=151.2, yaw_deg=-120.0, pitch_deg=90.0),
                                 dict(GEO, lat=64.1, lon=-21.9, altitude_m=120.0, pitch_deg=45.0, image_width_px=3840,
                                      image_height_px=2160)])
def test_geo_equal_to_jax(cfg):
    got, want = geo.GeoConverter(**cfg), jax_geo.GeoConverter(**cfg)
    assert (got.e0, got.n0, got.zone, got.hemi, got.gsd) == (want.e0, want.n0, want.zone, want.hemi, want.gsd)
    rng = np.random.default_rng(0)
    u, v = rng.uniform(0, cfg["image_width_px"], 50), rng.uniform(0, cfg["image_height_px"], 50)
    for fn in ("pixel_to_local", "pixel_to_utm", "pixel_to_latlon"):
        np.testing.assert_array_equal(np.asarray(getattr(got, fn)(u, v)), np.asarray(getattr(want, fn)(u, v)), err_msg=fn)
        assert getattr(got, fn)(float(u[0]), float(v[0])) == getattr(want, fn)(float(u[0]), float(v[0]))
    e, n, zone, hemi = geo.latlon_to_utm(cfg["lat"], cfg["lon"])
    assert (e, n, zone, hemi) == jax_geo.latlon_to_utm(cfg["lat"], cfg["lon"])
    assert geo.utm_to_latlon(e + 100.0, n - 50.0, zone, hemi) == jax_geo.utm_to_latlon(e + 100.0, n - 50.0, zone, hemi)
    lat, lon = geo.utm_to_latlon(e, n, zone, hemi)
    assert abs(lat - cfg["lat"]) < 1e-6 and abs(lon - cfg["lon"]) < 1e-6  # the round trip
    assert geo.gsd_meters_per_pixel(13.2, 8.8, 100.0, 4000) == jax_geo.gsd_meters_per_pixel(13.2, 8.8, 100.0, 4000)


def trajectory_rows(rng, n_tracks=12, n_frames=60):
    rows = []
    for tid in range(1, n_tracks + 1):
        f0, length = int(rng.integers(0, n_frames // 2)), int(rng.integers(2, n_frames // 2))
        xy, vel = rng.uniform(0, 1000, 2), rng.normal(0, 3, 2)
        for f in range(f0, f0 + length):
            if rng.random() < 0.1:
                continue  # a missed frame
            xy = xy + vel + rng.normal(0, 0.5, 2)
            rows.append([f, tid, *xy, rng.uniform(0.2, 1), int(rng.integers(0, 3))])
    return rows


def test_analytics_equal_to_jax(tmp_path):
    rng = np.random.default_rng(1)
    rows = trajectory_rows(rng)
    path = tmp_path / "traj.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["frame", "track_id", "cx", "cy", "conf", "cls", "speed_mps"])
        w.writerows([[*r, ""] for r in rows])
    for src in (rows, path, str(path)):
        for kw in ({}, {"fps": 25.0, "meters_per_pixel": 0.05, "min_len": 3}):
            assert analytics.trajectory_statistics(src, **kw) == jax_analytics.trajectory_statistics(src, **kw)
        assert analytics.confidence_statistics(src) == jax_analytics.confidence_statistics(src)
    pts = np.asarray(rows)[:, 2:4]
    for kw in ({}, {"grid_shape": (40, 60), "bandwidth": 0.3}, {"extent": (0, 1000, 0, 1000)}):
        got, want = analytics.kde_density(pts, **kw), jax_analytics.kde_density(pts, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    line = np.stack([np.arange(20.0), np.full(20, 5.0)], 1)  # a singular covariance: the histogram fallback of both
    got, want = analytics.kde_density(line), jax_analytics.kde_density(line)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (100, 100) and got[1] == want[1]
    known, speeds, query = rng.uniform(0, 100, (40, 2)), rng.uniform(0, 3, 40), rng.uniform(0, 100, (15, 2))
    for k in (1, 5):
        np.testing.assert_array_equal(analytics.impute_speeds(known, speeds, query, k),
                                      jax_analytics.impute_speeds(known, speeds, query, k))


def make_models():
    """(port detector, port pose model, JAX detector, JAX pose model): one set of weights per model."""
    out = []
    for name, bias, gain in (DET, POSE):
        port = YOLO(name, device="cpu")
        port.ensure_variables(imgsz=HW[0])
        port.model.load_state_dict(scored_weights(port.model.state_dict(), np.random.default_rng(len(out)), bias, gain))
        port.overrides.update(OVERRIDES)
        ref = JaxYOLO(name)
        ref.variables = convert_state_dict(ref.model, port.model.state_dict())
        ref.overrides.update(OVERRIDES)
        out.append((port, ref))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """Both pipelines stepped over the same frames: (port pipeline, JAX pipeline, per-step outputs, CSV paths)."""
    det, pose, ref_det, ref_pose = make_models()
    frames = moving_frames(np.random.default_rng(2), FRAMES, HW, 24)
    STrack.reset_id()
    JaxSTrack.reset_id()
    port = DroneVideoPipeline(det, pose, geo.GeoConverter(**GEO), imgsz=HW[0])
    ref = JaxPipeline(ref_det, ref_pose, jax_geo.GeoConverter(**GEO), imgsz=HW[0])
    outs = [(port.step(f), ref.step(f)) for f in frames]
    tmp = tmp_path_factory.mktemp("csv")
    paths = (tmp / "port.csv", tmp / "jax.csv")
    assert port.export_csv(paths[0], fps=25.0) == ref.export_csv(paths[1], fps=25.0)
    return port, ref, frames, outs, paths


def test_pipeline_steps_match_jax(pipelines):
    port, ref, _, outs, _ = pipelines
    n_pose = 0
    for i, (got, want) in enumerate(outs):
        assert got["frame"] == want["frame"] == i
        assert sorted(got["tracks"]) == sorted(want["tracks"]), f"step {i}"
        for tid, (x, y) in want["tracks"].items():
            assert abs(got["tracks"][tid][0] - x) <= CENTRE_TOL and abs(got["tracks"][tid][1] - y) <= CENTRE_TOL
            np.testing.assert_allclose(got["geo"][tid], want["geo"][tid], rtol=0, atol=1e-9)  # degrees: ~0.1 mm
        assert ("pose" in got) == ("pose" in want)
        if "pose" in want:
            g, w = got["pose"], want["pose"]
            assert len(g.boxes) == len(w.boxes) > 0
            np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, rtol=0, atol=1e-3)
            np.testing.assert_allclose(g.keypoints.xy, w.keypoints.xy, rtol=0, atol=1e-4)
            n_pose += 1
    assert n_pose >= FRAMES - 1 and len(port.trajectories) == len(ref.trajectories) >= 20
    assert max(len(v) for v in port.trajectories.values()) >= FRAMES - 1  # some tracks last the whole clip


def test_pipeline_csv_matches_jax(pipelines):
    *_, paths = pipelines
    (head, got), (head_ref, want) = read_csv(paths[0]), read_csv(paths[1])
    assert head == head_ref == ["frame", "track_id", "cx", "cy", "conf", "cls", "lat", "lon", "speed_mps"]
    assert len(got) == len(want) > 100
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[5] == w[5]  # frame, track id, class
        for j, tol in ((2, 0.01 + CENTRE_TOL), (3, 0.01 + CENTRE_TOL), (4, 1e-4 + 1e-6), (6, 1e-7 + 1e-9),
                       (7, 1e-7 + 1e-9)):  # each column rounded by the CSV, plus the values' own tolerance
            assert abs(float(g[j]) - float(w[j])) <= tol, (g, w)
        assert (g[8] == "") == (w[8] == "")
        if g[8]:
            assert abs(float(g[8]) - float(w[8])) <= 1e-3 + 0.1  # m/s: a 1e-3 px centre moves the speed by ~0.1 m/s


def test_run_over_jpeg_sequence_equals_steps(pipelines, tmp_path):
    """`run` over frames/%06d.jpg (starting at index 1, as FFmpeg's reader also accepts) decodes each frame as
    cv2.imread does and gives the CSV that `step` over the cv2.imread frames gives, at the sequence's 25 fps."""
    port, _, frames, _, _ = pipelines
    for i, f in enumerate(frames):
        cv2.imwrite(str(tmp_path / f"{i + 1:06d}.jpg"), f, [cv2.IMWRITE_JPEG_QUALITY, 95])
    det, pose = port.det, port.pose
    det.predictor = pose.predictor = None  # new trackers
    run = DroneVideoPipeline(det, pose, geo.GeoConverter(**GEO), imgsz=HW[0])
    out = run.run(str(tmp_path / "%06d.jpg"), csv_path=tmp_path / "run.csv")
    assert out["frames"] == FRAMES and out["fps"] == 25.0 and out["n_tracks"] == len(run.trajectories) > 0
    det.predictor = pose.predictor = None
    steps = DroneVideoPipeline(det, pose, geo.GeoConverter(**GEO), imgsz=HW[0])
    for i in range(FRAMES):
        steps.step(cv2.imread(str(tmp_path / f"{i + 1:06d}.jpg")))
    steps.export_csv(tmp_path / "steps.csv", fps=25.0)
    assert read_csv(tmp_path / "run.csv") == read_csv(tmp_path / "steps.csv")
    det.predictor = pose.predictor = None
    part = DroneVideoPipeline(det, None, None, imgsz=HW[0]).run(iter(frames), max_frames=3)
    assert part["frames"] == 3 and part["fps"] == 30.0 and part["stats"] is None


def test_run_refuses_video_files_and_missing_sequences(tmp_path):
    pipe = DroneVideoPipeline.__new__(DroneVideoPipeline)
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        pipe.run(tmp_path / "clip.mp4")
    with pytest.raises(FileNotFoundError, match="0-4"):
        pipe.run(str(tmp_path / "%06d.jpg"))
    with pytest.raises(FileNotFoundError, match="does not exist"):  # a single image is a source now
        pipe.run(str(tmp_path / "frame.jpg"))


# a None entry in sys.modules makes `import name` fail and importlib.util.find_spec(name) return None (torch's own
# optional-import probes ask for sklearn's spec); jax is blocked by a finder instead, as scipy.stats looks jax up in
# sys.modules (for its array checks) and takes an entry there for the module
BLOCKER = """
import sys
BLOCKED = {"jax", "jaxlib", "drone_yolo_tpu", "cv2", "PIL", "yaml", "sklearn", "matplotlib", "streamlit"}


class JaxBlocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ModuleNotFoundError(f"{name} is blocked", name=name)


sys.meta_path.insert(0, JaxBlocker())
sys.modules.update(dict.fromkeys(BLOCKED - {"jax", "jaxlib"}))
"""

RUN_APPS = BLOCKER + """
import importlib, json, pkgutil, runpy, tempfile
from pathlib import Path
import numpy as np, torch
torch.set_num_threads(1)
import drone_yolo_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(drone_yolo_tpu_torch.__path__, "drone_yolo_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.apps import DroneVideoPipeline, GeoConverter, kde_density, trajectory_statistics
from drone_yolo_tpu_torch.data.jpeg import encode_jpeg
models = []
for name, bias in (("yolov8n-p2-repvgg-sf.yaml", -7.0), ("yolov8n-pose.yaml", -2.0)):
    m = YOLO(name, device="cpu")
    m.ensure_variables(imgsz=128)
    m.model.load_state_dict(chip_smoke.scored_weights(m.model.state_dict(), np.random.default_rng(0), bias, 30.0))
    m.overrides.update(dtype="float32", iou=0.3)
    models.append(m)
frames = chip_smoke.moving_frames(np.random.default_rng(0), 3, (128, 128), 12)
tracks = [len(r.boxes) for f in frames for r in models[0].track(f, persist=True, imgsz=128, verbose=False)]
tracker = models[0].predictor.trackers[0]  # no tracker named: BoT-SORT, its motion compensation on the frames
tracker = [type(tracker).__name__, tracker.gmc.method, tracker.gmc.initialized, tuple(tracker.gmc.prev_frame.shape)]
models[0].predictor = None
d = Path(tempfile.mkdtemp())
for i, f in enumerate(frames):
    (d / f"{i:06d}.jpg").write_bytes(encode_jpeg(np.ascontiguousarray(f[..., ::-1])))
pipe = DroneVideoPipeline(models[0], models[1], GeoConverter(31.0, 121.0, 60.0, image_width_px=128, image_height_px=128), imgsz=128)
out = pipe.run(str(d / "%06d.jpg"), csv_path=d / "t.csv")
stats = trajectory_statistics(d / "t.csv", min_len=1)
dens, _ = kde_density([(p[1], p[2]) for v in pipe.trajectories.values() for p in v])
# the command line (predict over a directory of JPEG, PNG and MJPEG AVI, track over the AVI, val) from a checkpoint
# whose train_args set imgsz, and `run` over the AVI
src = Path(sys.argv[1])
models[0].overrides["imgsz"] = 128
models[0].save(src / "last.npz")

def cli(*args):
    sys.argv = ["drone_yolo_tpu_torch", *args]
    runpy.run_module("drone_yolo_tpu_torch", run_name="__main__")

common = [f"model={src / 'last.npz'}", "device=cpu", "dtype=float32", f"project={src / 'runs'}", "verbose=False"]
cli("predict", f"source={src / 'media'}", "save_txt=True", "save=True", "conf=0.0", "max_det=5", "name=p", *common)
cli("track", f"source={src / 'media' / 'clip.avi'}", "save=True", "name=t", *common)
from drone_yolo_tpu_torch.data.avi import AviReader
cli("val", f"data={src / 'ds' / 'data.yaml'}", "batch=2", "workers=1", *common)
models[0].predictor = None  # a new tracker
video = DroneVideoPipeline(models[0], imgsz=128).run(str(src / "media" / "clip.avi"), csv_path=src / "v.csv")
# the gait study (its forest in numpy) and two analytics apps; the browser app without streamlit
from drone_yolo_tpu_torch.apps import GaitStudy
from drone_yolo_tpu_torch import solutions
rng = np.random.default_rng(2)
walkers = {i: chip_smoke.make_walker(rng, cadence=1.6 + 0.6 * (i % 2), speed=70 + 30 * (i % 2)) for i in range(12)}
gait = GaitStudy().run(walkers, {i: i % 2 for i in walkers})["classifier"]["cv_accuracy"]
models[0].predictor = None
apps = [solutions.ObjectCounter(model=models[0], region=[(0, 64), (128, 64)]), solutions.Heatmap(model=models[0])]
apps = [[sorted(k for k in app.process(f) if k != "im0") for f in frames][-1] for app in apps]
try:
    solutions.Inference(model="yolov8n.yaml")
    no_streamlit = "no error"
except ImportError as e:
    no_streamlit = str(e)
print(json.dumps({"modules": mods, "tracks": tracks, "tracker": tracker, "frames": out["frames"],
                  "n_tracks": out["n_tracks"],
                  "stats": len(stats), "density_finite": bool(np.isfinite(dens).all()),
                  "labels": sorted(p.name for p in (src / "runs" / "p" / "labels").iterdir()),
                  "saved": [sorted(p.name for p in (src / "runs" / d).iterdir()) for d in ("p", "t")],
                  "avi_frames": [len(AviReader(src / "runs" / d / "clip.avi")) for d in ("p", "t")],
                  "video": [video["frames"], video["fps"], (src / "v.csv").read_text().splitlines()[0]],
                  "gait": gait, "apps": apps, "no_streamlit": no_streamlit,
                  "loaded": sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)}))
"""


def test_track_pose_and_pipeline_run_without_jax_cv2_pil_yaml_sklearn(tmp_path):
    (tmp_path / "media").mkdir()  # written by cv2 here, read by the port's decoders in the subprocess
    rng = np.random.default_rng(1)
    for name, hw in (("a.jpg", (96, 160)), ("b.png", (120, 90)), ("c.jpg", (64, 64))):
        cv2.imwrite(str(tmp_path / "media" / name), rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
    w = cv2.VideoWriter(str(tmp_path / "media" / "clip.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 12.5, (96, 64))
    for f in range(4):
        w.write(np.full((64, 96, 3), 40 * f, np.uint8))
    w.release()
    make_dataset(tmp_path / "ds", n_train=1, n_val=2, size=96)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", RUN_APPS, str(tmp_path)], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"drone_yolo_tpu_torch.trackers.byte_tracker", "drone_yolo_tpu_torch.trackers.track",
            "drone_yolo_tpu_torch.trackers.kalman_filter", "drone_yolo_tpu_torch.trackers.matching",
            "drone_yolo_tpu_torch.apps.pipeline", "drone_yolo_tpu_torch.apps.geo", "drone_yolo_tpu_torch.apps.analytics",
            "drone_yolo_tpu_torch.models.yolo.pose", "drone_yolo_tpu_torch.data.avi", "drone_yolo_tpu_torch.data.png",
            "drone_yolo_tpu_torch.data.loaders", "drone_yolo_tpu_torch.__main__", "drone_yolo_tpu_torch.trackers.bot_sort",
            "drone_yolo_tpu_torch.trackers.gmc", "drone_yolo_tpu_torch.ops.flow",
            "drone_yolo_tpu_torch.ops.tiling"} <= set(out["modules"])
    assert out["tracker"] == ["BOTSORT", "sparseOptFlow", True, [64, 64]]
    assert out["loaded"] == [] and out["frames"] == 3 and out["n_tracks"] > 0 and out["stats"] > 0
    assert all(n > 0 for n in out["tracks"]) and out["density_finite"]
    assert math.isfinite(out["n_tracks"])
    assert out["labels"] == ["a.txt", "b.txt", "c.txt", *(f"clip_{i}.txt" for i in range(1, 5))]
    assert out["saved"] == [["a.jpg", "b.png", "c.jpg", "clip.avi", "labels"], ["clip.avi"]]  # save=True, drawn
    assert out["avi_frames"] == [4, 4]
    assert out["video"][:2] == [4, 12.5] and out["video"][2].startswith("frame,track_id")
    assert {"drone_yolo_tpu_torch.apps.gait", "drone_yolo_tpu_torch.apps.forest", "drone_yolo_tpu_torch.solutions",
            "drone_yolo_tpu_torch.solutions.inference_app"} <= set(out["modules"])
    assert out["gait"] == 1.0 and out["apps"] == [["classwise", "in_count", "out_count"], ["heatmap"]]
    assert "needs streamlit" in out["no_streamlit"]

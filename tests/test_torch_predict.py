"""The port's predict slice against the JAX package's, and the port's independence from it.

Flagship yaml at scale n, imgsz 128, float32, on the CPU: the same weights (the
port's seeded init with kernels and BN statistics redrawn from numpy by
`chip_smoke.spread_weights`, so that scores spread instead of sitting on the
class-bias prior) and the same 96x160
frames go through both `YOLO` facades with conf=0.0, where all 1024 candidates
per image are valid. Counts must be equal and boxes within 1e-3 px. Weights
cross in both directions (`from_jax_variables`, `convert_state_dict`) and
through the JAX package's npz checkpoint.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from chip_smoke import spread_weights
from drone_yolo_tpu import YOLO as JaxYOLO
from drone_yolo_tpu.engine.checkpoint import save_checkpoint
from drone_yolo_tpu.ops.letterbox import letterbox_np
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.engine import model as engine_model
from drone_yolo_tpu_torch.engine.checkpoint import flatten_tree, from_jax_variables
from drone_yolo_tpu_torch.ops.letterbox import letterbox_u8, resize_linear_u8

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP_N = "yolov8n-p2-repvgg-sf.yaml"
PREDICT = dict(imgsz=128, conf=0.0, dtype="float32", verbose=False)
BOX_TOL = 1e-3  # px, in the original frame; the largest difference found is 3.8e-5


@pytest.fixture(scope="module")
def pair():
    """(port facade, JAX facade, frames, JAX results) with one set of weights."""
    port = YOLO(FLAGSHIP_N, device="cpu")
    port.ensure_variables(imgsz=128, seed=0)
    port.model.load_state_dict(spread_weights(port.model.state_dict(), np.random.default_rng(0)))
    ref = JaxYOLO(FLAGSHIP_N)
    ref.variables = convert_state_dict(ref.model, port.model.state_dict())
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (96, 160, 3), dtype=np.uint8) for _ in range(2)]
    return port, ref, frames, ref.predict(source=frames, **PREDICT)


def assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.orig_shape == w.orig_shape
        assert len(g.boxes) == len(w.boxes) > 0
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, rtol=0, atol=BOX_TOL)
        np.testing.assert_allclose(g.boxes.conf, w.boxes.conf, rtol=1e-4, atol=1e-7)
        np.testing.assert_array_equal(g.boxes.cls, w.boxes.cls)


def test_flagship_predict_matches_jax(pair):
    port, _, frames, want = pair
    got = port.predict(source=frames, **PREDICT)
    assert_same_results(got, want)
    assert all(len(r.boxes) < 1024 for r in got)  # NMS suppressed some of the 1024 valid candidates
    assert set(got[0].speed) == {"preprocess", "inference", "postprocess"}
    np.testing.assert_allclose(got[0].boxes.xywh[:, 2:], want[0].boxes.xywh[:, 2:], atol=2 * BOX_TOL)


def test_npz_checkpoint_from_jax_loads_and_predicts_the_same(pair, tmp_path):
    _, ref, frames, want = pair
    path = save_checkpoint(tmp_path / "flagship.npz", ref.model, ref.variables)
    port = YOLO(str(path), device="cpu")
    assert port.model.head.stride == ref.model.head.stride
    assert_same_results(port.predict(source=frames, **PREDICT), want)
    fused = save_checkpoint(tmp_path / "fused.npz", ref.model, ref.model.fuse(ref.variables))
    assert_same_results(YOLO(str(fused), device="cpu").predict(source=frames, **PREDICT), want)


def test_bridge_round_trip_is_exact(pair):
    port, ref, _, _ = pair
    tree = convert_state_dict(ref.model, port.model.state_dict())
    sd = from_jax_variables(tree)
    assert sd.keys() == port.model.state_dict().keys()
    for k, v in port.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    back = flatten_tree(convert_state_dict(ref.model, sd))
    for k, v in flatten_tree(tree).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    jax_init = jax.tree_util.tree_map(np.asarray, ref.model.init(jax.random.PRNGKey(3), imgsz=128))
    again = flatten_tree(convert_state_dict(ref.model, from_jax_variables(jax_init)))
    for k, v in flatten_tree(jax_init).items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)


def test_fused_port_matches_fused_jax_weights(pair):
    port, ref, _, _ = pair
    fused = YOLO(FLAGSHIP_N, device="cpu")
    fused.model.load_state_dict(port.model.state_dict())
    fused.initialized = True
    fused.fuse()
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, ref.model.fuse(ref.variables)), fused.model)
    got = fused.model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_default_device_is_cuda(monkeypatch):
    assert engine_model.select_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert YOLO("yolov8n.yaml").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            YOLO("yolov8n.yaml")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert engine_model.select_device(None) == torch.device("cuda")


def test_predict_sources_and_arguments(pair, tmp_path):
    port, ref, frames, _ = pair
    one = port.predict(source=frames[0], **PREDICT)
    assert len(one) == 1 and one[0].boxes.data.shape[1] == 6
    # frames of mixed shapes, both resized (96x160 to 77x128, 80x160 to 64x128): the uint8 letterbox of the port
    # against cv2's in the JAX facade
    source = [frames[0], np.ascontiguousarray(frames[1][:80])]
    mixed = port.predict(source=source, **PREDICT)
    assert [r.orig_shape for r in mixed] == [(96, 160), (80, 160)]
    assert_same_results(mixed, ref.predict(source=source, **PREDICT))
    top = port.predict(source=frames, **{**PREDICT, "conf": 0.0, "max_det": 7, "classes": [3]})
    assert all(len(r.boxes) <= 7 and set(r.boxes.cls) <= {3.0} for r in top)
    with pytest.raises(FileNotFoundError, match="does not exist"):  # a path is a file source now
        port.predict(source="bus.jpg", **PREDICT)
    saved = port.predict(source=frames, save=True, project=str(tmp_path), name="s", **PREDICT)  # drawing is ported
    assert sorted(p.name for p in (tmp_path / "s").iterdir()) == ["image0.jpg", "image1.jpg"]
    assert all(len(r.boxes) for r in saved)


@pytest.mark.parametrize("src,dst", [((720, 1280), (360, 640)), ((1080, 1920), (360, 640)), ((720, 1280), (90, 160))])
def test_resize_u8_equals_cv2_at_integer_factors(src, dst):
    """OpenCV's fixed-point INTER_LINEAR, exactly: 720p and 1080p drone frames to the 640 px letterbox, and 8x down."""
    img = np.random.default_rng(src[0] + dst[0]).integers(0, 256, (*src, 3), dtype=np.uint8)
    got = resize_linear_u8(torch.from_numpy(img)[None], dst)[0].numpy()
    np.testing.assert_array_equal(got, cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("src,dst", [((96, 160), (77, 128)), ((480, 640), (360, 480)), ((333, 517), (640, 994)),
                                     ((100, 100), (230, 230)), ((720, 1280), (137, 243)), ((64, 48), (640, 480))])
def test_resize_u8_within_one_of_cv2_elsewhere(src, dst):
    """Other downscales and upscales: within 1 grey level of cv2, and at least 99.5% of values equal (OpenCV's
    scalar tail rounds (S0 b0 + S1 b1 + 2**21) >> 22 where its vector code rounds the shifted products)."""
    img = np.random.default_rng(src[1] + dst[1]).integers(0, 256, (*src, 3), dtype=np.uint8)
    got = resize_linear_u8(torch.from_numpy(img)[None], dst)[0].numpy().astype(int)
    diff = np.abs(got - cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR).astype(int))
    share = float((diff == 0).mean())
    print(f"{src} -> {dst}: {share:.5f} of values equal to cv2, largest difference {diff.max()}")
    assert diff.max() <= 1 and share >= 0.995


def test_letterbox_u8_equals_jax_host_letterbox():
    """The whole uint8 letterbox (resize and 114 border) against the JAX package's cv2 one, on a 720p and a 1080p
    frame to 640 px."""
    rng = np.random.default_rng(2)
    for shape in ((720, 1280, 3), (1080, 1920, 3), (500, 375, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = letterbox_np(img, (640, 640))[0]
        got = letterbox_u8(torch.from_numpy(img)[None], (640, 640))[0].numpy()
        diff = np.abs(got.astype(int) - want.astype(int))
        assert got.shape == want.shape and diff.max() <= 1 and (diff == 0).mean() >= 0.995
        if shape[0] in (720, 1080):
            np.testing.assert_array_equal(got, want)


# the finder refuses every import of a blocked package; sklearn is a None entry in sys.modules instead, which makes
# `import sklearn` fail and importlib.util.find_spec("sklearn") return None (torch's optional-import probes ask for it)
BLOCKER = """
import importlib.abc, sys
BLOCKED = {"jax", "jaxlib", "drone_yolo_tpu", "cv2", "PIL", "yaml", "sklearn"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked: {name}", name=name)
sys.modules["sklearn"] = None
sys.meta_path.insert(0, Block())
"""

RUN_PORT = BLOCKER + """
import importlib, json, pkgutil
import numpy as np, torch
torch.set_num_threads(1)
import drone_yolo_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(drone_yolo_tpu_torch.__path__, "drone_yolo_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
from drone_yolo_tpu_torch import YOLO
frames = [np.random.default_rng(0).integers(0, 256, (96, 160, 3), dtype=np.uint8)] * 2
res = YOLO("yolov8n-p2-repvgg-sf.yaml", device="cpu").predict(source=frames, imgsz=128, conf=0.0, dtype="float32", verbose=False)
from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
batch = chip_smoke.synthetic_batch(np.random.default_rng(0), 2, 64, 2)
trainer = BaseTrainer(overrides=dict(model="yolov8n-p2-repvgg-sf.yaml", batch=2, imgsz=64, nbs=2, device="cpu", amp=False,
                                     optimizer="SGD", s2grad="cuda"), train_loader=[batch], data={"nc": 2})
steps = trainer.run_steps()
both = BaseTrainer(overrides=dict(model="yolov8n-p2-repvgg-sf.yaml", batch=2, imgsz=64, nbs=2, device="cpu", amp=False,
                                  optimizer="SGD", s2grad="cuda", bnstats="cuda"), train_loader=[batch], data={"nc": 2},
                   val_loader=[chip_smoke.synthetic_batch(np.random.default_rng(1), 2, 64, 2, val=True)])
steps += both.run_steps()
metrics = both.validate()
v11 = YOLO("yolo11n.yaml", device="cpu").predict(source=frames, imgsz=64, conf=0.0, dtype="float32", verbose=False)
v11_trainer = BaseTrainer(overrides=dict(model="yolo11n.yaml", batch=2, imgsz=64, nbs=2, device="cpu", amp=False,
                                         optimizer="SGD", s2grad="cuda", bnstats="cuda"), train_loader=[batch],
                          data={"nc": 2})
steps += v11_trainer.run_steps()
from drone_yolo_tpu_torch.models.yolo.classify import ClassificationTrainer
probs = YOLO("yolov8n-cls.yaml", device="cpu").predict(source=frames, imgsz=32, verbose=False)
cls_batch = {"img": np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8), "cls": np.array([0, 1], np.int32)}
cls_trainer = ClassificationTrainer(overrides=dict(model="yolov8n-cls.yaml", batch=2, imgsz=32, nbs=2, device="cpu",
                                                   amp=False, optimizer="SGD", s2grad="cuda", bnstats="cuda"),
                                    train_loader=[cls_batch], data={"nc": 2})
steps += cls_trainer.run_steps()
print(json.dumps({"modules": mods, "n": [len(r.boxes) for r in res + v11], "train_loss": [s["loss"] for s in steps],
                  "probs": [r.probs.data.shape[0] for r in probs],
                  "optimizer_steps": trainer.step + both.step + v11_trainer.step + cls_trainer.step, "metrics": metrics,
                  "loaded": sorted(m for m in BLOCKED if sys.modules.get(m) is not None)}))
"""


def test_port_runs_without_jax_cv2_pil_yaml():
    """Every module of the port imports, and the flagship, yolo11n and yolov8n-cls predict and train a step, with jax,
    cv2, PIL, yaml and sklearn blocked."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", RUN_PORT], cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"drone_yolo_tpu_torch.ops.cuda_nms", "drone_yolo_tpu_torch.engine.predictor", "drone_yolo_tpu_torch.ops.cuda_s2bwd",
            "drone_yolo_tpu_torch.engine.trainer", "drone_yolo_tpu_torch.engine.validator", "drone_yolo_tpu_torch.ops.cuda_bnstats",
            "drone_yolo_tpu_torch.utils.metrics", "drone_yolo_tpu_torch.models.yolo.classify"} <= set(out["modules"])
    assert out["loaded"] == [] and all(n > 0 for n in out["n"]) and out["probs"] == [1000, 1000]
    assert out["optimizer_steps"] == 4 and len(out["n"]) == 4 and all(math.isfinite(v) for v in out["train_loss"])
    assert len(out["train_loss"]) == 4
    assert set(out["metrics"]) == {"metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)", "fitness"}


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py would run for real")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout


def test_port_package_holds_sources_only():
    """Built libraries and caches stay out of the package's tracked files (they go to its ignored build/)."""
    pkg = REPO / "drone_yolo_tpu_torch"
    files = [p for p in pkg.rglob("*") if p.is_file() and not {"build", "__pycache__"} & set(p.relative_to(pkg).parts)]
    assert {p.suffix for p in files} <= {".py", ".yaml", ".cu"}
    for p in files:  # text sources only: no blob under a source suffix (the largest source file is 39 KB)
        data = p.read_bytes()
        assert b"\0" not in data and len(data) <= 64 * 1024, p
        data.decode("utf-8")
    assert sum(p.stat().st_size for p in files) < 776 * 1024  # 762 KB with the analytics apps, gait study and forest
    assert "build/" in (REPO / ".gitignore").read_text().split()

"""The port's training loop (`engine/trainer.py` `train()`) and its files against the JAX package, on the CPU.

- `EarlyStopping` against the JAX one on one fitness sequence;
- `to_jax_variables` equal to the JAX package's `convert_state_dict`, and the inverse of
  `from_jax_variables`;
- a port `last.npz` read by the JAX `load_checkpoint` with equal variables, and a JAX one read
  by the port's;
- a port `resume_state.npz` taken over by the JAX trainer's `resume_training` with equal params,
  momentum, EMA, step, count and epoch, and the other way round;
- the whole slice: `YOLO(init.npz).train(...)` of both packages from one init (a
  `drone_yolo_tpu.v1` npz) on one `tests/make_dataset.py` dataset of 128 px images at imgsz 64 (a
  factor of 2, where the resizes of both agree exactly), at the ablation hyperparameters, 2
  epochs, batch 4, nbs 4, float32. Each epoch's mean loss items within 1e-3 relative; the epoch-2
  metrics within 1e-3; results.csv, last.npz and best.npz written. The final EMA is held three
  ways, per tensor, within rtol 1e-4 and an absolute tolerance of 1e-5 plus a share of the tensor's
  largest update: the port against a float64 run of itself within `REF_NOISE` (the bar of
  tests/test_torch_train.py), the JAX package against that float64 run within `JAX_LOOP_NOISE`,
  and the port against the JAX package within the sum of the two;
- the loop, a pose model's epoch and val, and a segment and an obb model's epoch, val and predict, with jax,
  drone_yolo_tpu, cv2, PIL, yaml and sklearn blocked.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from make_dataset import make_dataset, make_obb_dataset, make_pose_dataset, make_seg_dataset
from test_torch_predict import BLOCKER
from drone_yolo_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from drone_yolo_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from drone_yolo_tpu.engine.model import YOLO as JaxYOLO
from drone_yolo_tpu.engine.trainer import BaseTrainer as JaxTrainer
from drone_yolo_tpu.nn.model import DetectionModel as JaxDetectionModel
from drone_yolo_tpu.utils.ema import EarlyStopping as JaxEarlyStopping
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.engine.checkpoint import (flatten_tree, from_jax_train_state, from_jax_variables, load_checkpoint,
                                                    read_resume_state, resume_state, save_checkpoint,
                                                    to_jax_variables)
from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
from drone_yolo_tpu_torch.nn.model import DetectionModel
from drone_yolo_tpu_torch.utils.ema import EarlyStopping

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]

FLAGSHIP_N = "yolov8n-p2-repvgg-sf.yaml"
NC, IMGSZ, BATCH = 4, 64, 4
REF_NOISE = 5e-3  # tests/test_torch_train.py:49
# The JAX loop's float32 EMA after 4 steps differs from the port's float64 run by up to 1.23e-2 of a tensor's
# largest update (BN biases, which the warmup moves at lr 0.1; the port's float32 run: within rtol 1e-4 and 1e-5);
# `test_train_loop_matches_jax` prints the measurement. Twice that.
JAX_LOOP_NOISE = 2.5e-2
ABLATION = dict(epochs=2, batch=BATCH, imgsz=IMGSZ, seed=0, optimizer="SGD", lr0=0.01, lrf=0.01, momentum=0.937,
                weight_decay=0.0005, warmup_epochs=3.0, warmup_momentum=0.8, warmup_bias_lr=0.1, nbs=BATCH, box=7.5,
                cls=0.5, dfl=1.5, mosaic=0.0, mixup=0.0, copy_paste=0.0, scale=0.0, translate=0.0, degrees=0.0,
                shear=0.0, perspective=0.0, fliplr=0.5, flipud=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0,
                multi_scale=False, rect=False, cos_lr=False, close_mosaic=0, patience=10_000, amp=False, workers=2,
                exist_ok=True)
METRIC_KEYS = ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)", "fitness")


@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    return str(make_dataset(tmp_path_factory.mktemp("loop") / "ds", n_train=8, n_val=4, size=128, nc=NC))


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    """(port model, its state dict, the init as a drone_yolo_tpu.v1 npz written by the port)."""
    model = DetectionModel(FLAGSHIP_N, nc=NC)
    model.init(0, imgsz=IMGSZ)
    path = save_checkpoint(tmp_path_factory.mktemp("init") / "init.npz", model, model.state_dict())
    return model, {k: v.clone() for k, v in model.state_dict().items()}, path


@pytest.mark.parametrize("patience", [0, 1, 3])
def test_early_stopping_matches_jax(patience):
    fitness = [None, 0.1, 0.05, 0.2, 0.2, 0.19, 0.18, 0.17, 0.3, 0.1, 0.1, 0.1, 0.1]
    port, ref = EarlyStopping(patience), JaxEarlyStopping(patience)
    got = [port(e, f) for e, f in enumerate(fitness)]
    assert got == [ref(e, f) for e, f in enumerate(fitness)]
    assert (port.best_epoch, port.best_fitness) == (ref.best_epoch, ref.best_fitness)
    assert any(got) == (patience > 0)


def test_to_jax_variables_inverts_the_bridge(init):
    model, sd, _ = init
    want = flatten_tree(convert_state_dict(JaxDetectionModel(FLAGSHIP_N, nc=NC), sd))
    got = to_jax_variables(sd)
    flat = flatten_tree(got)
    assert sorted(flat) == sorted(want)
    for k, w in want.items():
        assert flat[k].dtype == np.float32
        np.testing.assert_array_equal(flat[k], np.asarray(w), err_msg=k)
    back = from_jax_variables(got)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_checkpoints_cross_packages(init, tmp_path):
    model, sd, path = init
    ref = JaxDetectionModel(FLAGSHIP_N, nc=NC)
    _, variables, header = jax_load_checkpoint(path)  # the port's file in the JAX reader
    want = convert_state_dict(ref, sd)
    got, want_flat = flatten_tree(variables), flatten_tree(want)
    assert sorted(got) == sorted(want_flat)
    for k, w in want_flat.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert header["format"] == "drone_yolo_tpu.v1" and header["stride"] == [4.0, 8.0, 16.0, 32.0]
    ref.names = {i: f"thing{i}" for i in range(NC)}
    jax_path = jax_save_checkpoint(tmp_path / "jax.npz", ref, want, train_args={"epochs": 3}, meta={"epoch": 2})
    back, header = load_checkpoint(jax_path)  # the JAX file in the port's reader
    assert header["epoch"] == 2 and back.names == ref.names
    for k, v in back.state_dict().items():
        assert torch.equal(v, sd[k]), k


def _jax_state_np(trainer) -> dict:
    return jax.tree_util.tree_map(np.asarray, jax.device_get(trainer.state))


def _assert_states_equal(port_ts: dict, jax_state: dict):
    want = from_jax_train_state({**jax_state, "acc": jax_state["params"]})
    for part in ("params", "ema"):
        for k, v in want[part].items():
            assert torch.equal(port_ts[part][k].detach().cpu(), v), f"{part} {k}"
    for k, v in port_ts["opt"]["momentum"].items():
        assert torch.equal(v.cpu(), want["opt"]["momentum"][k]), f"momentum {k}"
    assert (port_ts["step"], port_ts["count"]) == (want["step"], want["count"])


def test_resume_states_cross_packages(data_yaml, tmp_path):
    """A port state after one optimizer step of three micro-steps and one micro-step more (count 1) resumes the JAX
    trainer; a JAX
    state with drawn momentum and counters resumes the port trainer."""
    common = dict(model=FLAGSHIP_N, data=data_yaml, imgsz=IMGSZ, batch=BATCH, optimizer="SGD", amp=False, workers=1,
                  project=str(tmp_path), exist_ok=True)
    port = BaseTrainer(overrides=dict(common, nbs=3 * BATCH, device="cpu", name="port"))
    port._setup_train()
    port.run_steps()  # the epoch's two batches, then two more: an optimizer step after the third
    port.run_steps()
    ts = port.train_state()
    assert (ts["step"], ts["count"]) == (1, 1)
    path = tmp_path / "port_resume_state.npz"
    np.savez(path, **resume_state(ts, epoch=4))
    ref = JaxTrainer(overrides=dict(common, nbs=3 * BATCH, resume=str(path), name="jax"))
    ref._setup_train()
    assert ref.start_epoch == 5
    _assert_states_equal(ts, _jax_state_np(ref))

    rng = np.random.default_rng(0)
    state = _jax_state_np(ref)
    state["opt"] = jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape).astype(np.float32), state["opt"])
    state["step"], state["count"] = np.int32(7), np.int32(1)
    ref.state = state
    ref.epoch = 6
    ref.save_model()  # the JAX trainer writes weights/last.npz, best.npz and resume_state.npz
    jax_file = ref.wdir / "resume_state.npz"
    back = BaseTrainer(overrides=dict(common, nbs=2 * BATCH, device="cpu", name="back", resume=str(jax_file)))
    back._setup_train()
    assert back.start_epoch == 7
    got = back.train_state()
    _assert_states_equal(got, state)
    assert all(not a.any() for a in got["acc"].values())  # the accumulator starts from zero
    ts2, epoch = read_resume_state(jax_file)
    assert epoch == 6 and ts2["count"] == 1


class _Float64Trainer(BaseTrainer):
    """The port's loop with the model, the batches and the loss in float64 (the EMA stays float32)."""

    def preprocess_batch(self, batch: dict) -> dict:
        return {k: v.double() if v.is_floating_point() else v for k, v in super().preprocess_batch(batch).items()}


def _ema_errors(got: dict, want: dict, start: dict) -> float:
    """The largest share of a tensor's largest update |want - start| by which |got - want| exceeds rtol 1e-4 and 1e-5."""
    worst = -np.inf
    for k in want:
        w, s = want[k].double().numpy(), start[k].double().numpy()
        excess = np.abs(got[k].double().numpy() - w) - 1e-4 * np.abs(w) - 1e-5
        worst = max(worst, float(excess.max() / max(np.abs(w - s).max(), 1e-12)))
    return worst


def test_train_loop_matches_jax(data_yaml, init, tmp_path):
    _, start, path = init
    port = YOLO(str(path), device="cpu")
    port_metrics = port.train(data=data_yaml, project=str(tmp_path), name="port", **ABLATION)
    trainer = port.trainer
    ref = JaxYOLO(str(path))
    # device "0": a mesh of one CPU device (the tests' JAX runs with 8, over which batch 4 does not divide)
    ref.train(data=data_yaml, project=str(tmp_path), name="jax", plots=False, device="0", **ABLATION)
    rows = [r.split(",") for r in (tmp_path / "jax" / "results.csv").read_text().splitlines()]
    jax_cols = {c: [float(r[i]) for r in rows[1:]] for i, c in enumerate(rows[0])}
    for e, stats in enumerate(trainer.epoch_stats):
        want = [jax_cols[f"train/{n}"][e] for n in trainer.loss_names]
        np.testing.assert_allclose(stats["loss_items"], want, rtol=1e-3, err_msg=f"epoch {e} loss items")
    jax_metrics = {k: jax_cols[k][-1] for k in METRIC_KEYS}
    for k in METRIC_KEYS:
        assert abs(port_metrics[k] - jax_metrics[k]) <= 1e-3, (k, port_metrics, jax_metrics)
    port_rows = (tmp_path / "port" / "results.csv").read_text().splitlines()
    assert port_rows[0] == ",".join(rows[0]) and len(port_rows) == 3
    assert all((trainer.wdir / f).is_file() for f in ("last.npz", "best.npz", "resume_state.npz"))

    f64_dir = tmp_path / "f64"
    torch.set_default_dtype(torch.float64)
    try:
        exact = _Float64Trainer(overrides=dict(model=str(path), data=data_yaml, device="cpu", project=str(f64_dir),
                                               name="f64", val=False, save=False, **ABLATION))
        exact.train()
    finally:
        torch.set_default_dtype(torch.float32)
    jax_ema = from_jax_variables(ref.trainer.final_vars)
    err = {"port": _ema_errors(trainer.final_state, exact.final_state, start),
           "jax": _ema_errors(jax_ema, exact.final_state, start),
           "port_vs_jax": _ema_errors(trainer.final_state, jax_ema, start)}
    print(f"final EMA, largest error beyond rtol 1e-4 and 1e-5 as a share of the tensor's largest update: {err}")
    assert err["port"] <= REF_NOISE and err["jax"] <= JAX_LOOP_NOISE
    assert err["port_vs_jax"] <= REF_NOISE + JAX_LOOP_NOISE


RUN_LOOP = BLOCKER + """
sys.modules["sklearn"] = None  # import fails, find_spec gives None (torch's optional-import probes ask for it)
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from drone_yolo_tpu_torch import YOLO
model = YOLO("yolov8n-p2-repvgg-sf.yaml", device="cpu")
metrics = model.train(data=sys.argv[1], project=sys.argv[2], name="blocked", epochs=2, imgsz=64, batch=4, nbs=4,
                      workers=2, cache="ram", close_mosaic=1, amp=False, s2grad="cuda", bnstats="cuda")
again = YOLO(model.trainer.wdir / "last.npz", device="cpu").val(data=sys.argv[1], imgsz=64, batch=4, dtype="float32")
pose = YOLO("yolov8n-pose.yaml", device="cpu")
pose_metrics = pose.train(data=sys.argv[3], project=sys.argv[2], name="pose", epochs=1, imgsz=64, batch=2, nbs=2,
                          workers=1, amp=False, s2grad="cuda", bnstats="cuda")
pose_again = YOLO(pose.trainer.wdir / "last.npz", device="cpu").val(data=sys.argv[3], imgsz=64, batch=2, dtype="float32")
seg = YOLO("yolov8n-seg.yaml", device="cpu")
seg_metrics = seg.train(data=sys.argv[4], project=sys.argv[2], name="seg", epochs=1, imgsz=64, batch=2, nbs=2,
                        workers=1, amp=False, copy_paste=0.5, s2grad="cuda", bnstats="cuda")
seg_last = YOLO(seg.trainer.wdir / "last.npz", device="cpu")
seg_again = seg_last.val(data=sys.argv[4], imgsz=64, batch=2, dtype="float32")
seg_pred = seg_last.predict(np.zeros((72, 96, 3), np.uint8), imgsz=64, conf=0.0, max_det=3, dtype="float32")[0]
obb = YOLO("yolov8n-obb.yaml", device="cpu")
obb_metrics = obb.train(data=sys.argv[5], project=sys.argv[2], name="obb", epochs=1, imgsz=64, batch=2, nbs=2,
                        workers=1, amp=False, degrees=20.0, s2grad="cuda", bnstats="cuda")
obb_last = YOLO(obb.trainer.wdir / "last.npz", device="cpu")
obb_again = obb_last.val(data=sys.argv[5], imgsz=64, batch=2, dtype="float32")
obb_pred = obb_last.predict(np.zeros((72, 96, 3), np.uint8), imgsz=64, conf=0.0, max_det=3, dtype="float32")[0]
print(json.dumps({"metrics": metrics, "again": again, "epochs": len(model.trainer.epoch_stats),
                  "pose_metrics": pose_metrics, "pose_again": pose_again, "seg_metrics": seg_metrics,
                  "seg_again": seg_again, "seg_masks": list(seg_pred.masks.data.shape),
                  "seg_outline": len(seg_pred.masks.xy), "obb_metrics": obb_metrics, "obb_again": obb_again,
                  "obb_corners": list(obb_pred.obb.xyxyxyxy.shape),
                  "loaded": sorted(m for m in BLOCKED if sys.modules.get(m) is not None), "sklearn": sys.modules["sklearn"] is None}))
"""


def test_loop_runs_without_jax_cv2_pil_yaml(data_yaml, tmp_path):
    """Two epochs (mosaic, then closed), validation, checkpoints and a val of last.npz with the imports blocked (and
    sklearn); then a pose model's epoch over a pose dataset (`make_pose_dataset`) and a val of its last.npz; then a
    segment model's epoch over a polygon dataset (`make_seg_dataset`, copy-paste on), a val and a predict of its
    last.npz with the masks' outlines; then an obb model's epoch over a rotated-rectangle dataset (`make_obb_dataset`,
    rotations on), a val and a predict of its last.npz with the oriented boxes' corners."""
    pose_yaml = str(make_pose_dataset(tmp_path / "pose", n_val=2, nc=2, seed=0, size=96, nkpt=4, n_train=4))
    seg_yaml = str(make_seg_dataset(tmp_path / "seg", n_val=2, nc=2, seed=0, size=96, n_train=4))
    obb_yaml = str(make_obb_dataset(tmp_path / "obb", n_val=2, nc=2, seed=0, size=96, n_train=4))
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", RUN_LOOP, data_yaml, str(tmp_path), pose_yaml, seg_yaml, obb_yaml],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == [] and out["epochs"] == 2
    assert set(out["metrics"]) == set(out["again"]) == set(METRIC_KEYS)
    pose_keys = {*METRIC_KEYS, "metrics/precision(P)", "metrics/recall(P)", "metrics/mAP50(P)", "metrics/mAP50-95(P)"}
    assert set(out["pose_metrics"]) == set(out["pose_again"]) == pose_keys
    seg_keys = {*METRIC_KEYS, "metrics/precision(M)", "metrics/recall(M)", "metrics/mAP50(M)", "metrics/mAP50-95(M)"}
    assert set(out["seg_metrics"]) == set(out["seg_again"]) == seg_keys
    assert out["seg_masks"] == [3, 72, 96] and out["seg_outline"] == 3 and out["sklearn"]
    assert set(out["obb_metrics"]) == set(out["obb_again"]) == set(METRIC_KEYS) and out["obb_corners"] == [3, 4, 2]


def test_multi_scale_sizes_and_device_resize():
    """`multi_scale`: per batch randrange(0.5 imgsz, 1.5 imgsz + 32) // 32 * 32 from a generator seeded by `seed`,
    and the batch resized with its boxes before the step."""
    from chip_smoke import synthetic_batch

    batch = synthetic_batch(np.random.default_rng(0), 2, IMGSZ, 2)
    trainer = BaseTrainer(overrides=dict(model=FLAGSHIP_N, batch=2, imgsz=IMGSZ, nbs=2, device="cpu", amp=False,
                                         optimizer="SGD", multi_scale=True, seed=3), train_loader=[batch], data={"nc": 2})
    trainer._setup_train()
    ref = __import__("random").Random(3)
    sizes = [trainer._multi_scale_size() for _ in range(50)]
    assert sizes == [ref.randrange(IMGSZ // 2, IMGSZ * 3 // 2 + 32) // 32 * 32 for _ in range(50)]
    assert set(sizes) == {32, 64, 96}
    seen = {}
    real = trainer.criterion.__call__
    trainer.criterion = lambda maps, b: (seen.update(img=b["img"].shape, boxes=b["bboxes"].clone()), real(maps, b))[1]
    loss, _ = trainer.train_step(batch, 0.01, 0.01, 0.9, size=96)
    assert seen["img"] == (2, 3, 96, 96) and torch.isfinite(loss)
    torch.testing.assert_close(seen["boxes"], torch.from_numpy(batch["bboxes"]) * 1.5)

"""Smoke run of the PyTorch/CUDA port on one CUDA card: builds the kernels, checks them, serves, trains and
validates the flagship, and runs the drone-video pipeline (tracking, pose, geo) over synthetic video.

    python3 chip_smoke.py

Phases, one JSON line each (with the seconds it took), flushed as they end:

1. preflight: torch, CUDA, nvcc and the card (name and power limit from nvidia-smi);
2. build: compiles the greedy-NMS kernels (`drone_yolo_tpu_torch/csrc/greedy_nms.cu`), the
   stride-2 conv backward (`csrc/s2_bwd.cu`) and the BN statistics (`csrc/bn_stats.cu`) with
   nvcc, in parallel, and prints the three ptxas reports, the build's seconds, the NMS
   bitmask's workspace bytes at predict's and validation's K, and the tensor-core instructions
   (HMMA, HGMMA) of each stride-2 kernel by `cuobjdump -sass` (or that the toolkit has no
   cuobjdump): the bf16 kernels must have them;
3. kernel_vs_plain: greedy NMS, B=8 at K in {128, 640, 1024, 4096, 8192} and B=1 at K=12288,
   IoU thresholds {0.45, 0.7}: the bitmask kernel's words against `suppression_words_reference`
   (image by image), the keep mask of the two kernels against `greedy_keep_reference`, and (up
   to K = 4096) against `sweep_reference` over the kernel's words: all equal, and every case
   must both keep and suppress. The stride-2 backward
   kernel against `s2_bwd_reference` at every dense stride-2 site of the flagship (batch 8,
   640 px: 8 with k=3, 4 with k=1), in float32 (TF32 off) and bfloat16, within `S2_TOL`. The
   BN-statistics kernel against `bn_stats_reference` at all 77 train-mode BN inputs of the
   flagship (batch 8, 640 px), in bfloat16 and float32, within `BN_RTOL` and `BN_ATOL`, and the
   `bn_stats` Function's gradient against autograd of the plain version at the largest site;
4. slice: `YOLO("yolov8s-p2-repvgg-sf.yaml")` at full width and depth, seed 0, on the card,
   fused, bfloat16, predicts on batches of 1 and 8 synthetic 720x1280 BGR frames, then once
   more with conf=0.0 so that all 1024 candidates per image are valid, then on a mixed batch
   of a 720x1280 and a 1080x1920 frame (the uint8 letterbox). Launch counts are set to 0
   before these calls and read after them. Checks: the NMS step with the kernel equals the
   same step with the plain keep on the card; the uint8 letterbox of both mixed frames on the
   card equals the same function on the CPU exactly; the float32 decoded predictions (TF32
   off, weights redrawn so activations stay O(1)) match the port on the CPU, boxes in pixels
   and scores relative to their size; per-image times and img/s at batch 1 and 8;
5. train: `BaseTrainer` on the flagship at full width and depth, 80 classes, imgsz 640, batch 8,
   bfloat16 autocast, SGD with one optimizer step per batch (nbs 8), seed 0: 6 steps on a
   synthetic batch with s2grad="cuda", the same 6 steps from the same init with stock
   autograd, and again with s2grad="cuda" and bnstats="cuda". Counts are set to 0 before each
   run and read after it: the kernel runs must call the stride-2 backward 8 (k=3) and 4 (k=1)
   times per step, every call through the bf16 tensor-core implementation, the stock run
   never; the third run must call the BN-statistics kernel 77 times per step (1 launch
   each), the other two never. Checks: finite losses, each step's
   loss within `TRAIN_LOSS_RTOL` of the stock run's; step ms, img/s and peak memory of each
   run, then the three paths timed again in turns (kernel, stock, both, both, stock, kernel; 5 steps each);
6. validate: `trainer.validate()` on the third run's EMA weights, over 4 synthetic batches of 8
   at 640 px with 80 classes, at conf 0.001 and again at conf 0.0 (all 4096 multi-label
   candidates of each image valid: the NMS kernel's real work), counts set to 0 before each.
   Checks: K = 4096 in both, one NMS call (two launches) per batch, the NMS step with the kernel equal to
   the step with the plain keep on the same predictions, P, R, mAP50 and mAP50-95 finite and in
   [0, 1]; the validator's per-image times and img/s;
7. kernels: each kernel's time at the main path's shapes against its plain version, its
   bound and the library call where there is one (cuDNN's `convolution_backward` at the
   stride-2 sites, `torch.batch_norm_stats` at the BN sites); greedy NMS with its two
   launches' device times apart; the stride-2 backward also at each of the 12 sites against
   cuDNN there, with TFLOP/s, GB/s and the share of the bound; the BN statistics at each of
   the 77 sites (timed once per distinct shape) against `torch.batch_norm_stats`, with the
   share of the bound;
8. profile: the device busy share and the device time by kernel of batch-8 predicts, of
   train steps with the stride-2 kernel, and of train steps with both kernels (torch.profiler);
9. loop: the epoch loop over a dataset on disk. 32 train and 16 val images of the dense
   small-object proxy (`tools/dense_dataset.py:make_dense_image`, 320 px, 90-140 objects of
   4-12 px, 6 classes, seed 1) written as JPEG by the port's encoder at quality 95, with labels
   and data.yaml, in a temporary directory. Run A: `YOLO("yolov8s-p2-repvgg-sf.yaml").train(...)`
   at full width and depth, imgsz 320, batch 8, nbs 8, SGD, default augmentation, close_mosaic 1,
   cache="ram", 4 loader threads, s2grad="cuda", bnstats="cuda", bf16 autocast, 3 epochs, EMA
   validation each epoch. Run B: a trainer that resumes A's resume_state.npz with epochs 4.
   Counts are set to 0 before each run and read after it. Checks: finite losses; 12 stride-2
   calls (8 k=3, 4 k=1) and 77 BN-statistics calls a step, one NMS call (two launches) a val
   batch; P, R, mAP50, mAP50-95 in [0, 1]; results.csv, last.npz, best.npz and
   resume_state.npz written, and `YOLO(last.npz)` predicting on the card; B starting at epoch 3
   with params, SGD momentum and EMA bitwise equal to A's final state, and running one epoch;
   the JPEG round trip of the dataset within `JPEG_MEAN_ERR`. Printed: seconds per epoch, train
   img/s, the share of the epoch spent waiting on the loader, decode ms per 320 and 640 px
   image, augmentation ms per sample, validation seconds, peak card memory, checkpoint bytes;
10. track: the drone-video analytics path. `DroneVideoPipeline` with the flagship (tracking) and
   `yolov8s-pose.yaml` (nc 1, 17 keypoints) at full width and depth, fused, bfloat16, and a
   `GeoConverter`, over 64 synthetic 1080x1920 frames of 60 textured rectangles that move, enter and
   leave (`moving_frames`, seed 3), imgsz 640, conf 0.25, ByteTrack. Random weights score near
   sigmoid(-13), below ByteTrack's thresholds, so each model's class logits are spread to follow
   the image (`scored_weights`, gain 30) and shifted so that 5% of frame 0's anchors score above
   0.25 (`calibrated_weights`). Pass A holds the keep mask of every NMS call of both models (the
   pose model's carries 51 keypoint columns) against `greedy_keep_reference` on the same
   candidates; pass B, the timed run with NMS counts set to 0 before it and read after it,
   prints frames/s of detect + track + pose + geo, per-stage ms a frame (the predictor's
   preprocess, inference and postprocess, the tracker's update, the pose model's predict, the geo
   conversion, the rest), the track count and the CSV's rows; pass C gives frames/s of detect +
   track + geo without the pose model; then the device's busy share over 8 steps of the full
   pipeline (torch.profiler), and `BYTETracker.update` alone on detection streams of 50, 200 and
   500 targets (`detection_stream`, 60 frames each);
11. imports: neither JAX, nor the JAX package, nor cv2, PIL, yaml or sklearn was imported, with the
   modules of every path (apps, trackers, the pose predictor) loaded.

Then the nvidia-smi line, the `kernels` JSON line, and last `{"ok": true, "device": ...}`.

`python3 chip_smoke.py accuracy [seed ...]` instead trains the flagship with the port's
`YOLO.train` at the JAX package's ablation settings (`tools/flagship_parity.py:216-286` with the
`HYPS` of `:43-70`, amp): 192 train and 96 val images of the dense proxy, 40 epochs, from the
init of each seed (0 and 1 by default; the ablation's is 0); then `YOLO.val` at conf 0.001, IoU
0.7 in float32; prints one JSON line per seed with mAP50-95, mAP50, the wall time and results.csv.

Greedy NMS is two launches a call (a suppression bitmask over many CTAs, then a sweep, one
CTA per image), the BN statistics one: the checks of the main path count NMS calls, and
the `kernels` line gives launches.
Any failure ends the script with a traceback and a non-zero exit code. Without a CUDA
card it exits with code 1 before any phase.
"""

from __future__ import annotations

import copy
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

FLAGSHIP = "yolov8s-p2-repvgg-sf.yaml"
FRAME_HW = (720, 1280)
# H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor cores, bf16 dense tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
TRAIN = dict(batch=8, imgsz=640, nc=80, steps=6)
# stride-2 backward, kernel vs plain on the same inputs. float32: tests/test_conv_s2.py:115-116 (both sum in
# float32, in different orders). bfloat16: tests/test_conv_s2.py:51-67 (both sum the same bf16 inputs in float32;
# dx is rounded to bf16 once, so the two may differ by one bf16 step).
# Those were set for reductions of ~100 terms; dw at the flagship's sites sums up to 819,200 products (layer 0,
# batch 8), whose float32 sums in two orders differ by ~1e-6 of the largest entry (1.8e-3 at a largest |dw| near
# 2,700 in the first chip run): atol grows by S2_SUM_FLOOR x the largest |plain| entry. The float32 cases also
# report both versions' distance from a float64 evaluation.
S2_TOL = {"float32": {"dx": dict(rtol=1e-5, atol=1e-4), "dw": dict(rtol=1e-4, atol=1e-3)},
          "bfloat16": {"dx": dict(rtol=0.05, atol=0.05), "dw": dict(rtol=0.05, atol=0.15)}}
S2_SUM_FLOOR = 2e-6
# the 6 bf16 steps with the kernel against the 6 with stock autograd: the first step's forward is the same; the
# backward differs by bf16 rounding (cuDNN's bf16 dw against the kernel's float32 sums), which moves later losses
# by far less than this
TRAIN_LOSS_RTOL = 2e-2
IOU_OPS = 14  # per IoU and compare: 4 min/max, 2 sub, 2 clamp, mul, add, sub, add, div, compare
# (B, K): predict's K = 1024, validate's K = 4096 (pre_nms_topk), two K above it
NMS_CASES = tuple((8, k) for k in (128, 640, 1024, 4096, 8192)) + ((1, 12288),)
NMS_SWEEP_PLAIN_MAX_K = 4096  # sweep_reference loops over the rows in Python: K launches of a few small ops
# BN statistics, kernel vs plain on the same inputs, per channel: both sum the same values in float32 in different
# orders (sums of up to 819,200 terms at the flagship's largest site), so the difference is held to BN_RTOL of the
# sum of |x| (for the sums) or of x^2 (for the sums of squares), plus BN_ATOL; the result is no scale for a sum
# that cancels.
BN_RTOL, BN_ATOL = 1e-5, 1e-6
BN_OPS = 3  # per element: add to the sum, multiply and add to the sum of squares
VAL = dict(batches=4, batch=8, imgsz=640, nc=80, pre_nms_topk=4096)
# float32 decoded predictions, card (TF32 off) vs CPU, with weights spread to O(1) activations:
# the two sum in different orders, ~1e-5 relative at the head; a box coordinate is stride
# (<= 32) x a DFL expectation over 16 bins. The class priors keep scores near sigmoid(-13), where
# a score's relative error is its logit's absolute error, so scores are held to a relative one.
BOX_ATOL_PX = 1e-2
SCORE_RTOL = 1e-4
# the loop phase: the dense small-object proxy of the JAX package's ablation (tools/flagship_parity.py:216)
LOOP = dict(n_train=32, n_val=16, imgsz=320, batch=8, epochs=3, nc=6, seed=1, obj_px=(4, 12), workers=4)
# mean absolute error of the dataset's JPEG round trip (quality 95, 4:2:0) per channel value: chroma subsampling
# of 4-12 px saturated objects on a noisy background costs ~6.5 (the same for cv2's encoder at quality 95)
JPEG_MEAN_ERR = 10.0
# the JAX package's ablation hyperparameters (tools/flagship_parity.py:43-70) for the port's keys; classify-only
# keys (erasing, auto_augment) are left out
ABLATION = dict(epochs=40, batch=8, imgsz=320, seed=0, optimizer="SGD", lr0=0.01, lrf=0.01, momentum=0.937,
                weight_decay=0.0005, warmup_epochs=3.0, warmup_momentum=0.8, warmup_bias_lr=0.1, nbs=8, box=7.5,
                cls=0.5, dfl=1.5, mosaic=0.0, mixup=0.0, copy_paste=0.0, scale=0.0, translate=0.0, degrees=0.0,
                shear=0.0, perspective=0.0, fliplr=0.5, flipud=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0,
                multi_scale=False, rect=False, cos_lr=False, close_mosaic=0, patience=10_000, amp=True)

# the track phase: the drone-video pipeline (detect + ByteTrack + pose + geo) over synthetic 1080p video. Random weights
# score near sigmoid(-13), under ByteTrack's thresholds, so each model's class logits are spread to follow the image
# (`scored_weights`, gain CLS_GAIN) and shifted so that SHARE_ABOVE_CONF of frame 0's anchors score above conf.
TRACK_CELL = dict(frames=64, hw=(1080, 1920), objects=60, obj_px=(24, 120), seed=3, imgsz=640, conf=0.25,
                  pose_model="yolov8s-pose.yaml", cls_gain=30.0, share_above_conf=0.05,
                  geo=dict(lat=31.2304, lon=121.4737, altitude_m=80.0, yaw_deg=15.0, pitch_deg=90.0))
TRACKER_TARGETS = (50, 200, 500)  # BYTETracker.update alone on detection streams of this many targets

T0 = time.perf_counter()


def emit(phase: str, t_start: float, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "s": round(time.perf_counter() - t_start, 3)}), flush=True)


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def clustered_boxes(rng: np.random.Generator, b: int, k: int, n_cls: int = 3, clusters: int = 12) -> torch.Tensor:
    """(b, k, 4) float32 xyxy boxes around a few centres per image, so that greedy NMS both keeps
    and suppresses, offset by class * 7680. Shared with the tests."""
    centres = rng.random((b, clusters, 2)) * 200
    pick = rng.integers(0, clusters, (b, k))
    c = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 6, (b, k, 2))
    wh = rng.uniform(10, 40, (b, k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1) + rng.integers(0, n_cls, (b, k, 1)) * 7680.0
    return torch.from_numpy(boxes.astype(np.float32))


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, tries: int = 3) -> float:
    """Mean device milliseconds per call: the summed durations of the kernels and copies that `reps` calls of `fn`
    run (torch.profiler, after one warm-up call), without the gaps in which the card waits for the host. A trace
    that recorded no device activity at all (seen once in a long run) is taken again, up to `tries` times."""
    for _ in range(tries):
        ms = profile_device(fn, steps=reps)["device_ms_per_step"]
        if ms > 0:
            return ms
    raise AssertionError(f"torch.profiler recorded no device time in {tries} traces")


def kernel_times(fn, reps: int, prefix: str = "") -> dict:
    """`fn`'s device time per call (`device_ms`) as `<prefix>ms`, and its time by CUDA events around back-to-back
    calls (`cuda_ms`, which also counts the card's waits for the host) as `<prefix>event_ms`."""
    return {f"{prefix}ms": device_ms(fn, reps), f"{prefix}event_ms": cuda_ms(fn, reps, warmup=1)}


def ious_needed(off_boxes, valid, keep, thr) -> int:
    """IoUs a sequential greedy sweep computes on this data: for each kept row i, the j > i still alive."""
    from drone_yolo_tpu_torch.ops.nms import iou_matrix

    adj = torch.triu(iou_matrix(off_boxes) > thr, 1)
    kept_rows = (keep[:, :, None] & adj).int()
    suppressed_before = kept_rows.cumsum(1) - kept_rows  # kept suppressors of j among rows < i
    upper = torch.ones_like(adj[0]).triu(1)
    alive = valid[:, None, :] & (suppressed_before == 0) & upper
    return int((alive & keep[:, :, None]).sum())


def synthetic_batch(rng: np.random.Generator, batch: int, imgsz: int, nc: int, n_max: int = 24, val: bool = False) -> dict:
    """A train batch in the collate format: uint8 RGB frames, 1..n_max GT boxes per image of 4-64 px sides
    (at most imgsz/2) with random classes, padded to `round_label_slots(n_max, 1.0)` slots; with `val` also
    `ori_shapes` (imgsz, imgsz) and `ratio_pads` (1.0, (0.0, 0.0)) per image, as the validator reads them.
    Shared with the tests."""
    from drone_yolo_tpu_torch.data.dataset import round_label_slots

    slots = round_label_slots(n_max, 1.0)
    cls = np.zeros((batch, slots), np.float32)
    boxes = np.zeros((batch, slots, 4), np.float32)
    mask = np.zeros((batch, slots), np.float32)
    for i in range(batch):
        n = int(rng.integers(1, n_max + 1))
        wh = rng.uniform(4, min(64, imgsz / 2), (n, 2))
        xy = rng.uniform(0, imgsz - wh)
        boxes[i, :n] = np.concatenate([xy, xy + wh], 1)
        cls[i, :n] = rng.integers(0, nc, n)
        mask[i, :n] = 1.0
    img = rng.integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)
    out = {"img": img, "cls": cls, "bboxes": boxes, "mask": mask}
    if val:
        out.update(ori_shapes=[(imgsz, imgsz)] * batch, ratio_pads=[(1.0, (0.0, 0.0))] * batch)
    return out


def write_dense_dataset(root: Path, n_train: int, n_val: int, size: int, seed: int, nc: int, obj_px) -> tuple[Path, dict]:
    """The dense small-object proxy (`tools/dense_dataset.py:make_dense_image`, numpy only) written by the port's JPEG
    encoder at quality 95, with YOLO labels and data.yaml, as `make_dense_dataset` lays it out. Returns the yaml path
    and the round trip's mean and largest absolute error over all images."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from dense_dataset import CLASSES, make_dense_image

    from drone_yolo_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

    rng = np.random.default_rng(seed)
    err_sum, err_max, n_val_px = 0.0, 0, 0
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img, labels = make_dense_image(rng, size=size, nc=nc, obj_px=obj_px)
            data = encode_jpeg(img, quality=95)
            (root / "images" / split / f"{split}_{i:04d}.jpg").write_bytes(data)
            err = np.abs(decode_jpeg(data).astype(np.int64) - img)
            err_sum, err_max, n_val_px = err_sum + float(err.sum()), max(err_max, int(err.max())), n_val_px + err.size
            (root / "labels" / split / f"{split}_{i:04d}.txt").write_text(
                "".join(f"{c} {x:.6f} {y:.6f} {w:.6f} {h:.6f}\n" for c, x, y, w, h in labels))
    names = "".join(f"  {i}: {CLASSES[i][0]}\n" for i in range(nc))
    yaml_path = root / "data.yaml"
    yaml_path.write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnc: {nc}\nnames:\n{names}")
    return yaml_path, {"mean_abs_err": err_sum / n_val_px, "max_abs_err": err_max}


def accuracy(seeds: list[int]) -> None:
    """`YOLO.train` at the ablation settings on 192 + 96 dense-proxy images, then `YOLO.val` at conf 0.001: one JSON
    line per init seed (the ablation's seed is 0)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(1)
    from drone_yolo_tpu_torch import YOLO

    smi = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader").splitlines()[0]
    tmp = Path(tempfile.mkdtemp(prefix="chip_accuracy_"))
    try:
        t = time.perf_counter()
        data, round_trip = write_dense_dataset(tmp / "dense", 192, 96, 320, seed=1, nc=6, obj_px=(4, 12))
        data_s = time.perf_counter() - t
        for seed in seeds:
            t = time.perf_counter()
            model = YOLO(FLAGSHIP)
            model.train(data=str(data), workers=4, cache="ram", project=str(tmp / "runs"), name=f"seed{seed}",
                        exist_ok=True, s2grad="cuda", bnstats="cuda", **{**ABLATION, "seed": seed})
            train_s = time.perf_counter() - t
            t = time.perf_counter()
            metrics = model.val(data=str(data), imgsz=320, batch=8, conf=0.001, iou=0.7, max_det=300, dtype="float32",
                                verbose=False)
            val_s = time.perf_counter() - t
            epochs = model.trainer.epoch_stats
            print(json.dumps({"phase": "accuracy", "model": FLAGSHIP, "nvidia_smi": smi, "hyps": {**ABLATION, "seed": seed},
                              "map50_95": metrics["metrics/mAP50-95(B)"], "map50": metrics["metrics/mAP50(B)"],
                              "metrics": metrics, "jax_ablation_json": {"map50_95": 0.8825, "map50": 0.9908},
                              "train_s": train_s, "val_s": val_s, "dataset_s": data_s, "jpeg_round_trip": round_trip,
                              "epoch_s_median": float(np.median([e["train_s"] for e in epochs])),
                              "data_wait_share": sum(e["data_wait_s"] for e in epochs) / sum(e["train_s"] for e in epochs),
                              "results_csv": (model.trainer.save_dir / "results.csv").read_text()}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def bn_stats_errors(x: torch.Tensor, s: torch.Tensor, q: torch.Tensor) -> dict:
    """The largest difference of (s, q) from `bn_stats_reference(x)` per channel, and the largest ratio of that
    difference to its tolerance BN_RTOL * (sum |x| or sum x^2) + BN_ATOL (<= 1 passes). Shared with the tests."""
    from drone_yolo_tpu_torch.ops.bn_stats import bn_stats_reference

    with torch.no_grad():
        s_p, q_p = bn_stats_reference(x)
        xf = x.float()
        scales = (xf.abs().sum((0, 2, 3)), q_p)
    out = {}
    for name, got, want, scale in (("sum", s, s_p, scales[0]), ("sumsq", q, q_p, scales[1])):
        err = (got - want).abs()
        out[f"{name}_err"] = float(err.max())
        out[f"{name}_err_over_tol"] = float((err / (BN_RTOL * scale + BN_ATOL)).max())
    return out


def spread_weights(state_dict: dict, rng: np.random.Generator) -> dict:
    """A redrawn float32 state dict of an unfused model whose activations stay O(1) through the
    depth: LeCun-normal kernels, BN statistics away from identity; the biases of the head's last
    convs (the box and class priors) stay. Shared with the tests."""
    out = {}
    for name, t in state_dict.items():
        if name.endswith("weight") and t.ndim == 4:
            v = rng.standard_normal(t.shape) * math.sqrt(1.0 / np.prod(t.shape[1:]))
        elif name.endswith("running_var") or (name.endswith("weight") and t.ndim == 1):
            v = rng.uniform(0.5, 1.5, t.shape)
        elif name.endswith("running_mean") or (name.endswith("bias") and (".bn." in name or "rbr_identity" in name)):
            v = rng.normal(0.0, 0.1, t.shape)
        else:
            v = t.cpu().numpy()
        out[name] = torch.from_numpy(v.astype(np.float32))
    return out


def scored_weights(state_dict: dict, rng: np.random.Generator, cls_bias: float, cls_gain: float) -> dict:
    """`spread_weights`, then the last conv of each level's class branch (`cv3.<i>.2`) with its weights scaled by
    `cls_gain` and its biases set to `cls_bias`: class logits that follow the image, spread around `cls_bias`, instead of
    scores near sigmoid(-13). A random model whose detections a tracker follows. Shared with the tests."""
    out = spread_weights(state_dict, rng)
    for name, t in out.items():
        if re.search(r"\.cv3\.\d+\.2\.bias$", name):
            out[name] = torch.full_like(t, cls_bias)
        elif re.search(r"\.cv3\.\d+\.2\.weight$", name):
            out[name] = t * cls_gain
    return out


def moving_frames(rng: np.random.Generator, n: int, hw: tuple[int, int], n_objects: int, size=(8, 40)):
    """`n` BGR uint8 frames of `n_objects` textured rectangles moving at constant velocity over a fixed textured
    background; an object enters at a random frame and leaves at a random later one, so tracks are born and die.
    The texture keeps neighbouring anchors from scoring exactly alike. Shared with the tests."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    bg = np.stack([90 + 30 * np.sin(xx / w * 6.3 + c) + 20 * np.cos(yy / h * 4.1 + c) for c in range(3)], -1)
    bg = np.clip(bg + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)
    wh = rng.integers(size[0], size[1] + 1, (n_objects, 2))
    xy = rng.uniform(0, 1, (n_objects, 2)) * (np.array([w, h]) - wh)
    vel = rng.normal(0, 1.5, (n_objects, 2)) * max(h, w) / 640
    patches = [np.clip(rng.integers(0, 256, 3) + rng.normal(0, 25, (bh, bw, 3)), 0, 255).astype(np.uint8)
               for bw, bh in wh]
    start = rng.integers(0, max(1, n // 2), n_objects)
    stop = np.minimum(n, start + rng.integers(n // 4 + 1, n + 1, n_objects))
    frames = []
    for f in range(n):
        img = bg.copy()
        for j in np.flatnonzero((start <= f) & (f < stop)):
            x1, y1 = np.floor(xy[j] + vel[j] * (f - start[j])).astype(int)
            bw, bh = wh[j]
            cx1, cy1, cx2, cy2 = max(x1, 0), max(y1, 0), min(x1 + bw, w), min(y1 + bh, h)
            if cx1 < cx2 and cy1 < cy2:
                img[cy1:cy2, cx1:cx2] = patches[j][cy1 - y1:cy2 - y1, cx1 - x1:cx2 - x1]
        frames.append(img)
    return frames


def detection_stream(rng: np.random.Generator, n_frames: int = 120, n_targets: int = 48, hw=(720, 1280)):
    """Per frame (xyxy float32 (n, 4), scores float32 (n,), classes float32 (n,)): targets of 20-80 px moving at
    constant velocity with jitter, each alive between a random birth and death, detected with probability 0.85 (a
    fifth of them at a low score in (0.11, 0.25)), plus up to 4 clutter boxes a frame. Shared with the tests."""
    h, w = hw
    birth = rng.integers(0, max(n_frames - 10, 1), n_targets)
    death = np.minimum(n_frames, birth + rng.integers(10, max(n_frames, 11), n_targets))
    wh = rng.uniform(20, 80, (n_targets, 2))
    xy0 = rng.uniform(0, 1, (n_targets, 2)) * (np.array([w, h]) - wh)
    vel = rng.normal(0, 3, (n_targets, 2))
    cls = rng.integers(0, 3, n_targets)
    frames = []
    for f in range(n_frames):
        boxes, scores, classes = [], [], []
        for t in np.flatnonzero((birth <= f) & (f < death)):
            if rng.random() > 0.85:
                continue  # missed
            c = xy0[t] + vel[t] * (f - birth[t]) + rng.normal(0, 1.5, 2)
            s = wh[t] * rng.uniform(0.95, 1.05, 2)
            boxes.append([*c, *(c + s)])
            scores.append(rng.uniform(0.11, 0.25) if rng.random() < 0.2 else rng.uniform(0.3, 0.95))
            classes.append(cls[t])
        for _ in range(int(rng.integers(0, 5))):
            c = rng.uniform(0, 1, 2) * np.array([w - 40, h - 40])
            boxes.append([*c, *(c + rng.uniform(10, 40, 2))])
            scores.append(rng.uniform(0.05, 0.4))
            classes.append(rng.integers(0, 3))
        order = rng.permutation(len(boxes))
        frames.append((np.asarray(boxes, np.float32).reshape(-1, 4)[order], np.asarray(scores, np.float32)[order],
                       np.asarray(classes, np.float32)[order]))
    return frames


def sass_counts(library: Path) -> dict:
    """Tensor-core instructions (HMMA: mma.sync, HGMMA: wgmma) per kernel of a built library, by `cuobjdump -sass`
    from nvcc's toolkit; {"cuobjdump": "absent"} where the toolkit has none. Kernels are named as in the source,
    with their template arguments."""
    from drone_yolo_tpu_torch.ops.cuda_build import find_nvcc

    tool = Path(find_nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return {"cuobjdump": "absent"}
    counts, name = {}, None
    for line in sh(str(tool), "-sass", str(library)).splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            mangled = fn.group(1)
            m = re.search(r"s2_d[wx]_[a-z]+", mangled)  # the source name: lower case, up to the mangling's next capital
            name = m.group(0) if m else mangled
            args = re.findall(r"Li(\d+)E", mangled)
            name += f"<{','.join(args)}>" if args else ""
            counts[name] = {"HMMA": 0, "HGMMA": 0}
        elif name is not None:
            for op in counts[name]:
                counts[name][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def profile_device(fn, steps: int, top: int = 15) -> dict:
    """torch.profiler over `steps` calls of `fn` (after one warm-up call): device busy share and the kernels that take the time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_wall = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_wall) * 1e3
    rows = []
    for evt in prof.key_averages():  # device-side events only: kernels and copies, not the ops that launch them
        if evt.device_type != torch.autograd.DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue  # a user annotation on the device (Optimizer.step) spans kernels counted on their own
        dev_us = getattr(evt, "self_device_time_total", None)
        dev_us = evt.self_cuda_time_total if dev_us is None else dev_us
        rows.append({"name": evt.key[:90], "calls": evt.count, "device_ms": dev_us / 1e3 / steps})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps, "device_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms * steps / wall_ms, "top": rows[:top]}


def s2_sites(model, batch: int, imgsz: int) -> list[dict]:
    """The convs of `model` that the stride-2 backward covers (`ops.conv_s2.covers`) in a train-mode forward of a
    (batch, 3, imgsz, imgsz) image, in forward order: name, k, the shapes of x, w and dy, and whether dx is needed.
    Traced on the meta device (no arithmetic)."""
    from drone_yolo_tpu_torch.nn import modules as M
    from drone_yolo_tpu_torch.ops.conv_s2 import covers

    sites = []

    def hook(mod, args, name):
        x = args[0]
        if covers(mod.conv, x):
            k = mod.conv.kernel_size[0]
            sites.append({"name": name, "k": k, "x": tuple(x.shape), "w": tuple(mod.conv.weight.shape),
                          "dy": (x.shape[0], mod.conv.out_channels, x.shape[2] // 2, x.shape[3] // 2),
                          "need_dx": x.requires_grad})

    handles = [m.register_forward_pre_hook(lambda m, a, name=n: hook(m, a, name))
               for n, m in model.named_modules() if isinstance(m, M.Conv)]
    state = {k: torch.empty_like(v, device="meta").requires_grad_(v.requires_grad)
             for k, v in model.state_dict(keep_vars=True).items()}
    was_training = model.training
    try:
        model.train()
        with M.collect_bn_stats():
            torch.func.functional_call(model, state, (torch.empty(batch, 3, imgsz, imgsz, device="meta"),))
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return sites


def bn_sites(model, batch: int, imgsz: int) -> list[dict]:
    """The train-mode BatchNorms of `model` in a forward of a (batch, 3, imgsz, imgsz) image, in forward order:
    name and input shape. Traced on the meta device (no arithmetic)."""
    from drone_yolo_tpu_torch.nn import modules as M

    sites = []
    handles = [m.register_forward_pre_hook(lambda m, a, name=n: sites.append({"name": name, "x": tuple(a[0].shape)}))
               for n, m in model.named_modules() if isinstance(m, M.BatchNorm2d)]
    state = {k: torch.empty_like(v, device="meta") for k, v in model.state_dict(keep_vars=True).items()}
    was_training = model.training
    try:
        model.train()
        with M.collect_bn_stats():
            torch.func.functional_call(model, state, (torch.empty(batch, 3, imgsz, imgsz, device="meta"),))
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return sites


def site_input(shape, dtype: torch.dtype, seed: int) -> torch.Tensor:
    """A BN input on the card: normals of mean 0.5 and scale 2 (a conv output's spread), cast to `dtype`."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)


def s2_site_inputs(site: dict, dtype: torch.dtype, seed: int):
    """Random x, w, dy of a site on the card: unit normals, w scaled by 1/sqrt(fan-in)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(site["x"], generator=g, device="cuda").to(dtype)
    w = (torch.randn(site["w"], generator=g, device="cuda") / math.sqrt(np.prod(site["w"][1:]))).to(dtype)
    dy = torch.randn(site["dy"], generator=g, device="cuda").to(dtype)
    return x, w, dy


def s2_cost(site: dict) -> tuple[int, int]:
    """(bytes, operations) of one bf16 backward at a site: x, w, dy read once, dx (when needed) and the float32 dw
    written once; 2 operations per multiply-add, B*Ho*Wo*Co*Ci*k*k of them for dw and again for dx."""
    b, ci, h, w = site["x"]
    numel = lambda shape: int(np.prod(shape))  # noqa: E731
    n_bytes = 2 * (numel(site["x"]) + numel(site["w"]) + numel(site["dy"])) + 4 * numel(site["w"])
    macs = numel(site["dy"]) * ci * site["k"] ** 2
    if site["need_dx"]:
        n_bytes += 2 * numel(site["x"])
    return n_bytes, 2 * macs * (2 if site["need_dx"] else 1)


def check_loop_counts(c: dict, steps: int, val_batches: int, run: str, n_bn: int, n_sites: dict) -> None:
    """A loop run's kernel counts: every step calls the stride-2 backward at each site and the BN statistics at each
    BN input, every val batch calls greedy NMS once (two launches)."""
    from drone_yolo_tpu_torch.ops import cuda_s2bwd
    from drone_yolo_tpu_torch.ops.conv_s2 import KINDS

    want_s2 = {cuda_s2bwd.NAMES[k]: steps * n_sites[k] for k in KINDS}
    if c["s2_calls"] != want_s2 or c["bn_calls"] != steps * n_bn:
        raise AssertionError(f"run {run}: {c}, expected stride-2 calls {want_s2} and {steps * n_bn} BN calls "
                             f"for {steps} steps")
    if c["nms_calls"] != val_batches or c["launches"]["greedy_nms"] != 2 * val_batches:
        raise AssertionError(f"run {run}: {c['nms_calls']} NMS calls ({c['launches']['greedy_nms']} launches) for "
                             f"{val_batches} val batches")


def run_loop(n_bn: int, n_sites: dict) -> dict:
    """Phase 9: runs A and B of the epoch loop (see the module docstring), their checks and their numbers."""
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.cfg import get_train_cfg
    from drone_yolo_tpu_torch.data.build import build_yolo_dataset
    from drone_yolo_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
    from drone_yolo_tpu_torch.data.utils import check_det_dataset
    from drone_yolo_tpu_torch.engine.checkpoint import read_resume_state
    from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
    from drone_yolo_tpu_torch.ops import cuda_bnstats, cuda_nms, cuda_s2bwd
    from drone_yolo_tpu_torch.ops.conv_s2 import KINDS

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from dense_dataset import make_dense_image

    def reset():
        cuda_s2bwd.reset_counts()
        cuda_bnstats.reset_counts()
        cuda_nms.reset_counts()

    def counts() -> dict:
        s2 = dict(cuda_s2bwd.s2_bwd_cuda.calls)
        s2_launches = dict(cuda_s2bwd.s2_bwd_cuda.launches)
        return {"s2_calls": s2, "bn_calls": cuda_bnstats.bn_stats_cuda.calls,
                "nms_calls": cuda_nms.greedy_keep_cuda.calls,
                "launches": {"greedy_nms": cuda_nms.greedy_keep_cuda.launches, "bn_stats": cuda_bnstats.bn_stats_cuda.launches,
                             **{cuda_s2bwd.NAMES[k]: s2_launches.get(cuda_s2bwd.NAMES[k], 0) for k in KINDS}}}

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_loop_"))
    try:
        data, round_trip = write_dense_dataset(tmp / "dense", LOOP["n_train"], LOOP["n_val"], LOOP["imgsz"],
                                               seed=LOOP["seed"], nc=LOOP["nc"], obj_px=LOOP["obj_px"])
        if not round_trip["mean_abs_err"] <= JPEG_MEAN_ERR:
            raise AssertionError(f"JPEG round trip of the dataset: {round_trip}, mean bound {JPEG_MEAN_ERR}")
        decode_ms = {}
        for size in (320, 640):
            blob = encode_jpeg(make_dense_image(np.random.default_rng(size), size=size)[0], quality=95)
            decode_jpeg(blob)  # the Huffman tables' lookup is built once
            t0 = time.perf_counter()
            for _ in range(5):
                decode_jpeg(blob)
            decode_ms[f"{size}px"] = (time.perf_counter() - t0) / 5 * 1e3
        cfg = get_train_cfg(overrides=dict(imgsz=LOOP["imgsz"], cache="ram"))  # default augmentation
        info = check_det_dataset(data)
        ds = build_yolo_dataset(cfg, info["train"], LOOP["batch"], info, mode="train")
        for i in range(len(ds)):
            ds.load_image(i)
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds[i]
        aug_ms = (time.perf_counter() - t0) / len(ds) * 1e3
        del ds

        common = dict(data=str(data), imgsz=LOOP["imgsz"], batch=LOOP["batch"], nbs=LOOP["batch"], optimizer="SGD",
                      close_mosaic=1, cache="ram", workers=LOOP["workers"], s2grad="cuda", bnstats="cuda", amp=True,
                      project=str(tmp / "runs"), exist_ok=True)
        reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = YOLO(FLAGSHIP)
        metrics_a = model.train(name="a", epochs=LOOP["epochs"], **common)
        wall_a = time.perf_counter() - t0
        counts_a = counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        a = model.trainer
        nb, val_nb = a.nb, math.ceil(LOOP["n_val"] / LOOP["batch"])
        check_loop_counts(counts_a, LOOP["epochs"] * nb, LOOP["epochs"] * val_nb, "A", n_bn, n_sites)
        losses = np.array([e["loss_items"] for e in a.epoch_stats])
        if not (np.isfinite(losses).all() and len(a.epoch_stats) == LOOP["epochs"]):
            raise AssertionError(f"run A: {len(a.epoch_stats)} epochs, loss items {losses}")
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in metrics_a.values()):
            raise AssertionError(f"run A: metrics out of [0, 1]: {metrics_a}")
        files = {f: (a.wdir / f).stat().st_size for f in ("last.npz", "best.npz", "resume_state.npz")}
        if not (a.save_dir / "results.csv").is_file() or len((a.save_dir / "results.csv").read_text().splitlines()) != 1 + LOOP["epochs"]:
            raise AssertionError("run A: results.csv missing or not one row per epoch")
        final_a = a.train_state()

        reset()
        b = BaseTrainer(overrides=dict(model=FLAGSHIP, name="b", epochs=LOOP["epochs"] + 1,
                                       resume=str(a.wdir / "resume_state.npz"), **common))
        b._setup_train()
        start_b = b.train_state()
        for part in ("params", "ema"):
            if not all(torch.equal(start_b[part][k].cpu(), final_a[part][k].detach().cpu()) for k in final_a[part]):
                raise AssertionError(f"run B: resumed {part} differ from run A's final state")
        if not all(torch.equal(start_b["opt"]["momentum"][k].cpu(), final_a["opt"]["momentum"][k].cpu())
                   for k in final_a["opt"]["momentum"]):
            raise AssertionError("run B: resumed SGD momentum differs from run A's final state")
        if (b.start_epoch, start_b["step"], start_b["count"]) != (LOOP["epochs"], final_a["step"], final_a["count"]):
            raise AssertionError(f"run B: starts at epoch {b.start_epoch}, step {start_b['step']}, count {start_b['count']}")
        b._do_train()
        counts_b = counts()
        check_loop_counts(counts_b, nb, val_nb, "B", n_bn, n_sites)
        if [e["epoch"] for e in b.epoch_stats] != [LOOP["epochs"]]:
            raise AssertionError(f"run B ran epochs {[e['epoch'] for e in b.epoch_stats]}, expected [{LOOP['epochs']}]")
        _, saved_epoch = read_resume_state(b.wdir / "resume_state.npz")
        if saved_epoch != LOOP["epochs"]:
            raise AssertionError(f"run B saved epoch {saved_epoch}")

        reset()
        last = YOLO(a.wdir / "last.npz")
        frame = decode_jpeg(next((data.parent / "images" / "val").glob("*.jpg")).read_bytes())[..., ::-1]
        res = last.predict(np.ascontiguousarray(frame), imgsz=LOOP["imgsz"], conf=0.0, verbose=False)
        if not (len(res) == 1 and res[0].boxes.data.shape[1] == 6 and np.isfinite(res[0].boxes.data).all()):
            raise AssertionError("YOLO(last.npz) predictions on the card are not finite (n, 6) boxes")
        epochs = a.epoch_stats + b.epoch_stats
        train_s = [e["train_s"] for e in epochs]
        launches = {k: counts_a["launches"][k] + counts_b["launches"][k] for k in counts_a["launches"]}
        return {"model": FLAGSHIP, "dataset": {**LOOP, "jpeg_quality": 95, "round_trip": round_trip,
                                               "round_trip_mean_bound": JPEG_MEAN_ERR},
                "metrics_a": metrics_a, "metrics_b": b.metrics, "epochs": epochs,
                "epoch_s": train_s, "epoch_s_median": float(np.median(train_s)),
                "train_img_per_s": sum(e["images"] for e in epochs) / sum(train_s),
                "data_wait_share": sum(e["data_wait_s"] for e in epochs) / sum(train_s),
                "val_s": [e["val_s"] for e in epochs], "decode_ms_per_image": decode_ms,
                "augment_ms_per_sample": aug_ms, "peak_memory_gb": peak_gb, "checkpoint_bytes": files,
                "run_a_wall_s": wall_a, "resume": {"start_epoch": b.start_epoch, "bitwise_equal": True},
                "predict_last_npz_n_det": len(res[0].boxes),
                "counts": {"a": counts_a, "b": counts_b, "launches": launches}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def calibrated_weights(facade, frame: np.ndarray, seed: int, gain: float, share: float, conf: float, imgsz: int) -> float:
    """Load `scored_weights` into the facade's unfused model with the class bias at which `share` of the anchors of
    `frame` (letterboxed to imgsz) score above `conf` by their best class. Returns that bias."""
    from drone_yolo_tpu_torch.ops.letterbox import letterbox

    model = facade.ensure_variables(imgsz=imgsz)
    base = {k: v.cpu() for k, v in model.state_dict().items()}
    model.load_state_dict(scored_weights(base, np.random.default_rng(seed), 0.0, gain))
    x = letterbox(torch.from_numpy(frame).to(facade.device).flip(-1).permute(2, 0, 1)[None].float() / 255.0,
                  (imgsz, imgsz))
    with torch.inference_mode():
        maps = model(x, raw=True)
    reg = 4 * model.head.reg_max
    best = torch.cat([m[:, reg:reg + model.nc].flatten(2) for m in maps], 2).amax(1).flatten().float()
    bias = math.log(conf / (1.0 - conf)) - float(torch.quantile(best, 1.0 - share))
    model.load_state_dict(scored_weights(base, np.random.default_rng(seed), bias, gain))
    return bias


def run_track() -> dict:
    """Phase 11: the drone-video pipeline on the card (see the module docstring), its checks and its numbers."""
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.apps import DroneVideoPipeline, GeoConverter
    from drone_yolo_tpu_torch.ops import cuda_nms
    from drone_yolo_tpu_torch.ops import nms as nms_ops
    from drone_yolo_tpu_torch.trackers.byte_tracker import BYTETracker, STrack
    from drone_yolo_tpu_torch.trackers.track import load_tracker_cfg

    c = TRACK_CELL
    h, w = c["hw"]
    frames = moving_frames(np.random.default_rng(c["seed"]), c["frames"], c["hw"], c["objects"], c["obj_px"])
    det, pose = YOLO(FLAGSHIP), YOLO(c["pose_model"])
    biases = {name: calibrated_weights(m, frames[0], seed, c["cls_gain"], c["share_above_conf"], c["conf"], c["imgsz"])
              for seed, (name, m) in enumerate(((FLAGSHIP, det), (c["pose_model"], pose)))}
    geo = GeoConverter(**c["geo"], image_width_px=w, image_height_px=h)

    def pipeline(with_pose: bool) -> DroneVideoPipeline:
        """A new pipeline whose trackers start afresh, as for a new video."""
        for m in (det, pose):
            if m.predictor is not None:
                m.predictor.__dict__.pop("trackers", None)
        STrack.reset_id()
        return DroneVideoPipeline(det, pose if with_pose else None, geo, imgsz=c["imgsz"], conf=c["conf"])

    # pass A: every keep mask of both models' NMS against the plain keep on the same candidates
    checks, kernel_keep = [], nms_ops.greedy_keep

    def checked_keep(boxes, valid, iou_thres):
        keep = kernel_keep(boxes, valid, iou_thres)
        plain = nms_ops.greedy_keep_reference(boxes, valid, iou_thres)
        checks.append({"K": int(boxes.shape[1]), "valid": int(valid.sum()), "kept": int(keep.sum()),
                       "equal": bool(torch.equal(keep, plain))})
        return keep

    nms_ops.greedy_keep = checked_keep
    try:
        pipe, steps_a = pipeline(True), []
        for f in frames:
            first = len(checks)
            steps_a.append(pipe.step(f))
            for j, ch in enumerate(checks[first:]):  # a step runs the detector's NMS, then the pose model's
                ch["model"] = ("detector", "pose")[j]
    finally:
        nms_ops.greedy_keep = kernel_keep
    n_pose = sum("pose" in o for o in steps_a)
    if not all(ch["equal"] for ch in checks) or len(checks) != len(frames) + n_pose:
        raise AssertionError(f"track: {sum(not ch['equal'] for ch in checks)} of {len(checks)} keep masks differ from "
                             f"the plain keep ({len(frames)} frames, {n_pose} pose calls)")
    if n_pose < len(frames) - 1 or not any(ch["valid"] > ch["kept"] > 0 for ch in checks):
        raise AssertionError(f"track: {n_pose} pose calls in {len(frames)} frames, or no NMS call kept and suppressed")
    det_checks, pose_checks = ([ch for ch in checks if ch["model"] == m] for m in ("detector", "pose"))

    # pass B: the timed run, detect + track + pose + geo, with host timers around the tracker, pose and geo
    stage = defaultdict(float)

    def timed(fn, key):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                stage[key] += time.perf_counter() - t
        return run

    update = BYTETracker.update
    BYTETracker.update = timed(update, "tracker_update")
    pipe = pipeline(True)
    pose.predict, geo.pixel_to_latlon = timed(pose.predict, "pose"), timed(geo.pixel_to_latlon, "geo")
    try:
        cuda_nms.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        speeds = [pipe.step(f)["results"].speed for f in frames]
        wall_full = time.perf_counter() - t
        nms_calls, nms_launches = cuda_nms.greedy_keep_cuda.calls, cuda_nms.greedy_keep_cuda.launches
    finally:
        BYTETracker.update = update
        del pose.predict, geo.pixel_to_latlon
    if nms_calls != len(frames) + n_pose or nms_launches != 2 * nms_calls:
        raise AssertionError(f"track: {nms_calls} NMS calls ({nms_launches} launches) for {len(frames)} frames and "
                             f"{n_pose} pose calls")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_track_"))
    try:
        pipe.export_csv(tmp / "tracks.csv")
        csv_rows = len((tmp / "tracks.csv").read_text().splitlines()) - 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = sum(len(v) for v in pipe.trajectories.values())
    if csv_rows != rows or len(pipe.trajectories) == 0:
        raise AssertionError(f"track: {csv_rows} CSV rows for {rows} trajectory points of {len(pipe.trajectories)} tracks")
    lens = [len(v) for v in pipe.trajectories.values()]

    # pass C: detect + track + geo without the pose model
    pipe_c = pipeline(False)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for f in frames:
        pipe_c.step(f)
    wall_det = time.perf_counter() - t

    # the device's busy share over steps of the full pipeline (torch.profiler)
    pipe_d, it = pipeline(True), itertools.cycle(frames)
    prof = profile_device(lambda: pipe_d.step(next(it)), steps=8, top=8)

    # BYTETracker.update alone
    tracker_alone = {}
    args = load_tracker_cfg("bytetrack.yaml")
    for n in TRACKER_TARGETS:
        stream = detection_stream(np.random.default_rng(n), n_frames=60, n_targets=n, hw=c["hw"])
        tracker, ms = BYTETracker(args), []
        for boxes, scores, cls in stream:
            t = time.perf_counter()
            out = tracker.update(boxes, scores, cls)
            ms.append((time.perf_counter() - t) * 1e3)
        tracker_alone[str(n)] = {"update_ms_mean": float(np.mean(ms[5:])), "update_ms_median": float(np.median(ms[5:])),
                                 "detections_per_frame": float(np.mean([len(s[0]) for s in stream])),
                                 "tracks_last_frame": len(out)}

    n = len(frames)
    per_frame = {k: float(np.mean([s[k] for s in speeds])) for k in ("preprocess", "inference", "postprocess")}
    per_frame.update({k: stage[k] * 1e3 / n for k in ("tracker_update", "pose", "geo")})
    per_frame["other"] = wall_full * 1e3 / n - sum(per_frame.values())
    return {"detector": FLAGSHIP, "pose_model": c["pose_model"], "cell": c, "class_bias": biases, "dtype": "bfloat16",
            "fused": True, "fps_detect_track": n / wall_det, "fps_detect_track_pose": n / wall_full,
            "stage_ms_per_frame": per_frame, "pose_ms_per_call": stage["pose"] * 1e3 / max(n_pose, 1),
            "pose_calls": n_pose, "tracks": len(pipe.trajectories), "csv_rows": csv_rows,
            "track_len": {"median": float(np.median(lens)), "max": max(lens)},
            "tracks_per_frame_last": len(steps_a[-1]["tracks"]),
            "nms_keep_checks": {"calls": len(checks), "all_equal_plain": True,
                                "detector_valid_median": float(np.median([ch["valid"] for ch in det_checks])),
                                "detector_kept_median": float(np.median([ch["kept"] for ch in det_checks])),
                                "pose_valid_median": float(np.median([ch["valid"] for ch in pose_checks])),
                                "pose_kept_median": float(np.median([ch["kept"] for ch in pose_checks])),
                                "K": sorted({ch["K"] for ch in checks})},
            "nms_calls": nms_calls, "nms_launches": nms_launches,
            "profile": {k: prof[k] for k in ("steps", "wall_ms_per_step", "device_ms_per_step", "device_idle_share", "top")},
            "bytetrack_update_alone": tracker_alone}


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(1)
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
    from drone_yolo_tpu_torch.nn.model import DetectionModel
    from drone_yolo_tpu_torch.ops import cuda_bnstats, cuda_build, cuda_nms, cuda_s2bwd
    from drone_yolo_tpu_torch.ops.bn_stats import bn_stats, bn_stats_reference
    from drone_yolo_tpu_torch.ops.conv_s2 import KINDS, s2_bwd_reference
    from drone_yolo_tpu_torch.ops.letterbox import letterbox_u8
    from drone_yolo_tpu_torch.ops.nms import (
        compact, greedy_keep, greedy_keep_reference, non_max_suppression, select_candidates, suppression_words_reference,
        sweep_reference)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. preflight -----------------------------------------------------------
    t = time.perf_counter()
    smi = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader").splitlines()[0]
    nvcc_version = sh(cuda_build.find_nvcc(), "--version").splitlines()[-1]
    emit("preflight", t, python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc_version, device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), nvidia_smi=smi)

    # 2. build: one nvcc per source, started together ---------------------------
    t = time.perf_counter()
    libraries = (cuda_nms.LIBRARY, cuda_s2bwd.LIBRARY, cuda_bnstats.LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as pool:
        built = list(pool.map(lambda lib: lib.build(), libraries))
    for lib in libraries:
        lib.load()
    build_s = time.perf_counter() - t
    sass = sass_counts(built[libraries.index(cuda_s2bwd.LIBRARY)])
    if "cuobjdump" not in sass:
        bf16_kernels = {n: c for n, c in sass.items() if n.startswith(("s2_dw_mma", "s2_dx_mma"))}
        if {n.split("<")[0] for n in bf16_kernels} != {"s2_dw_mma", "s2_dx_mma"} or not all(
                c["HMMA"] + c["HGMMA"] > 0 for c in bf16_kernels.values()):
            raise AssertionError(f"every bf16 stride-2 kernel should run on tensor cores, SASS: {sass}")
    emit("build", t, libraries={p.name: cuda_build.report_path(p).read_text().strip().splitlines() for p in built},
         build_s=build_s, s2_sass_tensor_core_instructions=sass,
         nms_workspace_bytes={f"B=8,K={k}": cuda_nms.workspace_bytes(8, k) for k in (1024, VAL["pre_nms_topk"])})

    # 3. kernels vs plain -----------------------------------------------------
    t = time.perf_counter()
    rng = np.random.default_rng(0)
    cases = []
    for b, k in NMS_CASES:
        for thr in (0.45, 0.7):
            boxes = clustered_boxes(rng, b, k, clusters=12 if k <= 1024 else 48).to(dev)
            valid = torch.from_numpy(rng.random((b, k)) > 0.1).to(dev)
            words = cuda_nms.suppression_words_cuda(boxes, valid, thr)
            got = greedy_keep(boxes, valid, thr)
            torch.cuda.synchronize()
            for i in range(b):  # image by image: the plain words take K * K * 8 bytes a image
                want_words = suppression_words_reference(boxes[i:i + 1], valid[i:i + 1], thr)
                if not torch.equal(words[i:i + 1], want_words):
                    raise AssertionError(f"B={b} K={k} thr={thr} image {i}: kernel and plain suppression words differ "
                                         f"in {int((words[i:i + 1] != want_words).sum())} words")
                del want_words
            want = greedy_keep_reference(boxes, valid, thr)
            kept, suppressed = int(got.sum()), int((valid & ~got).sum())
            if not torch.equal(got, want):
                raise AssertionError(f"B={b} K={k} thr={thr}: kernel and plain keep masks differ in {int((got != want).sum())} places")
            if k <= NMS_SWEEP_PLAIN_MAX_K and not torch.equal(got, sweep_reference(words, valid)):
                raise AssertionError(f"B={b} K={k} thr={thr}: the sweep kernel and sweep_reference over the same words differ")
            if kept == 0 or suppressed == 0:
                raise AssertionError(f"B={b} K={k} thr={thr}: case must keep and suppress (kept {kept}, suppressed {suppressed})")
            cases.append({"B": b, "K": k, "thr": thr, "kept": kept, "suppressed": suppressed, "keep_equal": True,
                          "words_equal": True, "sign_bit_words": int((words < 0).sum()),
                          "sweep_vs_plain_sweep": k <= NMS_SWEEP_PLAIN_MAX_K})
            del boxes, valid, words, got, want
    sites = s2_sites(DetectionModel(FLAGSHIP, nc=TRAIN["nc"]), TRAIN["batch"], TRAIN["imgsz"])
    n_sites = {k: sum(s["k"] == k for s in sites) for k in KINDS}
    if n_sites != {3: 8, 1: 4}:
        raise AssertionError(f"the flagship should have 8 k=3 and 4 k=1 stride-2 sites, found {n_sites}")
    s2_cases = []
    for i, site in enumerate(sites):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dy = s2_site_inputs(site, dtype, seed=i)
            dx, dw = cuda_s2bwd.s2_bwd_cuda(x, w, dy, site["k"], site["need_dx"])
            torch.cuda.synchronize()
            dx_p, dw_p = s2_bwd_reference(x, w, dy, site["k"], site["need_dx"])
            name = str(dtype).split(".")[1]
            row = {"site": site["name"], "k": site["k"], "dtype": name, "x": site["x"]}
            pairs = [("dw", dw, dw_p)] + ([("dx", dx.float(), dx_p.float())] if site["need_dx"] else [])
            if dtype == torch.float32:
                dx64, dw64 = s2_bwd_reference(x.double(), w.double(), dy.double(), site["k"], site["need_dx"])
                truth = {"dw": dw64, "dx": dx64}
            for what, got, want in pairs:
                tol = dict(S2_TOL[name][what])
                tol["atol"] += S2_SUM_FLOOR * float(want.abs().max())
                torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{site['name']} {name} {what}: {m}")
                row.update({f"{what}_err": float((got - want).abs().max()), f"{what}_scale": float(want.abs().max()),
                            f"{what}_atol": tol["atol"]})
                if dtype == torch.float32:
                    row.update({f"{what}_err_f64": float((got.double() - truth[what]).abs().max()),
                                f"{what}_plain_err_f64": float((want.double() - truth[what]).abs().max())})
            if not site["need_dx"] and dx is not None:
                raise AssertionError(f"{site['name']}: dx computed where it is not needed")
            s2_cases.append(row)
            del x, w, dy, dx, dw, dx_p, dw_p
    bn = bn_sites(DetectionModel(FLAGSHIP, nc=TRAIN["nc"]), TRAIN["batch"], TRAIN["imgsz"])
    if len(bn) != 77:
        raise AssertionError(f"the flagship should have 77 train-mode BN sites, found {len(bn)}")
    bn_cases = []
    for i, site in enumerate(bn):
        for dtype in (torch.bfloat16, torch.float32):
            x = site_input(site["x"], dtype, seed=i)
            s_k, q_k = cuda_bnstats.bn_stats_cuda(x)
            torch.cuda.synchronize()
            errs = bn_stats_errors(x, s_k, q_k)
            if not (errs["sum_err_over_tol"] <= 1 and errs["sumsq_err_over_tol"] <= 1):
                raise AssertionError(f"BN statistics at {site['name']} {dtype}: kernel vs plain {errs}")
            bn_cases.append({"site": site["name"], "x": site["x"], "dtype": str(dtype).split(".")[1], **errs})
            del x, s_k, q_k
    largest = max(bn, key=lambda b: math.prod(b["x"]))
    x = site_input(largest["x"], torch.bfloat16, seed=1000)
    g = torch.Generator(device="cuda").manual_seed(1001)
    g_s, g_q = (torch.randn(largest["x"][1], generator=g, device="cuda") for _ in range(2))
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    torch.autograd.backward(bn_stats(xa), (g_s, g_q))
    torch.autograd.backward(bn_stats_reference(xb), (g_s, g_q))
    torch.testing.assert_close(xa.grad.float(), xb.grad.float(), rtol=2**-8, atol=1e-6)  # one bf16 step
    bn_grad = {"site": largest["name"], "x": largest["x"], "dtype": "bfloat16",
               "max_abs_err": float((xa.grad.float() - xb.grad.float()).abs().max()), "rtol": 2**-8}
    del x, xa, xb
    emit("kernel_vs_plain", t, nms_cases=cases, s2_tolerances=S2_TOL, s2_sum_floor=S2_SUM_FLOOR, s2_cases=s2_cases,
         bn_rtol=BN_RTOL, bn_atol=BN_ATOL, bn_sites=len(bn), bn_cases=bn_cases, bn_grad=bn_grad)

    # 4. slice: the port's predict path, end to end ---------------------------
    t = time.perf_counter()
    model = YOLO(FLAGSHIP)  # the card is the default device
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(8)]
    cuda_nms.reset_counts()
    timings = {}
    for batch, reps in ((1, 10), (8, 5)):
        source = frames[:batch]
        model.predict(source, verbose=False)  # warm-up (first call builds the fused bfloat16 copy)
        walls, speeds = [], []
        for _ in range(reps):
            t_call = time.perf_counter()
            res = model.predict(source, verbose=False)
            walls.append(time.perf_counter() - t_call)
            speeds.append(res[0].speed)
        timings[f"batch{batch}"] = {
            **{f"{k}_ms_per_img": float(np.mean([s[k] for s in speeds])) for k in ("preprocess", "inference", "postprocess")},
            "img_per_s": batch / float(np.median(walls)),
            "n_det": [len(r.boxes) for r in res],
        }
    res0 = model.predict(frames, conf=0.0, verbose=False)
    mixed = [frames[0], rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)]
    res_mixed = model.predict(mixed, conf=0.0, verbose=False)
    nms_calls, launches = cuda_nms.greedy_keep_cuda.calls, cuda_nms.greedy_keep_cuda.launches
    if [r.orig_shape for r in res_mixed] != [(720, 1280), (1080, 1920)] or not all(
            len(r.boxes) > 0 and np.isfinite(r.boxes.data).all() for r in res_mixed):
        raise AssertionError("mixed-shape predict gave wrong shapes, no or non-finite detections")
    for frame in mixed:
        on_card = letterbox_u8(torch.from_numpy(frame).to(dev)[None], model.predictor.imgsz).cpu()
        if not torch.equal(on_card, letterbox_u8(torch.from_numpy(frame)[None], model.predictor.imgsz)):
            raise AssertionError(f"uint8 letterbox of a {frame.shape} frame differs between the card and the CPU")
    if nms_calls == 0 or launches != 2 * nms_calls:
        raise AssertionError(f"the predict path called the greedy-NMS kernels {nms_calls} times with {launches} launches")
    if not all(len(r.boxes) > 0 and r.boxes.data.shape[1] == 6 and np.isfinite(r.boxes.data).all() for r in res0):
        raise AssertionError("conf=0.0 predict gave no or non-finite detections")

    pred = model.predictor
    args = pred.args
    x = pred.preprocess(frames)
    with torch.inference_mode():  # one set of predictions, NMS with the kernel and with the plain keep
        preds, _ = pred.model(x)
        dets, n_valid = non_max_suppression(preds, args.conf, args.iou, args.max_det, pre_topk=1024)
        cand_boxes, top_scores, cls_idx, valid, off_boxes, cand_extra = select_candidates(preds, args.conf, 1024)
        keep_plain = greedy_keep_reference(off_boxes, valid, args.iou)
        dets_plain, n_plain = compact(keep_plain, cand_boxes, top_scores, cls_idx, args.max_det, cand_extra)
    if not (torch.equal(dets, dets_plain) and torch.equal(n_valid, n_plain)):
        raise AssertionError("NMS step with the kernel differs from the step with the plain keep")
    if not bool(valid.all()) or valid.shape != (8, 1024):
        raise AssertionError(f"conf=0.0 should make all 1024 candidates valid, got {int(valid.sum())} of {tuple(valid.shape)}")

    f32 = copy.deepcopy(model.model)
    f32.load_state_dict(spread_weights(f32.state_dict(), np.random.default_rng(1)))
    with torch.inference_mode():
        f32 = f32.fuse().float()
        x1 = x[:1].float()
        preds_card = f32(x1)[0].cpu()
        preds_cpu = f32.cpu()(x1.cpu())[0]
    del f32
    box_err = float((preds_card[..., :4] - preds_cpu[..., :4]).abs().max())
    score_rel_err = float(((preds_card[..., 4:] - preds_cpu[..., 4:]).abs() / preds_cpu[..., 4:]).max())
    if not (box_err <= BOX_ATOL_PX and score_rel_err <= SCORE_RTOL):
        raise AssertionError(f"float32 predictions card vs CPU: box err {box_err} px, score relative err {score_rel_err}")
    emit("slice", t, model=FLAGSHIP, dtype="bfloat16", frame_hw=list(FRAME_HW), imgsz=pred.imgsz,
         nms_calls=nms_calls, nms_launches=launches, timings=timings, conf0_n_valid=n_valid.tolist(), step_equals_plain_keep=True,
         mixed_shapes={"frames": [list(f.shape[:2]) for f in mixed], "n_det": [len(r.boxes) for r in res_mixed],
                       "letterbox_u8_card_equals_cpu": True},
         fp32_card_vs_cpu={"box_err_px": box_err, "score_rel_err": score_rel_err, "box_atol_px": BOX_ATOL_PX,
                           "score_rtol": SCORE_RTOL, "score_range": [float(preds_cpu[..., 4:].min()), float(preds_cpu[..., 4:].max())]},
         anchors=int(preds.shape[1]))

    # 5. train: the port's train step, with the kernels and with stock autograd --------
    t = time.perf_counter()
    batch = synthetic_batch(np.random.default_rng(0), TRAIN["batch"], TRAIN["imgsz"], TRAIN["nc"])
    modes = {"kernel": ("cuda", None), "stock": (None, None), "both": ("cuda", "cuda")}  # (s2grad, bnstats)
    runs, s2_calls, s2_launches, s2_impls, bn_counts, trainers = {}, {}, {}, {}, {}, {}
    for run, (s2grad, bnstats) in modes.items():
        trainer = BaseTrainer(overrides=dict(model=FLAGSHIP, batch=TRAIN["batch"], imgsz=TRAIN["imgsz"], nbs=TRAIN["batch"],
                                             optimizer="SGD", amp=True, s2grad=s2grad, bnstats=bnstats),
                              train_loader=[batch] * TRAIN["steps"], data={"nc": TRAIN["nc"]})
        torch.cuda.reset_peak_memory_stats()
        cuda_s2bwd.reset_counts()
        cuda_bnstats.reset_counts()
        steps = trainer.run_steps()
        s2_calls[run], s2_launches[run] = dict(cuda_s2bwd.s2_bwd_cuda.calls), dict(cuda_s2bwd.s2_bwd_cuda.launches)
        s2_impls[run] = {impl: dict(c) for impl, c in cuda_s2bwd.s2_bwd_cuda.impl_calls.items()}
        bn_counts[run] = {"calls": cuda_bnstats.bn_stats_cuda.calls, "launches": cuda_bnstats.bn_stats_cuda.launches,
                          "contiguous_copies": cuda_bnstats.bn_stats_cuda.copies}
        ms = [r["ms"] for r in steps[1:]]  # the first step builds cuDNN's plans
        runs[run] = {"s2grad": s2grad, "bnstats": bnstats, "loss": [r["loss"] for r in steps], "items": [r["items"] for r in steps],
                     "step_ms_median": float(np.median(ms)), "img_per_s": TRAIN["batch"] / float(np.median(ms)) * 1e3,
                     "first_step_ms": steps[0]["ms"], "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "s2_calls": s2_calls[run], "s2_launches": s2_launches[run], "s2_impl_calls": s2_impls[run],
                     "s2_contiguous_copies": cuda_s2bwd.s2_bwd_cuda.copies,
                     "bn_stats": bn_counts[run]}
        trainers[run] = trainer
    per_step = {cuda_s2bwd.NAMES[k]: n_sites[k] for k in KINDS}
    want_launches = {cuda_s2bwd.NAMES[k]: TRAIN["steps"] * sum(3 if s["need_dx"] else 2 for s in sites if s["k"] == k) for k in KINDS}
    for run in ("kernel", "both"):
        if s2_calls[run] != {n: TRAIN["steps"] * c for n, c in per_step.items()} or s2_launches[run] != want_launches:
            raise AssertionError(f"{run} run: stride-2 backward calls {s2_calls[run]} and launches {s2_launches[run]}, "
                                 f"expected {per_step} calls per step and {want_launches} launches")
        tensor_cores = cuda_s2bwd.IMPLS[torch.bfloat16]
        if s2_impls[run][tensor_cores] != s2_calls[run]:
            raise AssertionError(f"{run} run: every bf16 stride-2 call should run on {tensor_cores}, got {s2_impls[run]}")
    if any(s2_calls["stock"].values()):
        raise AssertionError(f"the stock run called the stride-2 backward kernel: {s2_calls['stock']}")
    want_bn = {"calls": TRAIN["steps"] * len(bn), "launches": TRAIN["steps"] * len(bn)}
    if {k: bn_counts["both"][k] for k in want_bn} != want_bn:
        raise AssertionError(f"both run: BN-statistics kernel {bn_counts['both']}, expected {want_bn}")
    if bn_counts["kernel"]["calls"] or bn_counts["stock"]["calls"]:
        raise AssertionError(f"runs without bnstats called the BN-statistics kernel: {bn_counts}")
    loss_s = np.array(runs["stock"]["loss"])
    loss_rel = {}
    for run in ("kernel", "both"):
        loss_k = np.array(runs[run]["loss"])
        if not (np.isfinite(loss_k).all() and np.isfinite(loss_s).all()):
            raise AssertionError(f"non-finite train losses: {run} {loss_k}, stock {loss_s}")
        loss_rel[run] = np.abs(loss_k - loss_s) / np.abs(loss_s)
        if not (loss_rel[run] <= TRAIN_LOSS_RTOL).all():
            raise AssertionError(f"train losses of the {run} run {loss_k} differ from stock {loss_s} by {loss_rel[run]}")
    in_turns = {run: [] for run in modes}  # the three paths again, in turns on one card: median ms of 5 steps each
    for run in (*modes, *reversed(modes)):
        in_turns[run].append(float(np.median([r["ms"] for r in trainers[run].run_steps(5)])))
    emit("train", t, model=FLAGSHIP, **{k: v for k, v in TRAIN.items()}, dtype="bfloat16 autocast", optimizer="SGD",
         kernel=runs["kernel"], stock=runs["stock"], both=runs["both"],
         loss_rel_diff={k: v.tolist() for k, v in loss_rel.items()}, loss_rtol=TRAIN_LOSS_RTOL,
         s2_calls_per_step=per_step, bn_stats_calls_per_step=len(bn), in_turns_step_ms=in_turns)
    kernel_trainer, both_trainer = trainers["kernel"], trainers["both"]
    del trainers

    # 6. validate: the EMA weights of the run with both kernels, multi-label NMS at K = 4096 --------
    t = time.perf_counter()
    both_trainer.val_loader = [synthetic_batch(np.random.default_rng(100 + i), VAL["batch"], VAL["imgsz"], VAL["nc"], val=True)
                               for i in range(VAL["batches"])]
    validation = {}
    for conf in (0.001, 0.0):
        if both_trainer.validator is not None:
            both_trainer.validator.args.conf = conf
        cuda_nms.reset_counts()
        t_call = time.perf_counter()
        metrics = both_trainer.validate()
        wall = time.perf_counter() - t_call
        val_calls, val_launches = cuda_nms.greedy_keep_cuda.calls, cuda_nms.greedy_keep_cuda.launches
        validator = both_trainer.validator
        if validator.args.conf != conf or validator.args.pre_nms_topk != VAL["pre_nms_topk"]:
            raise AssertionError(f"validator ran at conf {validator.args.conf}, pre_nms_topk {validator.args.pre_nms_topk}")
        if val_calls != VAL["batches"] or val_launches != 2 * val_calls:
            raise AssertionError(f"validation called the greedy-NMS kernels {val_calls} times ({val_launches} launches) "
                                 f"for {VAL['batches']} batches")
        values = [metrics[k] for k in validator.metrics.keys]
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in values):
            raise AssertionError(f"validation metrics out of [0, 1]: {metrics}")
        with torch.inference_mode():  # one batch's predictions: the NMS step with the kernel and with the plain keep
            x = validator.preprocess(both_trainer.val_loader[0])
            val_preds = validator.forward(x)
            dets, n_valid = validator.postprocess(val_preds)
            cand_boxes, top_scores, cls_idx, val_valid, val_off, cand_extra = select_candidates(
                val_preds, conf, VAL["pre_nms_topk"], multi_label=True)
            val_keep_plain = greedy_keep_reference(val_off, val_valid, validator.args.iou)
            dets_plain, n_plain = compact(val_keep_plain, cand_boxes, top_scores, cls_idx, validator.args.max_det,
                                          cand_extra)
        if val_valid.shape != (VAL["batch"], VAL["pre_nms_topk"]):
            raise AssertionError(f"validation NMS ran on {tuple(val_valid.shape)} candidates, expected K = {VAL['pre_nms_topk']}")
        if not (torch.equal(dets, dets_plain) and torch.equal(n_valid, n_plain)):
            raise AssertionError(f"conf {conf}: validation NMS step with the kernel differs from the step with the plain keep")
        if conf == 0.0 and not bool(val_valid.all()):
            raise AssertionError(f"conf=0.0 should make all {VAL['pre_nms_topk']} candidates valid, got {int(val_valid.sum())}")
        validation[str(conf)] = {"metrics": metrics, "nms_calls": val_calls, "nms_launches": val_launches, "K": int(val_valid.shape[1]),
                                 "valid_candidates": int(val_valid.sum()), "n_det": n_valid.tolist(),
                                 "step_equals_plain_keep": True, "speed_ms_per_img": validator.speed,
                                 "img_per_s": validator.seen / wall, "images": validator.seen}
    emit("validate", t, model=FLAGSHIP, dtype=validator.args.dtype, weights="EMA of the s2grad+bnstats run",
         iou=validator.args.iou, max_det=validator.args.max_det, runs=validation)

    # 7. the kernels at the main path's shapes ------------------------------------
    t = time.perf_counter()

    def nms_timing(boxes, valid, thr, keep_plain) -> dict:
        """The greedy-NMS kernel at one shape of the main path: its time, its plain version's, and its bound."""
        keep = greedy_keep(boxes, valid, thr)
        if not torch.equal(keep, keep_plain):
            raise AssertionError(f"kernel and plain keep masks differ at B, K = {tuple(valid.shape)}")
        b, k = valid.shape
        n_bytes = b * k * (16 + 1 + 1)  # boxes and valid read once, keep written once
        n_ops = IOU_OPS * ious_needed(boxes, valid, keep, thr)
        bytes_ms, ops_ms = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_FP32_PER_S * 1e3
        by_kernel = profile_device(lambda: greedy_keep(boxes, valid, thr), steps=20)["top"]
        return {"B": b, "K": k, "thr": thr, "kept": int(keep.sum()), "valid": int(valid.sum()),
                "max_abs_err": float((keep.int() - keep_plain.int()).abs().max()),
                "workspace_bytes": cuda_nms.workspace_bytes(b, k),
                "device_ms_by_kernel": {r["name"]: r["device_ms"] for r in by_kernel},
                **kernel_times(lambda: greedy_keep(boxes, valid, thr), reps=20),
                **kernel_times(lambda: greedy_keep_reference(boxes, valid, thr), reps=3, prefix="plain_"),
                "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}

    nms_predict = nms_timing(off_boxes, valid, args.iou, keep_plain)  # predict: B=8, K=1024, conf 0
    nms_val = nms_timing(val_off, val_valid, validator.args.iou, val_keep_plain)  # validate: B=8, K=4096, conf 0
    del val_off, val_valid, val_keep_plain
    val_calls = sum(v["nms_calls"] for v in validation.values())
    val_launches = sum(v["nms_launches"] for v in validation.values())
    kernels = [{
        "name": "greedy_nms", "route": "cuda", "impl": "cuda", "source": "drone_yolo_tpu_torch/csrc/greedy_nms.cu",
        "replaces": "drone_yolo_tpu/ops/pallas_nms.py:89", "launches": launches + val_launches, "calls": nms_calls + val_calls,
        "launches_by_path": {"predict": launches, "validate": val_launches}, "match": True,
        **{k: nms_predict[k] for k in ("max_abs_err", "ms", "event_ms", "plain_ms", "plain_event_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": nms_predict, "shape_k4096": nms_val,
    }]
    replaces = {3: "drone_yolo_tpu/ops/pallas_s2bwd.py:203", 1: "drone_yolo_tpu/ops/pallas_s2bwd.py:220"}
    for kind in KINDS:
        name = cuda_s2bwd.NAMES[kind]
        p = KINDS[kind]
        kind_sites = [s for s in sites if s["k"] == kind]
        inputs = [s2_site_inputs(site, torch.bfloat16, seed=100 + i) for i, site in enumerate(kind_sites)]
        calls = {  # one train step's calls at these sites: the kernel, its plain version, cuDNN's backward
            "": lambda: [cuda_s2bwd.s2_bwd_cuda(x, w, dy, kind, site["need_dx"]) for site, (x, w, dy) in zip(kind_sites, inputs)],
            "plain_": lambda: [s2_bwd_reference(x, w, dy, kind, site["need_dx"]) for site, (x, w, dy) in zip(kind_sites, inputs)],
            "library_": lambda: [torch.ops.aten.convolution_backward(dy, x, w, None, [2, 2], [p, p], [1, 1], False, [0, 0], 1,
                                                                     [site["need_dx"], True, False])
                                 for site, (x, w, dy) in zip(kind_sites, inputs)]}
        times = {}
        for prefix, fn in calls.items():
            times.update(kernel_times(fn, reps=2 if prefix == "plain_" else 5, prefix=prefix))
        per_site = []
        for site, (x, w, dy) in zip(kind_sites, inputs):  # each site alone: the kernel against cuDNN there
            n_bytes, n_ops = s2_cost(site)
            b, ci, h, wd = site["x"]
            row = {"site": site["name"], "x": site["x"], "w": site["w"], "need_dx": site["need_dx"],
                   "plan": cuda_s2bwd.device_plan(x.device, b, ci, h, wd, site["w"][0], kind, torch.bfloat16)._asdict(),
                   "bytes_ms": n_bytes / PEAK_BYTES_PER_S * 1e3, "ops_ms": n_ops / PEAK_BF16_PER_S * 1e3}
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row.update(kernel_times(lambda x=x, w=w, dy=dy, nd=site["need_dx"]: cuda_s2bwd.s2_bwd_cuda(x, w, dy, kind, nd),
                                    reps=10))
            row.update(kernel_times(lambda x=x, w=w, dy=dy, nd=site["need_dx"]: torch.ops.aten.convolution_backward(
                dy, x, w, None, [2, 2], [p, p], [1, 1], False, [0, 0], 1, [nd, True, False]), reps=10, prefix="library_"))
            row.update(tflop_per_s=n_ops / row["ms"] / 1e9, gb_per_s=n_bytes / row["ms"] / 1e6,
                       bound_share=row["bound_ms"] / row["ms"], library_bound_share=row["bound_ms"] / row["library_ms"],
                       vs_library=row["ms"] / row["library_ms"])
            per_site.append(row)
        del inputs, x, w, dy
        bf16 = [c for c in s2_cases if c["k"] == kind and c["dtype"] == "bfloat16"]
        kernels.append({
            "name": name, "route": "cuda", "impl": cuda_s2bwd.IMPLS[torch.bfloat16], "source": "drone_yolo_tpu_torch/csrc/s2_bwd.cu",
            "replaces": replaces[kind], "launches": s2_launches["kernel"][name], "calls": s2_calls["kernel"][name],
            "launches_per_step": s2_launches["kernel"][name] // TRAIN["steps"], "calls_per_step": per_step[name],
            "max_abs_err": max(max(c["dw_err"], c.get("dx_err", 0.0)) for c in bf16), "match": True, **times,
            "bound_ms": sum(r["bound_ms"] for r in per_site),
            "bound_by": "bytes" if sum(r["bytes_ms"] for r in per_site) >= sum(r["ops_ms"] for r in per_site) else "operations",
            "per": "train step: one bf16 call at each of the flagship's sites (batch 8, 640 px); ms is device time "
                   "(torch.profiler), event_ms CUDA events around back-to-back calls; library: cuDNN convolution_backward; "
                   "sites: each site alone, kernel and cuDNN",
            "sites": per_site,
        })
    xs = [site_input(site["x"], torch.bfloat16, seed=200 + i) for i, site in enumerate(bn)]
    times = {}  # one train step's 77 calls: the kernel, its plain version (the stock path's cast and two reductions),
    for prefix, fn in {"": lambda: [cuda_bnstats.bn_stats_cuda(x) for x in xs],  # and torch.batch_norm_stats
                       "plain_": lambda: [bn_stats_reference(x) for x in xs],
                       "library_": lambda: [torch.batch_norm_stats(x, 1e-3) for x in xs]}.items():
        times.update(kernel_times(fn, reps=5, prefix=prefix))
    per_site = [{"site": site["name"], "x": site["x"], "plan": cuda_bnstats.split_channel(x.shape[0] * x.shape[2] * x.shape[3]),
                 "bytes_ms": (2 * x.numel() + 2 * 4 * x.shape[1]) / PEAK_BYTES_PER_S * 1e3,  # bf16 x read, (2, C) f32 written
                 "ops_ms": BN_OPS * x.numel() / PEAK_FP32_PER_S * 1e3} for site, x in zip(bn, xs)]
    by_shape = {}  # each distinct shape alone (device time by torch.profiler): the kernel and torch.batch_norm_stats
    for site, x in zip(bn, xs):
        if site["x"] not in by_shape:
            by_shape[site["x"]] = {"ms": device_ms(lambda x=x: cuda_bnstats.bn_stats_cuda(x), reps=20),
                                   "library_ms": device_ms(lambda x=x: torch.batch_norm_stats(x, 1e-3), reps=20)}
    del xs
    for row in per_site:
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        row.update(by_shape[row["x"]])
        row.update(bound_share=row["bound_ms"] / row["ms"], library_bound_share=row["bound_ms"] / row["library_ms"],
                   vs_library=row["ms"] / row["library_ms"])
    kernels.append({
        "name": "bn_stats", "route": "cuda", "impl": "cuda", "source": "drone_yolo_tpu_torch/csrc/bn_stats.cu",
        "replaces": "tools/bn_stat_probe.py:70", "launches": bn_counts["both"]["launches"], "calls": bn_counts["both"]["calls"],
        "launches_per_step": bn_counts["both"]["launches"] // TRAIN["steps"], "calls_per_step": len(bn),
        "max_abs_err": max(max(c["sum_err"], c["sumsq_err"]) for c in bn_cases if c["dtype"] == "bfloat16"),
        "max_err_over_tol": max(max(c["sum_err_over_tol"], c["sumsq_err_over_tol"]) for c in bn_cases), "match": True,
        **times, "bound_ms": sum(r["bound_ms"] for r in per_site),
        "bound_by": "bytes" if sum(r["bytes_ms"] for r in per_site) >= sum(r["ops_ms"] for r in per_site) else "operations",
        "per": "train step: one bf16 call at each of the flagship's 77 BN inputs (batch 8, 640 px); ms is device time "
               "(torch.profiler), event_ms CUDA events around back-to-back calls; plain: the stock path's cast and two "
               "reductions; library: torch.batch_norm_stats; sites: each distinct shape alone, kernel and library",
        "sites_ms_sum": sum(r["ms"] for r in per_site), "sites": per_site,
    })
    emit("kernels", t, kernels=kernels)

    # 8. profile ---------------------------------------------------------------
    t = time.perf_counter()
    train_hyp = kernel_trainer._warmup_hyp(kernel_trainer.ni, 0)
    both_hyp = both_trainer._warmup_hyp(both_trainer.ni, 0)
    emit("profile", t, predict={"batch": len(frames), **profile_device(lambda: model.predict(frames, verbose=False), steps=5)},
         train={"batch": TRAIN["batch"], "s2grad": "cuda",
                **profile_device(lambda: kernel_trainer.train_step(batch, *train_hyp)[0].item(), steps=3)},
         train_both={"batch": TRAIN["batch"], "s2grad": "cuda", "bnstats": "cuda",
                     **profile_device(lambda: both_trainer.train_step(batch, *both_hyp)[0].item(), steps=3)})

    # 9. loop: the epoch loop over a dataset on disk -------------------------------
    t = time.perf_counter()
    loop = run_loop(len(bn), n_sites)
    for kern in kernels:
        n = loop["counts"]["launches"][kern["name"]]
        kern["launches"] += n
        kern.setdefault("launches_by_path", {"train": kern["launches"] - n})["loop"] = n
    emit("loop", t, **{k: v for k, v in loop.items() if k != "counts"}, counts=loop["counts"])

    # 10. track: the drone-video pipeline, detect + ByteTrack + pose + geo ------------------
    t = time.perf_counter()
    track = run_track()
    nms_row = kernels[0]
    nms_row["launches"] += track["nms_launches"]
    nms_row["calls"] += track["nms_calls"]
    nms_row["launches_by_path"]["track"] = track["nms_launches"]
    emit("track", t, **track)

    # 11. imports ---------------------------------------------------------------
    t = time.perf_counter()
    import drone_yolo_tpu_torch.apps  # noqa: F401  (the modules of every path, imported by now)
    import drone_yolo_tpu_torch.models.yolo  # noqa: F401
    import drone_yolo_tpu_torch.trackers  # noqa: F401

    absent = ["jax", "jaxlib", "drone_yolo_tpu", "cv2", "PIL", "yaml", "sklearn"]
    loaded = sorted(m for m in absent if m in sys.modules)
    if loaded:
        raise AssertionError(f"the port imported {loaded}")
    emit("imports", t, absent=absent, port_modules=sorted(m for m in sys.modules if m.startswith("drone_yolo_tpu_torch")),
         total_s=round(time.perf_counter() - T0, 3))

    print(smi, flush=True)
    print(json.dumps({"kernels": [{k: v for k, v in kern.items() if k != "sites"} for kern in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["accuracy"]:
        accuracy([int(s) for s in sys.argv[2:]] or [0, 1])
    else:
        main()

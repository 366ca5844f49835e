"""Smoke run of the PyTorch/CUDA port on one CUDA card: builds the kernels, checks them, serves the flagship.

    python3 chip_smoke.py

Phases, one JSON line each (with the seconds it took), flushed as they end:

1. preflight: torch, CUDA, nvcc and the card (name and power limit from nvidia-smi);
2. build: compiles the greedy-NMS kernel (`drone_yolo_tpu_torch/csrc/greedy_nms.cu`) with nvcc;
3. kernel_vs_plain: the kernel's keep mask against `greedy_keep_reference` on the card,
   B=8, K in {128, 640, 1024}, IoU thresholds {0.45, 0.7}: masks must be equal, and every
   case must both keep and suppress;
4. slice: `YOLO("yolov8s-p2-repvgg-sf.yaml")` at full width and depth, seed 0, on the card,
   fused, bfloat16, predicts on batches of 1 and 8 synthetic 720x1280 BGR frames, then once
   more with conf=0.0 so that all 1024 candidates per image are valid. Launch counts are
   set to 0 before these calls and read after them. Checks: the NMS step with the kernel
   equals the same step with the plain keep on the card; the float32 decoded predictions
   (TF32 off, weights redrawn so activations stay O(1)) match the port on the CPU, boxes
   in pixels and scores relative to their size; per-image times and img/s at batch 1 and 8;
5. kernels: the NMS kernel's time per launch at the slice's shapes against the plain
   version's and against its bound;
6. profile: the device busy share of batch-8 predicts and the device time by kernel
   (torch.profiler);
7. imports: neither JAX, nor the JAX package, nor cv2, PIL or yaml was imported.

Then the nvidia-smi line, the `kernels` JSON line, and last `{"ok": true, "device": ...}`.
Any failure ends the script with a traceback and a non-zero exit code. Without a CUDA
card it exits with code 1 before any phase.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

FLAGSHIP = "yolov8s-p2-repvgg-sf.yaml"
FRAME_HW = (720, 1280)
# H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
IOU_OPS = 14  # per IoU and compare: 4 min/max, 2 sub, 2 clamp, mul, add, sub, add, div, compare
# float32 decoded predictions, card (TF32 off) vs CPU, with weights spread to O(1) activations:
# the two sum in different orders, ~1e-5 relative at the head; a box coordinate is stride
# (<= 32) x a DFL expectation over 16 bins. The class priors keep scores near sigmoid(-13), where
# a score's relative error is its logit's absolute error, so scores are held to a relative one.
BOX_ATOL_PX = 1e-2
SCORE_RTOL = 1e-4

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


def ious_needed(off_boxes, valid, keep, thr) -> int:
    """IoUs a sequential greedy sweep computes on this data: for each kept row i, the j > i still alive."""
    from drone_yolo_tpu_torch.ops.nms import iou_matrix

    adj = torch.triu(iou_matrix(off_boxes) > thr, 1)
    kept_rows = (keep[:, :, None] & adj).int()
    suppressed_before = kept_rows.cumsum(1) - kept_rows  # kept suppressors of j among rows < i
    upper = torch.ones_like(adj[0]).triu(1)
    alive = valid[:, None, :] & (suppressed_before == 0) & upper
    return int((alive & keep[:, :, None]).sum())


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


def profile_step(model, frames, steps: int = 5, top: int = 15) -> dict:
    """torch.profiler over `steps` batch predicts: device busy share and the kernels that take the time."""
    from torch.profiler import ProfilerActivity, profile

    model.predict(frames, verbose=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_wall = time.perf_counter()
        for _ in range(steps):
            model.predict(frames, verbose=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_wall) * 1e3
    rows = []
    for evt in prof.key_averages():  # device-side events only: kernels and copies, not the ops that launch them
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        dev_us = evt.self_cuda_time_total if dev_us is None else dev_us
        rows.append({"name": evt.key[:90], "calls": evt.count, "device_ms": dev_us / 1e3 / steps})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    return {"batch": len(frames), "steps": steps, "wall_ms_per_step": wall_ms / steps, "device_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms * steps / wall_ms, "top": rows[:top]}


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(1)
    from drone_yolo_tpu_torch import YOLO
    from drone_yolo_tpu_torch.ops import cuda_nms
    from drone_yolo_tpu_torch.ops.nms import (
        compact, greedy_keep, greedy_keep_reference, non_max_suppression, select_candidates)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. preflight -----------------------------------------------------------
    t = time.perf_counter()
    smi = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader").splitlines()[0]
    nvcc_version = sh(cuda_nms.find_nvcc(), "--version").splitlines()[-1]
    emit("preflight", t, python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc_version, device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), nvidia_smi=smi)

    # 2. build ---------------------------------------------------------------
    t = time.perf_counter()
    lib = cuda_nms.build()
    cuda_nms.load()
    emit("build", t, library=lib.name, ptxas=cuda_nms.report_path(lib).read_text().strip().splitlines())

    # 3. kernel vs plain -----------------------------------------------------
    t = time.perf_counter()
    rng = np.random.default_rng(0)
    cases = []
    for k in (128, 640, 1024):
        for thr in (0.45, 0.7):
            boxes = clustered_boxes(rng, 8, k).to(dev)
            valid = torch.from_numpy(rng.random((8, k)) > 0.1).to(dev)
            got = greedy_keep(boxes, valid, thr)
            torch.cuda.synchronize()
            want = greedy_keep_reference(boxes, valid, thr)
            kept, suppressed = int(got.sum()), int((valid & ~got).sum())
            if not torch.equal(got, want):
                raise AssertionError(f"K={k} thr={thr}: kernel and plain keep masks differ in {int((got != want).sum())} places")
            if kept == 0 or suppressed == 0:
                raise AssertionError(f"K={k} thr={thr}: case must keep and suppress (kept {kept}, suppressed {suppressed})")
            cases.append({"B": 8, "K": k, "thr": thr, "kept": kept, "suppressed": suppressed, "equal": True})
    emit("kernel_vs_plain", t, cases=cases)

    # 4. slice: the port's predict path, end to end ---------------------------
    t = time.perf_counter()
    model = YOLO(FLAGSHIP)  # the card is the default device
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(8)]
    cuda_nms.greedy_keep_cuda.launches = 0
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
    launches = cuda_nms.greedy_keep_cuda.launches
    if launches == 0:
        raise AssertionError("the predict path never launched the greedy-NMS kernel")
    if not all(len(r.boxes) > 0 and r.boxes.data.shape[1] == 6 and np.isfinite(r.boxes.data).all() for r in res0):
        raise AssertionError("conf=0.0 predict gave no or non-finite detections")

    pred = model.predictor
    args = pred.args
    x = pred.preprocess(frames)
    with torch.inference_mode():  # one set of predictions, NMS with the kernel and with the plain keep
        preds, _ = pred.model(x)
        dets, n_valid = non_max_suppression(preds, args.conf, args.iou, args.max_det, pre_topk=1024)
        cand_boxes, top_scores, cls_idx, valid, off_boxes = select_candidates(preds, args.conf, 1024)
        keep_plain = greedy_keep_reference(off_boxes, valid, args.iou)
        dets_plain, n_plain = compact(keep_plain, cand_boxes, top_scores, cls_idx, args.max_det)
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
    box_err = float((preds_card[..., :4] - preds_cpu[..., :4]).abs().max())
    score_rel_err = float(((preds_card[..., 4:] - preds_cpu[..., 4:]).abs() / preds_cpu[..., 4:]).max())
    if not (box_err <= BOX_ATOL_PX and score_rel_err <= SCORE_RTOL):
        raise AssertionError(f"float32 predictions card vs CPU: box err {box_err} px, score relative err {score_rel_err}")
    emit("slice", t, model=FLAGSHIP, dtype="bfloat16", frame_hw=list(FRAME_HW), imgsz=pred.imgsz,
         nms_launches=launches, timings=timings, conf0_n_valid=n_valid.tolist(), step_equals_plain_keep=True,
         fp32_card_vs_cpu={"box_err_px": box_err, "score_rel_err": score_rel_err, "box_atol_px": BOX_ATOL_PX,
                           "score_rtol": SCORE_RTOL, "score_range": [float(preds_cpu[..., 4:].min()), float(preds_cpu[..., 4:].max())]},
         anchors=int(preds.shape[1]))

    # 5. the kernel at the slice's shapes --------------------------------------
    t = time.perf_counter()
    thr = args.iou
    keep = greedy_keep(off_boxes, valid, thr)
    kernel_ms = cuda_ms(lambda: greedy_keep(off_boxes, valid, thr), reps=200)
    plain_ms = cuda_ms(lambda: greedy_keep_reference(off_boxes, valid, thr), reps=10, warmup=1)
    b, k = valid.shape
    n_bytes = b * k * (16 + 1 + 1)  # boxes and valid read once, keep written once
    n_ops = IOU_OPS * ious_needed(off_boxes, valid, keep, thr)
    bytes_ms, ops_ms = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_FP32_PER_S * 1e3
    kernels = [{
        "name": "greedy_nms", "route": "cuda", "impl": "cuda", "source": "drone_yolo_tpu_torch/csrc/greedy_nms.cu",
        "replaces": "drone_yolo_tpu/ops/pallas_nms.py:89", "launches": launches,
        "max_abs_err": float((keep.int() - keep_plain.int()).abs().max()), "match": bool(torch.equal(keep, keep_plain)),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": None,
        "shape": {"B": b, "K": k, "thr": thr, "kept": int(keep.sum())},
    }]
    if not kernels[0]["match"]:
        raise AssertionError("kernel and plain keep masks differ at the slice's shapes")
    emit("kernels", t, kernels=kernels)

    # 6. profile ---------------------------------------------------------------
    t = time.perf_counter()
    emit("profile", t, **profile_step(model, frames))

    # 7. imports ---------------------------------------------------------------
    t = time.perf_counter()
    loaded = sorted(m for m in ("jax", "jaxlib", "drone_yolo_tpu", "cv2", "PIL", "yaml") if m in sys.modules)
    if loaded:
        raise AssertionError(f"the port imported {loaded}")
    emit("imports", t, absent=["jax", "jaxlib", "drone_yolo_tpu", "cv2", "PIL", "yaml"], total_s=round(time.perf_counter() - T0, 3))

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

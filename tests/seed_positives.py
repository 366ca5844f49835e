"""Positive anchors at step 0 for ten init seeds of each package: does the flagship's init decide whether TAL finds
any positive anchor for the dense proxy's 4-12 px objects?

    JAX_PLATFORMS=cpu python tests/seed_positives.py [--seeds 0-9] [--work DIR]

The accuracy run's data (`chip_smoke.py accuracy`: the dense small-object proxy, 192 train images of 320 px, seed 1,
6 classes, objects of 4-12 px, written as JPEG at quality 95 by the port's encoder) gives one batch: the first of the
ablation's train loader (seed 0, the ablation's hyperparameters: flips only, batch 8). For each seed, each package
builds the flagship `yolov8s-p2-repvgg-sf.yaml` (nc 6) from its own init (the port's `DetectionModel.init(seed)`, the
JAX package's `model.init(PRNGKey(seed))`; both U(+-1/sqrt(fan_in)) with the head's bias priors for 320 px), runs one
float32 train-mode forward of that batch on the CPU and the task-aligned assigner of its own loss. Printed per
package and seed: the positive anchors per image and in all, the GT boxes, and the largest alignment metric
score^0.5 x CIoU^6 over all (anchor, GT) pairs whose anchor lies inside the GT (the assigner keeps a pair only above
1e-9). One JSON line per (package, seed), then a summary line.

Imports both packages, like the tests; the port itself imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

FLAGSHIP = "yolov8s-p2-repvgg-sf.yaml"
NC, IMGSZ, BATCH = 6, 320, 8


def first_batch(work: Path) -> dict:
    """The ablation loader's first batch over the accuracy run's dataset, written to `work` if it is not there."""
    from chip_smoke import ABLATION, write_dense_dataset
    from drone_yolo_tpu_torch.cfg import get_train_cfg
    from drone_yolo_tpu_torch.data.build import build_dataloader, build_yolo_dataset
    from drone_yolo_tpu_torch.data.utils import check_det_dataset

    data = work / "dense" / "data.yaml"
    if not data.exists():
        data, _ = write_dense_dataset(work / "dense", 192, 96, IMGSZ, seed=1, nc=NC, obj_px=(4, 12))
    info = check_det_dataset(data)
    cfg = get_train_cfg(overrides={k: v for k, v in ABLATION.items() if k not in ("amp",)})
    ds = build_yolo_dataset(cfg, info["train"], BATCH, info, mode="train")
    loader = build_dataloader(ds, BATCH, workers=1, shuffle=True, seed=cfg.seed)
    loader.set_epoch(0)
    return next(iter(loader))


def alignment(scores, pd_boxes, anchors, gt_cls, gt_boxes, mask):
    """The largest score^0.5 x CIoU^6 over (anchor inside GT) pairs, by the port's assigner helpers (numpy in)."""
    import torch

    from drone_yolo_tpu_torch.utils.tal import _ciou_gt_pd, select_candidates_in_gts

    scores, pd_boxes, anchors = (torch.as_tensor(np.asarray(a, np.float32)) for a in (scores, pd_boxes, anchors))
    gt_boxes, mask = torch.as_tensor(gt_boxes), torch.as_tensor(mask) > 0
    inside = select_candidates_in_gts(anchors, gt_boxes) & mask[..., None]
    b, a, _ = scores.shape
    gl = torch.as_tensor(gt_cls).long()
    s = scores.transpose(1, 2).gather(1, gl[..., None].expand(b, gl.shape[1], a))  # each GT's class score, (B, M, A)
    ciou = _ciou_gt_pd(gt_boxes, pd_boxes).clamp(min=0)
    metric = s.sqrt() * ciou**6 * inside
    return float(metric.max())


def port_counts(batch: dict, seed: int) -> dict:
    import torch

    from drone_yolo_tpu_torch.nn.modules import collect_bn_stats
    from drone_yolo_tpu_torch.nn.model import DetectionModel
    from drone_yolo_tpu_torch.ops.anchors import dist2bbox, make_anchors
    from drone_yolo_tpu_torch.nn.modules import dfl_expectation
    from drone_yolo_tpu_torch.utils.loss import v8DetectionLoss

    model = DetectionModel(FLAGSHIP, nc=NC)
    model.init(seed, imgsz=IMGSZ)
    model.train()
    img = torch.from_numpy(batch["img"]).float().permute(0, 3, 1, 2) / 255.0
    with torch.no_grad(), collect_bn_stats():
        maps = model(img)
    crit = v8DetectionLoss(model)
    anchors, strides = make_anchors([m.shape[2:] for m in maps], crit.strides)
    flat = torch.cat([m.flatten(2) for m in maps], 2).transpose(1, 2)
    scores = flat[..., 4 * crit.reg_max:].sigmoid()
    pd = dist2bbox(dfl_expectation(flat[..., : 4 * crit.reg_max]), anchors, xywh=False) * strides
    mask = torch.from_numpy(batch["mask"])
    gt = torch.from_numpy(batch["bboxes"]) * mask[..., None]
    fg = crit.assigner(scores, pd, anchors * strides, torch.from_numpy(batch["cls"]).long(), gt, mask)[3]
    return {"positives_per_image": fg.sum(1).int().tolist(),
            "max_alignment": alignment(scores, pd, anchors * strides, batch["cls"], gt.numpy(), batch["mask"])}


def jax_counts(batch: dict, seed: int, cache: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from drone_yolo_tpu.nn import modules as JM
    from drone_yolo_tpu.nn.model import DetectionModel as JaxDetectionModel
    from drone_yolo_tpu.ops.anchors import dist2bbox, make_anchors
    from drone_yolo_tpu.utils.loss import v8DetectionLoss as JaxLoss

    if "model" not in cache:
        cache["model"] = model = JaxDetectionModel(FLAGSHIP, nc=NC)
        crit = JaxLoss(model)

        def run(v, img, targets):
            maps = model.apply(v, img, ctx=JM.Ctx(train=True, dtype=jnp.float32))
            parts = crit._detect_parts(maps, targets)
            b = img.shape[0]
            shapes = [(f.shape[1], f.shape[2]) for f in maps]
            anchors, strides = make_anchors(shapes, crit.strides, 0.5)
            flat = jnp.concatenate([f.reshape(b, -1, crit.no) for f in maps], axis=1)
            scores = jax.nn.sigmoid(flat[..., 4 * crit.reg_max:])
            return parts["fg_mask"], scores, parts["pred_bboxes"] * jnp.asarray(strides)[None], anchors * strides

        cache["run"] = jax.jit(run)
    model = cache["model"]
    v = model.init(jax.random.PRNGKey(seed), imgsz=IMGSZ)
    targets = {k: jnp.asarray(batch[k]) for k in ("cls", "bboxes", "mask")}
    fg, scores, pd, anchors = cache["run"](v, jnp.asarray(batch["img"].astype(np.float32) / 255.0), targets)
    gt = batch["bboxes"] * batch["mask"][..., None]
    return {"positives_per_image": np.asarray(fg).sum(1).astype(int).tolist(),
            "max_alignment": alignment(np.asarray(scores), np.asarray(pd), np.asarray(anchors), batch["cls"], gt,
                                       batch["mask"])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0-9", help="a range a-b or a comma list")
    ap.add_argument("--work", default="runs/seed_positives", help="directory for the dataset")
    args = ap.parse_args()
    a, _, b = args.seeds.partition("-")
    seeds = list(range(int(a), int(b) + 1)) if b else [int(s) for s in args.seeds.split(",")]
    import torch

    torch.set_num_threads(4)
    batch = first_batch(Path(args.work))
    n_gt = batch["mask"].sum(1).astype(int).tolist()
    summary, cache = {"port": {}, "jax": {}}, {}
    for seed in seeds:
        for pkg in ("port", "jax"):
            t = time.perf_counter()
            row = port_counts(batch, seed) if pkg == "port" else jax_counts(batch, seed, cache)
            row.update(package=pkg, seed=seed, positives=sum(row["positives_per_image"]), gt_per_image=n_gt,
                       s=round(time.perf_counter() - t, 1))
            summary[pkg][seed] = row["positives"]
            print(json.dumps(row), flush=True)
    print(json.dumps({"summary": summary, "model": FLAGSHIP, "batch": BATCH, "imgsz": IMGSZ, "nc": NC,
                      "seeds_without_positives": {p: [s for s, n in v.items() if n == 0] for p, v in summary.items()}}))


if __name__ == "__main__":
    main()

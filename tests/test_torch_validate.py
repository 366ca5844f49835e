"""The port's validate slice against the JAX package's, on the CPU in float32.

- The metric functions (`utils/metrics.py`) against the JAX package's on detections made
  from GT boxes with seeded jitter, false positives and scores, so that mAP50-95 lies well
  inside (0.2, 0.9): with random weights mAP is 0 in both packages and proves nothing.
- Multi-label `non_max_suppression` at pre_topk=4096 (K = 4096 of A * nc = 4608
  candidates) against the JAX one: exactly equal, ties included.
- `DetectionValidator` against the JAX `DetectionValidator` on one set of weights (the
  port's seeded init of the flagship at scale n with kernels and BN statistics redrawn by
  `chip_smoke.spread_weights` and the class priors zeroed, so that scores are O(1) and all
  A * nc = 4250 candidates pass conf 0.001) and the same batches, built by the JAX dataset
  from `tests/make_dataset.py` images at imgsz 160: exactly equal when the JAX forward's
  predictions are fed to both, and within 1e-4 end to end, also for the EMA of a JAX train
  state validated by `BaseTrainer.validate`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import spread_weights
from make_dataset import make_dataset_mixed
from drone_yolo_tpu.cfg import get_cfg as jax_get_cfg
from drone_yolo_tpu.data.build import build_dataloader, build_yolo_dataset
from drone_yolo_tpu.data.utils import check_det_dataset
from drone_yolo_tpu.engine.validator import DetectionValidator as JaxValidator
from drone_yolo_tpu.nn import modules as JM
from drone_yolo_tpu.nn.model import DetectionModel as JaxDetectionModel
from drone_yolo_tpu.ops.nms import non_max_suppression as jax_nms
from drone_yolo_tpu.utils import metrics as JMET
from drone_yolo_tpu.utils.optimizer import init_momentum
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch.engine.checkpoint import from_jax_train_state
from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
from drone_yolo_tpu_torch.engine.validator import DetectionValidator
from drone_yolo_tpu_torch.nn.model import DetectionModel
from drone_yolo_tpu_torch.ops.nms import non_max_suppression
from drone_yolo_tpu_torch.utils import metrics as MET

torch.set_num_threads(1)

FLAGSHIP_N = "yolov8n-p2-repvgg-sf.yaml"
IMGSZ, NC, BATCH = 160, 2, 4
VAL_ARGS = dict(imgsz=IMGSZ, conf=0.001, iou=0.7, max_det=300, pre_nms_topk=4096)
METRIC_KEYS = ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)", "fitness")


def jittered_detections(rng, n_img=16, nc=3, size=320.0):
    """Per image: GT boxes and classes, and detections in descending confidence: most GTs found again with a
    jitter of 2-20% of their size (now and then with the wrong class), plus false positives of lower scores."""
    images = []
    for _ in range(n_img):
        m = int(rng.integers(2, 9))
        xy = rng.uniform(0, size * 0.8, (m, 2))
        gt = np.concatenate([xy, xy + rng.uniform(12, size * 0.2, (m, 2))], 1).astype(np.float32)
        gt_cls = rng.integers(0, nc, m).astype(np.float32)
        found = rng.random(m) < 0.85
        wh = gt[found, 2:] - gt[found, :2]
        jit = rng.normal(0, 1, (int(found.sum()), 4)) * np.tile(wh, 2) * rng.uniform(0.02, 0.2, (int(found.sum()), 1))
        det_cls = np.where(rng.random(int(found.sum())) < 0.9, gt_cls[found], rng.integers(0, nc, int(found.sum())))
        n_fp = int(rng.integers(0, 5))
        fp_xy = rng.uniform(0, size * 0.8, (n_fp, 2))
        boxes = np.concatenate([gt[found] + jit, np.concatenate([fp_xy, fp_xy + rng.uniform(12, 60, (n_fp, 2))], 1)])
        conf = np.concatenate([rng.uniform(0.3, 1.0, int(found.sum())), rng.uniform(0.01, 0.7, n_fp)])
        cls = np.concatenate([det_cls, rng.integers(0, nc, n_fp)]).astype(np.float32)
        order = np.argsort(-conf, kind="stable")
        images.append((gt, gt_cls, boxes[order].astype(np.float32), conf[order].astype(np.float32), cls[order]))
    return images


def test_metrics_match_jax_on_jittered_gt():
    iouv = np.linspace(0.5, 0.95, 10)
    stats = {"port": [], "jax": []}
    for gt, gt_cls, boxes, conf, cls in jittered_detections(np.random.default_rng(0)):
        iou = MET.box_iou_np(gt, boxes)
        np.testing.assert_array_equal(iou, JMET.box_iou_np(gt, boxes))
        tp = MET.match_predictions(cls.astype(int), gt_cls.astype(int), iou, iouv)
        np.testing.assert_array_equal(tp, JMET.match_predictions(cls.astype(int), gt_cls.astype(int), iou, iouv))
        for who in stats:
            stats[who].append((tp, conf, cls, gt_cls))
    cat = [np.concatenate(parts) for parts in zip(*stats["port"])]
    got, want = MET.ap_per_class(*cat), JMET.ap_per_class(*cat)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    port, ref = MET.DetMetrics(names={i: str(i) for i in range(3)}), JMET.DetMetrics(names={i: str(i) for i in range(3)})
    port.process(*cat)
    ref.process(*cat)
    assert port.results_dict == ref.results_dict
    np.testing.assert_array_equal(port.maps, ref.maps)
    assert port.fitness == ref.fitness
    print(f"jittered GT: {port.results_dict}")
    assert 0.2 < port.results_dict["metrics/mAP50-95(B)"] < 0.9
    assert port.results_dict["metrics/mAP50(B)"] > port.results_dict["metrics/mAP50-95(B)"]


@pytest.mark.parametrize("conf,iou,ties", [(0.001, 0.7, False), (0.25, 0.45, False), (0.0, 0.6, True)])
def test_multi_label_nms_at_k4096_matches_jax(conf, iou, ties):
    """(2, 2304, 4 + 2) predictions: K = min(4096, A * nc) = 4096; with `ties`, scores on a grid of 0.01 so
    that the top-K order and its cut run through equal scores."""
    rng = np.random.default_rng(int(conf * 1000) + ties)
    a = 2304
    c = rng.random((2, a, 2)) * 96
    scores = rng.random((2, a, NC))
    if ties:
        scores = np.round(scores, 2)
    preds = np.concatenate([c, rng.uniform(2, 30, (2, a, 2)), scores], -1).astype(np.float32)
    dets_j, n_j = jax_nms(jnp.asarray(preds), conf_thres=conf, iou_thres=iou, max_det=300, pre_topk=4096, nc=NC,
                          multi_label=True)
    dets, n = non_max_suppression(torch.from_numpy(preds), conf_thres=conf, iou_thres=iou, max_det=300, pre_topk=4096,
                                  multi_label=True)
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(dets.numpy(), np.asarray(dets_j))
    assert (n.numpy() > 0).all() and set(np.unique(dets.numpy()[..., 5])) <= {0.0, 1.0}


class _Facade:
    def __init__(self, model, variables):
        self.model, self.variables = model, variables

    def ensure_variables(self, imgsz=640, seed=0):
        return self.variables


def _spread(model: DetectionModel, rng) -> dict:
    """`spread_weights` of the model's state, with the class priors zeroed: scores O(1), all A * nc candidates above
    conf 0.001."""
    sd = spread_weights(model.state_dict(), rng)
    for i in range(len(model.head.cv3)):
        sd[f"model.{len(model.model) - 1}.cv3.{i}.2.bias"].zero_()
    return sd


@pytest.fixture(scope="module")
def val_case(tmp_path_factory):
    """(port model, JAX model, JAX variables, collate-format batches) on one set of weights."""
    root = tmp_path_factory.mktemp("val")
    data = check_det_dataset(str(make_dataset_mixed(root / "d", n_val=8, nc=NC, seed=3, base=256)))
    cfg = jax_get_cfg(overrides={"imgsz": IMGSZ, "task": "detect", "mode": "val", "rect": False})
    dataset = build_yolo_dataset(cfg, data["val"], BATCH, data, mode="val", stride=32)
    batches = list(build_dataloader(dataset, BATCH, workers=0, shuffle=False, drop_last=False))
    assert any(rp[1] != (0.0, 0.0) for b in batches for rp in b["ratio_pads"])  # letterbox padding to undo
    port = DetectionModel(FLAGSHIP_N, nc=NC)
    port.init(0, imgsz=IMGSZ)
    port.load_state_dict(_spread(port, np.random.default_rng(5)))
    ref = JaxDetectionModel(FLAGSHIP_N, nc=NC)
    return port, ref, convert_state_dict(ref, port.state_dict()), batches


class _FedJax(JaxValidator):
    """The JAX validator with its forward replaced by given predictions, one array per batch in order."""

    def __init__(self, preds, **kw):
        super().__init__(**kw)
        self.fed = list(preds)

    def _forward(self, shape):
        a = self.args
        return lambda variables, x: jax_nms(self.fed.pop(0), conf_thres=a.conf, iou_thres=a.iou, max_det=a.max_det,
                                            pre_topk=a.pre_nms_topk, nc=self.nc, multi_label=True)


class _FedPort(DetectionValidator):
    """The port's validator with its forward replaced by given predictions, one tensor per batch in order."""

    def __init__(self, preds, *a, **kw):
        super().__init__(*a, **kw)
        self.fed = list(preds)

    def forward(self, x):
        return self.fed.pop(0)


def _jax_validator(cls, batches, tmp_path, **kw):
    args = dict(VAL_ARGS, batch=BATCH, half=False, plots=False, save_json=False, verbose=False, task="detect", mode="val")
    return cls(dataloader=batches, save_dir=tmp_path, args=args, **kw)


def plant_gt(preds: np.ndarray, batch: dict, rng) -> np.ndarray:
    """Predictions with each GT box of the batch planted at a random anchor, jittered by 2-20% of its size, at a
    score of 0.5-1 for its class (0.8 of the time) or another, so that the metrics have something to find."""
    out = preds.copy()
    for i in range(len(out)):
        gt = batch["bboxes"][i][batch["mask"][i] > 0]
        cls = batch["cls"][i][batch["mask"][i] > 0].astype(int)
        anchors = rng.choice(out.shape[1], len(gt), replace=False)
        wh = gt[:, 2:] - gt[:, :2]
        xy = (gt[:, :2] + gt[:, 2:]) / 2 + rng.normal(0, 0.1, (len(gt), 2)) * wh
        out[i, anchors, :4] = np.concatenate([xy, wh * rng.uniform(0.8, 1.2, (len(gt), 2))], 1)
        hit = np.where(rng.random(len(gt)) < 0.8, cls, (cls + 1) % NC)
        out[i, anchors, 4 + hit] = rng.uniform(0.5, 1.0, len(gt))
    return out


def test_validator_matches_jax_on_fed_predictions(val_case, tmp_path):
    """The JAX forward's predictions, with the GT planted, fed to both validators: NMS, rescaling, matching and
    metrics exactly equal."""
    port, ref, variables, batches = val_case
    fused = ref.fuse(variables)
    fwd = jax.jit(lambda v, x: ref.apply(v, x, ctx=JM.Ctx(train=False, dtype=jnp.float32))[0])
    rng = np.random.default_rng(6)
    preds = [plant_gt(np.asarray(fwd(fused, jnp.asarray(b["img"].astype(np.float32) / 255.0))), b, rng) for b in batches]
    assert preds[0].shape[1] * NC > 4096  # K = 4096 of the 4250 candidates
    want = _jax_validator(_FedJax, batches, tmp_path, preds=preds)(model=_Facade(ref, variables))
    val = _FedPort([torch.from_numpy(p) for p in preds], batches,
                   args=dict(VAL_ARGS, device="cpu", dtype="float32", verbose=False))
    got = val(model=port)
    print(f"fed predictions: port {got}, JAX {want}")
    assert got == want
    assert 0.2 < got["metrics/mAP50-95(B)"] < 0.9 and val.seen == sum(len(b["img"]) for b in batches)


@pytest.mark.parametrize("weights", ["model", "ema"])
def test_validator_matches_jax_end_to_end(val_case, tmp_path, weights):
    """Each validator with its own forward (float32 on the CPU): P, R, mAP50, mAP50-95 within 1e-4, and at least 95%
    of each image's detection confidences within 1e-4. "model": a `DetectionModel` validated directly. "ema": a JAX train state
    whose EMA differs from its params crosses by `from_jax_train_state`, and `BaseTrainer.validate` validates its
    EMA, as the JAX trainer's `validate` does (`variables=state["ema"]`)."""
    port, ref, variables, batches = val_case
    args = dict(VAL_ARGS, device="cpu", dtype="float32", verbose=False)
    jax_val = _jax_validator(JaxValidator, batches, tmp_path)
    if weights == "model":
        want = jax_val(model=_Facade(ref, variables))
        val = DetectionValidator(batches, args=args)
        got = val(model=port)
    else:
        ema = convert_state_dict(ref, _spread(port, np.random.default_rng(9)))
        params = jax.tree_util.tree_map(jnp.asarray, variables)
        state = {"params": params, "opt": init_momentum(params), "ema": ema, "acc": jax.tree_util.tree_map(jnp.zeros_like, params),
                 "count": 0, "step": 3}
        want = jax_val(model=_Facade(ref, variables), variables=ema)
        trainer = BaseTrainer(overrides=dict(model=FLAGSHIP_N, batch=BATCH, imgsz=IMGSZ, nbs=BATCH, device="cpu", amp=False,
                                             optimizer="SGD"), train_loader=batches, data={"nc": NC}, val_loader=batches)
        trainer.load_train_state(from_jax_train_state(state))
        got = trainer.validate()
        val = trainer.validator
        assert trainer.metrics == got and trainer.fitness == got["fitness"]
    n_det = sum(len(c) for c in val.stats["conf"])
    print(f"end to end ({weights}): port {got}, JAX {want}; detections {n_det}")
    assert set(got) == set(METRIC_KEYS)
    for k in METRIC_KEYS:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    assert n_det == len(batches[0]["img"]) * 2 * 300  # max_det detections for each of the 8 images
    for c_port, c_jax in zip(val.stats["conf"], jax_val.stats["conf"]):  # the same weights ran: the scores agree;
        # where two candidates' scores lie within float32 noise of each other the order, and so which one NMS keeps,
        # may differ between the two forwards (the JAX validator runs the EMA unfused, the port fused)
        same = np.abs(np.sort(c_port) - np.sort(c_jax)) <= 1e-4
        assert same.mean() >= 0.95, f"{(~same).sum()} of {len(same)} confidences differ by more than 1e-4"
    assert set(val.speed) == {"preprocess", "inference", "postprocess"}
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in got.values())

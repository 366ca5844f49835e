"""The port's segment model, mask ops, predictor and validator against the JAX package's, on the CPU in float32.

`yolov8n-seg.yaml` (nc 3) from one set of weights (the port's seeded init with kernels spread and class logits that
follow the image, `chip_smoke.scored_weights`, and a random, non-symmetric kernel in Proto's transposed conv),
crossed to JAX by `convert_state_dict`. Held against the JAX package:

- the head's decoded output with the 32 coefficients, the raw coefficients and the prototypes within 1e-4; Proto
  alone (a flipped kernel must change it); the weight bridge both ways, the npz header's task and the fuse;
- `crop_mask` (half-open edges), `process_mask` and `scale_masks` within 1e-5 before the 0.5 threshold and equal
  after it except where |v - 0.5| < 1e-5, `mask_iou` exactly;
- `Masks.xy` against `cv2.findContours`/`cv2.contourArea` and the JAX `Masks.xy`, `Results` with masks;
- `SegmentationPredictor` through the facades on mixed frame shapes (boxes within 1e-3 px, masks as above);
- `SegmentMetrics` on random stats, `SegmentationValidator` on fed predictions (planted boxes, coefficients and
  prototypes) exactly, and end to end within 1e-4 in square batches and through `YOLO.val`'s rect batches;
- the task's registration (`guess_model_task`, `TASK2MODELCLASS`, `TASK_MAP`) and the refusals.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import scored_weights, spread_weights
from make_dataset import make_seg_dataset
from drone_yolo_tpu import YOLO as JaxYOLO
from drone_yolo_tpu.cfg import get_cfg as jax_get_cfg
from drone_yolo_tpu.data.build import build_dataloader as jax_dataloader
from drone_yolo_tpu.data.build import build_yolo_dataset as jax_dataset
from drone_yolo_tpu.data.utils import check_det_dataset as jax_check
from drone_yolo_tpu.engine import results as jax_results
from drone_yolo_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from drone_yolo_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from drone_yolo_tpu.models.yolo.segment import SegmentationValidator as JaxSegValidator
from drone_yolo_tpu.nn import modules as JM
from drone_yolo_tpu.nn.model import SegmentationModel as JaxSegModel
from drone_yolo_tpu.nn.model import guess_model_task as jax_guess_task
from drone_yolo_tpu.ops import masks as JMASK
from drone_yolo_tpu.ops.nms import non_max_suppression as jax_nms
from drone_yolo_tpu.utils import metrics as JMET
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.cfg import get_train_cfg
from drone_yolo_tpu_torch.engine import results
from drone_yolo_tpu_torch.engine.checkpoint import flatten_tree, from_jax_variables, to_jax_variables
from drone_yolo_tpu_torch.models.yolo import TASK_MAP
from drone_yolo_tpu_torch.models.yolo.segment import SegmentationPredictor, SegmentationValidator
from drone_yolo_tpu_torch.nn import modules as M
from drone_yolo_tpu_torch.nn.model import TASK2MODELCLASS, SegmentationModel, guess_model_task
from drone_yolo_tpu_torch.ops import masks as MASK
from drone_yolo_tpu_torch.ops.polygon import contour_area, find_contours
from drone_yolo_tpu_torch.utils import metrics as MET

torch.set_num_threads(1)

SEG_N = "yolov8n-seg.yaml"
NC = 3
HEAD_TOL = dict(rtol=1e-5, atol=1e-4)
MASK_TOL = 1e-5  # before the threshold; after it, pixels may differ only within this of 0.5
PREDICT = dict(imgsz=128, conf=0.25, dtype="float32", verbose=False)
BOX_TOL = 1e-3  # px in the original frame, as tests/test_torch_predict.py
VAL_ARGS = dict(conf=0.001, iou=0.7, max_det=300, pre_nms_topk=4096)


def _random_up_kernel(sd: dict, rng) -> dict:
    """Proto's transposed-conv weight and bias redrawn from normals: no symmetry that would hide a flip."""
    return {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32) * (0.3 if v.ndim == 4 else 0.1))
            if ".proto.upsample." in k else v for k, v in sd.items()}


@pytest.fixture(scope="module")
def seg_pair():
    """(port facade, JAX facade) with one set of weights."""
    port = YOLO(SEG_N, device="cpu")
    port.model = SegmentationModel(SEG_N, nc=NC)
    port.ensure_variables(imgsz=128)
    rng = np.random.default_rng(0)
    port.model.load_state_dict(_random_up_kernel(scored_weights(port.model.state_dict(), rng, -2.0, 30.0), rng))
    ref = JaxYOLO(SEG_N)
    ref.model = JaxSegModel(SEG_N, nc=NC)
    ref.variables = convert_state_dict(ref.model, port.model.state_dict())
    return port, ref


def jax_forward(model, variables, x_nhwc):
    return jax.jit(lambda v, x: model.apply(v, x, ctx=JM.Ctx(train=False, dtype=jnp.float32)))(variables,
                                                                                             jnp.asarray(x_nhwc))


def test_segment_head_matches_jax(seg_pair):
    port, ref = seg_pair
    x = np.random.default_rng(1).random((2, 96, 128, 3), dtype=np.float32)
    want, (_, want_mc, want_protos) = jax_forward(ref.model, ref.variables, x)
    with torch.no_grad():
        got, (maps, got_mc, got_protos) = port.model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == want.shape == (2, 252, 4 + NC + 32) and got_protos.shape == (2, 32, 24, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HEAD_TOL)
    np.testing.assert_allclose(got_mc.numpy(), np.asarray(want_mc), **HEAD_TOL)
    np.testing.assert_allclose(got_protos.permute(0, 2, 3, 1).numpy(), np.asarray(want_protos), **HEAD_TOL)
    assert port.model.head.npr == 64  # 256 width-scaled at n (0.25), as the JAX builder
    assert sum(isinstance(m, M.BatchNorm2d) for m in port.model.modules()) == 57 + 6 + 3


def test_proto_transposed_kernel_orientation(seg_pair):
    """Proto alone against the JAX Proto on the bridged weights, and a flipped kernel must give another output (the
    test can see a flip)."""
    port, ref = seg_pair
    proto = port.model.head.proto
    jproto = ref.model.layers[-1].module.proto
    jvars = ref.variables[str(len(port.model.model) - 1)]["proto"]
    x = np.random.default_rng(2).standard_normal((1, 64, 6, 5)).astype(np.float32)
    want = np.asarray(jproto(jvars, jnp.asarray(x.transpose(0, 2, 3, 1)), JM.Ctx(train=False, dtype=jnp.float32)))
    with torch.no_grad():
        got = proto(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
        w = proto.upsample.weight.clone()
        proto.upsample.weight.copy_(w.flip(-1))
        flipped = proto(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
        proto.upsample.weight.copy_(w)
    np.testing.assert_allclose(got, want, **HEAD_TOL)
    assert np.abs(flipped - want).max() > 1e-2


def test_segment_bridge_fuse_and_npz(seg_pair, tmp_path):
    port, ref = seg_pair
    tree = convert_state_dict(ref.model, port.model.state_dict())
    sd = from_jax_variables(tree)
    assert sd.keys() == port.model.state_dict().keys() and any(".proto.upsample." in k for k in sd)
    assert all(torch.equal(sd[k], v) for k, v in port.model.state_dict().items())
    back = flatten_tree(to_jax_variables(sd))
    assert back.keys() == flatten_tree(tree).keys()
    for k, v in flatten_tree(tree).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    fused = YOLO(SEG_N, device="cpu")
    fused.model = SegmentationModel(SEG_N, nc=NC)
    fused.model.load_state_dict(port.model.state_dict())
    fused.initialized = True
    fused.fuse()
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, jax.jit(ref.model.fuse)(ref.variables)),
                              fused.model)
    got = fused.model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6, err_msg=k)
    path = jax_save_checkpoint(tmp_path / "seg.npz", ref.model, ref.variables)
    loaded = YOLO(str(path), device="cpu")
    assert loaded.task == "segment" and isinstance(loaded.model, SegmentationModel)
    x = torch.rand(1, 3, 96, 96, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        np.testing.assert_array_equal(loaded.model(x)[0].numpy(), port.model(x)[0].numpy())
    port.save(tmp_path / "port.npz")
    jmodel, _, header = jax_load_checkpoint(tmp_path / "port.npz")
    assert header["task"] == "segment" and type(jmodel).__name__ == "SegmentationModel"


@pytest.mark.parametrize("n,hw,img", [(7, (40, 48), (160, 192)), (3, (24, 32), (96, 128)), (0, (8, 8), (32, 32))])
def test_process_mask_crop_and_iou_match_jax(n, hw, img):
    rng = np.random.default_rng(n)
    protos = rng.standard_normal((32, *hw)).astype(np.float32)
    coeffs = rng.standard_normal((n, 32)).astype(np.float32)
    xy = rng.uniform(-10, np.array(img[::-1]) * 0.8, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 80, (n, 2))], 1).astype(np.float32)
    boxes[: n // 2] = np.round(boxes[: n // 2] / 4) * 4  # box edges on mask pixels: the half-open rule decides them
    got = MASK.process_mask(torch.from_numpy(protos), torch.from_numpy(coeffs), torch.from_numpy(boxes), img).numpy()
    want = np.asarray(JMASK.process_mask(jnp.asarray(protos.transpose(1, 2, 0)), jnp.asarray(coeffs),
                                         jnp.asarray(boxes), img))
    assert got.shape == want.shape == (n, *hw)
    np.testing.assert_allclose(got, want, rtol=0, atol=MASK_TOL)
    np.testing.assert_array_equal(got == 0, want == 0)  # the same pixels cropped
    a, b = got > 0.5, (rng.random((n + 2, *hw)) > 0.6)
    iou = MASK.mask_iou(torch.from_numpy(b), torch.from_numpy(a)).numpy()
    assert iou.shape == (n + 2, n)
    if n:  # the JAX function takes no empty set (its validator calls it with detections only)
        np.testing.assert_array_equal(iou, JMASK.mask_iou_np(b.astype(np.float32), a.astype(np.float32)))


def _assert_masks_close(got_bool, want_bool, values):
    """Thresholded masks equal except where the port's value lies within MASK_TOL of 0.5."""
    diff = got_bool != want_bool
    assert np.all(np.abs(values[diff] - 0.5) < MASK_TOL), values[diff]


@pytest.mark.parametrize("orig,inp,ratio_pad", [((480, 640), (160, 192), None), ((97, 211), (128, 256), None),
                                                ((300, 200), (128, 96), "from_letterbox"), ((64, 64), (64, 64), None)])
def test_scale_masks_matches_jax(orig, inp, ratio_pad):
    rng = np.random.default_rng(orig[0])
    m = rng.random((5, inp[0] // 4, inp[1] // 4)).astype(np.float32)
    m[:, ::3] = 0.5  # pixels on the threshold
    if ratio_pad:
        gain = min(inp[0] / orig[0], inp[1] / orig[1])
        ratio_pad = (gain, ((inp[1] - round(orig[1] * gain)) / 2, (inp[0] - round(orig[0] * gain)) / 2))
    got = MASK.scale_masks(torch.from_numpy(m), orig, inp, ratio_pad).numpy()
    want = JMASK.scale_masks_np(m, orig, inp, ratio_pad)
    assert got.shape == want.shape == (5, *orig)
    np.testing.assert_allclose(got, want, rtol=0, atol=MASK_TOL)
    _assert_masks_close(got > 0.5, want > 0.5, got)
    assert MASK.scale_masks(torch.zeros(0, 4, 4), orig, inp).shape == (0, *orig)


def _blobs(rng, h, w, n):
    m = np.zeros((h, w), np.uint8)
    for _ in range(n):
        pts = (rng.uniform(-2, [w + 2, h + 2], (int(rng.integers(3, 8)), 2))).astype(np.int32)
        cv2.fillPoly(m, [pts], 1)
    return m


def test_masks_xy_and_results_match_jax():
    """Masks.xy: the outline cv2 picks (largest contourArea of RETR_EXTERNAL / CHAIN_APPROX_SIMPLE) on random blobs,
    equal ties, holes, one-pixel and empty masks; Results indexing, len, update and summary's segments."""
    rng = np.random.default_rng(0)
    h, w = 60, 80
    masks = [_blobs(rng, h, w, int(rng.integers(1, 5))) for _ in range(20)]
    tie = np.zeros((h, w), np.uint8)
    tie[5:15, 5:15] = tie[30:40, 50:60] = 1  # two outlines of one area: cv2 returns the later one first
    hole = np.zeros((h, w), np.uint8)
    hole[10:50, 10:70] = 1
    hole[20:40, 20:60] = 0
    hole[25:35, 30:40] = 1  # an island in the hole: not an outer border
    dot = np.zeros((h, w), np.uint8)
    dot[h - 1, w - 1] = 1
    masks += [tie, hole, dot, np.zeros((h, w), np.uint8)]
    for m in masks:
        cs, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        mine = find_contours(m)
        assert len(mine) == len(cs) and all(np.array_equal(a, b) for a, b in zip(mine, cs))
        assert [contour_area(c) for c in mine] == [cv2.contourArea(c) for c in cs]
    data = np.stack(masks).astype(bool)
    got, want = results.Masks(data, (h, w)), jax_results.Masks(data, (h, w))
    for g, wv in zip(got.xy, want.xy):
        np.testing.assert_array_equal(g, wv)
    img = np.zeros((h, w, 3), np.uint8)
    boxes = np.concatenate([rng.uniform(0, 40, (len(masks), 2)), rng.uniform(40, 60, (len(masks), 2)),
                            rng.random((len(masks), 1)), rng.integers(0, 3, (len(masks), 1))], 1).astype(np.float32)
    r = results.Results(img, "a.jpg", {0: "a", 1: "b", 2: "c"}, boxes=boxes, masks=data)
    assert len(r) == len(masks) and len(r[2:5]) == 3 and r[3].masks.data.shape == (h, w)
    np.testing.assert_array_equal(r[[0, 4]].masks.data, data[[0, 4]])
    np.testing.assert_array_equal(r[[0, 4]].boxes.data, boxes[[0, 4]])
    for rec, xy in zip(r.summary(normalize=True), want.xy):
        assert rec["segments"] == {"x": (xy[:, 0] / w).round(5).tolist(), "y": (xy[:, 1] / h).round(5).tolist()}
    r.update(masks=data[:2], boxes=boxes[:2])
    assert len(r) == 2 and r.masks.data.shape == (2, h, w)
    assert results.Results(img, "a.jpg", {}, masks=data).masks.xy[-1].shape == (0, 2)


@pytest.mark.parametrize("shapes", [[(96, 160), (80, 160)], [(128, 128), (128, 128)], [(120, 90)]])
def test_segment_predictor_matches_jax(seg_pair, shapes):
    port, ref = seg_pair
    rng = np.random.default_rng(len(shapes) + shapes[0][0])
    frames = [rng.integers(0, 256, (*s, 3), dtype=np.uint8) for s in shapes]
    got, want = port.predict(source=frames, **PREDICT), ref.predict(source=frames, **PREDICT)
    pred = port.predictor
    assert isinstance(pred, SegmentationPredictor)
    x = pred.preprocess(frames)
    (dets, protos), n_valid = pred.inference(x)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.orig_shape == w.orig_shape and len(g.boxes) == len(w.boxes) > 0
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, rtol=0, atol=BOX_TOL)
        np.testing.assert_allclose(g.boxes.conf, w.boxes.conf, rtol=1e-4, atol=1e-7)
        assert g.masks.data.shape == w.masks.data.shape == (len(w.boxes), *shapes[i]) and g.masks.data.dtype == bool
        d = dets[i, : int(n_valid[i])].float()
        values = MASK.scale_masks(MASK.process_mask(protos[i], d[:, 6:], d[:, :4], x.shape[2:]), shapes[i],
                                  x.shape[2:]).numpy()
        _assert_masks_close(g.masks.data, w.masks.data, values)
        assert 0 < g.masks.data.sum() < g.masks.data.size


def test_segment_metrics_match_jax():
    rng = np.random.default_rng(0)
    n = 200
    stats = (rng.random((n, 10)) < 0.6, rng.random((n, 10)) < 0.4, rng.random(n), rng.integers(0, 3, n),
             rng.integers(0, 3, 150))
    got, want = MET.SegmentMetrics({0: "a", 1: "b", 2: "c"}), JMET.SegmentMetrics({0: "a", 1: "b", 2: "c"})
    got.process(*stats)
    want.process(*stats)
    assert got.keys == want.keys and len(got.keys) == 8
    np.testing.assert_array_equal(got.mean_results(), want.mean_results())
    assert got.fitness == want.fitness == got.box.fitness() + got.seg.fitness()
    np.testing.assert_array_equal(got.maps, want.maps)


class _Facade:
    def __init__(self, model, variables):
        self.model, self.variables = model, variables

    def ensure_variables(self, imgsz=640, seed=0):
        return self.variables


class _FedJax(JaxSegValidator):
    def __init__(self, fed, **kw):
        super().__init__(**kw)
        self.fed = list(fed)

    def _forward(self, shape):
        a = self.args

        def fn(variables, x):
            preds, protos = self.fed.pop(0)
            dets, n = jax_nms(jnp.asarray(preds), conf_thres=a.conf, iou_thres=a.iou, max_det=a.max_det,
                              pre_topk=a.pre_nms_topk, nc=self.nc, multi_label=True)
            return (dets, jnp.asarray(protos.transpose(0, 2, 3, 1))), n
        return fn


class _FedPort(SegmentationValidator):
    def __init__(self, fed, *a, **kw):
        super().__init__(*a, **kw)
        self.fed = list(fed)

    def forward(self, x):
        preds, self.protos = (torch.from_numpy(v) for v in self.fed.pop(0))
        return preds


@pytest.fixture(scope="module")
def val_case(tmp_path_factory):
    """(port model, JAX model, JAX variables, square val batches from the JAX dataset at imgsz 96, the dataset yaml)
    on spread weights with the class priors zeroed (scores O(1): every candidate passes conf 0.001)."""
    root = tmp_path_factory.mktemp("seg_val")
    yaml = str(make_seg_dataset(root / "d", n_val=4, nc=NC, seed=0, size=128, n_train=2))
    jd = jax_check(yaml)
    cfg = jax_get_cfg(overrides={"imgsz": 96, "task": "segment", "mode": "val", "rect": False})
    batches = list(jax_dataloader(jax_dataset(cfg, jd["val"], 4, jd, mode="val"), 4, 0, shuffle=False,
                                  drop_last=False))
    port = SegmentationModel(SEG_N, nc=NC)
    port.init(0, imgsz=96)
    sd = spread_weights(port.state_dict(), np.random.default_rng(5))
    for i in range(len(port.head.cv3)):
        sd[f"model.{len(port.model) - 1}.cv3.{i}.2.bias"].zero_()
    port.load_state_dict(sd)
    ref = JaxSegModel(SEG_N, nc=NC)
    return port, ref, convert_state_dict(ref, port.state_dict()), batches, yaml


def _plant(preds, batch, rng):
    """Each GT planted at a random anchor: its box jittered by up to ~10%, a score of 0.5-1 for its class (80%) or
    another, coefficients one-hot at its slot (70%) or another slot; prototypes +-10 on each slot's GT mask."""
    out = preds.copy()
    b, _, hm, wm = len(out), None, batch["masks"].shape[1], batch["masks"].shape[2]
    protos = rng.normal(0, 0.5, (b, 32, hm, wm)).astype(np.float32) - 10.0
    for i in range(b):
        live = batch["mask"][i] > 0
        gt, cls = batch["bboxes"][i][live], batch["cls"][i][live].astype(int)
        n = len(gt)
        for k in range(n):
            protos[i, k] += 20.0 * (batch["masks"][i] == k + 1)
        anchors = rng.choice(out.shape[1], n, replace=False)
        wh = gt[:, 2:] - gt[:, :2]
        xy = (gt[:, :2] + gt[:, 2:]) / 2 + rng.normal(0, 0.05, (n, 2)) * wh
        out[i, anchors, :4] = np.concatenate([xy, wh * rng.uniform(0.9, 1.1, (n, 2))], 1)
        out[i, anchors, 4 + np.where(rng.random(n) < 0.8, cls, (cls + 1) % NC)] = rng.uniform(0.5, 1.0, n)
        coeff = np.zeros((n, 32), np.float32)
        coeff[np.arange(n), np.where(rng.random(n) < 0.7, np.arange(n), (np.arange(n) + 1) % max(n, 1))] = 1.0
        out[i, anchors, 4 + NC:] = coeff + rng.normal(0, 0.02, coeff.shape)
    return out, protos


def _jax_args(**kw):
    return dict(VAL_ARGS, imgsz=96, batch=4, half=False, plots=False, save_json=False, verbose=False, task="segment",
                mode="val", **kw)


def test_segment_validator_matches_jax_on_fed_predictions(val_case, tmp_path):
    port, ref, variables, batches, _ = val_case
    fused = ref.fuse(variables)
    fwd = jax.jit(lambda v, x: ref.apply(v, x, ctx=JM.Ctx(train=False, dtype=jnp.float32))[0])
    rng = np.random.default_rng(6)
    fed = [_plant(np.asarray(fwd(fused, jnp.asarray(b["img"].astype(np.float32) / 255.0))), b, rng) for b in batches]
    assert fed[0][0].shape[2] == 4 + NC + 32 and fed[0][1].shape[1:] == (32, 24, 24)
    want = _FedJax(fed, dataloader=batches, save_dir=tmp_path, args=_jax_args())(model=_Facade(ref, variables))
    port_args = dict(VAL_ARGS, imgsz=96, device="cpu", dtype="float32", verbose=False)
    got = _FedPort(fed, batches, args=port_args)(model=port)
    print(f"fed predictions: port {got}, JAX {want}")
    assert got == want and len(got) == 9
    assert 0.1 < got["metrics/mAP50-95(B)"] < 0.9 and 0.1 < got["metrics/mAP50-95(M)"] < 0.9  # something to find


@pytest.mark.parametrize("batches_of", ["square", "rect"])
def test_segment_validator_matches_jax_end_to_end(val_case, tmp_path, batches_of):
    """Each package's own forward on the same weights (float32): the 8 metrics and fitness within 1e-4. square: the
    validators over the JAX dataset's batches; rect: `YOLO.val` of one npz (rect batches of 2)."""
    port, ref, variables, batches, yaml = val_case
    if batches_of == "square":
        want = JaxSegValidator(dataloader=batches, save_dir=tmp_path, args=_jax_args())(model=_Facade(ref, variables))
        val = SegmentationValidator(batches, args=dict(VAL_ARGS, imgsz=96, device="cpu", dtype="float32",
                                                       verbose=False))
        got = val(model=port)
        assert sum(len(c) for c in val.stats["conf"]) > 0 and sum(t.sum() for t in val.stats["tp_m"]) >= 0
    else:
        facade = YOLO(SEG_N, device="cpu")
        facade.model, facade.initialized = port, True
        facade.save(tmp_path / "m.npz")
        args = dict(data=yaml, imgsz=96, batch=2, plots=False, verbose=False)
        got = YOLO(tmp_path / "m.npz", device="cpu").val(dtype="float32", workers=1, **args)
        r = JaxYOLO(str(tmp_path / "m.npz")).val(**args)
        want = {**dict(zip(r.keys, r.mean_results())), "fitness": r.fitness() if callable(r.fitness) else r.fitness}
    print(f"end to end ({batches_of}): port {got}, JAX {want}")
    assert set(got) == set(want) and len(got) == 9
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])


def test_segment_task_registration_and_refusals(seg_pair):
    port, _ = seg_pair
    for cfg in ("yolov8n-seg.yaml", "yolov8s-seg.yaml", "yolov8n-pose.yaml", "yolov8n-p2-repvgg-sf.yaml"):
        assert guess_model_task(cfg) == jax_guess_task(cfg)
    assert port.task == "segment" and TASK2MODELCLASS["segment"] is SegmentationModel
    assert {k: v.__name__ for k, v in TASK_MAP["segment"].items()} == {
        "trainer": "SegmentationTrainer", "validator": "SegmentationValidator", "predictor": "SegmentationPredictor"}
    with pytest.raises(KeyError, match="overlap_mask=False"):
        get_train_cfg(overrides=dict(overlap_mask=False))
    with pytest.raises(KeyError, match="save_json=True"):
        port.val(data="data.yaml", save_json=True)
    frame = np.zeros((64, 64, 3), np.uint8)
    a = port.predict(frame, **{**PREDICT, "retina_masks": True})[0]  # accepted and, as in JAX, without effect
    b = port.predict(frame, **PREDICT)[0]
    np.testing.assert_array_equal(a.masks.data, b.masks.data)

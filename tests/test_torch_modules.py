"""The PyTorch port's modules against the JAX package's, in float32 on the CPU.

The same seeded numpy weights go into both (JAX init, then kernels and BN
statistics redrawn from numpy, crossing over by `from_jax_variables`), the same
seeded numpy input goes through both, and outputs agree within 1e-4, the
forward bar of ROADMAP.md ("How parity is judged").
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from drone_yolo_tpu.nn import modules as JM
from drone_yolo_tpu.nn.model import DetectionModel as JDetectionModel
from drone_yolo_tpu.ops import anchors as janchors
from drone_yolo_tpu.ops import boxes as jboxes
from drone_yolo_tpu.ops.letterbox import letterbox_device
from drone_yolo_tpu.ops.letterbox import letterbox_params as jletterbox_params
from drone_yolo_tpu_torch.cfg import MODEL_CFG_DIR
from drone_yolo_tpu_torch.engine.checkpoint import from_jax_variables
from drone_yolo_tpu_torch.nn import modules as TM
from drone_yolo_tpu_torch.nn.build import load_yaml
from drone_yolo_tpu_torch.nn.model import DetectionModel
from drone_yolo_tpu_torch.ops import anchors as tanchors
from drone_yolo_tpu_torch.ops import boxes as tboxes
from drone_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_params

torch.set_num_threads(1)

TOL = 1e-4
# largest difference found between jax.image.resize(linear) and the antialiased
# F.interpolate: 3.0e-7 (720x1280 -> 128x128)
LETTERBOX_TOL = 1e-6
CTX = JM.Ctx(train=False, dtype=jnp.float32)
FLAGSHIP_YAMLS = ["yolov8.yaml", "yolov8-p2.yaml", "yolov8-p2-repvgg.yaml", "yolov8-p2-repvgg-sf.yaml"]


def randomize(tree, rng):
    """Redraw a JAX variables tree from numpy: He-normal kernels, BN statistics away from identity."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        shape = np.shape(v)
        if k == "kernel":
            out[k] = (rng.standard_normal(shape) * math.sqrt(2.0 / np.prod(shape[:3]))).astype(np.float32)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:  # bias, mean
            out[k] = rng.normal(0.0, 0.1, shape).astype(np.float32)
    return out


def load_port(torch_module, variables):
    sd = {k.removeprefix("model.0."): v for k, v in from_jax_variables({"0": variables}).items()}
    torch_module.load_state_dict(sd, strict=True)


def fuse_port(torch_module):
    for kind in (TM.RepVGGBlock, TM.Conv):
        for mod in [m for m in torch_module.modules() if isinstance(m, kind)]:
            mod.fuse()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


MODULES = {
    "conv3s2": lambda M: M.Conv(8, 16, 3, 2),
    "conv1": lambda M: M.Conv(8, 16, 1, 1),
    "dwconv3s2": lambda M: M.DWConv(16, 16, 3, 2),
    "dwconv_g8": lambda M: M.DWConv(8, 16, 3, 1),
    "bottleneck": lambda M: M.Bottleneck(16, 16, True),
    "c2f_n2_shortcut": lambda M: M.C2f(16, 24, 2, True),
    "c2f_n1": lambda M: M.C2f(16, 16, 1, False),
    "sppf": lambda M: M.SPPF(16, 24, 5),
    "repvgg_s2": lambda M: M.RepVGGBlock(8, 16, 3, 2),
    "repvgg_identity": lambda M: M.RepVGGBlock(16, 16, 3, 1),
}


@pytest.mark.parametrize("fused", [False, True], ids=["train_form", "fused"])
@pytest.mark.parametrize("name", list(MODULES))
def test_module_matches_jax(name, fused):
    jm, tm = MODULES[name](JM), MODULES[name](TM)
    variables = randomize(jm.init(jax.random.PRNGKey(0)), np.random.default_rng(0))
    load_port(tm, variables)
    if fused:
        variables = jax.tree_util.tree_map(np.asarray, jm.fuse_vars(variables))
        fuse_port(tm)
        # the fold is the same float32 arithmetic in both packages
        want = {k.removeprefix("model.0."): v for k, v in from_jax_variables({"0": variables}).items()}
        got = tm.state_dict()
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    c1 = next(m for m in tm.modules() if isinstance(m, torch.nn.Conv2d)).in_channels
    x = np.random.default_rng(1).standard_normal((2, 16, 16, c1)).astype(np.float32)
    y_jax = np.asarray(jm(variables, jnp.asarray(x), CTX))
    with torch.no_grad():
        y_torch = nhwc(tm.eval()(nchw(x)))
    assert y_jax.shape == y_torch.shape
    np.testing.assert_allclose(y_torch, y_jax, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("nc", [3, 80])
def test_detect_matches_jax(nc):
    ch = (16, 32, 64, 64)
    jm, tm = JM.Detect(nc, ch), TM.Detect(nc, ch)
    variables = randomize(jm.init(jax.random.PRNGKey(0)), np.random.default_rng(0))
    load_port(tm, variables)
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((2, 32 // 2**i, 24 // 2**i, c)).astype(np.float32) for i, c in enumerate(ch)]
    preds_jax, maps_jax = jm(variables, [jnp.asarray(x) for x in xs], CTX)
    with torch.no_grad():
        preds_torch, maps_torch = tm.eval()([nchw(x) for x in xs])
    for a, b in zip(maps_jax, maps_torch):
        np.testing.assert_allclose(nhwc(b), np.asarray(a), rtol=TOL, atol=TOL)
    assert preds_torch.dtype == torch.float32 and preds_torch.shape == (2, sum(32 * 24 // 4**i for i in range(4)), 4 + nc)
    np.testing.assert_allclose(preds_torch.numpy(), np.asarray(preds_jax), rtol=TOL, atol=TOL)


def test_detect_bias_init_matches_jax():
    ch = (16, 32, 64, 64)
    jm, tm = JM.Detect(80, ch), TM.Detect(80, ch)
    want = jm.bias_init_vars(jm.init(jax.random.PRNGKey(0)), imgsz=640)
    tm.bias_init(640)
    for i in range(4):
        np.testing.assert_array_equal(tm.cv2[i][2].bias.detach().numpy(), np.asarray(want["cv2"][str(i)]["m"]["2"]["bias"]))
        np.testing.assert_allclose(tm.cv3[i][2].bias.detach().numpy(), np.asarray(want["cv3"][str(i)]["m"]["2"]["bias"]), rtol=1e-6)


def test_dfl_expectation_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 50, 64)).astype(np.float32) * 4
    np.testing.assert_allclose(TM.dfl_expectation(torch.from_numpy(x)).numpy(), np.asarray(JM.dfl_expectation(jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_max_pool_padding_never_wins():
    x = -np.abs(np.random.default_rng(4).standard_normal((1, 7, 9, 3))).astype(np.float32) - 1.0
    want = np.asarray(JM.max_pool2d(jnp.asarray(x), 5, 1, 2))
    np.testing.assert_array_equal(nhwc(torch.nn.functional.max_pool2d(nchw(x), 5, 1, 2)), want)


@pytest.mark.parametrize("name", FLAGSHIP_YAMLS)
def test_yaml_subset_reader_matches_pyyaml(name):
    text = (MODEL_CFG_DIR / "v8" / name).read_text()
    assert load_yaml(text) == yaml.safe_load(text)


def test_yaml_subset_reader_scalars():
    text = "a: 1   # c\nb: [1.5, 'x # y', \"q\", None, null, True, no, -3, ~]\nc:\n  d: [[1, 2], []]\n  e:\nf:\n- [x, 1]\n- [y, 2]\n"
    assert load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("name", ["yolov8n.yaml", "yolov8n-p2.yaml", "yolov8n-p2-repvgg.yaml", "yolov8n-p2-repvgg-sf.yaml",
                                  "yolov8s-p2-repvgg-sf.yaml"])
def test_param_count_matches_jax(name):
    jmodel = JDetectionModel(name)
    shapes = jax.eval_shape(jmodel.init_raw, jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    tmodel = DetectionModel(name)
    assert tmodel.param_count() == want
    assert tmodel.head.stride == jmodel.head.stride
    assert tmodel.save == jmodel.save and tmodel.ch_list == jmodel.ch_list


def test_make_anchors_and_dist2bbox_match_jax():
    shapes, strides = [(8, 12), (4, 6), (2, 3)], [8, 16, 32]
    a_j, s_j = janchors.make_anchors(shapes, strides)
    a_t, s_t = tanchors.make_anchors(shapes, strides)
    np.testing.assert_array_equal(a_t.numpy(), a_j)
    np.testing.assert_array_equal(s_t.numpy(), s_j)
    d = np.random.default_rng(5).random((2, len(a_j), 4)).astype(np.float32) * 10
    want = np.asarray(janchors.dist2bbox(jnp.asarray(d), jnp.asarray(a_j)[None], xywh=True))
    np.testing.assert_array_equal(tanchors.dist2bbox(torch.from_numpy(d), a_t[None]).numpy(), want)


def test_box_ops_match_jax():
    rng = np.random.default_rng(6)
    b = (rng.random((5, 4)) * 200 - 20).astype(np.float32)
    np.testing.assert_array_equal(tboxes.xywh2xyxy(torch.from_numpy(b)).numpy(), np.asarray(jboxes.xywh2xyxy(jnp.asarray(b))))
    np.testing.assert_array_equal(tboxes.clip_boxes(torch.from_numpy(b), (96, 160)).numpy(), np.asarray(jboxes.clip_boxes(jnp.asarray(b), (96, 160))))
    for img1, img0 in [((128, 128), (96, 160)), ((640, 640), (720, 1280)), ((128, 160), (100, 80))]:
        want = np.asarray(jboxes.scale_boxes(img1, jnp.asarray(b), img0))
        np.testing.assert_allclose(tboxes.scale_boxes(img1, torch.from_numpy(b), img0).numpy(), want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("hw", [(96, 160), (50, 70), (100, 100), (128, 128), (720, 1280), (300, 200)])
def test_letterbox_matches_jax_device_letterbox(hw):
    assert letterbox_params(hw, (128, 128)) == jletterbox_params(hw, (128, 128))
    x = np.random.default_rng(7).random((2, *hw, 3), dtype=np.float32)
    want = letterbox_device(jnp.asarray(x), (128, 128))[0]
    np.testing.assert_allclose(nhwc(letterbox(nchw(x), (128, 128))), np.asarray(want), rtol=0, atol=LETTERBOX_TOL)

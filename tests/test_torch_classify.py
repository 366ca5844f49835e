"""Classification in the port against the JAX package, on the CPU in float32.

Every comparison starts from one set of weights that crosses by the bridge (`to_jax_variables` /
`from_jax_variables`), and every input is made from a numpy seed or written by cv2 into an image folder:

- `Classify` alone (a list input too) and the models of the six classification yamls: yolov8-cls, yolo11-cls and
  yolo12-cls at scale n, a narrow yaml of `ResNetLayer` rows (the stem, blocks with and without `short`, a stride-2
  layer) and yolo11-cls-resnet18 (`TorchVision`), in eval mode (probabilities) and train mode (logits), within
  rtol 1e-5 + atol 1e-4; the layer plan of all six yamls (widths, variable count) against the JAX build; `Classify`'s
  pool and linear in float32 under bfloat16 autocast;
- the bridge both ways bitwise (the transposed linear, the ResNet and TorchVision trunk names, fused and unfused),
  the npz checkpoint read back by both packages and the resume state;
- `check_cls_dataset` (val/, validation/, the datasets directory, a missing folder) and `ClassificationDataset` item
  for item against the JAX one over several epochs: the same crop windows and flips exactly, pixels within 1 grey
  level with at least 99.5% equal (`resize_linear_u8` against `cv2.resize`), the collated batch;
- `YOLO.val` top-1 and top-5 exactly as the JAX facade's on the same weights and folder, and with tied probabilities
  the JAX package's order (the lower index first);
- `YOLO.predict` probabilities and `Probs` (ties included), and `save_txt`, `summary`, `verbose`, `to_json` and
  `plot` (tests/test_torch_plotting.py's check: bit for bit outside the text, and everywhere with the port's glyphs)
  against the JAX package's.
"""

import functools

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import spread_weights
from drone_yolo_tpu import YOLO as JaxYOLO
from drone_yolo_tpu.data import dataset as jax_dataset
from drone_yolo_tpu.data import utils as jax_data_utils
from drone_yolo_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from drone_yolo_tpu.engine.results import Probs as JaxProbs
from drone_yolo_tpu.engine.results import Results as JaxResults
from drone_yolo_tpu.models.yolo.classify import ClassificationValidator as JaxClassificationValidator
from drone_yolo_tpu.nn import modules as JM
from drone_yolo_tpu.nn.model import ClassificationModel as JClassificationModel
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.cfg import MODEL_CFG_DIR
from drone_yolo_tpu_torch.data import dataset as port_dataset
from drone_yolo_tpu_torch.data.utils import check_cls_dataset
from drone_yolo_tpu_torch.engine.checkpoint import (flatten_tree, from_jax_variables, load_checkpoint,
                                                    read_resume_state, resume_state, save_checkpoint,
                                                    to_jax_variables, unflatten_tree)
from drone_yolo_tpu_torch.engine.results import Probs, Results
from drone_yolo_tpu_torch.nn import modules as TM
from drone_yolo_tpu_torch.nn.build import load_yaml
from drone_yolo_tpu_torch.nn.model import ClassificationModel
from test_torch_modules import load_port, nchw, randomize
from test_torch_plotting import assert_equal_but_glyphs, label_boxes, port_glyphs

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)  # the forward bar (tests/test_torch_families.py)
RESIZE_EQUAL_SHARE = 0.995  # resize_linear_u8 against cv2.resize away from integer factors (tests/test_torch_predict.py)
NC = 7
IMGSZ = 32
CLS_YAMLS = ["yolov8-cls.yaml", "yolo11-cls.yaml", "yolo12-cls.yaml", "yolov8-cls-resnet50.yaml",
             "yolov8-cls-resnet101.yaml", "yolo11-cls-resnet18.yaml"]
# the ResNetLayer rows of yolov8-cls-resnet50 at narrow widths: the stem, a stride-1 layer whose first block widens
# (`short` 1x1), a stride-2 layer (`short` 1x1 stride 2, cv2 3x3 stride 2) and blocks without `short`
NARROW_RESNET = """nc: 7
backbone:
  - [-1, 1, ResNetLayer, [3, 16, 1, True, 1]]
  - [-1, 1, ResNetLayer, [16, 8, 1, False, 2]]
  - [-1, 1, ResNetLayer, [32, 16, 2, False, 2]]
head:
  - [-1, 1, Classify, [nc]]
"""


@pytest.fixture(scope="module")
def narrow_resnet(tmp_path_factory):
    path = tmp_path_factory.mktemp("yaml") / "resnet-narrow-cls.yaml"
    path.write_text(NARROW_RESNET)
    return str(path)


def write_folder(root, nc=NC, n_train=3, n_val=2, seed=0, val_name="val"):
    """An image folder (train/ and val_name/, a folder per class) of JPEG and PNG images of mixed sizes and aspects,
    each class a colour cast over noise, written by cv2."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), (val_name, n_val)):
        for c in range(nc):
            d = root / split / f"class{c}"
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                h, w = int(rng.integers(28, 90)), int(rng.integers(28, 90))
                im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                im[..., c % 3] = np.clip(im[..., c % 3].astype(int) // 2 + 30 * c, 0, 255)
                cv2.imwrite(str(d / f"{i}.{'png' if (i + c) % 3 == 0 else 'jpg'}"), im)
    return root


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_folder(tmp_path_factory.mktemp("cls"))


@functools.lru_cache(maxsize=None)
def _jax_model(cfg, nc=None):
    return JClassificationModel(cfg, nc=nc)


def _pair(cfg, nc=NC, seed=0, gain=1.0):
    """(port model in eval mode, JAX model, JAX variables): the port's init with its kernels and BN statistics redrawn
    (`spread_weights`) and the linear's weights scaled by `gain` (10 spreads the probabilities)."""
    port = ClassificationModel(cfg, nc=nc)
    port.init(seed, imgsz=IMGSZ)
    sd = spread_weights(port.state_dict(), np.random.default_rng(seed))
    for k in sd:
        if k.endswith("linear.weight"):
            sd[k] = sd[k] * gain
    port.load_state_dict(sd)
    return port.eval(), _jax_model(cfg, nc), to_jax_variables(port.state_dict())


def _jax_forward(ref, variables, x, train):
    def run(v, x):
        ctx = JM.Ctx(train=train, dtype=jnp.float32)
        return ref.apply(v, x, ctx=ctx), ctx.updates

    return jax.jit(run)(variables, jnp.asarray(x))


# -- modules and models ------------------------------------------------------------------------------------------------
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("inputs", [1, 2])
def test_classify_head_matches_jax(train, inputs):
    """Classify on one map, or on a list of two concatenated on channels: probabilities in eval, logits in train."""
    rng = np.random.default_rng(inputs)
    xs = [rng.standard_normal((2, 6, 5, 8 * (j + 1))).astype(np.float32) for j in range(inputs)]
    c1 = sum(x.shape[-1] for x in xs)
    ref, port = JM.Classify(c1, NC), TM.Classify(c1, NC)
    variables = randomize(ref.init(jax.random.PRNGKey(0)), rng)
    variables["linear"]["bias"] = rng.normal(0, 0.5, NC).astype(np.float32)
    load_port(port, variables)
    port.train(train)
    ctx = JM.Ctx(train=train, dtype=jnp.float32)
    want = ref(variables, [jnp.asarray(x) for x in xs] if inputs > 1 else jnp.asarray(xs[0]), ctx)
    with TM.collect_bn_stats():
        got = port([nchw(x) for x in xs] if inputs > 1 else nchw(xs[0]))
    assert got.shape == (2, NC) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    if not train:
        np.testing.assert_allclose(got.sum(1).detach().numpy(), 1.0, rtol=0, atol=1e-6)


def test_classify_pool_and_linear_stay_float32_under_autocast(monkeypatch):
    """Under bfloat16 autocast the conv runs in bfloat16 and the pool and linear in float32, as the JAX head does
    whatever the compute dtype: the linear sees float32 operands."""
    head = TM.Classify(16, NC).train()
    seen = []
    real = torch.nn.functional.linear
    monkeypatch.setattr(torch.nn.functional, "linear", lambda x, w, b=None: seen.append((x.dtype, w.dtype)) or real(x, w, b))
    head.conv.register_forward_hook(lambda m, a, out: seen.append(out.dtype))
    with torch.autocast("cpu", dtype=torch.bfloat16), TM.collect_bn_stats():
        y = head(torch.randn(2, 16, 4, 4))
    assert seen == [torch.bfloat16, (torch.float32, torch.float32)] and y.dtype == torch.float32


def _forward_case(cfg, train):
    port, ref, variables = _pair(cfg)
    x = np.random.default_rng(1).random((2, 64, 48, 3), dtype=np.float32)
    want, updates = _jax_forward(ref, variables, x, train)
    port.train(train)
    with torch.no_grad(), TM.collect_bn_stats() as stats:
        got = port(nchw(x))
    assert got.shape == (2, NC) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if train:
        assert len(stats) == len(updates) > 0
    else:
        np.testing.assert_allclose(got.sum(1).numpy(), 1.0, rtol=0, atol=1e-5)
    return port


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("cfg", ["yolov8n-cls.yaml", "yolo11n-cls.yaml", "yolo12n-cls.yaml", "yolo11-cls-resnet18.yaml"])
def test_model_forward_matches_jax(cfg, train):
    port = _forward_case(cfg, train)
    if cfg.startswith("yolo12"):  # A2C2f [512, True, 4] at P4: area attention in 4 stripes
        assert [m.area for m in port.modules() if isinstance(m, TM.AAttn)][:2] == [4, 4]


@pytest.mark.parametrize("train", [False, True])
def test_resnet_layers_match_jax(narrow_resnet, train):
    port = _forward_case(narrow_resnet, train)
    shorts = [(n, m.conv.stride) for n, m in port.named_modules() if n.endswith(".short")]
    assert shorts == [("model.1.blocks.0.short", (1, 1)), ("model.2.blocks.0.short", (2, 2))]


@pytest.mark.parametrize("name", CLS_YAMLS)
def test_layer_plan_matches_jax(name):
    """Each classification yaml at the default scale: the yaml read as PyYAML reads it, the variable count and the
    output widths of the JAX build; a Classify row is not width-scaled (c2 == nc)."""
    import yaml

    folder = "11" if name.startswith("yolo11") else "12" if name.startswith("yolo12") else "v8"
    text = (MODEL_CFG_DIR / folder / name).read_text()
    assert load_yaml(text) == yaml.safe_load(text)
    cfg = name if "resnet" in name else name.replace("-cls", "n-cls")
    jmodel = _jax_model(cfg)
    shapes = jax.eval_shape(jmodel.init_raw, jax.random.PRNGKey(0))
    port = ClassificationModel(cfg)
    assert port.param_count() == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert port.ch_list == jmodel.ch_list and port.nc == jmodel.nc
    assert port.head.linear.out_features == port.nc and port.head.stride == [1]
    assert [type(m).__name__ for m in port.model] == [type(s.module).__name__ for s in jmodel.layers]


def test_torchvision_refusals_and_names():
    """`weights` is accepted with a warning; other trunks and options are refused as in the JAX package; the state
    dict has the reference's names."""
    for kw in ({"model": "resnet50"}, {"unwrap": False}, {"truncate": 1}, {"split": True}):
        with pytest.raises(NotImplementedError, match="native TorchVision trunk"):
            TM.TorchVision(**kw)
        with pytest.raises(NotImplementedError, match="native TorchVision trunk"):
            JM.TorchVision(**kw)
    with pytest.warns(UserWarning, match="no pretrained weights are loaded"):
        TM.TorchVision("resnet18", weights="DEFAULT")  # accepted and initialised at random, as in the JAX package
    names = set(TM.TorchVision("resnet34", weights=None).state_dict())
    assert {"m.0.weight", "m.1.running_var", "m.4.2.conv2.weight", "m.5.0.downsample.0.weight",
            "m.7.2.bn2.bias"} <= names
    assert not any(n.startswith("m.4.0.downsample") for n in names)


# -- the bridge --------------------------------------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", ["yolov8n-cls.yaml", "yolo11-cls-resnet18.yaml", "narrow"])
def test_bridge_round_trips_bitwise(cfg, narrow_resnet, tmp_path):
    """A JAX variables tree (the JAX init's structure, seeded normal leaves) -> state_dict -> JAX tree bitwise, fused
    and unfused; the npz read back by both packages; the resume state."""
    cfg = narrow_resnet if cfg == "narrow" else cfg
    rng = np.random.default_rng(4)
    jmodel = _jax_model(cfg)
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                                  jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    tree = unflatten_tree({k: np.abs(v) if k.endswith("/var") else v for k, v in flatten_tree(tree).items()})
    for variables, fuse in ((tree, False), (jax.tree_util.tree_map(np.asarray, jmodel.fuse(tree)), True)):
        sd = from_jax_variables(variables)
        want = flatten_tree(variables)
        back = flatten_tree(to_jax_variables(sd))
        assert back.keys() == want.keys()
        assert all(np.array_equal(back[k], want[k]) for k in want)
        port = ClassificationModel(cfg)
        if fuse:
            port.fuse()
        port.load_state_dict(sd, strict=True)
        head = str(len(port.model) - 1)
        assert np.array_equal(sd[f"model.{head}.linear.weight"].numpy(), variables[head]["linear"]["kernel"].T)

    port = ClassificationModel(cfg)
    port.load_state_dict(from_jax_variables(tree), strict=True)
    path = save_checkpoint(tmp_path / "w.npz", port, port.state_dict())
    loaded, header = load_checkpoint(path)
    assert header["task"] == "classify" and header["stride"] == [1.0] and isinstance(loaded, ClassificationModel)
    for k, v in port.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    jax_vars = flatten_tree(jax.tree_util.tree_map(np.asarray, jax_load_checkpoint(path)[1]))
    want = flatten_tree(tree)
    assert jax_vars.keys() == want.keys() and all(np.array_equal(jax_vars[k], want[k]) for k in want)

    ts = {"params": port.state_dict(), "opt": {"momentum": {n: p.detach() * 2 for n, p in port.named_parameters()}},
          "ema": port.state_dict(), "step": 3, "count": 0}
    np.savez(tmp_path / "resume_state.npz", **resume_state(ts, epoch=1))
    got, epoch = read_resume_state(tmp_path / "resume_state.npz")
    assert epoch == 1 and got["step"] == 3
    for k, v in ts["opt"]["momentum"].items():
        assert torch.equal(got["opt"]["momentum"][k], v), k


# -- data --------------------------------------------------------------------------------------------------------------
def test_check_cls_dataset_matches_jax(tmp_path, monkeypatch):
    """train/, val/ or validation/, test/, sorted names; a name under $YOLO_DATASETS_DIR; a missing folder (the
    default imagenet10 among them) raises FileNotFoundError, as the JAX function does."""
    a = write_folder(tmp_path / "a", nc=3, n_train=1, n_val=1)
    b = write_folder(tmp_path / "datasets" / "b", nc=2, n_train=1, n_val=1, val_name="validation")
    (b / "test" / "class0").mkdir(parents=True)
    monkeypatch.setenv("YOLO_DATASETS_DIR", str(tmp_path / "datasets"))
    monkeypatch.setattr(jax_data_utils, "DATASETS_DIR", tmp_path / "datasets")
    for d in (a, b, "b"):
        got, want = check_cls_dataset(d), jax_data_utils.check_cls_dataset(d)
        assert got == want, d
    assert check_cls_dataset("b")["val"].name == "validation" and check_cls_dataset("b")["test"] is not None
    for missing in ("imagenet10", tmp_path / "nope"):
        with pytest.raises(FileNotFoundError):
            jax_data_utils.check_cls_dataset(missing)
        with pytest.raises(FileNotFoundError, match="not found"):
            check_cls_dataset(missing)
    (tmp_path / "c" / "val").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="missing train"):
        check_cls_dataset(tmp_path / "c")


def _recorded_items(ds, resize_owner, attr, wrap, epochs):
    """Every item of `ds` at each epoch, with the arrays its resize was given (its crop window's pixels)."""
    crops = []
    real = getattr(resize_owner, attr)

    def spy(im, *a, **kw):
        crops.append(np.array(im))
        return real(im, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resize_owner, attr, wrap(spy))
        items = []
        for e in epochs:
            ds.set_epoch(e, 3)
            items += [ds[i] for i in range(len(ds))]
    return items, crops


@pytest.mark.parametrize("augment", [True, False])
def test_dataset_items_match_jax(folder, augment):
    """Over 3 epochs (train) every item against the JAX dataset's: the same label, the same crop window (the pixels
    handed to the resize, exactly: both decoders equal cv2's), the same flip, and the final pixels within 1 grey level
    with at least 99.5% equal."""
    split = folder / ("train" if augment else "val")
    epochs = (0, 1, 2) if augment else (0,)
    port = port_dataset.ClassificationDataset(split, imgsz=IMGSZ, augment=augment)
    ref = jax_dataset.ClassificationDataset(split, imgsz=IMGSZ, augment=augment)
    assert port.samples == ref.samples and len(port) == (3 * NC if augment else 2 * NC)
    got, got_crops = _recorded_items(port, port_dataset.ClassificationDataset, "_resize", staticmethod, epochs)
    want, want_crops = _recorded_items(ref, cv2, "resize", lambda f: f, epochs)
    assert len(got_crops) == len(want_crops) == len(got)
    diffs = []
    for g, w, gc, wc in zip(got, want, got_crops, want_crops):
        assert g["cls"] == w["cls"] and g["img"].shape == w["img"].shape == (IMGSZ, IMGSZ, 3)
        assert gc.shape == wc.shape and np.array_equal(gc, wc)
        diffs.append(np.abs(g["img"].astype(int) - w["img"]))
    d = np.stack(diffs)
    share = float((d == 0).mean())
    print(f"augment={augment}: {share:.5f} of values equal to the JAX dataset's, largest difference {d.max()}")
    assert d.max() <= 1 and share >= RESIZE_EQUAL_SHARE
    if augment:  # the flips: each item is its resized crop or the crop's mirror, the same one in both
        windows = [wc.shape for wc in want_crops]
        assert len(set(windows)) > 3  # the windows vary from draw to draw
        batch, ref_batch = port.collate(got[:4]), ref.collate(want[:4])
        assert batch["cls"].dtype == ref_batch["cls"].dtype == np.int32
        assert np.array_equal(batch["cls"], ref_batch["cls"]) and batch["img"].shape == (4, IMGSZ, IMGSZ, 3)
        flips = []
        for i in range(len(got)):
            plain = cv2.resize(want_crops[i], (IMGSZ, IMGSZ))
            flips.append(not np.array_equal(want[i]["img"], plain))
            if flips[-1]:
                assert np.array_equal(want[i]["img"], plain[:, ::-1])
            g_plain = port_dataset.ClassificationDataset._resize(got_crops[i], IMGSZ, IMGSZ)
            assert np.array_equal(got[i]["img"], g_plain[:, ::-1] if flips[-1] else g_plain)
        assert 0 < sum(flips) < len(flips)
    assert len(port_dataset.ClassificationDataset(split, imgsz=IMGSZ, fraction=0.5)) == len(
        jax_dataset.ClassificationDataset(split, imgsz=IMGSZ, fraction=0.5))


def test_dataset_refuses_formats_it_does_not_decode(tmp_path):
    write_folder(tmp_path, nc=2, n_train=1, n_val=1)
    cv2.imwrite(str(tmp_path / "train" / "class1" / "x.bmp"), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(NotImplementedError, match=r"\.bmp images are not decoded"):
        port_dataset.ClassificationDataset(tmp_path / "train")
    assert len(port_dataset.ClassificationDataset(tmp_path / "val")) == 2


# -- validation and prediction -----------------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def facades():
    """(port facade, JAX facade) of yolov8n-cls with NC classes and one set of weights."""
    port_model, ref_model, variables = _pair("yolov8n-cls.yaml", gain=10.0)
    port = YOLO("yolov8n-cls.yaml", device="cpu")
    port.model, port.initialized = port_model, True
    ref = JaxYOLO("yolov8n-cls.yaml")
    ref.model, ref.variables = ref_model, variables
    return port, ref


def test_val_top1_top5_equal_jax(facades, folder):
    port, ref = facades
    got = port.val(data=str(folder), imgsz=IMGSZ, batch=4, workers=2)
    want = ref.val(data=str(folder), imgsz=IMGSZ, batch=4, workers=2)
    assert set(got) == {"metrics/accuracy_top1", "metrics/accuracy_top5", "fitness"}
    assert got == want.results_dict
    assert all(0.0 <= v <= 1.0 for v in got.values()) and port.validator.seen == 2 * NC


def test_val_ties_take_the_lower_index_first(folder):
    """With the linear's weights at zero every image has the bias's probabilities: ties among classes 0, 2, 3, 5 and
    among 1, 6. Both validators take [0, 2, 3, 5, 1] for every image (jax.lax.top_k's order)."""
    port_model, ref_model, _ = _pair("yolov8n-cls.yaml")
    sd = port_model.state_dict()
    sd["model.9.linear.weight"].zero_()
    sd["model.9.linear.bias"].copy_(torch.tensor([0.5, 0.2, 0.5, 0.5, 0.1, 0.5, 0.2]))
    port_model.load_state_dict(sd)
    port = YOLO("yolov8n-cls.yaml", device="cpu")
    port.model, port.initialized = port_model, True
    ref = JaxYOLO("yolov8n-cls.yaml")
    ref.model, ref.variables = ref_model, to_jax_variables(sd)
    got = port.val(data=str(folder), imgsz=IMGSZ, batch=4, workers=2)
    validator = JaxClassificationValidator(args=dict(task="classify", mode="val", data=str(folder), imgsz=IMGSZ, batch=4))
    assert got == validator(model=ref)
    preds = np.concatenate(port.validator.pred)
    assert np.array_equal(preds, np.concatenate(validator.pred))
    assert (preds == [0, 2, 3, 5, 1]).all() and preds.shape == (2 * NC, 5)


def test_predict_probs_and_strings_equal_jax(facades, tmp_path):
    """Frames at integer resize factors (the input pixels equal to cv2's): the probabilities within 1e-5 and the same
    top-1 and top-5. A frame at another factor: the predictor's input within 1 grey level of the JAX one's with at
    least 99.5% equal. Then Results' strings and files as the JAX package's."""
    port, ref = facades
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in ((64, 96), (96, 64), (32, 32), (50, 75))]
    got = port.predict(frames, imgsz=IMGSZ, verbose=False)
    want = ref.predict(source=frames, imgsz=IMGSZ, verbose=False)
    x = port.predictor.preprocess(frames[3:]).permute(0, 2, 3, 1).numpy() * 255
    d = np.abs(np.rint(x).astype(int) - np.rint(ref.predictor.preprocess(frames[3:]) * 255).astype(int))
    assert x.shape == (1, IMGSZ, IMGSZ, 3) and d.max() <= 1 and (d == 0).mean() >= RESIZE_EQUAL_SHARE
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.boxes is None and len(g) == len(w) == NC
        if i < 3:
            np.testing.assert_allclose(g.probs.data, w.probs.data, rtol=1e-5, atol=1e-6)
            assert g.probs.top1 == w.probs.top1 and g.probs.top5 == w.probs.top5
        w.probs.data = g.probs.data  # the strings from equal probabilities
        assert g.verbose() == w.verbose() and g.summary() == w.summary() and g.to_json() == w.to_json()
        g.save_txt(tmp_path / f"p{i}.txt")
        w.save_txt(tmp_path / f"j{i}.txt")
        assert (tmp_path / f"p{i}.txt").read_text() == (tmp_path / f"j{i}.txt").read_text()
    assert len((tmp_path / "p0.txt").read_text().splitlines()) == 5


def test_probs_with_ties_equal_jax():
    data = np.array([0.1, 0.3, 0.3, 0.05, 0.3, 0.1, 0.3, 0.05, 0.2], np.float32)
    for d in (data, data[::-1].copy(), np.full(9, 1 / 9, np.float32)):
        got, want = Probs(d), JaxProbs(d, None)
        assert (got.top1, got.top5, got.top1conf) == (want.top1, want.top5, want.top1conf)
        assert np.array_equal(got.top5conf, want.top5conf) and len(got) == len(want) == 9


@pytest.mark.parametrize("hw", [(120, 160), (90, 72)])
def test_results_plot_equals_jax(hw):
    """The top-5 lines from (8, 8): bit for bit outside their text boxes, and everywhere against the JAX drawing with
    the port's glyphs; `probs=False` draws nothing."""
    rng = np.random.default_rng(hw[0])
    img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    names = {i: n for i, n in enumerate(("goldfish", "tench", "cock", "hen", "ostrich", "robin", "jay"))}
    probs = rng.dirichlet(np.ones(NC)).astype(np.float32)
    port, ref = Results(img, "a.jpg", names, probs=probs), JaxResults(img, "a.jpg", names, probs=probs)
    lw = max(round(sum(img.shape) / 2 * 0.003), 2)
    lines = [(f"{probs[j]:.2f} {names[j]}", (8, 8 + 20 * (i + 1))) for i, j in enumerate(port.probs.top5)]
    got, want = port.plot(), ref.plot()
    assert got.shape == want.shape and not np.array_equal(got, img)
    assert_equal_but_glyphs(got, want, port_glyphs(ref.plot), label_boxes(img.shape, lw, lines), f"probs {hw}")
    assert np.array_equal(port.plot(probs=False), img)

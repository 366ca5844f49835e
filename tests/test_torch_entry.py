"""The port's entry points against the JAX package's: configuration, command line, facade, checkpoints, results files.

The flagship at scale n, imgsz 96, float32 on the CPU, one set of weights (the port's seeded init redrawn by
`chip_smoke.spread_weights`) saved once by the port's `YOLO.save` with train_args imgsz 96:

- `DEFAULT_CFG` holds the JAX package's key set and defaults (botsort.yaml the tracker) and its type groups;
- `entrypoint` over a table of command lines gives each package's `YOLO` (a recorder here) the same model, task,
  mode and arguments; special words and bad words behave alike;
- `YOLO("last.npz")` carries the checkpoint's train_args into predict: with no imgsz both facades predict at 96 and
  give the same boxes (ROADMAP.md queue 3 item 1); `save` then `load` round-trips; `load` transfers what the
  JAX facade's `load` transfers; `embed` equals the JAX facade's;
- `save_txt` label lines equal the JAX predictor's on a directory of images; `save_crop` numbers the crops of one
  class instead of overwriting them;
- refusals by name and user callbacks reaching the predictor.

The command line (predict over a directory with PNG and AVI, track, val) and `DroneVideoPipeline.run("clip.avi")`
with jax, cv2, PIL, yaml and sklearn blocked run in the subprocess of tests/test_torch_apps.py.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import drone_yolo_tpu.cfg as jax_cfg
import drone_yolo_tpu.engine.model as jax_model
import drone_yolo_tpu_torch.cfg as port_cfg
import drone_yolo_tpu_torch.engine.model as port_model
from chip_smoke import spread_weights
from drone_yolo_tpu import YOLO as JaxYOLO
from drone_yolo_tpu.utils import DEFAULT_CFG_DICT as JAX_DEFAULTS
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.engine.results import Results
from drone_yolo_tpu_torch.nn.build import load_yaml

torch.set_num_threads(1)

FLAGSHIP_N = "yolov8n-p2-repvgg-sf.yaml"
IMGSZ = 96
PREDICT = dict(conf=0.0, max_det=20, dtype="float32", verbose=False)  # no imgsz: it comes from the checkpoint


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(the port's last.npz with train_args imgsz 96, a directory of 2 JPEGs and a PNG, their BGR frames)."""
    d = tmp_path_factory.mktemp("entry")
    m = YOLO(FLAGSHIP_N, device="cpu")
    m.ensure_variables(imgsz=IMGSZ, seed=0)
    m.model.load_state_dict(spread_weights(m.model.state_dict(), np.random.default_rng(0)))
    m.overrides["imgsz"] = IMGSZ
    m.save(d / "last.npz")
    rng = np.random.default_rng(1)
    (d / "imgs").mkdir()
    frames = {}
    for name, hw in (("a.jpg", (96, 160)), ("b.png", (120, 90)), ("c.jpg", (64, 64))):
        frames[name] = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        cv2.imwrite(str(d / "imgs" / name), frames[name])
        if name.endswith(".jpg"):  # what the decoders see
            frames[name] = cv2.imread(str(d / "imgs" / name))
    return d / "last.npz", d / "imgs", frames


@pytest.fixture(scope="module")
def predictions(ckpt, tmp_path_factory):
    """Both facades from last.npz over the directory, with save_txt: (port, JAX facade, their Results, runs dir)."""
    path, imgs, _ = ckpt
    runs = tmp_path_factory.mktemp("runs")
    port, ref = YOLO(path, device="cpu"), JaxYOLO(str(path))
    args = dict(PREDICT, save_txt=True, save_conf=True, project=str(runs), exist_ok=True)
    return port, ref, port.predict(str(imgs), name="port", **args), ref.predict(str(imgs), name="jax", **args), runs


def test_default_cfg_matches_jax():
    port = dict(port_cfg.DEFAULT_CFG)
    assert port["tracker"] == JAX_DEFAULTS["tracker"] == "botsort.yaml"
    assert port.pop("s2grad") is None and port.pop("bnstats") is None
    assert port == JAX_DEFAULTS
    for group in ("CFG_FLOAT_KEYS", "CFG_FRACTION_KEYS", "CFG_INT_KEYS", "CFG_BOOL_KEYS"):
        assert getattr(port_cfg, group) == getattr(jax_cfg, group), group
    assert load_yaml(port_cfg.yaml_text(port_cfg.DEFAULT_CFG)) == port_cfg.DEFAULT_CFG


class Recorder:
    """Stands in for a package's YOLO: records (model, task, mode, overrides) of each mode call."""

    calls: list = []

    def __init__(self, model, task=None, **kwargs):
        self.model, self.task_arg, self.task = model, task, task or "detect"

    def __getattr__(self, mode):
        if mode in jax_cfg.MODES:
            return lambda **overrides: Recorder.calls.append((self.model, self.task_arg, mode, overrides))
        raise AttributeError(mode)


ARGV = [
    "yolo predict model=last.npz source=imgs/ imgsz=320 conf=0.3",
    "yolo detect val data=data.yaml batch=4 rect=False",
    "yolo train model=yolov8n.yaml data=d.yaml epochs=3 lr0=0.02 cache=True name=7",
    "yolo track m.npz source=clip.avi tracker=bytetrack.yaml classes=[0,2] persist=True",
    "yolo predict",
    "yolo val",
    "yolo pose predict source=a.jpg half=false",
    "yolo mode=val model=m.yaml data=d.yaml",
    "yolo model=sub/m.yaml",
    "yolo predict source=x.jpg save_txt=True save_conf=True project=runs/x name=none iou=.5",
    "yolo train resume=True model=last.npz",
    "yolo export model=m.yaml format=onnx",
    "yolo val cfg={cfg} imgsz=256",
    "yolo help",
]


def _record(pkg_model, monkeypatch, argv):
    Recorder.calls = []
    monkeypatch.setattr(pkg_model, "YOLO", Recorder)
    (jax_cfg if pkg_model is jax_model else port_cfg).entrypoint(argv)
    calls = []
    for model, task, mode, overrides in Recorder.calls:
        if str(overrides.get("source", "")).endswith("assets"):  # each package's default source, its own assets dir
            overrides["source"] = "assets"
        calls.append((model, task, mode, overrides))
    return calls


@pytest.mark.parametrize("argv", ARGV)
def test_entrypoint_matches_jax(argv, monkeypatch, tmp_path):
    (tmp_path / "c.yaml").write_text("imgsz: 320\nconf: 0.2\nbatch: 2\n")
    argv = argv.format(cfg=tmp_path / "c.yaml")
    got, want = _record(port_model, monkeypatch, argv), _record(jax_model, monkeypatch, argv)
    assert got == want
    assert len(got) == (0 if argv.endswith("help") else 1)


def test_entrypoint_words(monkeypatch, tmp_path, caplog):
    for pkg in (jax_cfg, port_cfg):
        with pytest.raises(SyntaxError, match="not a valid argument"):
            pkg.entrypoint("yolo predict bogus")
    tokens = ["predict", "imgsz", "=", "320", "source=", "a.jpg", "conf", "=0.5"]
    assert port_cfg.merge_equals_args(tokens) == ["predict", "imgsz=320", "source=a.jpg", "conf=0.5"]  # the JAX copy
    # keeps "320" and "a.jpg" as tokens too, and the JAX entrypoint does not merge
    assert _record(port_model, monkeypatch, "yolo predict imgsz = 320 source= a.jpg") == \
           [("yolov8n.yaml", None, "predict", {"imgsz": 320, "source": "a.jpg"})]
    monkeypatch.chdir(tmp_path)
    caplog.set_level("INFO", logger="drone_yolo_tpu_torch")
    for word in ("copy-cfg", "checks", "version", "cfg"):
        port_cfg.entrypoint(f"yolo {word}")
    assert load_yaml((tmp_path / "default_copy.yaml").read_text()) == port_cfg.DEFAULT_CFG
    assert "torch " in caplog.text and "0.1.0" in caplog.text and "rect_max_shapes: 8" in caplog.text


def test_refusals_by_name(ckpt, tmp_path):
    path, imgs, _ = ckpt
    saved = YOLO(path, device="cpu").predict(str(imgs), save=True, dtype="float32", project=str(tmp_path), name="s",
                                             verbose=False)
    assert sorted(p.name for p in (tmp_path / "s").iterdir()) == ["a.jpg", "b.png", "c.jpg"]  # save is ported now
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "s" / "b.png")), saved[1].plot())
    m = YOLO(path, device="cpu")
    for key in ("show", "visualize", "augment"):
        with pytest.raises(KeyError, match=f"{key}=True"):
            m.predict(str(imgs), **{key: True})
    with pytest.raises(KeyError, match="save_json=True"):
        m.val(data="d.yaml", save_json=True)
    with pytest.raises(KeyError, match="device_aug=True"):
        m.train(data="d.yaml", device_aug=True)
    with pytest.raises(KeyError, match="unsupported arguments"):
        m.predict(str(imgs), no_such_key=1)
    for mode in ("tune", "benchmark", "export"):
        with pytest.raises(NotImplementedError, match=f"{mode}.*not ported"):
            getattr(m, mode)()
    orb = tmp_path / "orb.yaml"  # BoT-SORT is ported with sparseOptFlow motion compensation; ORB's is not
    orb.write_text((port_cfg.TRACKER_CFG_DIR / "botsort.yaml").read_text().replace("sparseOptFlow #", "orb #"))
    with pytest.raises(NotImplementedError, match="gmc_method 'orb' is not ported"):
        m.track(str(imgs), tracker=str(orb))
    r = Results(np.zeros((4, 4, 3), np.uint8), str(tmp_path / "x.png"), {0: "a"}, boxes=np.zeros((0, 6)))
    np.testing.assert_array_equal(r.plot(), r.orig_img)
    assert r.save(tmp_path / "r.png") == tmp_path / "r.png"
    with pytest.raises(NotImplementedError, match="display library"):
        r.show()


def test_checkpoint_train_args_carry_into_predict(ckpt, predictions):
    """ROADMAP.md queue 3 item 1: a checkpoint written at imgsz 96 predicts at 96 with no imgsz passed, with the JAX
    facade's boxes."""
    port, ref, got, want, _ = predictions
    assert port.overrides["imgsz"] == ref.overrides["imgsz"] == IMGSZ
    assert {k: v for k, v in port.overrides.items() if k != "model"} == {k: v for k, v in ref.overrides.items() if k != "model"}
    assert port.predictor.imgsz == (IMGSZ, IMGSZ) and tuple(ref.predictor.imgsz) == (IMGSZ, IMGSZ)
    assert [Path(r.path).name for r in got] == [Path(r.path).name for r in want] == ["a.jpg", "b.png", "c.jpg"]
    for g, w in zip(got, want, strict=True):
        assert len(g.boxes) == len(w.boxes) == 20
        np.testing.assert_allclose(g.boxes.data[:, :4], w.boxes.data[:, :4], atol=1e-3)
        np.testing.assert_allclose(g.boxes.data[:, 4:], w.boxes.data[:, 4:], atol=1e-5)
    frames = list(ckpt[2].values())
    assert port(frames, save_txt=False, **PREDICT)[0].boxes.data.shape == (20, 6)  # __call__ is predict
    assert got[0].summary()[0].keys() == want[0].summary()[0].keys() and got[0].verbose() == want[0].verbose()


def test_save_load_info_embed(ckpt, tmp_path):
    """`save` then the constructor round-trip the weights and train_args; `load` transfers, by name and shape, what
    the JAX facade's `load` (`intersect_tree`) transfers; `embed` equals the JAX facade's on the same frames."""
    path, _, frames = ckpt
    a = YOLO(path, device="cpu")
    a.save(tmp_path / "copy.npz")
    b = YOLO(tmp_path / "copy.npz", device="cpu")
    assert all(torch.equal(v, b.model.state_dict()[k]) for k, v in a.model.state_dict().items())
    assert b.overrides["imgsz"] == IMGSZ and b.names == a.names and b.stride == a.stride == [4, 8, 16, 32]
    assert a.info(verbose=False).startswith("DetectionModel: ") and "task=detect" in a.info(verbose=False)
    ref = JaxYOLO(str(path))
    imgs = list(frames.values())[:2]
    layers = [4, len(a.model.model) - 2]  # a C2f of the backbone and the layer before the head
    got, want = a.embed(imgs, layers=layers), ref.embed(imgs, layers=layers)  # both at the checkpoint's imgsz
    assert sorted(got) == sorted(want) == layers and list(a.embed(imgs[:1])) == [layers[1]]
    for i in layers:
        assert got[i].dtype == torch.float32 and got[i].shape[0] == 2
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=0, atol=1e-4)
    pose = YOLO("yolov8n-pose.yaml", device="cpu")  # the source of a partial transfer: backbone and box branch
    pose.ensure_variables(imgsz=IMGSZ)
    pose.model.load_state_dict(spread_weights(pose.model.state_dict(), np.random.default_rng(2)))
    pose.save(tmp_path / "pose.npz")
    moved = YOLO(path, device="cpu").load(tmp_path / "pose.npz").model.state_dict()
    ref.load(str(tmp_path / "pose.npz")).save(tmp_path / "jax.npz")
    want = YOLO(tmp_path / "jax.npz", device="cpu").model.state_dict()
    src, dst = pose.model.state_dict(), a.model.state_dict()
    same = {k for k in dst if k in src and src[k].shape == dst[k].shape}
    assert 0 < len(same) < len(dst) and moved.keys() == want.keys() == dst.keys()
    for k, v in moved.items():
        assert torch.equal(v, want[k]) and torch.equal(v, (src if k in same else dst)[k]), k
    assert not a.reset_weights().initialized and a.ensure_variables(imgsz=IMGSZ) is a.model


def test_callbacks_reach_the_predictor(ckpt):
    path, imgs, _ = ckpt
    m, seen = YOLO(path, device="cpu"), []
    m.add_callback("on_predict_start", lambda p: seen.append(("start", type(p).__name__)))
    m.add_callback("on_predict_batch_end", lambda p: seen.append(("batch", len(p.results))))
    m.predict(str(imgs), batch=2, **PREDICT)
    assert seen == [("start", "DetectionPredictor"), ("batch", 2), ("batch", 1)]
    m.clear_callback("on_predict_batch_end")
    m.reset_callbacks()
    m.predictor = None
    m.predict(str(imgs), **PREDICT)
    assert len(seen) == 3


def test_save_txt_matches_jax(predictions):
    runs = predictions[-1]
    files = sorted(p.name for p in (runs / "jax" / "labels").iterdir())
    assert files == ["a.txt", "b.txt", "c.txt"] == sorted(p.name for p in (runs / "port" / "labels").iterdir())
    for name in files:
        got, want = ((runs / k / "labels" / name).read_text().splitlines() for k in ("port", "jax"))
        assert len(got) == len(want) == 20
        for g, w in zip(got, want):
            g, w = np.array(g.split(), float), np.array(w.split(), float)
            assert g[0] == w[0] and len(g) == len(w) == 6
            np.testing.assert_allclose(g[1:], w[1:], atol=2e-5)  # %g keeps 6 digits of float32 boxes


def test_save_crop_numbers_the_crops_of_one_class(tmp_path):
    """Three boxes of one class give three files (the JAX package writes them all to one name)."""
    y, x = np.mgrid[0:40, 0:60]
    img = np.stack([4 * x, 6 * y, 2 * (x + y)], -1).astype(np.uint8)
    boxes = np.array([[0, 0, 20, 10, 0.9, 1], [10, 5, 40, 30, 0.8, 1], [30, 20, 60, 40, 0.7, 1], [5, 5, 5, 9, 0.6, 1]],
                     np.float32)
    written = Results(img, "f.jpg", {1: "car"}, boxes=boxes).save_crop(tmp_path, "frame")
    assert [p.name for p in written] == ["frame.jpg", "frame2.jpg", "frame3.jpg"]  # the no-pixel box writes nothing
    for p, (x1, y1, x2, y2) in zip(written, boxes[:3, :4].astype(int)):
        got = cv2.imread(str(p)).astype(int)
        assert got.shape == (y2 - y1, x2 - x1, 3) and np.abs(got - img[y1:y2, x1:x2]).mean() < 3

"""`save=True` and the train-batch plots of the port against the JAX package, on the CPU.

- `YOLO.predict(save=True)` of both facades, one set of weights, over two JPEGs, a PNG and a 3-frame MJPEG AVI: the
  same file names, except the video, which the port writes as `<stem>.avi` (MJPEG) where the JAX package writes
  `<stem>.mp4` (cv2's MPEG-4 encoder; ROADMAP.md, reference behaviours not copied); the PNG equal to `plot()` bit
  for bit and to the JAX package's PNG outside the label text boxes; the JPEGs and the AVI's frames (read back by
  `cv2.VideoCapture` here) within JPEG quality 95 of `plot()`, their bytes (the AVI's payloads by the port's
  `AviReader`) the port's encoding of `plot()`; the AVI at the source's frame rate, one frame per source frame.
- `YOLO.track(save=True)` over the AVI, and the pose, segment and obb predictors with `save=True`.
- `Results.save` by suffix, `show` refused with its reason.
- `train(plots=True)` writes `train_batch0..2.jpg`; a batch the trainer draws is the encoding of `plot_images`, which
  equals the JAX `plot_images` call of the JAX trainer on the same batch outside the text boxes.
- `check_det_dataset` resolving a yaml and a relative `path:` through `YOLO_DATASETS_DIR` as the JAX one does.
"""

import cv2
import numpy as np
import pytest

import drone_yolo_tpu.data.utils as jax_data_utils
from chip_smoke import moving_frames, scored_weights, synthetic_batch
from make_dataset import make_dataset
from test_torch_plotting import assert_equal_but_glyphs, label_boxes, plot_labels, port_glyphs
from drone_yolo_tpu import YOLO as JaxYOLO
from drone_yolo_tpu.utils import plotting as JP
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.data.avi import AviReader
from drone_yolo_tpu_torch.data.jpeg import encode_jpeg
from drone_yolo_tpu_torch.data.utils import check_det_dataset
from drone_yolo_tpu_torch.engine.results import Results
from drone_yolo_tpu_torch.engine.trainer import BaseTrainer
from drone_yolo_tpu_torch.utils import plotting as PP

PREDICT = dict(imgsz=64, conf=0.25, iou=0.3, dtype="float32", verbose=False, exist_ok=True)
JPEG_MEAN_TOL = 8.0  # grey levels: mean |decoded by cv2 - plot()| of a quality-95 JPEG of these drawn frames


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """A directory of a.jpg, b.jpg, c.png and d.avi (3 frames, 12.5 frames/s), written by cv2."""
    d = tmp_path_factory.mktemp("media")
    frames = moving_frames(np.random.default_rng(0), 6, (96, 128), 6, size=(16, 40))
    cv2.imwrite(str(d / "a.jpg"), frames[0])
    cv2.imwrite(str(d / "b.jpg"), frames[1][:80])
    cv2.imwrite(str(d / "c.png"), frames[2])
    w = cv2.VideoWriter(str(d / "d.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 12.5, (128, 96))
    for f in frames[3:]:
        w.write(f)
    w.release()
    return d


@pytest.fixture(scope="module")
def facades():
    """(port, JAX) facades of yolov8n with one set of weights whose scores pass conf 0.25."""
    port = YOLO("yolov8n.yaml", device="cpu")
    port.ensure_variables(imgsz=64, seed=0)
    port.model.load_state_dict(scored_weights(port.model.state_dict(), np.random.default_rng(0), -2.0, 30.0))
    ref = JaxYOLO("yolov8n.yaml")
    ref.variables = convert_state_dict(ref.model, port.model.state_dict())
    return port, ref


def jpeg(bgr: np.ndarray) -> bytes:
    return encode_jpeg(np.ascontiguousarray(bgr[..., ::-1]), quality=95)


def read_video(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return frames, fps


def test_predict_save_writes_images_and_avi_as_jax(source, facades, tmp_path):
    port, ref = facades
    got = port.predict(str(source), save=True, project=str(tmp_path), name="port", **PREDICT)
    want = ref.predict(str(source), save=True, project=str(tmp_path), name="jax", **PREDICT)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["a.jpg", "b.jpg", "c.png", "d.avi"]
    assert sorted(p.name for p in (tmp_path / "jax").iterdir()) == ["a.jpg", "b.jpg", "c.png", "d.mp4"]
    assert [len(r) for r in got] == [len(r) for r in want] and sum(len(r) for r in got) > 0
    c = got[2]
    png = cv2.imread(str(tmp_path / "port" / "c.png"))
    np.testing.assert_array_equal(png, c.plot())
    lw = max(round(sum(png.shape) / 2 * 0.003), 2)
    text = label_boxes(png.shape, lw, plot_labels(c, lw))
    assert_equal_but_glyphs(png, cv2.imread(str(tmp_path / "jax" / "c.png")), port_glyphs(want[2].plot), text, "c.png")
    for name, r in (("a.jpg", got[0]), ("b.jpg", got[1])):  # the port's encoding of plot(), read back by cv2 too
        assert (tmp_path / "port" / name).read_bytes() == jpeg(r.plot())
        assert np.abs(cv2.imread(str(tmp_path / "port" / name)).astype(np.int16) - r.plot()).mean() < JPEG_MEAN_TOL
    frames, fps = read_video(tmp_path / "port" / "d.avi")
    with AviReader(tmp_path / "port" / "d.avi") as reader:
        assert len(frames) == len(reader) == 3 and fps == reader.fps == 12.5
        for i, r in enumerate(got[3:]):
            assert reader.payload(i) == jpeg(r.plot())
            assert np.abs(frames[i].astype(np.int16) - r.plot()).mean() < JPEG_MEAN_TOL


def test_track_save_writes_the_drawn_tracks(source, facades, tmp_path):
    port, _ = facades
    port.predictor = None
    results = port.track(str(source / "d.avi"), save=True, project=str(tmp_path), name="t", **PREDICT)
    port.predictor = None
    assert [p.name for p in (tmp_path / "t").iterdir()] == ["d.avi"]
    frames, _ = read_video(tmp_path / "t" / "d.avi")
    assert len(frames) == 3 and any(r.boxes.is_track and len(r.boxes) for r in results)
    for f, r in zip(frames, results):
        assert np.abs(f.astype(np.int16) - r.plot()).mean() < JPEG_MEAN_TOL


@pytest.mark.parametrize("model", ["yolov8n-pose.yaml", "yolov8n-seg.yaml", "yolov8n-obb.yaml"])
def test_task_predictors_save(model, source, tmp_path):
    m = YOLO(model, device="cpu")
    m.ensure_variables(imgsz=64, seed=0)
    m.model.load_state_dict(scored_weights(m.model.state_dict(), np.random.default_rng(0), -2.0, 30.0))
    got = m.predict(str(source / "c.png"), save=True, project=str(tmp_path), name="p", **PREDICT)
    assert len(got[0]) > 0
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "p" / "c.png")), got[0].plot())


def test_results_save_by_suffix_and_show_refused(tmp_path):
    img = np.full((48, 64, 3), 90, np.uint8)
    r = Results(img, str(tmp_path / "x.jpg"), {0: "car"}, boxes=np.array([[4, 20, 40, 44, 0.9, 0]], np.float32))
    assert r.save(tmp_path / "r.png") == tmp_path / "r.png"
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "r.png")), r.plot())
    r.save(str(tmp_path / "r.jpg"))
    assert np.abs(cv2.imread(str(tmp_path / "r.jpg")).astype(np.int16) - r.plot()).mean() < JPEG_MEAN_TOL
    with pytest.raises(ValueError, match=".jpg and .png"):
        r.save(tmp_path / "r.bmp")
    with pytest.raises(NotImplementedError, match="display library"):
        r.show()


def test_train_plots_the_first_batches(tmp_path):
    data = make_dataset(tmp_path / "ds", n_train=6, n_val=2, size=96)
    m = YOLO("yolov8n.yaml", device="cpu")
    m.train(data=str(data), epochs=1, imgsz=64, batch=2, nbs=2, workers=0, amp=False, project=str(tmp_path / "runs"),
            name="t", val=False, verbose=False)
    for i in range(3):
        im = cv2.imread(str(tmp_path / "runs" / "t" / f"train_batch{i}.jpg"))
        assert im.shape == (128, 128, 3)  # 2 images in ceil(sqrt(2)) = 2 columns of 64


def test_train_batch_plot_equals_jax(tmp_path):
    batch = synthetic_batch(np.random.default_rng(0), 4, 64, 3)
    names = {0: "car", 1: "van", 2: "bus"}
    t = BaseTrainer(overrides=dict(model="yolov8n.yaml", batch=4, imgsz=64, device="cpu", project=str(tmp_path),
                                   name="p"), train_loader=[batch], data={"nc": 3, "names": names})
    t._setup_train()
    t.save_dir.mkdir(parents=True, exist_ok=True)
    t.plot_training_samples(batch, 1).join()
    valid = batch["mask"].reshape(-1).astype(bool)  # the JAX trainer's call (drone_yolo_tpu/engine/trainer.py)
    bi, cls = np.repeat(np.arange(batch["cls"].shape[0]), batch["cls"].shape[1])[valid], batch["cls"].reshape(-1)[valid]
    boxes = batch["bboxes"].reshape(-1, 4)[valid]
    args = (batch["img"].astype(np.float32) / 255.0, bi, cls, boxes)
    port = PP.plot_images(*args, names=names, threaded=False, save=False)
    want = JP.plot_images(*args, names=names, threaded=False, save=False)
    want_pg = port_glyphs(JP.plot_images, *args, names=names, threaded=False, save=False)
    assert (t.save_dir / "train_batch1.jpg").read_bytes() == jpeg(port)
    labels = []
    for i, c, b in zip(bi, cls, boxes):
        x1, y1 = int(b[0] + 64 * (i // 2)), int(b[1] + 64 * (i % 2))
        labels.append((names[int(c)], (x1, y1 - 2) if y1 - 18 >= 3 else (x1, y1 + 18 + 2)))
    assert_equal_but_glyphs(port, want, want_pg, label_boxes(port.shape, 2, labels), "train batch")


def test_check_det_dataset_resolves_through_datasets_dir(tmp_path, monkeypatch):
    root = tmp_path / "datasets"
    make_dataset(root / "tiny", n_train=1, n_val=1, size=32)
    (root / "tiny" / "data.yaml").unlink()
    (root / "tiny.yaml").write_text("path: tiny\ntrain: images/train\nval: images/val\nminival: images/val\n"
                                    "names: [a, b, c, d]\n")
    monkeypatch.setenv("YOLO_DATASETS_DIR", str(root))
    monkeypatch.setattr(jax_data_utils, "DATASETS_DIR", root)
    monkeypatch.chdir(tmp_path)
    got, want = check_det_dataset("tiny.yaml"), jax_data_utils.check_det_dataset("tiny.yaml")
    assert got["path"] == want["path"] == (root / "tiny").resolve()
    for k in ("train", "val", "minival", "names", "nc", "yaml_file"):
        assert got[k] == want[k], k
    with pytest.raises(FileNotFoundError, match="not found"):
        check_det_dataset("missing.yaml")

"""The port's drawing (`ops/draw.py`, `utils/plotting.py`, `Results.plot`) against cv2 and the JAX package, on the CPU.

- Every `ops/draw.py` call against the installed cv2 (OpenCV 5.0) on seeded cases: lines, rectangle outlines and
  fills, filled circles and polylines, LINE_8 and LINE_AA, thickness 1..7, clipped at the image borders, on 1- and
  3-channel images of random pixels: bit for bit.
- `get_text_size` exactly, at every annotator line width 1..24 for every printable character and random strings.
  `put_text` draws the port's own stroke font: its ink, and OpenCV's, stay inside the text box (OpenCV's reaches up
  to lw / 2 + 1 px left of it), so the image outside the box is untouched by both.
- `add_weighted` (alpha 0.5 as the annotator blends, and others) bit for bit.
- `Annotator`, `Results.plot` (detect, tracks, pose, segment, obb) and `plot_images` against the JAX ones, fed the
  same detections: bit for bit outside the label text boxes (box outlines, label rectangles, masks, keypoints,
  skeletons, rotated boxes). Inside the text boxes the glyphs differ from OpenCV's, so the text is checked twice:
  bit for bit everywhere against the JAX drawing with `cv2.putText` swapped for the port's `put_text` (the same
  strings, origins, scales, colors and thicknesses), and against the JAX drawing with cv2's own glyphs within a mean
  absolute difference of `TEXT_MEAN_TOL` grey levels over the boxes' pixels and channels. The sound port reads
  0.47-18.07 (mean 10.71) there over the 36 labelled `Results.plot` cases, 16.05 and 19.67 in the annotator's parts
  and 10.74 in `plot_images`; blank labels read 1.51-40.26, so the mean alone does not tell them apart. The first
  check does: it fails on all 36 cases drawn with blank labels and on 27 of 36 with one character changed (in the
  rest the changed label lies off the image), and `test_text_check_rejects_wrong_labels` holds that it fails.
- `ConfusionMatrix` against the JAX one exactly, on fed detections and after `YOLO.val(plots=True)`.
"""

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import spread_weights
from make_dataset import make_dataset
from drone_yolo_tpu import YOLO as JaxYOLO
from drone_yolo_tpu.engine.validator import DetectionValidator as JaxDetectionValidator
from drone_yolo_tpu.engine.results import Results as JaxResults
from drone_yolo_tpu.utils import metrics as JMET
from drone_yolo_tpu.utils import plotting as JP
from drone_yolo_tpu.utils.torch_convert import convert_state_dict
from drone_yolo_tpu_torch import YOLO
from drone_yolo_tpu_torch.data.jpeg import decode_jpeg
from drone_yolo_tpu_torch.engine.results import Results
from drone_yolo_tpu_torch.ops import draw
from drone_yolo_tpu_torch.utils import metrics as MET
from drone_yolo_tpu_torch.utils import plotting as PP

TEXT_MEAN_TOL = 24.0  # grey levels: the mean |port - cv2| over the text boxes' pixels and channels (sound: <= 19.67)
PORT_PUT_TEXT = draw.put_text  # kept from before any test swaps it
NAMES = {i: n for i, n in enumerate(("person", "car", "van", "truck", "bus", "motor", "bicycle", "tricycle"))}


def random_case(rng, gray: bool):
    h, w = int(rng.integers(20, 60)), int(rng.integers(20, 60))
    img = rng.integers(0, 256, (h, w) if gray else (h, w, 3), dtype=np.uint8)
    return img, [int(c) for c in rng.integers(-8, 68, 8)], tuple(int(c) for c in rng.integers(0, 256, 3))


@pytest.mark.parametrize("line_type", [cv2.LINE_8, cv2.LINE_AA])
@pytest.mark.parametrize("kind", ["line", "rectangle", "filled", "circle_filled", "polylines_closed", "polylines_open"])
def test_shapes_equal_cv2(kind, line_type):
    rng = np.random.default_rng([line_type, len(kind)])
    for t in range(150):
        img, p, col = random_case(rng, gray=t % 3 == 0)
        th = int(rng.integers(1, 8))
        r = int(rng.integers(0, 15))
        pts = np.array(p, np.int32).reshape(-1, 1, 2)
        if kind == "line":
            want = cv2.line(img.copy(), p[:2], p[2:4], col, th, line_type)
            got = draw.line(img.copy(), p[:2], p[2:4], col, th, line_type)
        elif kind == "rectangle":
            want = cv2.rectangle(img.copy(), p[:2], p[2:4], col, th, line_type)
            got = draw.rectangle(img.copy(), p[:2], p[2:4], col, th, line_type)
        elif kind == "filled":
            want = cv2.rectangle(img.copy(), p[:2], p[2:4], col, -1, line_type)
            got = draw.rectangle(img.copy(), p[:2], p[2:4], col, draw.FILLED, line_type)
        elif kind == "circle_filled":
            want = cv2.circle(img.copy(), p[:2], r, col, -1, line_type)
            got = draw.circle(img.copy(), p[:2], r, col, -1, line_type)
        else:
            closed = kind.endswith("closed")
            want = cv2.polylines(img.copy(), [pts], closed, col, th, line_type)
            got = draw.polylines(img.copy(), [pts], closed, col, th, line_type)
        np.testing.assert_array_equal(got, want, err_msg=f"{kind} case {t}: {p} thickness {th} radius {r}")


def test_text_size_equals_cv2():
    rng = np.random.default_rng(0)
    chars = [chr(c) for c in range(32, 127)]
    for lw in range(1, 25):
        sf, tf = lw / 3, max(lw - 1, 1)
        strings = chars + ["", "person 0.87", "car 1.00", "".join(chars)]
        strings += ["".join(rng.choice(chars, int(rng.integers(1, 24)))) for _ in range(40)]
        for s in strings:
            assert draw.get_text_size(s, sf, tf) == cv2.getTextSize(s, 0, sf, tf), (lw, s)
    with pytest.raises(ValueError, match="lw / 3"):
        draw.get_text_size("a", 0.5, 1)


@pytest.mark.parametrize("lw", [1, 2, 3, 5, 9])
def test_text_stays_inside_its_box(lw):
    sf, tf = lw / 3, max(lw - 1, 1)
    rng = np.random.default_rng(lw)
    chars = [chr(c) for c in range(33, 127)]
    for t in range(6):
        s = "".join(rng.choice(chars, 12)) if t else "person 0.87 jQ|_g"
        (w, h), base = draw.get_text_size(s, sf, tf)
        img = rng.integers(0, 256, (h + base + 20, w + 2 * lw + 20, 3), dtype=np.uint8)
        org = (lw + 10, h + 10)
        box = np.zeros(img.shape[:2], bool)
        box[org[1] - h:org[1] + base + 1, org[0] - (lw // 2 + 1):org[0] + w] = True
        for out in (draw.put_text(img.copy(), s, org, sf, (255, 255, 255), tf, draw.LINE_AA),
                    cv2.putText(img.copy(), s, org, 0, sf, (255, 255, 255), tf, cv2.LINE_AA)):
            changed = (out != img).any(-1)
            assert not (changed & ~box).any() and changed.any(), s


@pytest.mark.parametrize("alpha", [0.5, 0.3, 0.7, 0.45, 0.123, 0.9])
def test_add_weighted_equals_cv2(alpha):
    rng = np.random.default_rng(int(alpha * 1000))
    a, b = (rng.integers(0, 256, (90, 70, 3), dtype=np.uint8) for _ in range(2))
    np.testing.assert_array_equal(draw.add_weighted(a, 1 - alpha, b, alpha, 0),
                                  cv2.addWeighted(a, 1 - alpha, b, alpha, 0))


# -- the annotator and Results.plot against the JAX package --------------------------------------------------------
def label_boxes(shape, lw, labels):
    """The union of the text boxes of `labels` [(text, org)], grown by OpenCV's ink left of the box and a pixel."""
    m = np.zeros(shape[:2], bool)
    for text, (x, y) in labels:
        (w, h), base = draw.get_text_size(text, lw / 3, max(lw - 1, 1))
        m[max(y - h - 1, 0):max(y + base + 2, 0), max(x - lw - 1, 0):max(x + w + 1, 0)] = True
    return m


def plot_labels(r: Results, lw: int):
    """(label, baseline origin) of every label `Results.plot` draws, as `Annotator.box_label` and `obb_label` place
    them."""
    out = []
    for d in r.boxes.data if r.boxes is not None else ():
        label = f"{r._name(int(d[-1]))} {d[-2]:.2f}"
        h = draw.get_text_size(label, lw / 3, max(lw - 1, 1))[0][1]
        x1, y1 = int(d[0]), int(d[1])
        out.append((label, (x1, y1 - 2) if y1 - h >= 3 else (x1, y1 + h + 2)))
    for d, pts in zip(r.obb.data, r.obb.xyxyxyxy) if r.obb is not None else ():
        p = np.asarray(pts, np.int32)[0]
        out.append((f"{r._name(int(d[-1]))} {d[-2]:.2f}", (int(p[0]), int(p[1]))))
    return out


def port_glyphs(fn, *args, **kw):
    """Call a JAX drawing function with `cv2.putText` drawing the port's glyphs."""
    def put_text(img, text, org, font_face, font_scale, color, thickness=1, lineType=cv2.LINE_8):
        assert font_face == cv2.FONT_HERSHEY_SIMPLEX
        return PORT_PUT_TEXT(img, text, org, font_scale, color, thickness, lineType)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cv2, "putText", put_text)
        return fn(*args, **kw)


def assert_equal_but_glyphs(got, want, want_port_glyphs, text_mask, what):
    """Bit for bit with `want_port_glyphs` (the JAX drawing with the port's glyphs); bit for bit with `want` (cv2's
    glyphs) outside the text boxes, and inside them within TEXT_MEAN_TOL."""
    bad = np.argwhere((got != want_port_glyphs).reshape(*got.shape[:2], -1).any(-1))
    assert not len(bad), (f"{what}: {len(bad)} pixels differ from the drawing with the port's glyphs, "
                          f"first at {bad[:4].tolist()}")
    diff = (got != want).any(-1)
    bad = np.argwhere(diff & ~text_mask)
    assert not len(bad), f"{what}: {len(bad)} pixels differ outside the text boxes, first at {bad[:4].tolist()}"
    if text_mask.any():
        assert np.abs(got.astype(np.int16) - want)[text_mask].mean() <= TEXT_MEAN_TOL, what


def detections(rng, n, h, w, nc=8):
    xy, wh = rng.uniform(0, [w, h], (n, 2)), rng.uniform(4, 0.5 * min(h, w), (n, 2))
    return np.concatenate([xy - wh / 2, xy + wh / 2, rng.uniform(0.05, 1, (n, 1)), rng.integers(0, nc, (n, 1))],
                          1).astype(np.float32)


@pytest.mark.parametrize("task", ["detect", "track", "pose", "pose4", "segment", "obb"])
@pytest.mark.parametrize("hw", [(120, 160), (90, 72)])
def test_results_plot_equals_jax(task, hw):
    h, w = hw
    rng = np.random.default_rng([len(task), h])
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    n = 7
    boxes = detections(rng, n, h, w)
    kw = {"boxes": boxes}
    if task == "track":
        kw = {"boxes": np.concatenate([boxes[:, :4], np.arange(1, n + 1)[:, None], boxes[:, 4:]], 1)}
    elif task.startswith("pose"):
        nk = 17 if task == "pose" else 4
        kw["keypoints"] = np.concatenate([rng.uniform(-5, [w + 5, h + 5], (n, nk, 2)), rng.uniform(0, 1, (n, nk, 1))],
                                         -1).astype(np.float32)
    elif task == "segment":
        kw["masks"] = rng.random((n, h, w)) > 0.8
    elif task == "obb":
        kw = {"obb": np.concatenate([rng.uniform(0, [w, h], (n, 2)), rng.uniform(4, 40, (n, 2)),
                                     rng.uniform(-1.5, 1.5, (n, 1)), boxes[:, 4:]], 1).astype(np.float32)}
    port, ref = Results(img, "a.jpg", NAMES, **kw), JaxResults(img, "a.jpg", NAMES, **kw)
    lw = max(round(sum(img.shape) / 2 * 0.003), 2)
    for args in ({}, {"conf": False}, {"line_width": 3}, {"labels": False}, {"boxes": False}):
        lwa = args.get("line_width", lw)
        labels = plot_labels(port, lwa) if args.get("labels", True) and args.get("boxes", True) else []
        if not args.get("conf", True):
            labels = [(t.rsplit(" ", 1)[0], o) for t, o in labels]
        got, want = port.plot(**args), ref.plot(**args)
        assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
        assert_equal_but_glyphs(got, want, port_glyphs(ref.plot, **args), label_boxes(img.shape, lwa, labels),
                                f"{task} {args}")


@pytest.mark.parametrize("wrong", ["blank", "one_character"])
def test_text_check_rejects_wrong_labels(wrong, monkeypatch):
    """The negative control of the text check: the port's drawing with blank labels, or with one character of each
    label changed, differs from the JAX drawing with the port's glyphs."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    boxes = detections(rng, 7, 120, 160)
    port, ref = Results(img, "a.jpg", NAMES, boxes=boxes), JaxResults(img, "a.jpg", NAMES, boxes=boxes)
    swap = {"blank": lambda s: "", "one_character": lambda s: s[:-1] + ("8" if s[-1] == "7" else "7")}[wrong]
    monkeypatch.setattr(draw, "put_text", lambda im, s, *a: PORT_PUT_TEXT(im, swap(s), *a))
    with pytest.raises(AssertionError, match="drawing with the port's glyphs"):
        assert_equal_but_glyphs(port.plot(), ref.plot(), port_glyphs(ref.plot), np.ones(img.shape[:2], bool), wrong)


def test_annotator_parts_equal_jax():
    """masks (with a nearest resize), kpts with a radius and skeleton off, text lines, box_label below the top edge;
    circle outlines are refused."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (100, 140, 3), dtype=np.uint8)
    port, ref, ref_pg = PP.Annotator(img.copy()), JP.Annotator(img.copy()), JP.Annotator(img.copy())
    masks = rng.random((3, 25, 35)) > 0.5
    kpts = np.concatenate([rng.uniform(0, 100, (17, 2)), np.ones((17, 1))], -1)

    def first(a):
        a.masks(masks, [(10, 200, 30), (0, 0, 255), (255, 255, 0)], alpha=0.5)
        a.kpts(kpts, (100, 140), radius=3, kpt_line=False)
        a.box_label([5, 1, 60, 40], "van 0.51", color=(0, 128, 255))
        return a.result()

    first(port), first(ref)
    text = label_boxes(img.shape, port.lw, [("van 0.51", (5, 1 + 9 * port.lw + 2))])
    assert_equal_but_glyphs(port.result(), ref.result(), port_glyphs(first, ref_pg), text,
                            "masks, kpts, box_label below")

    def second(a):
        a.text((8, 8), "0.91 car\n0.05 bus")
        return a.result()

    second(port), second(ref)
    text |= label_boxes(img.shape, port.lw, [("0.91 car", (8, 28)), ("0.05 bus", (8, 48))])
    assert_equal_but_glyphs(port.result(), ref.result(), port_glyphs(second, ref_pg), text, "text")
    with pytest.raises(NotImplementedError, match="filled circles only"):
        draw.circle(img.copy(), (5, 5), 3, (0, 0, 255), 1)
    with pytest.raises(ValueError, match="LINE_AA"):
        draw.put_text(img.copy(), "car", (5, 20), 2 / 3, (255, 255, 255), 1, draw.LINE_8)


def test_plot_images_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    b, s = 5, 96
    ramp = np.linspace(0, 255, s)
    imgs = np.stack([np.stack(np.broadcast_arrays(ramp[:, None] * (i + 1) / b, ramp[None, :], 255 - ramp[:, None]), -1)
                     for i in range(b)]).astype(np.uint8)  # smooth, so that the written JPEG stays close
    n = 12
    bi, cls = rng.integers(0, b, n), rng.integers(0, 8, n).astype(np.float32)
    xy, wh = rng.uniform(10, s - 10, (n, 2)), rng.uniform(6, 40, (n, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], 1).astype(np.float32)
    args = (imgs.astype(np.float32) / 255.0, bi, cls, boxes)
    got = PP.plot_images(*args, fname=tmp_path / "p.jpg", names=NAMES, threaded=False)
    want = JP.plot_images(*args, fname=tmp_path / "j.jpg", names=NAMES, threaded=False)
    want_pg = port_glyphs(JP.plot_images, *args, fname=tmp_path / "g.jpg", names=NAMES, threaded=False)
    ns = 3
    labels = []
    for i in range(b):
        x, y = s * (i // ns), s * (i % ns)
        for bb, c in zip(boxes[bi == i], cls[bi == i]):
            name = NAMES[int(c)]
            h = draw.get_text_size(name, 2 / 3, 1)[0][1]
            x1, y1 = int(bb[0] + x), int(bb[1] + y)
            labels.append((name, (x1, y1 - 2) if y1 - h >= 3 else (x1, y1 + h + 2)))
    assert_equal_but_glyphs(got, want, want_pg, label_boxes(got.shape, 2, labels), "plot_images")
    written = decode_jpeg((tmp_path / "p.jpg").read_bytes())[..., ::-1]
    assert written.shape == got.shape and np.abs(written.astype(np.int16) - got).mean() < 3.0
    t = PP.plot_images(*args, fname=tmp_path / "t.jpg", names=NAMES)  # threaded, as the trainer calls it
    t.join()
    assert (tmp_path / "t.jpg").stat().st_size > 0


def test_plot_images_shrinks_a_large_mosaic_as_jax(tmp_path):
    """A batch of 16 at 640 px of random pixels: the 2560 px mosaic shrinks by 0.75 to 1920 px (`resize_linear_u8`
    against `cv2.resize`, within 1 grey level of it at most factors). At this factor the drawing equals the JAX
    drawing with the port's glyphs bit for bit, and the JAX drawing with cv2's glyphs outside the text boxes."""
    rng = np.random.default_rng(16)
    b, s = 16, 640
    imgs = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    n = 40
    bi, cls = rng.integers(0, b, n), rng.integers(0, 8, n).astype(np.float32)
    xy, wh = rng.uniform(40, s - 40, (n, 2)), rng.uniform(20, 200, (n, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], 1).astype(np.float32)
    args = (imgs, bi, cls, boxes)
    got = PP.plot_images(*args, names=NAMES, save=False, threaded=False)
    want = JP.plot_images(*args, fname=tmp_path / "j.jpg", names=NAMES, save=False, threaded=False)
    want_pg = port_glyphs(JP.plot_images, *args, fname=tmp_path / "g.jpg", names=NAMES, save=False, threaded=False)
    assert got.shape == want.shape == (1920, 1920, 3)
    labels = []
    for i in range(b):
        x, y = int(s * (i // 4) * 0.75), int(s * (i % 4) * 0.75)
        for bb, c in zip(boxes[bi == i] * 0.75, cls[bi == i]):
            name = NAMES[int(c)]
            h = draw.get_text_size(name, 2 / 3, 1)[0][1]
            x1, y1 = int(bb[0] + x), int(bb[1] + y)
            labels.append((name, (x1, y1 - 2) if y1 - h >= 3 else (x1, y1 + h + 2)))
    text = label_boxes(got.shape, 2, labels)
    assert len(labels) == n and text.mean() < 0.05
    assert_equal_but_glyphs(got, want, want_pg, text, "plot_images 16 x 640 px")


# -- the confusion matrix ----------------------------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_confusion_matrix_equals_jax(seed):
    rng = np.random.default_rng(seed)
    nc = 5
    port, ref = MET.ConfusionMatrix(nc), JMET.ConfusionMatrix(nc)
    for _ in range(12):
        m = int(rng.integers(0, 6))
        gt = detections(rng, m, 100, 100, nc)
        d = np.concatenate([gt[:, :4] + rng.normal(0, 4, (m, 4)), rng.uniform(0, 1, (m, 1)),
                            np.where(rng.random((m, 1)) < 0.7, gt[:, 5:], rng.integers(0, nc, (m, 1)))], 1)
        d = np.concatenate([d, detections(rng, int(rng.integers(0, 4)), 100, 100, nc)])
        if rng.random() < 0.15:
            d = d[:0]
        for cm in (port, ref):
            cm.process_batch(d, gt[:, :4], gt[:, 5])
    np.testing.assert_array_equal(port.matrix, ref.matrix)
    for a, b in zip(port.tp_fp(), ref.tp_fp()):
        np.testing.assert_array_equal(a, b)
    preds, targets = rng.integers(0, nc, 30), rng.integers(0, nc, 30)
    port, ref = MET.ConfusionMatrix(nc, task="classify"), JMET.ConfusionMatrix(nc, task="classify")
    port.process_cls_preds(preds, targets)
    ref.process_cls_preds(preds, targets)
    np.testing.assert_array_equal(port.matrix, ref.matrix)
    assert MET.ConfusionMatrix(nc, conf=0.001).conf == JMET.ConfusionMatrix(nc, conf=0.001).conf == 0.25


def test_val_plots_fills_the_confusion_matrix_as_jax(tmp_path):
    """`YOLO.val(plots=True)` of both facades on one set of weights and dataset: the same confusion matrix."""
    data = make_dataset(tmp_path / "ds", n_train=1, n_val=4, size=96)
    port = YOLO("yolov8n.yaml", device="cpu")
    port.ensure_variables(imgsz=64, seed=0)
    sd = spread_weights(port.model.state_dict(), np.random.default_rng(0))
    for k in [k for k in sd if k.endswith("cv3.2.2.bias") or k.endswith("cv3.1.2.bias") or k.endswith("cv3.0.2.bias")]:
        sd[k] = torch.full_like(sd[k], 1.0)  # class scores around sigmoid(1): detections above conf 0.25
    port.model.load_state_dict(sd)
    ref = JaxYOLO("yolov8n.yaml")
    ref.variables = convert_state_dict(ref.model, port.model.state_dict())
    args = dict(data=str(data), imgsz=64, batch=2, dtype="float32", plots=True, rect=False, verbose=False,
                project=str(tmp_path / "runs"))
    port.val(**args)
    jax_validator = JaxDetectionValidator(args={**ref.overrides, "mode": "val", **args})
    jax_validator(model=ref)
    got, want = port.validator.confusion_matrix.matrix, jax_validator.confusion_matrix.matrix
    assert got.sum() > 0
    np.testing.assert_array_equal(got, want)

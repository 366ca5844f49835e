"""Inference results: `Results` per image with its `Boxes`, `Masks`, `Probs`, `Keypoints` and `OBB`, numpy-backed.

Counterpart of `drone_yolo_tpu/engine/results.py` (Boxes, Masks, Probs, Keypoints, OBB, Results) for
detection, tracking, segmentation, pose, oriented boxes and classification: a classifier's probabilities (nc,) with
top-1 and top-5 (drawn as five lines of text, written by `save_txt` as 'conf name' lines); boxes of 6 columns (xyxy,
conf, cls) or, from a
tracker, 7 (xyxy, track id, conf, cls); masks (N, H, W) bool at the original image's size,
whose `xy` outlines come from `ops/polygon.py:find_contours` (`cv2.findContours`); keypoints
(N, K, 2 or 3); oriented boxes (N, 7) cx, cy, w, h, angle (radians), conf, cls. A `Results` indexes, slices and
updates all of them together. `save_txt` writes YOLO-format label lines (of the boxes, as the JAX package, and of
the oriented boxes), `save_crop` the boxes' crops as JPEG (the port's encoder), `summary`/`to_json` a list of dicts
(with each mask's outline as `segments`). `plot` draws the result as the JAX package does (`utils/plotting.py`:
masks, boxes with their labels, oriented boxes, keypoints, in that order; a track is labelled as a detection, without
its id); `save` writes the drawing as JPEG (quality 95, `cv2.imwrite`'s default) or PNG by the file's suffix; `show`
is refused, since the card's machine has no display library.

`summary` differs from the JAX package on purpose for masks: there it reads `self.masks[i].xy[0]`, the outline of
the mask's first row, which fails; here it reads the i-th mask's outline, `masks.xy[i]`, as Ultralytics does.

Oriented boxes differ from the JAX package on purpose, as Ultralytics has them: `save_txt` writes a line
'cls x1 y1 x2 y2 x3 y3 x4 y4 [conf]' per box, its corners normalised to the original image (the JAX package writes
nothing for them); `summary` gives the four corners as `box` (x1, y1, ..., x4, y4; the JAX package labels cx, cy, w,
h as x1, y1, x2, y2 and divides the angle by the height); a frame without detections has an empty `OBB` (the JAX
package gives None). `save_crop` writes nothing for them, as in both.

`save_crop` differs from the JAX package on purpose: there every crop of one class in
one image goes to the same `<stem>.jpg`, each overwriting the last; here the second and
later crops are numbered (`<stem>2.jpg`, `<stem>3.jpg`, ...), as Ultralytics'
`save_one_box` numbers them. A crop of no pixels is not written.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from drone_yolo_tpu_torch.data.jpeg import encode_jpeg
from drone_yolo_tpu_torch.data.png import encode_png
from drone_yolo_tpu_torch.ops.polygon import contour_area, find_contours
from drone_yolo_tpu_torch.ops.rotated import xywhr2xyxyxyxy
from drone_yolo_tpu_torch.utils.plotting import Annotator, colors

SHOW_REFUSAL = "showing results needs a display library (cv2.imshow), which the card's machine does not have"


def write_image(path, bgr: np.ndarray) -> Path:
    """Write a BGR uint8 image as `cv2.imwrite` would by the file's suffix: .jpg/.jpeg/.jpe as JPEG at quality 95,
    .png as PNG; another suffix is refused. Returns the path."""
    path = Path(path)
    suffix = path.suffix.lower()
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    if suffix in (".jpg", ".jpeg", ".jpe"):
        data = encode_jpeg(rgb, quality=95)
    elif suffix == ".png":
        data = encode_png(rgb)
    else:
        raise ValueError(f"{path}: the port writes .jpg and .png images only")
    path.write_bytes(data)
    return path


class Boxes:
    """Detections (N, 6) x1, y1, x2, y2, conf, cls, or tracks (N, 7) x1, y1, x2, y2, id, conf, cls, in the original
    image's pixels."""

    def __init__(self, boxes, orig_shape):
        boxes = np.asarray(boxes)
        if boxes.ndim == 1:
            boxes = boxes[None, :]
        if boxes.shape[-1] not in (6, 7):
            raise ValueError(f"expected 6 or 7 columns, got shape {boxes.shape}")
        self.data = boxes
        self.orig_shape = orig_shape
        self.is_track = boxes.shape[-1] == 7

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return Boxes(self.data[idx], self.orig_shape)

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

    @property
    def id(self):
        """Track ids, or None for detections."""
        return self.data[:, -3] if self.is_track else None

    @property
    def xywh(self):
        x1, y1, x2, y2 = self.data[:, :4].T
        return np.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)


class Keypoints:
    """Keypoints (N, K, 2 or 3): x, y in the original image's pixels, then the visibility score if there is one."""

    def __init__(self, keypoints, orig_shape):
        keypoints = np.asarray(keypoints)
        if keypoints.ndim == 2:  # one instance (K, 2|3): keep the instance dimension
            keypoints = keypoints[None, :]
        self.data = keypoints
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return Keypoints(self.data[idx], self.orig_shape)

    @property
    def xy(self):
        return self.data[..., :2]

    @property
    def xyn(self):
        """xy over the original image's width and height."""
        d = self.data[..., :2].copy()
        d[..., 0] /= self.orig_shape[1]
        d[..., 1] /= self.orig_shape[0]
        return d

    @property
    def conf(self):
        return self.data[..., 2] if self.data.shape[-1] == 3 else None


class Masks:
    """Instance masks (N, H, W), bool, at the original image's size."""

    def __init__(self, masks, orig_shape):
        self.data = np.asarray(masks)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return Masks(self.data[idx], self.orig_shape)

    @property
    def xy(self) -> list[np.ndarray]:
        """Per mask its outline in the original image's pixels, (K, 2) float32: of the outer borders that
        `cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)` finds, the first of largest `cv2.contourArea`; (0, 2)
        for an empty mask."""
        out = []
        for m in self.data.astype(np.uint8):
            contours = find_contours(m)
            c = (max(contours, key=contour_area).reshape(-1, 2).astype(np.float32) if contours
                 else np.zeros((0, 2), np.float32))
            out.append(c * np.array([self.orig_shape[1] / m.shape[1], self.orig_shape[0] / m.shape[0]], np.float32))
        return out


class OBB:
    """Oriented boxes (N, 7) cx, cy, w, h, angle, conf, cls, or tracks (N, 8) with the track id before conf, in the
    original image's pixels, the angle in radians."""

    def __init__(self, boxes, orig_shape):
        boxes = np.asarray(boxes)
        if boxes.ndim == 1:
            boxes = boxes[None, :]
        if boxes.shape[-1] not in (7, 8):
            raise ValueError(f"expected 7 or 8 columns, got shape {boxes.shape}")
        self.data = boxes
        self.orig_shape = orig_shape
        self.is_track = boxes.shape[-1] == 8

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return OBB(self.data[idx], self.orig_shape)

    @property
    def xywhr(self):
        return self.data[:, :5]

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

    @property
    def id(self):
        """Track ids, or None for detections."""
        return self.data[:, -3] if self.is_track else None

    @property
    def xyxyxyxy(self):
        """The four corners (N, 4, 2): centre + w/2 (cos, sin) + h/2 (-sin, cos), then +-, --, -+."""
        return xywhr2xyxyxyxy(self.data[:, :5]).reshape(-1, 4, 2)

    @property
    def xyxyxyxyn(self):
        """The corners over the original image's width and height."""
        pts = self.xyxyxyxy.copy()
        pts[..., 0] /= self.orig_shape[1]
        pts[..., 1] /= self.orig_shape[0]
        return pts

    @property
    def xyxy(self):
        """The axis-aligned extent of each rotated box (N, 4)."""
        pts = self.xyxyxyxy
        return np.concatenate([pts.min(axis=1), pts.max(axis=1)], axis=-1)


class Probs:
    """A classifier's probabilities (nc,) of one image. `top5` is numpy's `argsort()[::-1][:5]`, as in the JAX
    package: among equal probabilities its order is numpy's, not the validator's lower index first."""

    def __init__(self, probs, orig_shape=None):
        self.data = np.asarray(probs)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def top1(self) -> int:
        return int(self.data.argmax())

    @property
    def top5(self) -> list[int]:
        return self.data.argsort()[::-1][:5].tolist()

    @property
    def top1conf(self) -> float:
        return float(self.data.max())

    @property
    def top5conf(self):
        return self.data[self.top5]


class Results:
    """Result of one image: the original frame, its path, the class names, boxes, masks, a classifier's
    probabilities, keypoints, oriented boxes and timings."""

    def __init__(self, orig_img, path, names, boxes=None, masks=None, probs=None, keypoints=None, obb=None, speed=None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.masks = Masks(masks, self.orig_shape) if masks is not None else None
        self.probs = Probs(probs, self.orig_shape) if probs is not None else None
        self.keypoints = Keypoints(keypoints, self.orig_shape) if keypoints is not None else None
        self.obb = OBB(obb, self.orig_shape) if obb is not None else None
        self.names = names
        self.path = path
        self.speed = speed or {"preprocess": None, "inference": None, "postprocess": None}

    def __len__(self):
        for v in (self.boxes, self.masks, self.probs, self.keypoints, self.obb):
            if v is not None:
                return len(v)
        return 0

    def __getitem__(self, idx) -> Results:
        """The result of the instances `idx` (an index, a slice or an index array) of boxes, masks, keypoints and
        oriented boxes; the probabilities stay whole."""
        r = Results(self.orig_img, self.path, self.names, speed=self.speed)
        for k in ("boxes", "masks", "keypoints", "obb"):
            v = getattr(self, k)
            if v is not None:
                setattr(r, k, v[idx])
        r.probs = self.probs
        return r

    def update(self, boxes=None, masks=None, probs=None, keypoints=None, obb=None) -> None:
        """Replace the boxes (6 or 7 columns), the masks, the probabilities, the keypoints and/or the oriented boxes;
        what is None stays."""
        if boxes is not None:
            self.boxes = Boxes(boxes, self.orig_shape)
        if masks is not None:
            self.masks = Masks(masks, self.orig_shape)
        if probs is not None:
            self.probs = Probs(probs, self.orig_shape)
        if keypoints is not None:
            self.keypoints = Keypoints(keypoints, self.orig_shape)
        if obb is not None:
            self.obb = OBB(obb, self.orig_shape)

    def plot(self, conf: bool = True, line_width=None, labels: bool = True, boxes: bool = True, masks: bool = True,
             probs: bool = True, color_mode: str = "class", img=None) -> np.ndarray:
        """The BGR image (the original, or `img`) with the masks, boxes and oriented boxes (labelled 'name conf',
        'name' without conf, nothing without labels) and keypoints drawn, and with `probs` the top-5 lines
        'conf name' from (8, 8). `color_mode` has no effect, as in the JAX package."""
        annotator = Annotator((img if img is not None else self.orig_img).copy(), line_width=line_width,
                              example=str(self.names))
        if self.masks is not None and masks:
            annotator.masks(self.masks.data, [colors(int(c), True) for c in
                                              (self.boxes.cls if self.boxes else range(len(self.masks)))])
        if self.boxes is not None and boxes:
            for d in self.boxes.data:
                c = int(d[-1])
                label = (f"{self._name(c)} {d[-2]:.2f}" if conf else self._name(c)) if labels else None
                annotator.box_label(d[:4], label, color=colors(c, True))
        if self.obb is not None and boxes:
            for d, pts in zip(self.obb.data, self.obb.xyxyxyxy):
                c = int(d[-1])
                label = (f"{self._name(c)} {d[-2]:.2f}" if conf else self._name(c)) if labels else None
                annotator.obb_label(pts, label, color=colors(c, True))
        if self.keypoints is not None:
            for k in self.keypoints.data:
                annotator.kpts(k, self.orig_shape)
        if self.probs is not None and probs:
            annotator.text((8, 8), "\n".join(f"{self.probs.data[j]:.2f} {self._name(j)}" for j in self.probs.top5))
        return annotator.result()

    def save(self, filename=None):
        """Write `plot()` to `filename` (default results_<image name>), JPEG or PNG by its suffix; returns it."""
        filename = filename or f"results_{Path(self.path).name}"
        write_image(filename, self.plot())
        return filename

    def show(self, *args, **kwargs):
        raise NotImplementedError(SHOW_REFUSAL)

    def _name(self, c: int) -> str:
        return self.names.get(c, str(c)) if isinstance(self.names, dict) else self.names[c]

    def save_txt(self, txt_file, save_conf: bool = False) -> None:
        """Append YOLO-format lines normalised to the original image: 'cls cx cy w h [conf]' per box, or 'cls x1 y1 x2
        y2 x3 y3 x4 y4 [conf]' per oriented box (its corners); for a classifier's probabilities 'conf name' per class
        of the top 5 and nothing else."""
        h, w = self.orig_shape
        texts = []
        if self.probs is not None:
            texts = [f"{self.probs.data[j]:.2f} {self._name(j)}" for j in self.probs.top5]
        elif self.obb is not None:
            for d, pts in zip(self.obb.data, self.obb.xyxyxyxyn):
                line = (int(d[-1]), *pts.reshape(-1).tolist()) + ((float(d[-2]),) if save_conf else ())
                texts.append(("%g " * len(line)).rstrip() % line)
        for d in self.boxes.data if self.boxes is not None else ():
            c, conf_v = int(d[-1]), float(d[-2])
            x1, y1, x2, y2 = d[:4]
            box = np.array([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1]) / np.array([w, h, w, h])
            line = (c, *box.tolist()) + ((conf_v,) if save_conf else ())
            texts.append(("%g " * len(line)).rstrip() % line)
        if texts:
            Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
            with open(txt_file, "a", encoding="utf-8") as f:
                f.writelines(t + "\n" for t in texts)

    def save_crop(self, save_dir, file_name=Path("im.jpg")) -> list[Path]:
        """Write each box's crop of the original image to save_dir/<class name>/<stem>.jpg, numbering the second and
        later crops of a class <stem>2.jpg, <stem>3.jpg, ...; returns the files written."""
        if self.boxes is None:
            return []
        written = []
        for d in self.boxes.data:
            x1, y1, x2, y2 = (int(v) for v in d[:4])
            crop = self.orig_img[max(y1, 0):y2, max(x1, 0):x2]
            if crop.size == 0:
                continue
            stem, folder = Path(file_name).stem, Path(save_dir) / self._name(int(d[-1]))
            out, n = folder / f"{stem}.jpg", 2
            while out.exists():
                out, n = folder / f"{stem}{n}.jpg", n + 1
            folder.mkdir(parents=True, exist_ok=True)
            out.write_bytes(encode_jpeg(np.ascontiguousarray(crop[..., ::-1]), quality=95))
            written.append(out)
        return written

    def summary(self, normalize: bool = False, decimals: int = 5) -> list[dict]:
        """One dict per box: name, class, confidence, box (x1, y1, x2, y2, or an oriented box's four corners x1, y1,
        ..., x4, y4; over the image size with normalize), the mask's outline x, y as `segments` when there are masks,
        and the keypoints' x, y (and visible) when there are keypoints. A classifier's result gives one dict, its top
        class."""
        out = []
        if self.probs is not None:
            c = self.probs.top1
            return [{"name": self.names.get(c, c) if isinstance(self.names, dict) else self.names[c], "class": c,
                     "confidence": round(self.probs.top1conf, decimals)}]
        h, w = self.orig_shape if normalize else (1, 1)
        if self.obb is not None:
            for d, pts in zip(self.obb.data, self.obb.xyxyxyxy):
                c = int(d[-1])
                box = {}
                for j, (x, y) in enumerate(pts, 1):
                    box[f"x{j}"], box[f"y{j}"] = round(float(x) / w, decimals), round(float(y) / h, decimals)
                out.append({"name": self._name(c), "class": c, "confidence": round(float(d[-2]), decimals), "box": box})
            return out
        if self.boxes is None:
            return out
        outlines = self.masks.xy if self.masks is not None else None
        for i, d in enumerate(self.boxes.data):
            c, conf_v = int(d[-1]), float(d[-2])
            rec = {"name": self._name(c), "class": c, "confidence": round(conf_v, decimals),
                   "box": {k: round(float(v) / (w if k in "x1x2" else h), decimals)
                           for k, v in zip(["x1", "y1", "x2", "y2"], d[:4])}}
            if outlines is not None:
                xy = outlines[i]
                rec["segments"] = {"x": (xy[:, 0] / w).round(decimals).tolist(),
                                   "y": (xy[:, 1] / h).round(decimals).tolist()}
            if self.keypoints is not None:
                k = self.keypoints.data[i]
                rec["keypoints"] = {"x": (k[:, 0] / w).round(decimals).tolist(), "y": (k[:, 1] / h).round(decimals).tolist(),
                                    **({"visible": k[:, 2].round(decimals).tolist()} if k.shape[-1] == 3 else {})}
            out.append(rec)
        return out

    def to_json(self, normalize: bool = False, decimals: int = 5) -> str:
        return json.dumps(self.summary(normalize, decimals), indent=2)

    def verbose(self) -> str:
        """'2 cars, 1 bus, ' style summary of the boxes or oriented boxes, classes in index order; for a classifier
        'name conf, ' for each of the top 5."""
        if self.probs is not None:
            return ", ".join(f"{self._name(j)} {self.probs.data[j]:.2f}" for j in self.probs.top5) + ", "
        data = self.obb if self.obb is not None else self.boxes
        if data is None or not len(data):
            return "(no detections), "
        counts = {}
        for c in data.cls.astype(int):
            counts[c] = counts.get(c, 0) + 1
        return "".join(f"{n} {self._name(c)}{'s' * (n > 1)}, " for c, n in sorted(counts.items()))

"""Inference results: `Results` per image with its `Boxes` and `Keypoints`, numpy-backed.

Counterpart of `drone_yolo_tpu/engine/results.py` (Boxes, Keypoints, Results) for
detection, tracking and pose: boxes of 6 columns (xyxy, conf, cls) or, from a
tracker, 7 (xyxy, track id, conf, cls); keypoints (N, K, 2 or 3). `save_txt` writes
YOLO-format label lines, `save_crop` the boxes' crops as JPEG (the port's encoder),
`summary`/`to_json` a list of dicts. Drawing (`plot`, and `save` and `show`, which draw)
is not ported yet and is refused by name.

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

PLOT_REFUSAL = "drawing results (Results.plot, save, show) is not ported yet (ROADMAP.md queue 1 item 4)"


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


class Results:
    """Result of one image: the original frame, its path, the class names, boxes, keypoints and timings."""

    def __init__(self, orig_img, path, names, boxes=None, keypoints=None, speed=None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.keypoints = Keypoints(keypoints, self.orig_shape) if keypoints is not None else None
        self.names = names
        self.path = path
        self.speed = speed or {"preprocess": None, "inference": None, "postprocess": None}

    def __len__(self):
        for v in (self.boxes, self.keypoints):
            if v is not None:
                return len(v)
        return 0

    def update(self, boxes=None, keypoints=None) -> None:
        """Replace the boxes (6 or 7 columns) and/or the keypoints; what is None stays."""
        if boxes is not None:
            self.boxes = Boxes(boxes, self.orig_shape)
        if keypoints is not None:
            self.keypoints = Keypoints(keypoints, self.orig_shape)

    def plot(self, *args, **kwargs):
        raise NotImplementedError(PLOT_REFUSAL)

    def save(self, *args, **kwargs):
        raise NotImplementedError(PLOT_REFUSAL)

    def show(self, *args, **kwargs):
        raise NotImplementedError(PLOT_REFUSAL)

    def _name(self, c: int) -> str:
        return self.names.get(c, str(c)) if isinstance(self.names, dict) else self.names[c]

    def save_txt(self, txt_file, save_conf: bool = False) -> None:
        """Append the boxes as YOLO-format lines 'cls cx cy w h [conf]', normalised to the original image."""
        if self.boxes is None:
            return
        h, w = self.orig_shape
        texts = []
        for d in self.boxes.data:
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
        """One dict per box: name, class, confidence, box (x1, y1, x2, y2; over the image size with normalize), and
        the keypoints' x, y (and visible) when there are keypoints."""
        out = []
        if self.boxes is None:
            return out
        h, w = self.orig_shape if normalize else (1, 1)
        for i, d in enumerate(self.boxes.data):
            c, conf_v = int(d[-1]), float(d[-2])
            rec = {"name": self._name(c), "class": c, "confidence": round(conf_v, decimals),
                   "box": {k: round(float(v) / (w if k in "x1x2" else h), decimals)
                           for k, v in zip(["x1", "y1", "x2", "y2"], d[:4])}}
            if self.keypoints is not None:
                k = self.keypoints.data[i]
                rec["keypoints"] = {"x": (k[:, 0] / w).round(decimals).tolist(), "y": (k[:, 1] / h).round(decimals).tolist(),
                                    **({"visible": k[:, 2].round(decimals).tolist()} if k.shape[-1] == 3 else {})}
            out.append(rec)
        return out

    def to_json(self, normalize: bool = False, decimals: int = 5) -> str:
        return json.dumps(self.summary(normalize, decimals), indent=2)

    def verbose(self) -> str:
        """'2 cars, 1 bus, ' style summary, classes in index order."""
        if self.boxes is None or not len(self.boxes):
            return "(no detections), "
        counts = {}
        for c in self.boxes.cls.astype(int):
            counts[c] = counts.get(c, 0) + 1
        return "".join(f"{n} {self._name(c)}{'s' * (n > 1)}, " for c, n in sorted(counts.items()))

"""Host augmentation of detection, segmentation and pose samples: mosaic, copy-paste, affine warp, mixup, HSV, flips,
letterbox.

Counterpart of `drone_yolo_tpu/data/augment.py` for the detect, segment and pose tasks, without
cv2: the image operations are `ops/image.py`'s, `ops/letterbox.py`'s and `ops/polygon.py`'s. Every
random draw is made from the same generator, with the same arguments and in the same order as in
the JAX package, so one `(seed, epoch, index)` gives the same sample in both.

A sample is a dict: `img` (H, W, 3) uint8 RGB, `cls` (N,) float32, `bboxes` (N, 4)
float32 pixel xyxy, with polygon labels `segments` (N polygons (K, 2) float32 pixel x, y,
for any task), for pose `keypoints` (N, nk, 3) (x, y in pixels, visibility), and
`im_file`, `ori_shape`. Keypoints follow the JAX package where it departs from the
reference: the affine zeroes the visibility of points it moves out of the frame and keeps
their coordinates, and a horizontal flip without `flip_idx` mirrors the points without
remapping them. Polygons follow it too: the affine warps and clips their points and takes
each box from its polygon (area threshold 0.01), without the reference's resampling to 1000
points. `MixUp` also adds the second sample's polygons, which the JAX package leaves out, so that
its segment batches fail to collate there (ROADMAP queue 3). `CopyPaste` pastes flipped instances
(flip mode) of samples with polygons. warpPerspective (`perspective` > 0) is refused.
"""

from __future__ import annotations

import math
import random
import threading

import numpy as np
import torch

from drone_yolo_tpu_torch.ops.image import get_rotation_matrix_2d, hsv_to_rgb_u8, rgb_to_hsv_u8, warp_affine_u8
from drone_yolo_tpu_torch.ops.letterbox import letterbox_params, letterbox_u8
from drone_yolo_tpu_torch.ops.polygon import fill_poly

# Per-sample deterministic draws: each sample seeds this thread's generators from (seed, epoch, index), so a
# sample does not depend on the worker count or the scheduling of the loader's threads.
_thread_rng = threading.local()


def _rng() -> random.Random:
    r = getattr(_thread_rng, "rng", None)
    if r is None:
        r = random.Random(random.getrandbits(64))
        _thread_rng.rng = r
    return r


def _np_rng() -> np.random.Generator:
    g = getattr(_thread_rng, "np_rng", None)
    if g is None:
        g = np.random.default_rng(random.getrandbits(64))
        _thread_rng.np_rng = g
    return g


def seed_sample(seed: int, epoch: int, index: int) -> None:
    """Seed this thread's `random.Random` and numpy Generator for one sample: the splitmix64 finalizer of the
    packed (seed, epoch, index), as `drone_yolo_tpu/data/augment.py:seed_sample`."""
    h = (int(seed) & 0xFFFF) << 48 | (int(epoch) & 0xFFFF) << 32 | int(index) & 0xFFFFFFFF
    h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
    h = (h ^ (h >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 31
    _rng().seed(h)
    _thread_rng.np_rng = np.random.default_rng(h)


class Compose:
    """Transforms applied in order to a sample dict."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, labels):
        for t in self.transforms:
            labels = t(labels)
        return labels

    def __repr__(self):
        return f"Compose({', '.join(t.__class__.__name__ for t in self.transforms)})"


class Mosaic:
    """4-image mosaic: the sample and three companions tiled on a (2s, 2s) canvas around a random centre."""

    def __init__(self, dataset, imgsz: int = 640, p: float = 1.0):
        self.dataset = dataset
        self.imgsz = imgsz
        self.p = p
        self.border = (-imgsz // 2, -imgsz // 2)
        self._tls = threading.local()

    def _canvas(self, size: int) -> np.ndarray:
        """This thread's (size, size, 3) canvas filled with 114: RandomPerspective always warps it into a new array
        before the thread's next sample starts."""
        c = getattr(self._tls, "canvas", None)
        if c is None or c.shape[0] != size:
            c = np.empty((size, size, 3), np.uint8)
            self._tls.canvas = c
        c.fill(114)
        return c

    def _pick(self, k: int) -> list:
        """Companion indices: from the loader's sample window (the epoch permutation's trailing indices before this
        sample), uniform at its position 0; from the decode buffer or uniform outside a loader."""
        win = getattr(self.dataset, "sample_window", None)
        win = win() if callable(win) else None
        if win is not None:
            if len(win):
                return [int(x) for x in _rng().choices(list(win), k=k)]
            return [_rng().randint(0, len(self.dataset) - 1) for _ in range(k)]
        buf = getattr(self.dataset, "buffer", None)
        if buf:
            return _rng().choices(list(buf), k=k)
        return [_rng().randint(0, len(self.dataset) - 1) for _ in range(k)]

    def __call__(self, labels):
        if _rng().random() > self.p:
            return labels
        s = self.imgsz
        yc = int(_rng().uniform(s // 2, 2 * s - s // 2))
        xc = int(_rng().uniform(s // 2, 2 * s - s // 2))
        mix = [labels] + [self.dataset.get_sample(i) for i in self._pick(3)]
        canvas = self._canvas(s * 2)
        cls_all, box_all, kpt_all, seg_all = [], [], [], []
        for i, lb in enumerate(mix):
            img = lb["img"]
            h, w = img.shape[:2]
            if i == 0:  # top-left
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
            elif i == 1:  # top-right
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
                x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
            elif i == 2:  # bottom-left
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
            else:  # bottom-right
                x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
            canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            padw, padh = x1a - x1b, y1a - y1b
            if len(lb["bboxes"]):
                box_all.append(lb["bboxes"] + np.array([padw, padh, padw, padh], np.float32))
                cls_all.append(lb["cls"])
                if lb.get("keypoints") is not None:
                    k = lb["keypoints"].copy()
                    k[..., 0] += padw
                    k[..., 1] += padh
                    kpt_all.append(k)
                seg_all += [seg + np.array([padw, padh], np.float32) for seg in lb.get("segments") or []]
        out = {
            "img": canvas,
            "cls": np.concatenate(cls_all) if cls_all else np.zeros((0,), np.float32),
            "bboxes": np.concatenate(box_all) if box_all else np.zeros((0, 4), np.float32),
            "mosaic_border": self.border,
            "im_file": labels.get("im_file", ""),
            "ori_shape": labels.get("ori_shape", canvas.shape[:2]),
        }
        if seg_all:
            out["segments"] = seg_all
        if kpt_all:
            out["keypoints"] = np.concatenate(kpt_all)
        clip_sample(out, (s * 2, s * 2))
        return out


class MixUp:
    """Blend with a second sample by a Beta(32, 32) ratio; its boxes, keypoints and polygons join the sample's."""

    def __init__(self, dataset, pre_transform=None, p: float = 0.0):
        self.dataset = dataset
        self.pre_transform = pre_transform
        self.p = p

    def __call__(self, labels):
        if _rng().random() > self.p:
            return labels
        other = self.dataset.get_sample(_rng().randint(0, len(self.dataset) - 1))
        if self.pre_transform is not None:
            other = self.pre_transform(other)
        if other["img"].shape != labels["img"].shape:
            return labels
        r = float(_np_rng().beta(32.0, 32.0))
        labels["img"] = (labels["img"] * r + other["img"] * (1 - r)).astype(np.uint8)
        labels["cls"] = np.concatenate([labels["cls"], other["cls"]])
        labels["bboxes"] = np.concatenate([labels["bboxes"], other["bboxes"]])
        if labels.get("keypoints") is not None and other.get("keypoints") is not None:
            labels["keypoints"] = np.concatenate([labels["keypoints"], other["keypoints"]])
        segs = list(labels.get("segments") or []) + list(other.get("segments") or [])
        if segs and len(segs) == len(labels["bboxes"]):  # the JAX package drops the second's polygons here
            labels["segments"] = segs
        return labels


class CopyPaste:
    """Flip-mode copy-paste: with probability p, a share p of the instances whose mirrored box overlaps every box by
    less than 30% of that box (IoA) are pasted mirrored, their polygons filled by `fill_poly` (`cv2.fillPoly`) as
    the mask of the pixels taken from the mirrored image. Needs polygons; a sample without them is returned as it is,
    with no draw. It pastes into a copy: the JAX package pastes into the image it is given, which without mosaic is
    the loaded image that its RAM cache and decode buffer hold, so that later samples see the pastes."""

    def __init__(self, p: float = 0.0):
        self.p = p

    def __call__(self, labels):
        segs = labels.get("segments")
        if self.p == 0 or not segs or _rng().random() > self.p:
            return labels
        img = labels["img"] = labels["img"].copy()  # without mosaic, the loaded image itself (cache, buffer)
        h, w = img.shape[:2]
        boxes = labels["bboxes"]
        flipped = boxes.copy()
        flipped[:, [0, 2]] = w - boxes[:, [2, 0]]
        candidates = np.nonzero((bbox_ioa(flipped, boxes) < 0.30).all(1))[0]
        new_cls, new_box, new_seg = [], [], []
        for j in _rng().sample(list(candidates), k=round(self.p * len(candidates))):
            seg = segs[j].copy()
            seg[:, 0] = w - seg[:, 0]
            mask = fill_poly(np.zeros((h, w), np.uint8), [seg.astype(np.int32)], 1).astype(bool)
            img[mask] = img[:, ::-1][mask]
            new_cls.append(labels["cls"][j])
            new_box.append(flipped[j])
            new_seg.append(seg)
        if new_box:
            labels["cls"] = np.concatenate([labels["cls"], np.asarray(new_cls)])
            labels["bboxes"] = np.concatenate([labels["bboxes"], np.stack(new_box)])
            labels["segments"] = segs + new_seg
        return labels


def bbox_ioa(box1, box2, eps=1e-7):
    """(N, M) intersection of box1[i] and box2[j] over box2[j]'s area, xyxy."""
    a1, a2 = box1[:, None, :2], box1[:, None, 2:]
    b1, b2 = box2[None, :, :2], box2[None, :, 2:]
    inter = np.clip(np.minimum(a2, b2) - np.maximum(a1, b1), 0, None).prod(-1)
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return inter / (area2[None] + eps)


class RandomPerspective:
    """Affine warp of the image, its boxes, polygons and keypoints (rotation, scale, shear, translation), cropping a
    mosaic's 2s canvas back to s, and dropping boxes that the warp made degenerate. With one polygon per box, the
    polygons are warped and clipped to the frame and give the boxes; otherwise the box corners are warped. A kept
    box's keypoints that land outside the frame keep their coordinates with visibility 0."""

    def __init__(self, degrees=0.0, translate=0.1, scale=0.5, shear=0.0, perspective=0.0, border=(0, 0),
                 pre_transform=None):
        if perspective:
            raise ValueError(f"perspective={perspective}: the perspective warp is not ported yet (see ROADMAP.md)")
        self.degrees, self.translate, self.scale, self.shear, self.perspective = degrees, translate, scale, shear, 0.0
        self.border = border
        self.pre_transform = pre_transform

    def matrix(self, h: int, w: int, out_h: int, out_w: int) -> tuple[np.ndarray, float]:
        """The (3, 3) warp of an (h, w) image into (out_h, out_w), and its scale: eight draws in a fixed order."""
        C = np.eye(3)
        C[0, 2], C[1, 2] = -w / 2, -h / 2
        P = np.eye(3)
        P[2, 0] = _rng().uniform(-self.perspective, self.perspective)
        P[2, 1] = _rng().uniform(-self.perspective, self.perspective)
        R = np.eye(3)
        a = _rng().uniform(-self.degrees, self.degrees)
        s = _rng().uniform(1 - self.scale, 1 + self.scale)
        R[:2] = get_rotation_matrix_2d((0, 0), a, s)
        S = np.eye(3)
        S[0, 1] = math.tan(_rng().uniform(-self.shear, self.shear) * math.pi / 180)
        S[1, 0] = math.tan(_rng().uniform(-self.shear, self.shear) * math.pi / 180)
        T = np.eye(3)
        T[0, 2] = _rng().uniform(0.5 - self.translate, 0.5 + self.translate) * out_w
        T[1, 2] = _rng().uniform(0.5 - self.translate, 0.5 + self.translate) * out_h
        return T @ S @ R @ P @ C, s

    def __call__(self, labels):
        if self.pre_transform is not None and "mosaic_border" not in labels:
            labels = self.pre_transform(labels)
        border = labels.pop("mosaic_border", self.border)
        img = labels["img"]
        h, w = img.shape[:2]
        out_h, out_w = h + border[0] * 2, w + border[1] * 2
        Mt, s = self.matrix(h, w, out_h, out_w)
        if (border[0] != 0) or (border[1] != 0) or (Mt != np.eye(3)).any():
            img = warp_affine_u8(img, Mt[:2], (out_w, out_h), border=114)
        boxes = labels["bboxes"]
        segments = labels.get("segments")
        n = len(boxes)
        new_boxes = np.zeros((0, 4), np.float32)
        keep = np.zeros((0,), bool)
        if n and segments and len(segments) == n:  # boxes from the warped, clipped polygons
            new_segments, sb = [], []
            for seg in segments:
                pts = np.ones((len(seg), 3), np.float32)
                pts[:, :2] = seg
                p2 = (pts @ Mt.T)[:, :2]
                p2[:, 0] = p2[:, 0].clip(0, out_w)
                p2[:, 1] = p2[:, 1].clip(0, out_h)
                new_segments.append(p2.astype(np.float32))
                sb.append([p2[:, 0].min(), p2[:, 1].min(), p2[:, 0].max(), p2[:, 1].max()])
            new_boxes = np.asarray(sb, np.float32)
            keep = box_candidates(boxes.T * s, new_boxes.T, area_thr=0.01)
            labels["img"] = img
            labels["bboxes"] = new_boxes[keep]
            labels["cls"] = labels["cls"][keep]
            labels["segments"] = [sg for sg, k in zip(new_segments, keep) if k]
            if labels.get("keypoints") is not None:  # kept, not warped, as in the JAX package's polygon path
                labels["keypoints"] = labels["keypoints"][keep]
            return labels
        labels.pop("segments", None)  # out of step with the boxes: dropped, as in the JAX package
        if n:
            pts = np.ones((n * 4, 3), np.float32)
            pts[:, :2] = boxes[:, [0, 1, 2, 1, 2, 3, 0, 3]].reshape(n * 4, 2)
            pts = (pts @ Mt.T)[:, :2].reshape(n, 8)
            xs, ys = pts[:, [0, 2, 4, 6]], pts[:, [1, 3, 5, 7]]
            new_boxes = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], 1).astype(np.float32)
            new_boxes[:, [0, 2]] = new_boxes[:, [0, 2]].clip(0, out_w)
            new_boxes[:, [1, 3]] = new_boxes[:, [1, 3]].clip(0, out_h)
            keep = box_candidates(boxes.T * s, new_boxes.T, area_thr=0.10)
        labels["img"] = img
        labels["bboxes"] = new_boxes[keep]
        labels["cls"] = labels["cls"][keep] if n else labels["cls"]
        if labels.get("keypoints") is not None and n:
            k = labels["keypoints"][keep]
            if len(k):
                kp = np.ones((k.shape[0] * k.shape[1], 3), np.float32)
                kp[:, :2] = k[..., :2].reshape(-1, 2)
                kp = (kp @ Mt.T)[:, :2]
                vis = k[..., 2].reshape(-1)
                oob = (kp[:, 0] < 0) | (kp[:, 0] > out_w) | (kp[:, 1] < 0) | (kp[:, 1] > out_h)
                vis = np.where(oob, 0.0, vis)
                k = np.concatenate([kp, vis[:, None]], -1).reshape(k.shape[0], k.shape[1], 3)
            labels["keypoints"] = k
        return labels


def box_candidates(box1, box2, wh_thr=2, ar_thr=100, area_thr=0.1, eps=1e-16):
    """Keep warped boxes wider and taller than wh_thr px, of area ratio above area_thr and aspect below ar_thr."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


class RandomHSV:
    """Hue, saturation and value gains, by lookup tables over OpenCV's 8-bit HSV."""

    def __init__(self, hgain=0.5, sgain=0.5, vgain=0.5):
        self.hgain, self.sgain, self.vgain = hgain, sgain, vgain

    def __call__(self, labels):
        if not (self.hgain or self.sgain or self.vgain):
            return labels
        img = labels["img"]
        r = _np_rng().uniform(-1, 1, 3) * [self.hgain, self.sgain, self.vgain] + 1
        x = np.arange(0, 256, dtype=r.dtype)
        lut_h = ((x * r[0]) % 180).astype(img.dtype)
        lut_s = np.clip(x * r[1], 0, 255).astype(img.dtype)
        lut_v = np.clip(x * r[2], 0, 255).astype(img.dtype)
        hsv = rgb_to_hsv_u8(img)
        hsv = np.stack([lut_h[hsv[..., 0]], lut_s[hsv[..., 1]], lut_v[hsv[..., 2]]], -1)
        labels["img"] = hsv_to_rgb_u8(hsv)
        return labels


class RandomFlip:
    """Horizontal or vertical flip (boxes, polygons, keypoints) with probability p; a horizontal flip reorders the
    keypoints by `flip_idx` (left and right swap) when it is given."""

    def __init__(self, p=0.5, direction="horizontal", flip_idx=None):
        if direction not in {"horizontal", "vertical"}:
            raise ValueError(f"direction {direction!r}")
        self.p, self.direction, self.flip_idx = p, direction, flip_idx

    def __call__(self, labels):
        if _rng().random() >= self.p:
            return labels
        img = labels["img"]
        h, w = img.shape[:2]
        boxes = labels["bboxes"]
        if self.direction == "horizontal":
            labels["img"] = np.ascontiguousarray(img[:, ::-1])
            if len(boxes):
                boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
            for seg in labels.get("segments") or []:
                seg[:, 0] = w - seg[:, 0]
            if labels.get("keypoints") is not None:
                k = labels["keypoints"]
                k[..., 0] = w - k[..., 0]
                if self.flip_idx is not None and len(k):
                    k = k[:, np.asarray(self.flip_idx, int)]
                labels["keypoints"] = np.ascontiguousarray(k)
        else:
            labels["img"] = np.ascontiguousarray(img[::-1])
            if len(boxes):
                boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
            for seg in labels.get("segments") or []:
                seg[:, 1] = h - seg[:, 1]
            if labels.get("keypoints") is not None:
                labels["keypoints"][..., 1] = h - labels["keypoints"][..., 1]
        labels["bboxes"] = boxes
        return labels


class LetterBoxT:
    """Letterbox to `new_shape` (the uint8 INTER_LINEAR resize and a 114 border), boxes, polygons and keypoints moved
    with the image; records `ratio_pad` = (gain, (pad_w, pad_h))."""

    def __init__(self, new_shape=(640, 640), scaleup=True):
        self.new_shape = new_shape if isinstance(new_shape, (tuple, list)) else (new_shape, new_shape)
        self.scaleup = scaleup

    def __call__(self, labels):
        img = labels["img"]
        new_shape = labels.pop("rect_shape", None) or self.new_shape  # a rect batch's shape, when the dataset plans one
        r, (dw, dh), _ = letterbox_params(img.shape[:2], new_shape, scaleup=self.scaleup)
        labels["img"] = letterbox_u8(torch.from_numpy(np.ascontiguousarray(img))[None], new_shape,
                                     scaleup=self.scaleup)[0].numpy()
        if len(labels["bboxes"]):
            b = labels["bboxes"] * r
            b[:, [0, 2]] += dw
            b[:, [1, 3]] += dh
            labels["bboxes"] = b
        if labels.get("keypoints") is not None:
            k = labels["keypoints"]
            k[..., 0] = k[..., 0] * r + dw
            k[..., 1] = k[..., 1] * r + dh
        if labels.get("segments"):
            labels["segments"] = [seg * r + np.array([dw, dh], np.float32) for seg in labels["segments"]]
        labels["ratio_pad"] = (r, (dw, dh))
        return labels


class BGRChannel:
    """RGB <-> BGR with probability p."""

    def __init__(self, p=0.0):
        self.p = p

    def __call__(self, labels):
        if _rng().random() < self.p:
            labels["img"] = np.ascontiguousarray(labels["img"][..., ::-1])
        return labels


def clip_sample(labels, shape):
    """Clip boxes (and polygons, one per box) to (h, w) and drop the empty ones, with their polygons and keypoints
    (which are not clipped)."""
    h, w = shape
    b = labels["bboxes"]
    if len(b):
        b[:, [0, 2]] = b[:, [0, 2]].clip(0, w)
        b[:, [1, 3]] = b[:, [1, 3]].clip(0, h)
        keep = (b[:, 2] - b[:, 0] > 1e-3) & (b[:, 3] - b[:, 1] > 1e-3)
        labels["bboxes"] = b[keep]
        labels["cls"] = labels["cls"][keep]
        if labels.get("keypoints") is not None:
            labels["keypoints"] = labels["keypoints"][keep]
        if labels.get("segments") and len(labels["segments"]) == len(keep):
            for seg in labels["segments"]:
                seg[:, 0] = seg[:, 0].clip(0, w)
                seg[:, 1] = seg[:, 1].clip(0, h)
            labels["segments"] = [seg for seg, k in zip(labels["segments"], keep) if k]
    return labels


def v8_transforms(dataset, imgsz: int, hyp):
    """The train pipeline: mosaic, copy-paste, affine, mixup (over a second mosaic, copy-paste and affine), HSV, BGR,
    flips (the horizontal one with the dataset's `flip_idx`)."""
    mosaic = Mosaic(dataset, imgsz=imgsz, p=hyp.mosaic)
    affine = RandomPerspective(degrees=hyp.degrees, translate=hyp.translate, scale=hyp.scale, shear=hyp.shear,
                               perspective=hyp.perspective, pre_transform=LetterBoxT((imgsz, imgsz)))
    return Compose([
        mosaic,
        CopyPaste(p=hyp.copy_paste),
        affine,
        MixUp(dataset, pre_transform=Compose([mosaic, CopyPaste(p=hyp.copy_paste), affine]), p=hyp.mixup),
        RandomHSV(hgain=hyp.hsv_h, sgain=hyp.hsv_s, vgain=hyp.hsv_v),
        BGRChannel(p=hyp.bgr),
        RandomFlip(p=hyp.flipud, direction="vertical"),
        RandomFlip(p=hyp.fliplr, direction="horizontal", flip_idx=getattr(dataset, "flip_idx", None)),
    ])

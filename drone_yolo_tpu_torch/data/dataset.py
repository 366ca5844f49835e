"""YOLO-format detection, segmentation and pose dataset: label cache, image loading with a decode buffer, transforms,
padded batches; and the image-folder classification dataset (`ClassificationDataset`).

Counterpart of `drone_yolo_tpu/data/dataset.py` (YOLODataset) for the detect, segment, pose and obb tasks. A
batch from `collate` is a dict of numpy arrays: `img` (B, H, W, 3) uint8 RGB, `cls` (B, M)
float32 class ids, `bboxes` (B, M, 4) float32 xyxy pixels and `mask` (B, M) float32 slot
validity, with M from `round_label_slots`; for the segment task `masks` (B, H / r, W / r) int32, the
overlap index mask of each image at `mask_ratio` r (`polygons2masks_overlap`: pixel value j + 1 for the
j-th instance by area, largest first), with each image's instances reordered to match; for the pose task
`keypoints` (B, M, nk, 3) float32 (x, y in pixels, visibility), nk from the data yaml's `kpt_shape`; and
per image `im_files`, `ori_shapes` (h, w) and `ratio_pads` ((gain, (pad_w, pad_h)) from the letterbox, or
None); for the obb task `segments_list`, per image its polygons (K, 2) float32 in pixels after the transforms, in
step with its boxes (all of them, not only the first M). Polygon labels are read for every task and go through the
augmentation (`data/augment.py`); the segment task turns them into masks, the obb task's trainer and validator into
rotated boxes.

The label cache is the JAX package's file: `<labels dir>.cache.npz` beside the labels, the
same version, hash and pickled list of label dicts, so either package reads the other's.
Images are decoded by `data/jpeg.py` and resized so that the long side is `imgsz`:
bilinear (`ops/letterbox.py:resize_linear_u8`) for training or enlarging, area
(`ops/image.py:resize_area_u8`) for shrinking validation images.

With `rect` (validation only) `set_rectangle` sorts the images by aspect ratio and gives
each batch one shape, the JAX package's plan (`drone_yolo_tpu/data/dataset.py:set_rectangle`):
the batch's aspect range mapped to imgsz, rounded up to a multiple of the stride after a
`pad` of half a stride, with the rounding step doubled until at most `rect_max_shapes`
distinct shapes remain. Each sample is letterboxed to its batch's shape, not enlarged.
"""

from __future__ import annotations

import glob
import logging
import math
import os
import threading
from pathlib import Path

import numpy as np
import torch

from drone_yolo_tpu_torch.data.augment import Compose, LetterBoxT, _rng, seed_sample, v8_transforms
from drone_yolo_tpu_torch.data.utils import (DECODED_FORMATS, IMG_FORMATS, get_hash, img2label_paths, imread_rgb,
                                             polygons2masks_overlap, verify_image_label)
from drone_yolo_tpu_torch.ops.image import resize_area_u8
from drone_yolo_tpu_torch.ops.letterbox import resize_linear_u8

LOGGER = logging.getLogger("drone_yolo_tpu_torch")
DATASET_CACHE_VERSION = "1.0"


def round_label_slots(n_max: int, headroom: float) -> int:
    """GT slots per image: n_max labels x augmentation headroom, rounded up to a multiple of 32 (up to 128
    needed) or 128, at least 32 and at most 2048 (`drone_yolo_tpu/data/dataset.py:round_label_slots`)."""
    need = int(max(n_max * headroom, 1))
    q = 32 if need <= 128 else 128
    return min(max(32, -(-need // q) * q), 2048)


class YOLODataset:
    """Detection, segmentation, pose and oriented box dataset over YOLO-txt labels. `hyp` is the train configuration
    (augmentation keys, `mask_ratio`)."""

    def __init__(self, img_path, imgsz: int = 640, cache: bool = False, augment: bool = True, hyp=None,
                 prefix: str = "", batch_size: int = 16, stride: int = 32, pad: float = 0.5, single_cls: bool = False,
                 classes=None, fraction: float = 1.0, data: dict | None = None, task: str = "detect",
                 max_labels: int | None = None, rect: bool = False, rect_max_shapes: int = 8):
        self.img_path = img_path
        self.imgsz = imgsz
        self.augment = augment
        self.single_cls = single_cls
        self.prefix = prefix
        self.fraction = fraction
        self.data = data or {}
        if task not in ("detect", "segment", "pose", "obb"):
            raise NotImplementedError(f"task {task!r}: the port's dataset reads detect, segment, pose and obb labels "
                                      "only")
        self.task = task
        self.use_segments = task == "segment"
        self.use_keypoints = task == "pose"
        self.kpt_shape = self.data.get("kpt_shape", (0, 0))
        self.flip_idx = self.data.get("flip_idx", None)
        self.im_files = self.get_img_files(img_path)
        self.label_files = img2label_paths(self.im_files)
        self.labels = self.cache_labels()
        self.update_labels(classes)
        self.ni = len(self.labels)
        self.batch_size = batch_size
        self.stride = stride
        self.pad = pad
        self.hyp = hyp
        self.cache = cache
        self._ram: dict = {}
        # recently decoded images stay in a bounded FIFO (train only), where mosaic companions find them
        self.buffer: list = []
        self._buffer_ims: dict = {}
        self._buffer_lock = threading.Lock()
        self.max_buffer_length = min(self.ni, batch_size * 8, 1000) if augment else 0
        self.epoch = 0
        self.aug_seed = 0
        self._sample_ctx = threading.local()
        self.rect = rect and not augment
        self.batch_shapes = self.batch = None
        if self.rect:
            self.set_rectangle(rect_max_shapes)
        n_max = max((len(lb["cls"]) for lb in self.labels), default=1)
        mosaic_on = augment and hyp is not None and (hyp.mosaic or 0) > 0
        mixup_on = augment and hyp is not None and (hyp.mixup or 0) > 0
        headroom = (5 if mixup_on else 4) if mosaic_on else (2 if mixup_on else 1.25)
        self.max_labels = max_labels or round_label_slots(n_max, headroom)
        self.transforms = self.build_transforms(hyp)

    # -- files and labels ----------------------------------------------------------
    def get_img_files(self, img_path) -> list[str]:
        """Image files under a directory, from a txt list, or from a list of either; sorted."""
        f = []
        for p in img_path if isinstance(img_path, list) else [img_path]:
            p = Path(p)
            if p.is_dir():
                f += glob.glob(str(p / "**" / "*.*"), recursive=True)
            elif p.is_file():
                with open(p, encoding="utf-8") as t:
                    parent = str(p.parent) + os.sep
                    f += [x.replace("./", parent) if x.startswith("./") else x for x in t.read().strip().splitlines()]
            else:
                raise FileNotFoundError(f"{self.prefix}{p} does not exist")
        im_files = sorted(x for x in f if x.split(".")[-1].lower() in IMG_FORMATS)
        undecoded = sorted({x.split(".")[-1].lower() for x in im_files} - DECODED_FORMATS)
        if undecoded:
            raise NotImplementedError(f"{self.prefix}{img_path}: .{', .'.join(undecoded)} images are not decoded by the "
                                      f"port yet (JPEG and PNG only; see ROADMAP.md)")
        if not im_files:
            raise FileNotFoundError(f"{self.prefix}No images found in {img_path}")
        if self.fraction < 1:
            im_files = im_files[: round(len(im_files) * self.fraction)]
        return im_files

    def cache_labels(self) -> list[dict]:
        """Labels from the cache file when its version and hash match, else verified anew and cached."""
        cache_path = Path(self.label_files[0]).parent.with_suffix(".cache.npz") if self.label_files else None
        h = get_hash(self.label_files + self.im_files)
        if cache_path and cache_path.exists():
            try:
                z = np.load(cache_path, allow_pickle=True)  # written by this package or the JAX one
                if str(z["version"]) == DATASET_CACHE_VERSION and str(z["hash"]) == h:
                    return list(z["labels"])
            except (OSError, ValueError, KeyError) as e:
                LOGGER.warning(f"{self.prefix}label cache {cache_path} unreadable ({e}); verifying the labels again")
        nkpt, ndim = self.kpt_shape or (0, 0)
        labels = []
        nm = nf = ne = nc_bad = 0
        msgs = []
        for im_file, lb_file in zip(self.im_files, self.label_files):
            im, lb, shape, segs, kpts, nm_, nf_, ne_, nc_, msg = verify_image_label(
                im_file, lb_file, self.data.get("nc", 999), self.use_keypoints, nkpt, ndim, self.single_cls)
            nm, nf, ne, nc_bad = nm + nm_, nf + nf_, ne + ne_, nc_bad + nc_
            if msg:
                msgs.append(msg)
            if im is None:
                continue
            labels.append({"im_file": im, "shape": shape, "cls": lb[:, 0], "bboxes_n": lb[:, 1:], "segments": segs,
                           "keypoints": kpts})
        if msgs:
            LOGGER.info("\n".join(msgs[:10]))
        if nf == 0:
            LOGGER.warning(f"{self.prefix}no labels found; training will not work correctly")
        LOGGER.info(f"{self.prefix}{nf} labels, {nm} missing, {ne} empty, {nc_bad} corrupt")
        if cache_path:
            try:
                np.savez(cache_path, labels=np.array(labels, dtype=object), hash=h, version=DATASET_CACHE_VERSION)
            except OSError as e:
                LOGGER.warning(f"{self.prefix}cache not saved: {e}")
        self.im_files = [lb["im_file"] for lb in labels]
        return labels

    def update_labels(self, classes) -> None:
        """Keep only `classes` (with their polygons and keypoints); single_cls makes every class 0."""
        if classes is not None:
            inc = np.asarray(classes).reshape(1, -1)
            for lb in self.labels:
                keep = (lb["cls"].reshape(-1, 1) == inc).any(1)
                lb["cls"], lb["bboxes_n"] = lb["cls"][keep], lb["bboxes_n"][keep]
                if lb["keypoints"] is not None:
                    lb["keypoints"] = lb["keypoints"][keep]
                if lb["segments"]:  # the JAX package keeps every polygon here; kept in step with the boxes instead
                    lb["segments"] = [seg for seg, k in zip(lb["segments"], keep) if k]
        if self.single_cls:
            for lb in self.labels:
                lb["cls"][:] = 0

    def set_rectangle(self, max_shapes: int = 8) -> None:
        """Sort the images by aspect ratio (h / w) and plan one letterbox shape per batch: `batch` (image -> batch
        index) and `batch_shapes` ((nb, 2) h, w), with at most `max_shapes` distinct shapes."""
        bi = np.floor(np.arange(self.ni) / self.batch_size).astype(int)
        nb = int(bi[-1]) + 1
        s = np.array([lb["shape"] for lb in self.labels], np.float64)
        ar = s[:, 0] / s[:, 1]
        irect = ar.argsort()
        self.labels = [self.labels[i] for i in irect]
        self.im_files = [lb["im_file"] for lb in self.labels]
        ar = ar[irect]
        shapes = np.ones((nb, 2), np.float64)
        for i in range(nb):
            ari = ar[bi == i]
            mini, maxi = ari.min(), ari.max()
            if maxi < 1:
                shapes[i] = [maxi, 1]
            elif mini > 1:
                shapes[i] = [1, 1 / mini]
        q = self.stride
        while True:
            batch_shapes = (np.ceil(shapes * self.imgsz / q + self.pad) * q).astype(int)
            n_distinct = len({tuple(x) for x in batch_shapes})
            if n_distinct <= max_shapes or q >= self.imgsz:
                break
            q *= 2
        if q != self.stride:
            LOGGER.info(f"{self.prefix}rect: merged the batch shapes to {n_distinct} (rounded to {q} px)")
        self.batch_shapes = batch_shapes
        self.batch = bi

    # -- samples ---------------------------------------------------------------------
    def load_image(self, i: int) -> np.ndarray:
        """Image i as (h, w, 3) uint8 RGB with its long side resized to imgsz. Kept in RAM with `cache`, and in the
        decode buffer while training; no transform writes into a loaded image, so sharing it is safe."""
        if i in self._ram:
            return self._ram[i]
        im = self._buffer_ims.get(i)
        if im is not None:
            return im
        path = self.labels[i]["im_file"]
        im = imread_rgb(path)
        h0, w0 = im.shape[:2]
        r = self.imgsz / max(h0, w0)
        if r != 1:
            size = (min(math.ceil(w0 * r), self.imgsz), min(math.ceil(h0 * r), self.imgsz))  # (w, h)
            if self.augment or r > 1:
                im = resize_linear_u8(torch.from_numpy(im)[None], (size[1], size[0]))[0].numpy()
            else:
                im = resize_area_u8(im, size)
        if self.cache:
            self._ram[i] = im
        if self.max_buffer_length:
            with self._buffer_lock:
                if not self.cache:
                    self._buffer_ims[i] = im
                self.buffer.append(i)
                if len(self.buffer) > self.max_buffer_length:
                    self._buffer_ims.pop(self.buffer.pop(0), None)
        return im

    def get_sample(self, i: int) -> dict:
        """Sample i before the transforms: the loaded image, its boxes in pixel xyxy, its polygons and keypoints in
        pixels."""
        lb = self.labels[i]
        img = self.load_image(i)
        h, w = img.shape[:2]
        bn = lb["bboxes_n"]
        boxes = np.zeros((0, 4), np.float32)
        if len(bn):
            cx, cy, bw, bh = bn[:, 0] * w, bn[:, 1] * h, bn[:, 2] * w, bn[:, 3] * h
            boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1).astype(np.float32)
        out = {"img": img, "cls": lb["cls"].astype(np.float32).copy(), "bboxes": boxes, "im_file": lb["im_file"],
               "ori_shape": lb["shape"]}
        if lb["segments"]:
            out["segments"] = [seg * np.array([w, h], np.float32) for seg in lb["segments"]]
        if lb["keypoints"] is not None:
            k = lb["keypoints"].copy()
            k[..., 0] *= w
            k[..., 1] *= h
            out["keypoints"] = k.astype(np.float32)
        if self.rect:
            out["rect_shape"] = tuple(int(x) for x in self.batch_shapes[self.batch[i]])
        return out

    def __len__(self) -> int:
        return self.ni

    def set_epoch(self, epoch: int, seed: int | None = None) -> None:
        """The epoch (and seed) of the per-sample augmentation draws; the loader sets it."""
        self.epoch = int(epoch)
        if seed is not None:
            self.aug_seed = int(seed)

    def set_sample_window(self, window) -> None:
        """Mosaic companions for this thread's next sample: the epoch permutation's indices just before it."""
        self._sample_ctx.window = window

    def sample_window(self):
        return getattr(self._sample_ctx, "window", None)

    def __getitem__(self, i: int) -> dict:
        seed_sample(self.aug_seed, self.epoch, int(i))
        return self.transforms(self.get_sample(i))

    # -- transforms ----------------------------------------------------------------------
    def build_transforms(self, hyp=None) -> Compose:
        """Train: `v8_transforms`; validation: the letterbox, which does not enlarge."""
        if self.augment and hyp is not None:
            return v8_transforms(self, self.imgsz, hyp)
        return Compose([LetterBoxT((self.imgsz, self.imgsz), scaleup=False)])

    def close_mosaic(self, hyp) -> None:
        """Turn mosaic, mixup and copy-paste off in `hyp` and rebuild the transforms (the last epochs)."""
        hyp.mosaic = hyp.mixup = hyp.copy_paste = 0.0
        self.transforms = self.build_transforms(hyp)

    def collate(self, samples: list[dict]) -> dict:
        """Stack the images and pad the labels (and the pose task's keypoints) to `max_labels` slots (extra labels
        are dropped); for the segment task draw each image's overlap index mask of its first `max_labels` polygons
        and reorder those instances' classes and boxes to its order."""
        b, m = len(samples), self.max_labels
        imgs = np.stack([s["img"] for s in samples])
        cls = np.zeros((b, m), np.float32)
        boxes = np.zeros((b, m, 4), np.float32)
        mask = np.zeros((b, m), np.float32)
        kpts = np.zeros((b, m, self.kpt_shape[0], 3), np.float32) if self.use_keypoints else None
        seg_masks = None
        if self.use_segments:
            ratio = int(getattr(self.hyp, "mask_ratio", 4) or 4)
            seg_masks = np.zeros((b, imgs.shape[1] // ratio, imgs.shape[2] // ratio), np.int32)
        for i, s in enumerate(samples):
            n = min(len(s["cls"]), m)
            if seg_masks is not None and s.get("segments"):
                seg_masks[i], order = polygons2masks_overlap(imgs.shape[1:3], s["segments"][:n], ratio)
                s = {**s, "cls": s["cls"][order], "bboxes": s["bboxes"][order]}
            cls[i, :n], boxes[i, :n], mask[i, :n] = s["cls"][:n], s["bboxes"][:n], 1.0
            if kpts is not None and n and s.get("keypoints") is not None:
                kpts[i, :n] = s["keypoints"][:n]
        batch = {"img": imgs, "cls": cls, "bboxes": boxes, "mask": mask,
                 "im_files": [s.get("im_file", "") for s in samples],
                 "ori_shapes": [s.get("ori_shape", s["img"].shape[:2]) for s in samples],
                 "ratio_pads": [s.get("ratio_pad") for s in samples]}
        if kpts is not None:
            batch["keypoints"] = kpts
        if seg_masks is not None:
            batch["masks"] = seg_masks
        if self.task == "obb":
            batch["segments_list"] = [s.get("segments", []) for s in samples]
        return batch


class ClassificationDataset:
    """An image-folder classification dataset: `root/<class>/**/<image>`, classes sorted by name, images sorted within
    each class; a sample is {"img": (imgsz, imgsz, 3) uint8 RGB, "cls": class index}.

    Counterpart of `drone_yolo_tpu/data/dataset.py` `ClassificationDataset`, draw for draw. Train (`augment`): the
    sample's generators are seeded from (aug_seed, epoch, index) (`seed_sample`), then up to 10 tries of a random
    window (area share U(0.5, 1), aspect exp(U(log 3/4, log 4/3)), sides round(sqrt(area * aspect)) and
    round(sqrt(area / aspect)), a corner by `randint`, both ends included) until one fits, a resize to imgsz x imgsz
    and a horizontal flip with probability 0.5. Validation: the short side resized to imgsz (the other by Python's
    round), then the centre imgsz x imgsz crop. Resizes are `ops/letterbox.py:resize_linear_u8` (cv2's INTER_LINEAR,
    which the JAX package calls). `fraction` keeps the first share of the samples. Image formats the port does not
    decode (all but JPEG and PNG) are refused by name, as `YOLODataset` refuses them.
    """

    def __init__(self, root, imgsz: int = 224, augment: bool = False, fraction: float = 1.0, hyp=None):
        self.root = Path(root)
        self.imgsz = imgsz
        self.augment = augment
        self.hyp = hyp
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = [(str(f), self.class_to_idx[c]) for c in classes for f in sorted((self.root / c).rglob("*.*"))
                        if f.suffix[1:].lower() in IMG_FORMATS]
        undecoded = sorted({Path(f).suffix[1:].lower() for f, _ in self.samples} - DECODED_FORMATS)
        if undecoded:
            raise NotImplementedError(f"{root}: .{', .'.join(undecoded)} images are not decoded by the port yet (JPEG "
                                      "and PNG only; see ROADMAP.md)")
        if fraction < 1.0:
            self.samples = self.samples[: round(len(self.samples) * fraction)]
        self.epoch = 0
        self.aug_seed = 0

    def __len__(self) -> int:
        return len(self.samples)

    @staticmethod
    def _resize(im: np.ndarray, h: int, w: int) -> np.ndarray:
        return resize_linear_u8(torch.from_numpy(np.ascontiguousarray(im))[None], (h, w))[0].numpy()

    def __getitem__(self, i: int) -> dict:
        path, label = self.samples[i]
        im = imread_rgb(path)
        if self.augment:
            seed_sample(self.aug_seed, self.epoch, int(i))
            rng = _rng()
            h, w = im.shape[:2]
            area = h * w
            for _ in range(10):
                ta = area * rng.uniform(0.5, 1.0)
                ar = math.exp(rng.uniform(math.log(3 / 4), math.log(4 / 3)))
                cw, ch = int(round(math.sqrt(ta * ar))), int(round(math.sqrt(ta / ar)))
                if cw <= w and ch <= h:
                    x0, y0 = rng.randint(0, w - cw), rng.randint(0, h - ch)
                    im = im[y0 : y0 + ch, x0 : x0 + cw]
                    break
            im = self._resize(im, self.imgsz, self.imgsz)
            if rng.random() < 0.5:
                im = np.ascontiguousarray(im[:, ::-1])
        else:
            h, w = im.shape[:2]
            r = self.imgsz / min(h, w)
            im = self._resize(im, round(h * r), round(w * r))
            top, left = (im.shape[0] - self.imgsz) // 2, (im.shape[1] - self.imgsz) // 2
            im = np.ascontiguousarray(im[top : top + self.imgsz, left : left + self.imgsz])
        return {"img": im, "cls": label}

    def set_epoch(self, epoch: int, seed: int | None = None) -> None:
        """The epoch (and seed) of the per-sample augmentation draws; the loader sets it."""
        self.epoch = int(epoch)
        if seed is not None:
            self.aug_seed = int(seed)

    def collate(self, samples: list[dict]) -> dict:
        """{"img": (B, imgsz, imgsz, 3) uint8, "cls": (B,) int32}."""
        return {"img": np.stack([s["img"] for s in samples]), "cls": np.asarray([s["cls"] for s in samples], np.int32)}

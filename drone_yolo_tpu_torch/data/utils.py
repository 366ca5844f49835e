"""Dataset files: label paths, the cache hash, one image-label check, and the dataset yaml.

Counterpart of `drone_yolo_tpu/data/utils.py` (`img2label_paths`, `get_hash`,
`verify_image_label` for box, polygon and keypoint labels, `polygon2mask`, `polygons2masks_overlap`,
`check_det_dataset`, `imread_rgb`). Polygons are drawn by `ops/polygon.py:fill_poly` (`cv2.fillPoly`). Images are
read by the port's own decoders, JPEG (`data/jpeg.py`) and PNG (`data/png.py`); the other
formats of the JAX package's `IMG_FORMATS` are refused by name (ROADMAP). The yaml is read by the
port's YAML subset (`nn/build.py:load_yaml`). Nothing is downloaded: a missing dataset
raises.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np
import torch

from drone_yolo_tpu_torch.data.jpeg import decode_jpeg, jpeg_shape
from drone_yolo_tpu_torch.data.png import decode_png, png_shape
from drone_yolo_tpu_torch.nn.build import load_yaml
from drone_yolo_tpu_torch.ops.letterbox import resize_linear_u8
from drone_yolo_tpu_torch.ops.polygon import fill_poly

IMG_FORMATS = {"bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp", "pfm", "heic"}  # listed as images
VID_FORMATS = {"asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "ts", "wmv", "webm"}  # listed as videos
DECODED_FORMATS = {"jpeg", "jpg", "png"}  # what the port decodes


def _format(path) -> str:
    suffix = str(path).rsplit(".", 1)[-1].lower()
    if suffix not in DECODED_FORMATS:
        raise ValueError(f"{path}: .{suffix} images are not decoded by the port yet (JPEG and PNG only; see ROADMAP.md)")
    return suffix


def imread(path) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 BGR, equal to cv2.imread(path) for JPEG and PNG files."""
    if _format(path) == "png":
        return decode_png(Path(path).read_bytes())
    return np.ascontiguousarray(decode_jpeg(Path(path).read_bytes())[..., ::-1])


def imread_rgb(path) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB, equal to cv2.imread(path, IMREAD_COLOR_RGB) for JPEG and PNG files."""
    if _format(path) == "png":
        return np.ascontiguousarray(decode_png(Path(path).read_bytes())[..., ::-1])
    return decode_jpeg(Path(path).read_bytes())


def image_shape(path) -> tuple[int, int]:
    """(height, width) of a JPEG or PNG file, from its header."""
    if _format(path) == "png":
        with open(path, "rb") as f:
            return png_shape(f.read(24))
    return jpeg_shape(path)


def img2label_paths(img_paths):
    """…/images/xx.jpg -> …/labels/xx.txt."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return [sb.join(x.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt" for x in img_paths]


def get_hash(paths) -> str:
    """Hash of the files' total size and their names, which validates a label cache."""
    size = sum(os.path.getsize(p) for p in paths if os.path.exists(p))
    h = hashlib.sha256(str(size).encode())
    h.update("".join(paths).encode())
    return h.hexdigest()


def verify_image_label(im_file, lb_file, num_cls: int, keypoint: bool = False, nkpt: int = 0, ndim: int = 0,
                       single_cls: bool = False):
    """Check one image and its labels: (im_file, labels (N, 5) float32, shape (h, w), segments (N polygons (K, 2)
    float32, normalized, or []), keypoints (N, nkpt, 3) or None, missing, found, empty, corrupt, message); im_file
    is None for a corrupt pair.

    A row is `cls cx cy w h`, normalized. Without `keypoint`, a file with a row of more than 6 values holds
    polygons, `cls x1 y1 x2 y2 ...`: each row's box is its polygon's extent, for every task, as in the JAX package.
    With `keypoint`, a row is `cls cx cy w h` and `nkpt` points of `ndim` values (x, y[, visibility]); points of two
    values get visibility 1. Duplicate rows are dropped with their polygons and keypoints."""
    nm = nf = ne = 0
    msg = ""
    keypoints = None
    segments = []
    try:
        fmt = str(im_file).rsplit(".", 1)[-1].lower()
        if fmt not in DECODED_FORMATS:
            raise ValueError(f"invalid image format {fmt} (the port reads JPEG and PNG only)")
        shape = image_shape(im_file)
        if shape[0] < 10 or shape[1] < 10:
            raise ValueError(f"image size {shape} <10 pixels")
        if os.path.isfile(lb_file):
            nf = 1
            with open(lb_file, encoding="utf-8") as f:
                rows = [x.split() for x in f.read().strip().splitlines() if len(x)]
            cols = 5 + nkpt * ndim if keypoint else 5
            if any(len(r) > 6 for r in rows) and not keypoint:  # polygons
                segments = [np.array(r[1:], dtype=np.float32).reshape(-1, 2) for r in rows]
                boxes = np.array([_segment2box_norm(seg) for seg in segments], dtype=np.float32)
                lb = np.concatenate([np.array([r[0] for r in rows], dtype=np.float32).reshape(-1, 1), boxes], 1)
            else:
                lb = np.array(rows, dtype=np.float32) if rows else np.zeros((0, cols), np.float32)
            n = len(lb)
            if n:
                if lb.shape[1] != cols:
                    raise ValueError(f"labels require {cols} columns, got {lb.shape[1]}")
                if keypoint:
                    keypoints = lb[:, 5:].reshape(-1, nkpt, ndim)
                    if ndim == 2:  # no visibility column: every point is visible
                        keypoints = np.concatenate([keypoints, np.ones_like(keypoints[..., :1])], axis=-1)
                    lb = lb[:, :5]
                pts = lb[:, 1:]
                if pts.max() > 1.01:
                    raise ValueError(f"non-normalized or out-of-bounds coordinates {pts[pts > 1.01]}")
                if lb.min() < -0.01:
                    raise ValueError(f"negative label values {lb[lb < -0.01]}")
                if single_cls:
                    lb[:, 0] = 0
                max_cls = int(lb[:, 0].max())
                if max_cls >= num_cls:
                    raise ValueError(f"label class {max_cls} exceeds dataset nc={num_cls}")
                _, idx = np.unique(lb, axis=0, return_index=True)
                if len(idx) < n:
                    lb = lb[np.sort(idx)]
                    if keypoints is not None:  # the JAX package keeps every row's points here; kept in step instead
                        keypoints = keypoints[np.sort(idx)]
                    if segments:
                        segments = [segments[i] for i in np.sort(idx)]
                    msg = f"removed {n - len(idx)} duplicate labels"
            else:
                ne = 1
        else:
            nm = 1
            lb = np.zeros((0, 5), np.float32)
        return im_file, lb, shape, segments, keypoints, nm, nf, ne, 0, msg
    except (ValueError, OSError) as e:
        return None, None, None, [], None, nm, nf, ne, 1, f"ignoring corrupt image/label {im_file}: {e}"


def _segment2box_norm(seg: np.ndarray) -> list:
    """A normalized polygon (K, 2) -> its extent as [cx, cy, w, h], in float32."""
    x, y = seg[:, 0], seg[:, 1]
    x1, y1, x2, y2 = x.min(), y.min(), x.max(), y.max()
    return [(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1]


def polygon2mask(imgsz, polygons, color: int = 1, downsample_ratio: int = 1) -> np.ndarray:
    """An (h, w) uint8 mask of `polygons` (pixel x, y, truncated to integers) filled with `color`
    (`cv2.fillPoly`), then with `downsample_ratio` > 1 resized to (h // r, w // r) as `cv2.resize`'s INTER_LINEAR
    (`resize_linear_u8`)."""
    mask = np.zeros(imgsz, dtype=np.uint8)
    fill_poly(mask, np.asarray(polygons, dtype=np.int32).reshape(len(polygons), -1, 2), color)
    if downsample_ratio > 1:
        size = (imgsz[0] // downsample_ratio, imgsz[1] // downsample_ratio)
        mask = resize_linear_u8(torch.from_numpy(mask)[None, :, :, None], size)[0, :, :, 0].numpy()
    return mask


def polygons2masks_overlap(imgsz, segments, downsample_ratio: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """One index mask of (h // r, w // r) for overlapping instances: pixel value j + 1 for the j-th instance by
    area, largest first, so that a smaller instance overwrites a larger one; returns (mask, order), order[j] the
    index in `segments` of the j-th instance (`drone_yolo_tpu/data/utils.py:polygons2masks_overlap`)."""
    masks = np.zeros((imgsz[0] // downsample_ratio, imgsz[1] // downsample_ratio),
                     dtype=np.uint8 if len(segments) <= 255 else np.int32)
    ms = [polygon2mask(imgsz, [seg.reshape(-1)], 1, downsample_ratio) for seg in segments]
    order = np.argsort(-np.asarray([m.sum() for m in ms]))
    for i, oi in enumerate(order):
        masks = np.where(ms[oi], i + 1, masks)
    return masks, order


def datasets_dir() -> Path:
    """The datasets directory: $YOLO_DATASETS_DIR, else ./datasets."""
    return Path(os.environ.get("YOLO_DATASETS_DIR", Path.cwd() / "datasets"))


def check_det_dataset(dataset) -> dict:
    """Resolve a detection dataset yaml: train/val/test/minival paths made absolute, `names` as a dict, `nc`,
    `channels`. A yaml that does not exist is looked for as `datasets_dir() / its name`; a relative `path:` is
    taken under `datasets_dir()` first, then beside the yaml, then as the yaml's own directory, as in the JAX
    package."""
    file = Path(dataset)
    if not file.exists():
        alt = datasets_dir() / file.name
        if not alt.exists():
            raise FileNotFoundError(f"dataset yaml '{dataset}' not found at {file} or {alt} (nothing is downloaded)")
        file = alt
    data = load_yaml(file.read_text(encoding="utf-8"))
    data["yaml_file"] = str(file)
    if "val" not in data and "validation" in data:
        data["val"] = data.pop("validation")
    if "names" not in data and "nc" not in data:
        raise SyntaxError(f"{dataset} requires 'names' or 'nc'")
    if isinstance(data.get("names"), (list, tuple)):
        data["names"] = dict(enumerate(data["names"]))
    if "names" not in data:
        data["names"] = {i: f"class_{i}" for i in range(data["nc"])}
    data["names"] = {int(k): str(v) for k, v in data["names"].items()}
    data["nc"] = len(data["names"])
    data["channels"] = data.get("channels", 3)
    path = Path(data.get("path") or file.parent)
    if not path.is_absolute():
        for cand in (datasets_dir() / path, file.parent / path, file.parent):
            if cand.exists() and any((cand / s).exists() for s in ("images", "train", data.get("train") or "")):
                path = cand.resolve()
                break
        else:
            path = (file.parent / path).resolve()
    data["path"] = path
    for k in ("train", "val", "test", "minival"):
        if data.get(k):
            if isinstance(data[k], str):
                p = (path / data[k]).resolve()
                if not p.exists() and data[k].startswith("../"):
                    p = (path / data[k][3:]).resolve()
                data[k] = str(p)
            else:
                data[k] = [str((path / x).resolve()) for x in data[k]]
    val = data.get("val")
    if val:
        missing = [v for v in ([val] if isinstance(val, str) else val) if not Path(v).exists()]
        if missing:
            raise FileNotFoundError(f"dataset images not found: {missing} (nothing is downloaded)")
    return data

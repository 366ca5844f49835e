"""Dataset files: label paths, the cache hash, one image-label check, and the dataset yaml.

Counterpart of `drone_yolo_tpu/data/utils.py` (`img2label_paths`, `get_hash`,
`verify_image_label` for detect labels, `check_det_dataset`, `imread_rgb`). Images are
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

from drone_yolo_tpu_torch.data.jpeg import decode_jpeg, jpeg_shape
from drone_yolo_tpu_torch.data.png import decode_png, png_shape
from drone_yolo_tpu_torch.nn.build import load_yaml

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


def verify_image_label(im_file, lb_file, num_cls: int, single_cls: bool = False):
    """Check one image and its detect labels: (im_file, labels (N, 5) float32, shape (h, w), segments [],
    keypoints None, missing, found, empty, corrupt, message); im_file is None for a corrupt pair."""
    nm = nf = ne = 0
    msg = ""
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
            if any(len(r) > 6 for r in rows):
                raise ValueError("segment labels are not ported yet (detect labels only)")
            lb = np.array(rows, dtype=np.float32) if rows else np.zeros((0, 5), np.float32)
            n = len(lb)
            if n:
                if lb.shape[1] != 5:
                    raise ValueError(f"labels require 5 columns, got {lb.shape[1]}")
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
                    msg = f"removed {n - len(idx)} duplicate labels"
            else:
                ne = 1
        else:
            nm = 1
            lb = np.zeros((0, 5), np.float32)
        return im_file, lb, shape, [], None, nm, nf, ne, 0, msg
    except (ValueError, OSError) as e:
        return None, None, None, [], None, nm, nf, ne, 1, f"ignoring corrupt image/label {im_file}: {e}"


def check_det_dataset(dataset) -> dict:
    """Resolve a detection dataset yaml: train/val paths made absolute, `names` as a dict, `nc`, `channels`."""
    file = Path(dataset)
    if not file.exists():
        raise FileNotFoundError(f"dataset yaml '{dataset}' not found (nothing is downloaded)")
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
        for cand in (file.parent / path, file.parent):
            if cand.exists() and any((cand / s).exists() for s in ("images", "train", data.get("train") or "")):
                path = cand.resolve()
                break
        else:
            path = (file.parent / path).resolve()
    data["path"] = path
    for k in ("train", "val", "test"):
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

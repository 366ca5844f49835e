"""Inference sources: image files and MJPEG AVI videos, numpy frames, numpy batches.

Counterpart of `drone_yolo_tpu/data/loaders.py` (SourceTypes, LoadImagesAndVideos,
LoadPilAndNumpy, LoadTensor) and of `load_inference_source`
(`drone_yolo_tpu/engine/predictor.py`). Each loader yields (paths, images, info): lists
of file paths, (H, W, 3) uint8 BGR frames and log strings, batch by batch.

`LoadImagesAndVideos` takes what the JAX loader takes (a file, a directory, a glob, a
`.txt` list, or a list of these) and gives the same file order, batches, `mode`, frame
counters and info strings. Images are decoded by the port (`data/utils.py:imread`: JPEG
and PNG, each equal to `cv2.imread`); AVI files are read by `data/avi.py` (MJPEG). A
listed image or video format the port does not decode is refused by name when the
loader is made, never skipped; a file of a decoded format that fails to decode is
skipped with a warning, as the JAX loader skips an image cv2 cannot read.
`LoadStreams`, `LoadScreenshots` and PIL images are refused by name.
"""

from __future__ import annotations

import glob
import logging
import math
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from drone_yolo_tpu_torch.data.avi import AviReader
from drone_yolo_tpu_torch.data.utils import DECODED_FORMATS, IMG_FORMATS, VID_FORMATS, imread

LOGGER = logging.getLogger("drone_yolo_tpu_torch")
DECODED_VIDEOS = {"avi"}  # MJPEG in AVI (`data/avi.py`)
STREAM_PREFIXES = ("https://", "http://", "rtsp://", "rtmp://", "tcp://")


@dataclass
class SourceTypes:
    """Flags describing the input source."""

    stream: bool = False
    screenshot: bool = False
    from_img: bool = False
    tensor: bool = False


class LoadImagesAndVideos:
    """Image files and AVI videos from a path, a directory, a glob, a .txt list or a list of them, in batches."""

    def __init__(self, path, batch: int = 1, vid_stride: int = 1):
        parent = None
        if isinstance(path, str) and Path(path).suffix == ".txt":
            parent = Path(path).parent
            path = Path(path).read_text().split()
        files = []
        for p in sorted(path) if isinstance(path, (list, tuple)) else [path]:
            a = str(Path(p).absolute() if not parent else (parent / p).absolute())
            if "*" in a:
                files.extend(sorted(glob.glob(a, recursive=True)))
            elif os.path.isdir(a):
                files.extend(sorted(glob.glob(os.path.join(a, "*.*"))))
            elif os.path.isfile(a):
                files.append(a)
            else:
                raise FileNotFoundError(f"{p} does not exist")
        self.files, self.video_flag = [], []
        for f in files:
            suffix = f.split(".")[-1].lower()
            if suffix in IMG_FORMATS or suffix in VID_FORMATS:
                video = suffix in VID_FORMATS
                if suffix not in (DECODED_VIDEOS if video else DECODED_FORMATS):
                    raise NotImplementedError(
                        f"{f}: .{suffix} {'video' if video else 'image'}s are not decoded by the port yet (images: "
                        f"{sorted(DECODED_FORMATS)}, videos: MJPEG in AVI; other video goes through NVDEC, ROADMAP.md "
                        "queue 1 item 4)")
                self.files.append(f)
                self.video_flag.append(video)
        self.nf = len(self.files)
        self.ni = self.video_flag.count(False)
        self.mode = "video" if any(self.video_flag) else "image"
        self.vid_stride = vid_stride
        self.bs = batch
        self.cap = None
        self.frame = 0
        self.frames = 0
        self.fps = 0.0
        if self.nf == 0:
            raise FileNotFoundError(f"No images or videos found in {path}")

    def __iter__(self):
        self.count = 0
        return self

    def _close(self) -> None:
        self.cap.close()
        self.cap = None
        self.count += 1

    def __next__(self):
        paths, imgs, info = [], [], []
        while len(imgs) < self.bs:
            if self.count >= self.nf:
                if imgs:
                    return paths, imgs, info
                raise StopIteration
            path = self.files[self.count]
            if self.video_flag[self.count]:
                self.mode = "video"
                if self.cap is None:
                    self.cap = AviReader(path)
                    self.frame = 0
                    self.frames = len(self.cap) or float("inf")
                    self.fps = self.cap.fps
                if self.frame + self.vid_stride > len(self.cap):  # the grabs run past the last frame
                    self._close()
                    continue
                self.frame += self.vid_stride
                paths.append(path)
                imgs.append(self.cap.frame(self.frame - 1))
                info.append(f"video {self.count + 1}/{self.nf} (frame {self.frame}/{self.frames}) {path}: ")
            else:
                self.mode = "image"
                try:
                    im0 = imread(path)
                except ValueError as e:
                    LOGGER.warning(f"Image read error {path}: {e}")
                else:
                    paths.append(path)
                    imgs.append(im0)
                    info.append(f"image {self.count + 1}/{self.nf} {path}: ")
                self.count += 1
        return paths, imgs, info

    def __len__(self):
        return math.ceil(self.nf / self.bs)


class LoadPilAndNumpy:
    """In-memory numpy frames, one batch of all of them. PIL images are refused by name (the port has no PIL)."""

    def __init__(self, im0):
        if not isinstance(im0, list):
            im0 = [im0]
        self.paths = [getattr(im, "filename", "") or f"image{i}.jpg" for i, im in enumerate(im0)]
        self.im0 = [self._single_check(im) for im in im0]
        self.mode = "image"
        self.bs = len(self.im0)

    @staticmethod
    def _single_check(im):
        if not isinstance(im, np.ndarray):
            raise TypeError(f"a {type(im).__name__} source is not supported: the port takes numpy BGR frames "
                            "(PIL images need PIL, which the port does not use)")
        if im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"each frame must be (H, W, 3), got {im.shape}")
        return im

    def __iter__(self):
        self.count = 0
        return self

    def __next__(self):
        if self.count == 1:
            raise StopIteration
        self.count = 1
        return self.paths, self.im0, [""] * self.bs

    def __len__(self):
        return 1


class LoadTensor:
    """A 4-D NHWC batch that is not uint8, read like frames (BGR, 0-255), as the JAX predictor reads it."""

    def __init__(self, im0):
        self.im0 = np.asarray(im0)
        if self.im0.ndim != 4:
            raise ValueError(f"expected a 4-D NHWC batch, got {self.im0.shape}")
        self.bs = self.im0.shape[0]
        self.mode = "image"
        self.paths = [f"image{i}.jpg" for i in range(self.bs)]

    def __iter__(self):
        self.count = 0
        return self

    def __next__(self):
        if self.count == 1:
            raise StopIteration
        self.count = 1
        return self.paths, list(self.im0), [""] * self.bs

    def __len__(self):
        return 1


def load_inference_source(source, batch: int = 1, vid_stride: int = 1):
    """The loader of a source: files (a str or Path, or a list of them), numpy frames, or a 4-D batch. A 4-D uint8
    batch is a list of frames. Streams (URLs, webcam indices) and screenshots are refused by name."""
    source_type = SourceTypes()
    if isinstance(source, (str, Path, int)):
        s = str(source)
        if s.isnumeric() or s.lower().startswith(STREAM_PREFIXES):
            raise NotImplementedError(f"{s}: streams (LoadStreams) are not ported yet (ROADMAP.md queue 1 item 4)")
        if s.lower().startswith("screen"):
            raise NotImplementedError(f"{s}: screenshots (LoadScreenshots) are not ported yet (ROADMAP.md queue 1 item 4)")
        ds = LoadImagesAndVideos(s, batch=batch, vid_stride=vid_stride)
    elif isinstance(source, (list, tuple)) and source and isinstance(source[0], (str, Path)):
        ds = LoadImagesAndVideos([str(p) for p in source], batch=batch, vid_stride=vid_stride)
    elif isinstance(source, np.ndarray) and source.ndim == 4 and source.dtype != np.uint8:
        source_type.tensor = True
        ds = LoadTensor(source)
    else:
        source_type.from_img = True
        if isinstance(source, tuple) or (isinstance(source, np.ndarray) and source.ndim == 4):
            source = list(source)
        ds = LoadPilAndNumpy(source)
    ds.source_type = source_type
    return ds

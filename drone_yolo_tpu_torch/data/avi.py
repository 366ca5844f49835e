"""MJPEG in AVI: a RIFF reader that gives the JPEG payloads of the video stream, its frame rate and frame count.

`read_avi(path)` walks the chunk tree of the file by sizes and never searches the bytes
(an OpenDML writer leaves index placeholders in `JUNK` chunks inside the headers, which
may hold a stray chunk id): the `hdrl` list with its `avih` and one `strl` per stream
(`strh`: type, handler, `dwRate/dwScale`, `dwLength`; `strf`: the BITMAPINFOHEADER of a
video stream), then `LIST movi` of the first `RIFF AVI ` and of each OpenDML `RIFF AVIX`
continuation past 1 GB. Inside `movi` the video stream's `##dc` and `##db` chunks are the
frames, in file order; `LIST rec ` groups are entered, index (`ix##`, `idx1`) and other
streams' chunks skipped. Chunks are padded to even sizes.

The frame rate is `dwRate / dwScale` of the video stream's header and the frame count the
number of its frame chunks, which is what `cv2.VideoCapture` reports for such a file
(`CAP_PROP_FPS`, `CAP_PROP_FRAME_COUNT`). A stream whose codec is not Motion JPEG (FourCC
MJPG, mjpg, AVRn, LJPG or JPEG) is refused with a `ValueError` that names its FourCC;
other containers (MP4, MKV, ...) with one that names the container.

`AviReader.frame(i)` decodes frame i into (H, W, 3) uint8 BGR with `data/jpeg.py`; a
payload without Huffman tables decodes with the standard ones of JPEG Annex K.3, as
FFmpeg's and libjpeg's MJPEG decoders do.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from drone_yolo_tpu_torch.data.jpeg import decode_jpeg

MJPEG_FOURCCS = {b"MJPG", b"mjpg", b"AVRn", b"LJPG", b"JPEG", b"jpeg", b"dmb1"}


@dataclass
class AviInfo:
    """The video stream of an AVI file: frame payloads as (offset, size), fps, FourCC and frame size."""

    path: str
    fps: float
    fourcc: str
    width: int
    height: int
    frames: list = field(default_factory=list)


def _walk(f, start: int, end: int):
    """Yield (chunk id, list type or None, payload offset, payload size) of the chunks in [start, end)."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        head = f.read(12)
        if len(head) < 8:
            break
        cid, size = head[:4], struct.unpack("<I", head[4:8])[0]
        if cid in (b"RIFF", b"LIST"):
            yield cid, head[8:12], pos + 12, size - 4
        else:
            yield cid, None, pos + 8, size
        pos += 8 + size + (size & 1)


def read_avi(path) -> AviInfo:
    """The video stream of an MJPEG AVI file: its frames' (offset, size) in the file, fps and FourCC."""
    path = Path(path)
    streams, movis = [], []
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise ValueError(f"{path}: not an AVI file (no RIFF 'AVI ' header)")
        end = f.seek(0, 2)
        for cid, kind, off, size in _walk(f, 0, end):
            if cid != b"RIFF" or kind not in (b"AVI ", b"AVIX"):
                continue
            for cid2, kind2, off2, size2 in _walk(f, off, min(off + size, end)):
                if cid2 == b"LIST" and kind2 == b"hdrl":
                    for cid3, kind3, off3, size3 in _walk(f, off2, off2 + size2):
                        if cid3 == b"LIST" and kind3 == b"strl":
                            stream = {}
                            for cid4, _, off4, size4 in _walk(f, off3, off3 + size3):
                                if cid4 in (b"strh", b"strf"):
                                    f.seek(off4)
                                    stream[cid4] = f.read(size4)
                            streams.append(stream)
                elif cid2 == b"LIST" and kind2 == b"movi":
                    movis.append((off2, min(off2 + size2, end)))
        video = next((i for i, s in enumerate(streams) if s.get(b"strh", b"")[:4] == b"vids"), None)
        if video is None:
            raise ValueError(f"{path}: no video stream in the AVI headers")
        strh, strf = streams[video][b"strh"], streams[video].get(b"strf", b"")
        handler = strh[4:8]
        compression = strf[16:20] if len(strf) >= 20 else b""
        if handler not in MJPEG_FOURCCS and compression not in MJPEG_FOURCCS:
            raise ValueError(f"{path}: AVI video codec {(compression or handler).decode('latin-1')!r} is not supported: "
                             "the port decodes Motion JPEG only (H.264/HEVC through NVDEC is ROADMAP.md queue 1 item 4)")
        scale, rate = struct.unpack("<II", strh[20:28])
        width, height = struct.unpack("<ii", strf[4:12]) if len(strf) >= 12 else (0, 0)
        info = AviInfo(str(path), rate / scale if scale else 0.0, (compression or handler).decode("latin-1"),
                       width, abs(height))
        ids = (b"%02ddc" % video, b"%02ddb" % video)
        for start, stop in movis:
            _frames(f, start, stop, ids, info.frames)
    return info


def _frames(f, start: int, stop: int, ids: tuple, out: list) -> None:
    """Append (offset, size) of the frame chunks in [start, stop) of a movi list, entering `rec ` lists."""
    for cid, kind, off, size in _walk(f, start, stop):
        if cid == b"LIST" and kind == b"rec ":
            _frames(f, off, off + size, ids, out)
        elif cid in ids and size:
            out.append((off, size))


class AviReader:
    """Frames of an MJPEG AVI file, decoded on demand: `len(reader)`, `reader.fps`, `reader.frame(i)` (BGR)."""

    def __init__(self, path):
        self.info = read_avi(path)
        self.fps = self.info.fps
        self._file = open(path, "rb")

    def __len__(self) -> int:
        return len(self.info.frames)

    def payload(self, i: int) -> bytes:
        off, size = self.info.frames[i]
        self._file.seek(off)
        return self._file.read(size)

    def frame(self, i: int) -> np.ndarray:
        """Frame i as (H, W, 3) uint8 BGR."""
        return np.ascontiguousarray(decode_jpeg(self.payload(i))[..., ::-1])

    def close(self) -> None:
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

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

`AviWriter` writes BGR frames as MJPEG AVI 1.0 (`data/jpeg.py:encode_jpeg`, quality 95):
RIFF 'AVI ' with `hdrl` (`avih`, one `strl` with `strh` 'vids' 'MJPG' at the frame rate
as dwRate / dwScale, and a BITMAPINFOHEADER `strf`), `LIST movi` with one `00dc` chunk per
frame, and `idx1`; the frame count and sizes are filled in when it closes. The JAX package
writes video as MPEG-4 Part 2 in .mp4 through cv2 (`cv2.VideoWriter`, 'mp4v'), for which
the port has no encoder: it writes this instead, under the same stem with .avi.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from fractions import Fraction
from pathlib import Path

import numpy as np

from drone_yolo_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

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


def _u32(*values) -> bytes:
    return struct.pack(f"<{len(values)}I", *(int(v) for v in values))


class AviWriter:
    """MJPEG AVI 1.0 file of BGR frames at `fps` (a float, kept as the nearest fraction of denominator <= 10000, so
    30000/1001 stays exact): `write(frame)` per frame, `close()` (or `release()`, or the end of a `with` block) to
    finish the index and the headers. Every frame must have the first one's size."""

    quality = 95  # JPEG quality of every frame, `cv2.imwrite`'s default

    def __init__(self, path, fps: float = 30.0):
        rate = Fraction(float(fps) if fps and fps > 0 else 30.0).limit_denominator(10000)
        self.path, self.rate, self.scale = Path(path), rate.numerator, rate.denominator
        self.size = None
        self._index, self._big = [], 0
        self._file = open(self.path, "wb")
        self._file.write(b"\0" * self._header_bytes())

    @staticmethod
    def _header_bytes() -> int:
        return 12 + 8 + 4 + (8 + 56) + 12 + (8 + 56) + (8 + 40) + 12  # RIFF, hdrl(avih, strl(strh, strf)), movi head

    def _headers(self, n: int, movi_bytes: int, riff_bytes: int) -> bytes:
        w, h = self.size or (0, 0)
        usec = round(1e6 * self.scale / self.rate)
        avih = _u32(usec, self._big * self.rate // self.scale, 0, 0x10, n, 0, 1, self._big, w, h, 0, 0, 0, 0)
        strh = b"vidsMJPG" + _u32(0, 0, 0, self.scale, self.rate, 0, n, self._big, 0xFFFFFFFF, 0) + bytes(8)
        strf = _u32(40, w, h) + struct.pack("<HH", 1, 24) + b"MJPG" + _u32(w * h * 3, 0, 0, 0, 0)
        strl = b"strl" + b"strh" + _u32(len(strh)) + strh + b"strf" + _u32(len(strf)) + strf
        hdrl = b"hdrl" + b"avih" + _u32(len(avih)) + avih + b"LIST" + _u32(len(strl)) + strl
        return (b"RIFF" + _u32(riff_bytes) + b"AVI " + b"LIST" + _u32(len(hdrl)) + hdrl
                + b"LIST" + _u32(movi_bytes) + b"movi")

    def write(self, frame: np.ndarray) -> None:
        """Append one (H, W, 3) uint8 BGR frame, encoded as JPEG."""
        h, w = frame.shape[:2]
        if self.size is None:
            self.size = (w, h)
        elif self.size != (w, h):
            raise ValueError(f"{self.path}: frame of {w}x{h} after frames of {self.size[0]}x{self.size[1]}")
        data = encode_jpeg(np.ascontiguousarray(frame[..., ::-1]), quality=self.quality)
        offset = self._file.tell() - (self._header_bytes() - 4)  # from the 'movi' fourcc, as idx1 counts
        self._file.write(b"00dc" + _u32(len(data)) + data + b"\0" * (len(data) & 1))
        self._index.append(b"00dc" + _u32(0x10, offset, len(data)))
        self._big = max(self._big, len(data))

    def close(self) -> None:
        if self._file.closed:
            return
        end = self._file.tell()
        idx1 = b"".join(self._index)
        self._file.write(b"idx1" + _u32(len(idx1)) + idx1)
        total = self._file.tell()
        self._file.seek(0)
        self._file.write(self._headers(len(self._index), end - (self._header_bytes() - 4), total - 8))
        self._file.close()

    release = close

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

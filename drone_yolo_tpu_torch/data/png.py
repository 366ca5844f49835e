"""PNG on the standard library's zlib: a decoder that gives what `cv2.imread(path, IMREAD_COLOR)` gives, and an encoder.

`decode_png` reads the IHDR, PLTE, tRNS, IDAT and IEND chunks (others are skipped, as
libpng skips ancillary chunks it is not asked for), inflates the IDAT stream, reverses
the five filter types and returns (H, W, 3) uint8 BGR:

- colour types grey, RGB, palette, grey + alpha and RGBA; bit depths 1, 2, 4 and 8, and
  16 for the non-palette types;
- as OpenCV asks libpng for IMREAD_COLOR: alpha (and a tRNS transparency) is dropped
  without compositing, 16-bit samples keep their high byte, grey is replicated into three
  channels, grey of 1, 2 or 4 bits is scaled to 0-255, palette indices are looked up;
- Adam7 interlacing is refused with a `ValueError` that names it, as are a bad signature,
  a chunk whose CRC does not match and a filter type outside 0-4.

Rows whose filter is None, Sub or Up are reversed row by row, vectorised along the row;
when some row uses Average or Paeth, whose predictor depends on the pixel just decoded,
the image is reversed along anti-diagonals (pixel (r, c) needs only (r, c-1), (r-1, c) and
(r-1, c-1)), H + W - 1 vectorised steps.

`encode_png` writes 8-bit RGB or grey with filter Up on every row (zlib level 6).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _chunks(data: bytes):
    """Yield (type, payload) of each chunk, checking the CRCs."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG stream (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if len(payload) != length or pos + 12 + length > len(data):
            raise ValueError("truncated PNG stream")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"corrupt PNG stream: CRC mismatch in chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("truncated PNG stream (no IEND chunk)")


def png_shape(data: bytes) -> tuple[int, int]:
    """(height, width) from the IHDR chunk."""
    if data[:8] != SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError("not a PNG stream (bad signature or no IHDR first)")
    w, h = struct.unpack(">II", data[16:24])
    return h, w


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ft: np.ndarray, data: np.ndarray, bpp: int) -> np.ndarray:
    """Filters None, Sub and Up only: row by row."""
    out = np.empty_like(data)
    prev = np.zeros(data.shape[1], np.uint8)
    for r in range(len(data)):
        row = data[r]
        if ft[r] == 1:  # Sub: a running sum of every bpp-th byte, mod 256
            row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ft[r] == 2:
            row = row + prev
        out[r] = prev = row
    return out


def _unfilter_diagonals(ft: np.ndarray, data: np.ndarray, bpp: int) -> np.ndarray:
    """Any filters: along anti-diagonals of pixels, each diagonal one vectorised step."""
    h, stride = data.shape
    w = stride // bpp
    raw = data.reshape(h, w, bpp).astype(np.int32)
    x = np.zeros((h + 1, w + 1, bpp), np.int32)  # row 0 and column 0: the zeros before the image
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        c = d - r
        a, b, cc = x[r + 1, c], x[r, c + 1], x[r, c]
        f = ft[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, _paeth(a, b, cc)], 0)
        x[r + 1, c + 1] = (raw[r, c] + pred) & 255
    return x[1:, 1:].astype(np.uint8).reshape(h, stride)


def decode_png(data: bytes) -> np.ndarray:
    """A PNG stream -> (H, W, 3) uint8 BGR, as `cv2.imdecode(buf, IMREAD_COLOR)` gives it."""
    data = bytes(data)
    ihdr, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if ihdr is None:
        raise ValueError("corrupt PNG stream: no IHDR chunk")
    w, h, depth, colour, compression, filter_method, interlace = ihdr
    if colour not in _CHANNELS or depth not in _DEPTHS[colour]:
        raise ValueError(f"PNG colour type {colour} at bit depth {depth} is not a valid combination")
    if interlace == 1:
        raise ValueError("Adam7-interlaced PNG is not supported (non-interlaced only; see ROADMAP.md)")
    if compression != 0 or filter_method != 0 or interlace != 0 or w == 0 or h == 0:
        raise ValueError("corrupt PNG stream: unknown compression, filter method or interlace, or zero size")
    if colour == 3 and palette is None:
        raise ValueError("corrupt PNG stream: palette image without a PLTE chunk")
    ch = _CHANNELS[colour]
    bpp = max(1, ch * depth // 8)  # the filters' byte distance
    stride = -(-w * ch * depth // 8)
    try:
        flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG stream: {e}") from None
    if flat.size < h * (stride + 1):
        raise ValueError("corrupt PNG stream: the image data ends early")
    rows = flat[: h * (stride + 1)].reshape(h, stride + 1)
    ft = rows[:, 0].astype(np.int64)
    if ft.max() > 4:
        raise ValueError(f"corrupt PNG stream: filter type {int(ft.max())}")
    pad = -stride % bpp  # sub-byte depths: bpp is 1, the stride any length
    data_rows = np.ascontiguousarray(rows[:, 1:])
    if pad:
        data_rows = np.pad(data_rows, ((0, 0), (0, pad)))
    recon = (_unfilter_rows if ft.max() <= 2 else _unfilter_diagonals)(ft, data_rows, bpp)[:, :stride]
    if depth == 16:
        samples = recon.reshape(h, w, ch, 2)[..., 0]  # the high byte of each big-endian sample
    elif depth == 8:
        samples = recon.reshape(h, w, ch)
    else:
        samples = np.unpackbits(recon, axis=1).reshape(h, -1, depth)[:, :w]
        samples = (samples * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)[..., None]
        if colour == 0:
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
    if colour == 3:
        idx = samples[..., 0]
        if idx.max() >= len(palette):
            raise ValueError("corrupt PNG stream: palette index out of range")
        rgb = palette[idx]
    elif colour in (0, 4):
        rgb = np.repeat(samples[..., :1], 3, axis=2)
    else:
        rgb = samples[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB or (H, W) uint8 grey -> an 8-bit, non-interlaced PNG stream, filter Up on every row."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3) or 0 in img.shape:
        raise ValueError(f"expected (H, W, 3) or (H, W) uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    up = rows - np.concatenate([np.zeros((1, rows.shape[1]), np.uint8), rows[:-1]])  # mod 256
    body = np.concatenate([np.full((h, 1), 2, np.uint8), up], 1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if img.ndim == 3 else 0, 0, 0, 0)
    return SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(body.tobytes(), 6)) + _chunk(b"IEND", b"")

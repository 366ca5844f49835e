"""Baseline JPEG in numpy: a decoder that computes what libjpeg-turbo computes under OpenCV's defaults, and an encoder.

`decode_jpeg` is the counterpart of `drone_yolo_tpu/data/utils.py:imread_rgb`
(`cv2.imread(path, IMREAD_COLOR_RGB)`) and returns the same (H, W, 3) uint8 RGB array:

- sequential Huffman streams with 8-bit samples (SOF0 and SOF1), grey or YCbCr at any
  sampling factors (4:4:4, 4:2:2, 4:2:0, ...), interleaved or one scan per component,
  restart markers, partial MCUs at the right and bottom edges;
- the ISLOW integer IDCT (libjpeg's `jidctint.c`: 13-bit constants, 2 extra bits in the
  first pass), "fancy" triangle-filter chroma upsampling (`jdsample.c`: h2v1, h1v2 and
  h2v2 with the edge rows and columns replicated, plain replication for other factors and
  for components two samples wide or less), and fixed-point YCbCr to RGB with 16 fraction
  bits (`jdcolor.c`). Grey images are replicated into three channels.
- Huffman tables 0 and 1 that the stream does not define are those of the standard's
  Annex K.3, as libjpeg and FFmpeg decode Motion JPEG frames without a DHT segment.
- Progressive, arithmetic-coded, lossless, hierarchical and 12-bit streams are refused
  with a `ValueError` that names the mode.

The Huffman stage is a Python loop that peeks 16 bits at a time into a table of 65,536
entries per Huffman table; where a code and its magnitude bits fit in the 16 bits, the
entry holds the coefficient itself. Everything after entropy decoding (dequantisation,
IDCT, upsampling, colour conversion) is vectorised over all blocks of a component.

`encode_jpeg` writes a baseline 4:2:0 JFIF stream (a 4:0:0 one for a single-channel
image) with the example tables of the standard's Annex K, scaled by quality as libjpeg
scales them; the forward DCT is in float64 and the bit packing and 0xFF stuffing are
vectorised.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

import numpy as np

# zigzag position -> natural (row-major) position in the 8x8 block
ZIGZAG = np.array(sorted(range(64), key=lambda i: (i // 8 + i % 8, (i // 8) if (i // 8 + i % 8) % 2 else (i % 8))),
                  np.int64)
_ZZ = ZIGZAG.tolist() + [64] * 16  # a run past the block's end writes into the next block's slots: refused below

_SOF_REFUSED = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential (hierarchical) sequential",
                0xC6: "differential (hierarchical) progressive", 0xC7: "differential (hierarchical) lossless",
                0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
                0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential sequential",
                0xCE: "arithmetic-coded differential progressive", 0xCF: "arithmetic-coded differential lossless"}

# jidctint.c: FIX(x) = round(x * 2**13)
CONST_BITS, PASS1_BITS = 13, 2
F_0_298631336, F_0_390180644, F_0_541196100, F_0_765366865 = 2446, 3196, 4433, 6270
F_0_899976223, F_1_175875602, F_1_501321110, F_1_847759065 = 7373, 9633, 12299, 15137
F_1_961570560, F_2_053119869, F_2_562915447, F_3_072711026 = 16069, 16819, 20995, 25172


def _segments(data: bytes):
    """Yield (marker, payload start, payload end) of the marker segments before the entropy-coded data of a scan,
    and (0xDA, ...) for each start of scan, whose entropy-coded data the caller consumes."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream (no SOI marker)")
    pos = 2
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG stream: expected a marker at byte {pos}")
        while pos < n and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            return
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            raise ValueError("truncated JPEG stream")
        length = data[pos] << 8 | data[pos + 1]
        start, end = pos + 2, pos + length
        if end > n:
            raise ValueError("truncated JPEG stream")
        pos = yield marker, start, end
        if pos is None:
            pos = end


def _sof(data: bytes, marker: int, start: int):
    if marker in _SOF_REFUSED:
        raise ValueError(f"{_SOF_REFUSED[marker]} JPEG is not supported (baseline and extended sequential Huffman only; "
                         f"see ROADMAP.md)")
    precision, h, w, nc = data[start], data[start + 1] << 8 | data[start + 2], data[start + 3] << 8 | data[start + 4], data[start + 5]
    if precision != 8:
        raise ValueError(f"{precision}-bit JPEG is not supported (8-bit samples only)")
    if h == 0 or w == 0:
        raise ValueError("JPEG with a DNL-defined or zero size is not supported")
    comps = []
    for i in range(nc):
        o = start + 6 + 3 * i
        comps.append({"id": data[o], "h": data[o + 1] >> 4, "v": data[o + 1] & 15, "tq": data[o + 2]})
    return h, w, comps


def jpeg_shape(path) -> tuple[int, int]:
    """(height, width) of a JPEG file, from its frame header."""
    data = Path(path).read_bytes()
    for marker, start, end in _segments(data):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):  # a start of frame, of any mode
            return data[start + 1] << 8 | data[start + 2], data[start + 3] << 8 | data[start + 4]
        if marker == 0xDA:
            break
    raise ValueError(f"{path}: no JPEG frame header before the first scan")


# -- Huffman tables ---------------------------------------------------------------


def _codes(bits, vals):
    """Canonical codes: [(symbol, code, length)] of a DHT's 16 counts and symbols."""
    out, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out.append((vals[k], code, length))
            code += 1
            k += 1
        if code > 1 << length:
            raise ValueError("corrupt JPEG Huffman table")
        code <<= 1
    return out


@functools.lru_cache(maxsize=32)
def _lookup(spec: bytes, is_ac: bool) -> list:
    """The 16-bit lookahead table of one Huffman table (`spec`: 16 counts, then the symbols).

    DC entries: (bits consumed, difference, True) where the code and its magnitude bits fit in 16 bits, else
    (code length, magnitude bit count, None). AC entries: (bits consumed, zeros skipped, coefficient) for a
    coefficient that fits, and for ZRL (16 zeros: 15 skipped and a zero written); else (code length, run/size
    symbol, None), symbol 0 being the end of block; unassigned codes are (0, -1, None)."""
    bits, vals = spec[:16], spec[16:]
    length = np.zeros(65536, np.int64)
    sym = np.full(65536, -1, np.int64)
    for s, code, n in _codes(bits, vals):
        lo, hi = code << (16 - n), (code + 1) << (16 - n)
        length[lo:hi], sym[lo:hi] = n, s
    idx = np.arange(65536, dtype=np.int64)
    size = np.where(sym >= 0, sym & 15, 0)
    total = length + size
    fits = (length > 0) & (total <= 16)
    extra = (idx >> np.clip(16 - total, 0, 16)) & ((1 << size) - 1)
    value = np.where(size > 0, np.where(extra < (1 << np.maximum(size - 1, 0)), extra - (1 << size) + 1, extra), 0)
    if not is_ac:
        fast = fits
        return [(int(t), int(v), True) if f else (int(n), int(s), None)
                for f, t, v, n, s in zip(fast, total, value, length, size)]
    fast = fits & ((size > 0) | (sym == 0xF0))
    run = np.where(sym == 0xF0, 15, sym >> 4)
    return [(int(t), int(r), int(v)) if f else (int(n), int(s) if n else -1, None)
            for f, t, r, v, n, s in zip(fast, total, run, value, length, sym)]


# -- entropy decoding -------------------------------------------------------------


def _entropy_segments(data: bytes, pos: int):
    """Split the entropy-coded data that starts at `pos` at its restart markers: (list of unstuffed segments, the
    position of the marker that ends the scan)."""
    segs = []
    start = pos
    for m in re.finditer(rb"\xff+([^\x00\xff])", data[pos:]):
        end = pos + m.start()
        marker = m.group(1)[0]
        segs.append(data[start:end].replace(b"\xff\x00", b"\xff"))
        start = pos + m.end()
        if not 0xD0 <= marker <= 0xD7:
            return segs, end
    segs.append(data[start:].replace(b"\xff\x00", b"\xff"))
    return segs, len(data)


def _windows(seg: bytes) -> list:
    """W[i] = bytes i, i+1, i+2 as one 24-bit int (zeros past the end, as libjpeg fills a stream that runs out)."""
    b = np.frombuffer(seg + b"\x00" * 8, np.uint8).astype(np.int64)
    return ((b[:-2] << 16) | (b[1:-1] << 8) | b[2:]).tolist()


def _decode_blocks(W: list, order: list, coefs: list, dcs: list, acs: list, pred: list) -> None:
    """Decode the blocks of one restart interval. `order` holds (component slot, offset of the block's first
    coefficient in that component's flat list) in stream order; coefficients are stored at their natural index."""
    zz = _ZZ
    p = 0
    for ci, base in order:
        co = coefs[ci]
        act = acs[ci]
        nb, d, fast = dcs[ci][(W[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
        p += nb
        if fast is None:  # a code and magnitude bits longer than 16 bits
            if nb == 0:
                raise ValueError("corrupt JPEG data: bad DC code")
            if d:
                s = d
                d = ((W[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - s)
                p += s
                if d < (1 << (s - 1)):
                    d -= (1 << s) - 1
        pred[ci] += d
        co[base] = pred[ci]
        k = 1
        while k < 64:
            nb, r, v = act[(W[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
            if v is None:
                if r == 0:  # end of block
                    p += nb
                    break
                if r < 0:
                    raise ValueError("corrupt JPEG data: bad AC code")
                p += nb
                s = r & 15
                v = ((W[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - s)
                p += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                r >>= 4
            else:
                p += nb
            k += r
            co[base + zz[k]] = v
            k += 1
        if k > 64:
            raise ValueError("corrupt JPEG data: run past the end of a block")


# -- after entropy decoding ---------------------------------------------------------


def _idct_1d(x0, x1, x2, x3, x4, x5, x6, x7):
    """One pass of the ISLOW IDCT on int64 arrays: the eight outputs before descaling (`jidctint.c`)."""
    z1 = (x2 + x6) * F_0_541196100
    tmp2 = z1 - x6 * F_1_847759065
    tmp3 = z1 + x2 * F_0_765366865
    tmp0 = (x0 + x4) << CONST_BITS
    tmp1 = (x0 - x4) << CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F_1_175875602
    t0, t1, t2, t3 = t0 * F_0_298631336, t1 * F_2_053119869, t2 * F_3_072711026, t3 * F_1_501321110
    z1, z2 = z1 * -F_0_899976223, z2 * -F_2_562915447
    z3, z4 = z3 * -F_1_961570560 + z5, z4 * -F_0_390180644 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantised coefficients (N, 8, 8) in natural order -> (N, 8, 8) uint8 samples: columns first, descaled by
    11 bits, then rows, descaled by 18 bits, level-shifted by 128 and clamped."""
    c = coef.astype(np.int64)
    cols = _idct_1d(*(c[:, k, :] for k in range(8)))
    ws = np.stack([(v + (1 << (CONST_BITS - PASS1_BITS - 1))) >> (CONST_BITS - PASS1_BITS) for v in cols], 1)
    rows = _idct_1d(*(ws[:, :, k] for k in range(8)))
    shift = CONST_BITS + PASS1_BITS + 3
    out = np.stack([(v + (1 << (shift - 1))) >> shift for v in rows], 2) + 128
    return np.clip(out, 0, 255).astype(np.uint8)


def _fancy_h2(x: np.ndarray, bias_lo: int, bias_hi: int, shift: int) -> np.ndarray:
    """Double the last axis by the triangle filter: out[2i] = (3 x[i] + x[i-1] + lo) >> shift and out[2i+1] =
    (3 x[i] + x[i+1] + hi) >> shift, the edge samples replicated."""
    prev = np.concatenate([x[..., :1], x[..., :-1]], -1)
    nxt = np.concatenate([x[..., 1:], x[..., -1:]], -1)
    out = np.empty(x.shape[:-1] + (2 * x.shape[-1],), np.int64)
    out[..., 0::2] = (3 * x + prev + bias_lo) >> shift
    out[..., 1::2] = (3 * x + nxt + bias_hi) >> shift
    return out


def _upsample(plane: np.ndarray, dh: int, dw: int, fy: int, fx: int) -> np.ndarray:
    """The real dh x dw samples of a component plane upsampled by (fy, fx) (`jdsample.c`)."""
    x = plane[:dh, :dw].astype(np.int64)
    if (fy, fx) == (1, 1):
        return x
    if dw > 2 and (fy, fx) == (1, 2):
        return _fancy_h2(x, 1, 2, 2)
    if dw > 2 and (fy, fx) == (2, 2):
        above = np.concatenate([x[:1], x[:-1]], 0)
        below = np.concatenate([x[1:], x[-1:]], 0)
        out = np.empty((2 * dh, 2 * dw), np.int64)
        out[0::2] = _fancy_h2(3 * x + above, 8, 7, 4)
        out[1::2] = _fancy_h2(3 * x + below, 8, 7, 4)
        return out
    if (fy, fx) == (2, 1):  # h1v2 fancy: 3/4 nearer row + 1/4 further row
        above = np.concatenate([x[:1], x[:-1]], 0)
        below = np.concatenate([x[1:], x[-1:]], 0)
        out = np.empty((2 * dh, dw), np.int64)
        out[0::2] = (3 * x + above + 1) >> 2
        out[1::2] = (3 * x + below + 2) >> 2
        return out
    return np.repeat(np.repeat(x, fy, 0), fx, 1)


def _ycc_tables():
    """`jdcolor.c` build_ycc_rgb_table, SCALEBITS 16."""
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16, -fix(0.71414) * x,
            -fix(0.34414) * x + half)


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """int planes of Y, Cb, Cr in 0..255 -> (H, W, 3) uint8 RGB, libjpeg's fixed-point conversion."""
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """A baseline or extended sequential Huffman JPEG stream -> (H, W, 3) uint8 RGB, as `cv2.imdecode` with
    IMREAD_COLOR_RGB gives it. Raises ValueError for a stream it does not support or cannot parse."""
    try:
        return _decode(bytes(data))
    except (IndexError, KeyError):
        raise ValueError("corrupt JPEG data: the entropy-coded data ends early or a table is missing") from None


def _decode(data: bytes) -> np.ndarray:
    qts, restart = {}, 0
    # tables 0 and 1 default to Annex K.3's, as libjpeg and FFmpeg decode Motion JPEG frames that carry no DHT
    dc_specs, ac_specs = {0: b"".join(_DC_LUMA), 1: b"".join(_DC_CHROMA)}, {0: b"".join(_AC_LUMA), 1: b"".join(_AC_CHROMA)}
    frame = None
    gen = _segments(data)
    item = next(gen, None)
    while item is not None:
        marker, start, end = item
        nxt = None
        if marker == 0xDB:  # quantisation tables
            o = start
            while o < end:
                pq, tq = data[o] >> 4, data[o] & 15
                n = 2 if pq else 1
                vals = np.frombuffer(data[o + 1:o + 1 + 64 * n], ">u2" if pq else np.uint8).astype(np.int64)
                q = np.empty(64, np.int64)
                q[ZIGZAG] = vals
                qts[tq] = q.reshape(8, 8)
                o += 1 + 64 * n
        elif marker == 0xC4:  # Huffman tables
            o = start
            while o < end:
                tc, th = data[o] >> 4, data[o] & 15
                count = sum(data[o + 1:o + 17])
                (ac_specs if tc else dc_specs)[th] = data[o + 1:o + 17 + count]
                o += 17 + count
        elif marker == 0xDD:
            restart = data[start] << 8 | data[start + 1]
        elif marker == 0xCC:
            raise ValueError("arithmetic-coded JPEG is not supported (see ROADMAP.md)")
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8):
            frame = _frame(*_sof(data, marker, start))
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("corrupt JPEG stream: scan before the frame header")
            nxt = _scan(data, start, end, frame, restart, dc_specs, ac_specs)
        try:
            item = gen.send(nxt)
        except StopIteration:
            break
    if frame is None or not frame["scanned"]:
        raise ValueError("corrupt JPEG stream: no frame or no scan")
    return _finish(frame, qts)


def _frame(h: int, w: int, comps: list) -> dict:
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    for c in comps:
        c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]  # blocks, MCU-padded
        c["dw"], c["dh"] = -(-w * c["h"] // hmax), -(-h * c["v"] // vmax)  # real samples
        c["coef"] = [0] * (c["bw"] * c["bh"] * 64)
    return {"h": h, "w": w, "comps": comps, "hmax": hmax, "vmax": vmax, "mcux": mcux, "mcuy": mcuy,
            "scanned": False}


def _scan(data: bytes, start: int, end: int, frame: dict, restart: int, dc_specs: dict, ac_specs: dict) -> int:
    """Decode one scan; returns the position of the marker after its entropy-coded data."""
    ns = data[start]
    by_id = {c["id"]: i for i, c in enumerate(frame["comps"])}
    sel = [(by_id[data[start + 1 + 2 * j]], data[start + 2 + 2 * j] >> 4, data[start + 2 + 2 * j] & 15) for j in range(ns)]
    ss, se = data[start + 1 + 2 * ns], data[start + 2 + 2 * ns]
    if ss != 0 or se != 63:
        raise ValueError("progressive JPEG is not supported (see ROADMAP.md)")
    comps = frame["comps"]
    slots = [ci for ci, _, _ in sel]
    coefs = [comps[ci]["coef"] for ci in slots]
    dcs = [_lookup(bytes(dc_specs[td]), False) for _, td, _ in sel]
    acs = [_lookup(bytes(ac_specs[ta]), True) for _, _, ta in sel]
    # block order: (slot, offset of the block in its component), MCU by MCU
    if ns == 1:
        c = comps[slots[0]]
        nbx, nby = -(-c["dw"] // 8), -(-c["dh"] // 8)  # a non-interleaved scan covers the component's own blocks
        by, bx = np.meshgrid(np.arange(nby), np.arange(nbx), indexing="ij")
        per_mcu = 1
        order = list(zip([0] * (nbx * nby), ((by * c["bw"] + bx) * 64).reshape(-1).tolist()))
    else:
        my, mx = np.meshgrid(np.arange(frame["mcuy"]), np.arange(frame["mcux"]), indexing="ij")
        parts = []
        for slot, ci in enumerate(slots):
            c = comps[ci]
            for v in range(c["v"]):
                for hh in range(c["h"]):
                    base = ((my * c["v"] + v) * c["bw"] + mx * c["h"] + hh) * 64
                    parts.append((slot, base.reshape(-1)))
        per_mcu = len(parts)
        n_mcu = frame["mcux"] * frame["mcuy"]
        offs = np.stack([b for _, b in parts], 1).reshape(-1).tolist()
        order = list(zip([s for s, _ in parts] * n_mcu, offs))
    segs, after = _entropy_segments(data, end)
    chunk = restart * per_mcu if restart else len(order)
    n_chunks = -(-len(order) // chunk)
    if len(segs) < n_chunks:
        raise ValueError(f"corrupt JPEG data: {len(segs)} restart intervals of {n_chunks}")
    for i in range(n_chunks):
        _decode_blocks(_windows(segs[i]), order[i * chunk:(i + 1) * chunk], coefs, dcs, acs, [0] * ns)
    frame["scanned"] = True
    return after


def _finish(frame: dict, qts: dict) -> np.ndarray:
    h, w = frame["h"], frame["w"]
    planes = []
    for c in frame["comps"]:
        coef = np.asarray(c["coef"], np.int64).reshape(-1, 8, 8) * qts[c["tq"]]
        blocks = idct_islow(coef).reshape(c["bh"], c["bw"], 8, 8)
        plane = blocks.transpose(0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)
        fy, fx = frame["vmax"] // c["v"], frame["hmax"] // c["h"]
        if frame["vmax"] % c["v"] or frame["hmax"] % c["h"]:
            raise ValueError("JPEG sampling factors that do not divide the largest are not supported")
        planes.append(_upsample(plane, c["dh"], c["dw"], fy, fx)[:h, :w])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, -1)
    if len(planes) != 3:
        raise ValueError(f"JPEG with {len(planes)} components is not supported (grey or YCbCr only)")
    return ycc_to_rgb(*planes)


# -- encoder ------------------------------------------------------------------------

# Annex K: example quantisation tables (natural order) and Huffman tables (counts per length, symbols)
_Q_LUMA = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
                    14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_Q_CHROMA = np.full(64, 99, np.int64)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
_DC_LUMA = (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12)))
_DC_CHROMA = (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12)))
_AC_LUMA = (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a3435363738"
    "393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a92939495969798999aa2a3a4a5"
    "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a262728292a3536"
    "3738393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a92939495969798999aa2"
    "a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def quality_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """libjpeg's `jpeg_set_quality`: the Annex K tables scaled by 5000/q (q < 50) or 200 - 2q percent, rounded,
    clamped to 1..255 (baseline)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (_Q_LUMA, _Q_CHROMA))


def _huff_codes(spec) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) per symbol 0..255 of a (counts, symbols) table."""
    code, length = np.zeros(256, np.int64), np.zeros(256, np.int64)
    for s, c, n in _codes(*spec):
        code[s], length[s] = c, n
    return code, length


def _fdct(blocks: np.ndarray) -> np.ndarray:
    """Orthonormal 2-D DCT-II of (N, 8, 8) level-shifted samples, as the standard scales it."""
    k = np.arange(8)
    basis = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.where(k == 0, np.sqrt(1 / 8), 0.5)[:, None]
    return basis @ blocks @ basis.T


def _to_blocks(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """A plane padded by edge replication to (8 bh, 8 bw) -> (bh, bw, 8, 8) blocks."""
    h, w = plane.shape
    p = np.pad(plane, ((0, 8 * bh - h), (0, 8 * bw - w)), mode="edge")
    return p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)


def _magnitude(v: np.ndarray):
    """(bit count, magnitude bits) of signed values: the one's-complement form of negatives, as JPEG codes them."""
    a = np.abs(v)
    s = np.zeros_like(a)
    nz = a > 0
    s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return s, np.where(v < 0, v + (1 << s) - 1, v)


def _symbols(zz: np.ndarray, comp: np.ndarray, table: np.ndarray, dc_codes, ac_codes):
    """The codes of blocks in stream order (rows of zigzag-ordered quantised coefficients; per block its component,
    whose previous block predicts its DC, and its Huffman table, 0 or 1), each code joined with its magnitude bits:
    (bits, length) in stream order."""
    n = len(zz)
    diff = zz[:, 0].copy()
    for c in np.unique(comp):
        m = comp == c
        diff[m] = np.diff(zz[m, 0], prepend=0)
    items = []  # (block, key within the block, bits, length)
    s, mbits = _magnitude(diff)
    code, length = dc_codes[0][table, s], dc_codes[1][table, s]
    items.append((np.arange(n), np.zeros(n, np.int64), (code << s) | mbits, length + s))
    b, p = np.nonzero(zz[:, 1:])
    p = p + 1
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate([[0], p[:-1]]))
    run = p - prev - 1
    ac_code, ac_len = ac_codes
    for j in range(3):  # a run of 16 or more zeros: one ZRL code per 16, before the coefficient
        z = run >= 16 * (j + 1)
        items.append((b[z], 4 * p[z] + j, ac_code[table[b[z]], 0xF0], ac_len[table[b[z]], 0xF0]))
    s, mbits = _magnitude(zz[b, p])
    rs = (run % 16) << 4 | s
    items.append((b, 4 * p + 3, (ac_code[table[b], rs] << s) | mbits, ac_len[table[b], rs] + s))
    last = np.zeros(n, np.int64)
    last[b] = p  # b ascends: the last write per block is its last nonzero
    eob = np.nonzero(last < 63)[0]
    items.append((eob, np.full(len(eob), 4 * 64), ac_code[table[eob], 0], ac_len[table[eob], 0]))
    blk, key, bits, lens = (np.concatenate(x) for x in zip(*items))
    order = np.lexsort((key, blk))
    return bits[order], lens[order]


def _pack(bits: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate codes MSB first, pad the last byte with 1 bits, stuff a 0x00 after every 0xFF."""
    total = int(lens.sum())
    start = np.cumsum(lens) - lens
    pos = np.arange(total) - np.repeat(start, lens)  # bit index within its code
    stream = ((np.repeat(bits, lens) >> (np.repeat(lens, lens) - 1 - pos)) & 1).astype(np.uint8)
    out = np.packbits(np.concatenate([stream, np.ones(-total % 8, np.uint8)]))
    return np.insert(out, np.nonzero(out == 0xFF)[0] + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 RGB -> a baseline JFIF JPEG stream, YCbCr 4:2:0; an (H, W) uint8 grey image -> a grey one."""
    img = np.asarray(rgb)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3) or 0 in img.shape:
        raise ValueError(f"expected (H, W, 3) or (H, W) uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    qts = quality_tables(quality)
    x = img.astype(np.float64)
    if img.ndim == 2:
        planes, factors, mcu = [x], [1], 8
    else:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128
        cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128
        halves = [np.pad(c, ((0, h % 2), (0, w % 2)), mode="edge").reshape((h + 1) // 2, 2, (w + 1) // 2, 2).mean((1, 3))
                  for c in (cb, cr)]
        planes, factors, mcu = [y, *halves], [2, 1, 1], 16
    mcux, mcuy = -(-w // mcu), -(-h // mcu)
    comps = []  # per component: (MCUs, blocks per MCU, 64) zigzag-ordered quantised coefficients
    for ci, (plane, f) in enumerate(zip(planes, factors)):
        blocks = _to_blocks(plane - 128.0, mcuy * f, mcux * f).reshape(-1, 8, 8)
        coef = np.rint(_fdct(blocks) / qts[min(ci, 1)].reshape(8, 8)).astype(np.int64).reshape(-1, 64)[:, ZIGZAG]
        comps.append(coef.reshape(mcuy, f, mcux, f, 64).transpose(0, 2, 1, 3, 4).reshape(mcuy * mcux, f * f, 64))
    zz = np.concatenate(comps, 1)  # stream order: MCU by MCU, each component's blocks in turn
    comp = np.tile(np.concatenate([np.full(f * f, ci) for ci, f in enumerate(factors)]), len(zz))
    dc = [_huff_codes(_DC_LUMA), _huff_codes(_DC_CHROMA)]
    ac = [_huff_codes(_AC_LUMA), _huff_codes(_AC_CHROMA)]
    bits, lens = _symbols(zz.reshape(-1, 64), comp, np.minimum(comp, 1), tuple(np.stack(t) for t in zip(*dc)),
                          tuple(np.stack(t) for t in zip(*ac)))
    head = b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    head += _segment(0xDB, b"".join(bytes([t]) + qts[t][ZIGZAG].astype(np.uint8).tobytes() for t in range(min(len(planes), 2))))
    head += _segment(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([len(planes)])
                     + b"".join(bytes([ci + 1, f << 4 | f, min(ci, 1)]) for ci, f in enumerate(factors)))
    for tc, specs in ((0, (_DC_LUMA, _DC_CHROMA)), (1, (_AC_LUMA, _AC_CHROMA))):
        head += _segment(0xC4, b"".join(bytes([tc << 4 | th]) + cnt + sym for th, (cnt, sym) in enumerate(specs[:len(planes)])))
    head += _segment(0xDA, bytes([len(planes)]) + b"".join(bytes([ci + 1, min(ci, 1) * 0x11]) for ci in range(len(planes)))
                     + bytes([0, 63, 0]))
    return head + _pack(bits, lens) + b"\xff\xd9"

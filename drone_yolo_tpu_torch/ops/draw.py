"""OpenCV's drawing calls without an image library: lines, rectangles, circles, polylines, text, in numpy.

The JAX package draws results, train batches and plots through `cv2` (`drone_yolo_tpu/utils/plotting.py`). The port
draws the same pixels as OpenCV 5.0 with these functions, on (H, W, 3) or (H, W) uint8 images in place:

- `line`, `rectangle` (outline or filled), `circle` (filled), `polylines` (closed or open), for LINE_8 and LINE_AA and
  any thickness, as OpenCV's `ThickLine`, `PolyLine`, `FillConvexPoly`, `EllipseEx` and `Circle` draw them:
  coordinates in 16.16 fixed point (`XY_SHIFT`); an anti-aliased edge (`LineAA`) is three pixels across per step,
  weighted from OpenCV's filter and slope-correction tables with end-point corrections, each pixel blended twice with
  its weight (OpenCV 5.0's blend); a thick segment is the convex quadrilateral around it, after its end points are
  clipped to the image grown by the thickness, with round caps (polygons of the circle's `ellipse2Poly` points, or
  filled Bresenham circles for LINE_8); rows of a polygon are filled from its two active edges;
- `get_text_size` and `put_text` for FONT_HERSHEY_SIMPLEX at the sizes the annotator uses (font scale lw / 3,
  thickness max(lw - 1, 1), lw = 1..24, and LINE_AA for `put_text`; other sizes and line types are refused).
  OpenCV 5.0 draws that font as its built-in TrueType face: the text box is the sum of per-character pixel advances
  plus one wide, 9 lw high above the baseline and the largest per-character descent below it. Those advances and
  descents are tabulated here (`_ADVANCE`, `_DESCENT`; read from OpenCV 5.0's `getTextSize`), so the box, and the
  label rectangle placed from it, are exact.
  The glyphs are the port's own stroke font (`_GLYPHS`), each drawn once per size inside its character's cell of the
  box, at the stroke width, side bearings, baseline and ink that fit OpenCV's (`_style`), and blended by its
  coverage: their pixels differ from OpenCV's outline glyphs, which are not reproduced. The port's strokes stay
  inside the box; OpenCV's ink reaches up to lw / 2 + 1 px left of it;
- `add_weighted` (`cv2.addWeighted` on uint8: float32 b * beta, then a * alpha added in one rounding, as a fused
  multiply-add, rounded half to even and saturated). INTER_NEAREST is `ops/letterbox.py:resize_nearest`;
- `apply_color_map` (`cv2.applyColorMap` on a one-channel uint8 image) for OpenCV 5.0's 22 colormaps, their constants
  cv2's (`COLORMAP_PARULA` = 12, ...): each a table of 256 BGR colors, read from OpenCV 5.0 at every level and stored
  as per-channel differences, zlib-compressed (`_COLORMAPS`).

Every shape is bit-equal to the installed OpenCV on the seeded cases of `tests/test_torch_plotting.py`. Circles are
drawn filled only, as every cv2.circle call of the JAX package draws them.
"""

from __future__ import annotations

import base64
import math
import zlib

import numpy as np

from drone_yolo_tpu_torch.ops.polygon import clip_line, line_pixels

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
LINE_8, LINE_AA = 8, 16
FILLED = -1

# OpenCV's `LineAA` tables: the weight of a pixel at 1/32-pixel distances from the line, and the slope correction
_FILTER = np.array([
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252, 254, 254,
    254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202, 194, 185, 177, 168,
    158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75, 68, 62, 56, 50, 45,
    40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8, 7, 5, 5], np.int64)
_SLOPE_CORR = (181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196, 198, 201,
               203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238, 242, 246, 250, 254)
# OpenCV's float table of sin(d) for d = 0..450 degrees, to 7 decimals (cos(d) = _SIN[450 - d])
_SIN = np.array([round(math.sin(math.radians(d)), 7) for d in range(451)], np.float32)


def _trunc_div(a: int, b: int) -> int:
    """C's integer division, which truncates toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip(w: int, h: int, p1, p2):
    """`cv::clipLine` of p1-p2 to a w x h box (in the points' own units): the clipped (p1, p2), or None."""
    a, b = [int(p1[0]), int(p1[1])], [int(p2[0]), int(p2[1])]
    return (tuple(a), tuple(b)) if clip_line(w, h, a, b) else None


def _color(img: np.ndarray, color) -> np.ndarray:
    """The color as int64 channel values for the image: a scalar or the first channels of a tuple."""
    c = np.atleast_1d(np.asarray(color, np.float64))
    n = img.shape[2] if img.ndim == 3 else 1
    c = np.concatenate([c, np.zeros(max(n - len(c), 0))])[:n]
    return np.clip(np.rint(c), 0, 255).astype(np.int64)


def _blend(img: np.ndarray, xs, ys, a, c: np.ndarray) -> None:
    """Blend the color into the pixels (xs, ys) inside the image with 8-bit weights `a`, twice, as OpenCV 5.0's
    `LineAA` does: v += ((c - v) * a + 127) >> 8, applied two times."""
    h, w = img.shape[:2]
    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    xs, ys, a = xs[ok], ys[ok], a[ok]
    v = img[ys, xs].astype(np.int64)
    if img.ndim == 3:
        a = a[:, None]
    else:
        c = c[0]
    v += ((c - v) * a + 127) >> 8
    v += ((c - v) * a + 127) >> 8
    img[ys, xs] = v


def _put(img: np.ndarray, xs, ys, c: np.ndarray) -> None:
    h, w = img.shape[:2]
    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    img[ys[ok], xs[ok]] = c if img.ndim == 3 else c[0]


def _hline(img: np.ndarray, y: int, x1: int, x2: int, c: np.ndarray) -> None:
    img[y, x1:x2 + 1] = c if img.ndim == 3 else c[0]


def _line_aa(img: np.ndarray, p1, p2, c: np.ndarray) -> None:
    """OpenCV's `LineAA` from p1 to p2 (16.16 fixed point): along the major axis one step per pixel, three pixels
    across weighted by the distance to the line, the two ends corrected by their sub-pixel fractions."""
    h, w = img.shape[:2]
    clipped = _clip(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    x_major = abs(dx) > abs(dy)
    if not x_major:  # walk y as if it were x
        x1, y1, x2, y2, dx, dy = y1, x1, y2, x2, dy, dx
    if dx < 0:
        x1, y1, x2, y2, dy = x2, y2, x1, y1, -dy
    step = _trunc_div(dy << XY_SHIFT, abs(dx) | 1)
    x2 += XY_ONE
    ecount = (x2 >> XY_SHIFT) - (x1 >> XY_SHIFT)
    y1 += ((step * -(x1 & (XY_ONE - 1))) >> XY_SHIFT) + (XY_ONE >> 1)
    slope = ((step >> (XY_SHIFT - 5)) & 0x3F) ^ (0x3F if step < 0 else 0)
    i, j = (x1 >> (XY_SHIFT - 7)) & 0x78, (x2 >> (XY_SHIFT - 7)) & 0x78
    slope = 0x100 if slope & 0x20 else _SLOPE_CORR[slope]
    t0, t1, t2 = slope << 7, ((0x78 - i) | 4) * slope, (j | 4) * slope
    ep = np.array([0, ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF, (t1 >> 8) & 0x1FF,
                   ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF, ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1FF,
                   ((t1 + t0) >> 8) & 0x1FF, (t2 >> 8) & 0x1FF, ((t2 + t0) >> 8) & 0x1FF, slope], np.int64)
    k = np.arange(ecount + 1, dtype=np.int64)
    e = ecount - k
    corr = ep[(((k >= 2) + 1) & (k | 2)) * 3 + (((e >= 2) + 1) & (e | 2))]
    major = (x1 >> XY_SHIFT) + k
    minor_f = y1 + k * step
    minor = (minor_f >> XY_SHIFT) - 1
    dist = (minor_f >> (XY_SHIFT - 5)) & 31
    a = (np.tile(corr, 3) * _FILTER[np.concatenate([dist + 32, dist, 63 - dist])] >> 8) & 0xFF  # three pixels across
    major, minor = np.tile(major, 3), np.concatenate([minor, minor + 1, minor + 2])
    _blend(img, *((major, minor) if x_major else (minor, major)), a, c)


def _line2(img: np.ndarray, p1, p2, c: np.ndarray) -> None:
    """OpenCV's `Line2`: the LINE_8 line between 16.16 fixed-point points, one pixel per major step plus the end
    point rounded."""
    h, w = img.shape[:2]
    clipped = _clip(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    x_major = abs(dx) > abs(dy)
    if not x_major:
        x1, y1, x2, y2, dx, dy = y1, x1, y2, x2, dy, dx
    if dx < 0:
        x1, y1, x2, y2, dy = x2, y2, x1, y1, -dy
    step = _trunc_div(dy << XY_SHIFT, abs(dx) | 1)
    k = np.arange(((x2 - x1) >> XY_SHIFT) + 1, dtype=np.int64)
    half = XY_ONE >> 1
    major = np.concatenate([[(x2 + half) >> XY_SHIFT], ((x1 + half) >> XY_SHIFT) + k])
    minor = np.concatenate([[(y2 + half) >> XY_SHIFT], (y1 + half + k * step) >> XY_SHIFT])
    if x_major:
        _put(img, major, minor, c)
    else:
        _put(img, minor, major, c)


def _fill_convex_poly(img: np.ndarray, v: list, c: np.ndarray, aa: bool, shift: int) -> None:
    """OpenCV's `FillConvexPoly` of the points `v` (in `shift`-bit fixed point): the edges drawn (LineAA, or Line2),
    then each row from the top vertex down filled between the two active edges, x in 16.16 with dx rounded."""
    h, w = img.shape[:2]
    n = len(v)
    delta = (1 << shift) >> 1
    delta1, delta2 = (XY_ONE - 1, 0) if aa else (XY_ONE >> 1, XY_ONE >> 1)
    up = XY_SHIFT - shift
    p0 = (v[-1][0] << up, v[-1][1] << up)
    for p in v:
        p = (p[0] << up, p[1] << up)
        (_line_aa if aa else _line2)(img, p0, p, c)
        p0 = p
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    imin = ys.index(min(ys))
    xmin, xmax = (min(xs) + delta) >> shift, (max(xs) + delta) >> shift
    ymin, ymax = (min(ys) + delta) >> shift, (max(ys) + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    idx, di, ex, edx, ye = [imin, imin], [1, n - 1], [-XY_ONE, -XY_ONE], [0, 0], [ymin, ymin]
    y, edges = ymin, n
    while True:
        if not aa or y < ymax or y == ymin:
            for s in (0, 1):
                if y < ye[s]:
                    continue
                i0 = idx[s]
                i1 = (i0 + di[s]) % n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[i1][1] + delta) >> shift
                    if ty > y:
                        x0, x1 = v[i0][0] << up, v[i1][0] << up
                        ye[s], ex[s], idx[s] = ty, x0, i1
                        edx[s] = _trunc_div((x1 - x0) * 2 + (ty - y), 2 * (ty - y))
                        break
                    i0, i1 = i1, (i1 + di[s]) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if ex[0] > ex[1] else (0, 1)
            xx1, xx2 = (ex[left] + delta1) >> XY_SHIFT, (ex[right] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), c)
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        if y > ymax:
            break


def _circle_filled(img: np.ndarray, cx: int, cy: int, r: int, c: np.ndarray) -> None:
    """OpenCV's `Circle` with fill: Bresenham's octants, each row between its two boundary points."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, r, 0, 1, (r << 1) - 1
    while dx >= dy:
        for yy, xa, xb in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                           (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= yy < h and xa < w and xb >= 0:
                _hline(img, yy, max(xa, 0), min(xb, w - 1), c)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _ellipse2poly(cx: float, cy: float, ax: float, ay: float, delta: int) -> list:
    """`cv::ellipse2Poly` (double version) of a whole unrotated ellipse: a point every `delta` degrees from
    OpenCV's sine table."""
    pts = []
    for i in range(0, 360 + delta, delta):
        a = min(i, 360)
        pts.append((cx + ax * float(_SIN[450 - a]), cy + ay * float(_SIN[a])))
    return pts


def _ellipse_ex(img: np.ndarray, center, axes, c: np.ndarray, aa: bool) -> None:
    """OpenCV's `EllipseEx` of a whole unrotated ellipse, filled (center and axes in 16.16): its polygon, a point
    every 90, 30, 18 or 5 degrees by size, rounded to the fixed point."""
    ax, ay = abs(axes[0]), abs(axes[1])
    delta = (max(ax, ay) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    v, prev = [], None
    for x, y in _ellipse2poly(float(center[0]), float(center[1]), float(ax), float(ay), delta):
        px, py = round(x / XY_ONE) << XY_SHIFT, round(y / XY_ONE) << XY_SHIFT
        p = (px + round(x - px), py + round(y - py))
        if p != prev:
            v.append(p)
            prev = p
    _fill_convex_poly(img, v if len(v) > 1 else [tuple(center)] * 2, c, aa, XY_SHIFT)


def _thick_line(img: np.ndarray, p0, p1, c: np.ndarray, thickness: int, aa: bool, flags: int, shift: int) -> None:
    """OpenCV 5.0's `ThickLine` (points in `shift`-bit fixed point): thickness <= 1 a plain line; else the end
    points clipped to the image grown by the thickness, the quadrilateral around the segment filled, and a round cap
    at each end flagged in `flags` (1 the first, 2 the second)."""
    h, w = img.shape[:2]
    if thickness > 1:
        m = thickness << shift
        clipped = _clip((w << shift) + 2 * m, (h << shift) + 2 * m, (p0[0] + m, p0[1] + m), (p1[0] + m, p1[1] + m))
        if clipped is None:
            return
        p0, p1 = ((q[0] - m, q[1] - m) for q in clipped)
    up = XY_SHIFT - shift
    p0, p1 = (p0[0] << up, p0[1] << up), (p1[0] << up, p1[1] << up)
    if thickness <= 1:
        if aa:
            _line_aa(img, p0, p1, c)
        elif shift == 0:
            xs, ys = line_pixels(w, h, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT), (p1[0] >> XY_SHIFT, p1[1] >> XY_SHIFT))
            _put(img, xs, ys, c)
        else:
            _line2(img, p0, p1, c)
        return
    dx, dy = (p0[0] - p1[0]) / XY_ONE, (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > 2.220446049250313e-16:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        ox, oy = round(dy * r), round(dx * r)
        _fill_convex_poly(img, [(p0[0] + ox, p0[1] + oy), (p0[0] - ox, p0[1] - oy),
                                (p1[0] - ox, p1[1] - oy), (p1[0] + ox, p1[1] + oy)], c, aa, XY_SHIFT)
    for i, p in enumerate((p0, p1)):
        if flags & (i + 1):
            if aa:
                _ellipse_ex(img, p, (thickness, thickness), c, aa)
            else:
                half = XY_ONE >> 1
                _circle_filled(img, (p[0] + half) >> XY_SHIFT, (p[1] + half) >> XY_SHIFT,
                               (thickness + half) >> XY_SHIFT, c)


def _poly_line(img: np.ndarray, v: list, closed: bool, c: np.ndarray, thickness: int, aa: bool, shift: int) -> None:
    """OpenCV's `PolyLine`: each segment a thick line with a cap at its end (and at the start of an open one)."""
    if not v:
        return
    p0, flags = v[-1] if closed else v[0], 2 + (not closed)
    for p in v[0 if closed else 1:]:
        _thick_line(img, p0, p, c, thickness, aa, flags, shift)
        p0, flags = p, 2


def _pt(p) -> tuple[int, int]:
    return int(p[0]), int(p[1])


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1, line_type: int = LINE_8) -> np.ndarray:
    """`cv2.line(img, pt1, pt2, color, thickness, line_type)` in place; returns img."""
    _thick_line(img, _pt(pt1), _pt(pt2), _color(img, color), int(thickness), line_type == LINE_AA, 3, 0)
    return img


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 1, line_type: int = LINE_8) -> np.ndarray:
    """`cv2.rectangle(img, pt1, pt2, color, thickness, line_type)` in place, filled when thickness < 0."""
    (x1, y1), (x2, y2) = _pt(pt1), _pt(pt2)
    v, c = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)], _color(img, color)
    if thickness >= 0:
        _poly_line(img, v, True, c, int(thickness), line_type == LINE_AA, 0)
    else:
        _fill_convex_poly(img, v, c, line_type == LINE_AA, 0)
    return img


def circle(img: np.ndarray, center, radius: int, color, thickness: int = FILLED, line_type: int = LINE_8) -> np.ndarray:
    """`cv2.circle(img, center, radius, color, thickness < 0, line_type)` in place: a filled circle (outlines are
    refused)."""
    if thickness >= 0:
        raise NotImplementedError("the port draws filled circles only (thickness < 0), as the JAX package calls them")
    (cx, cy), c = _pt(center), _color(img, color)
    if line_type == LINE_8:
        _circle_filled(img, cx, cy, int(radius), c)
    else:
        _ellipse_ex(img, (cx << XY_SHIFT, cy << XY_SHIFT), (int(radius) << XY_SHIFT, int(radius) << XY_SHIFT), c,
                    line_type == LINE_AA)
    return img


def polylines(img: np.ndarray, pts, is_closed: bool, color, thickness: int = 1, line_type: int = LINE_8) -> np.ndarray:
    """`cv2.polylines(img, pts, is_closed, color, thickness, line_type)` in place: `pts` a list of (K, 2) or
    (K, 1, 2) integer point arrays."""
    c = _color(img, color)
    for p in pts:
        v = [(int(x), int(y)) for x, y in np.asarray(p).reshape(-1, 2)]
        _poly_line(img, v, bool(is_closed), c, int(thickness), line_type == LINE_AA, 0)
    return img


def add_weighted(src1: np.ndarray, alpha: float, src2: np.ndarray, beta: float, gamma: float = 0.0) -> np.ndarray:
    """`cv2.addWeighted(src1, alpha, src2, beta, gamma)` on uint8: t = float32(src2 * beta + gamma), then
    src1 * alpha + t in one float32 rounding, rounded half to even and saturated."""
    t = src2.astype(np.float32) * np.float32(beta) + np.float32(gamma)
    s = (src1.astype(np.float64) * np.float64(np.float32(alpha)) + t.astype(np.float64)).astype(np.float32)
    return np.clip(np.rint(s), 0, 255).astype(np.uint8)


# -- text --------------------------------------------------------------------------------------------------------------
# Per annotator line width lw = 1..24 (font scale lw / 3, thickness max(lw - 1, 1)): the pixel advance of each
# character ' ' .. '~', and the descent below the baseline of the characters in `_DESCENDERS` (0 for the others), as
# OpenCV 5.0's getTextSize gives them for FONT_HERSHEY_SIMPLEX.
_ADVANCE = (
    "2 2 3 6 5 7 6 2 5 5 4 5 2 4 2 4 5 5 5 5 5 5 5 5 5 5 2 2 4 5 4 5 8 6 6 6 6 5 5 6 6 2 6 5 5 7 6 6 6 6 6 5 5 6 "
    "6 7 6 6 5 3 4 3 4 7 3 5 5 5 5 5 3 5 5 2 2 4 2 8 5 5 5 5 3 4 3 5 5 7 5 5 4 3 2 3 5",
    "4 4 7 13 11 14 13 4 11 11 8 11 4 9 4 9 11 11 11 11 11 11 11 11 11 11 4 5 9 10 9 10 16 12 12 12 13 11 11 13 "
    "13 5 12 11 10 15 13 13 12 13 12 11 11 13 12 15 12 12 11 6 9 6 8 14 6 10 11 10 11 10 7 11 11 4 4 9 4 17 11 11 "
    "11 11 7 9 7 11 10 15 10 10 9 7 4 7 10",
    "7 8 12 19 18 22 21 6 18 18 12 17 7 13 7 15 18 18 18 18 18 18 18 18 18 18 8 8 14 16 14 16 24 20 20 20 20 18 "
    "17 20 21 8 19 18 16 23 20 20 19 20 19 18 17 20 19 23 19 19 18 10 14 10 13 21 11 16 17 16 17 16 12 18 18 7 8 "
    "16 7 26 18 17 17 17 12 15 12 18 16 23 16 16 15 11 7 11 16",
    "9 10 16 26 25 30 28 9 25 25 17 23 10 18 10 20 25 25 25 25 25 25 25 25 25 25 10 11 19 21 19 22 32 27 26 26 27 "
    "24 23 27 28 11 25 24 22 31 27 27 25 27 26 25 23 27 26 31 25 25 24 14 19 14 17 28 14 22 23 22 23 22 16 24 24 "
    "10 11 21 10 34 24 23 23 23 16 20 17 24 22 31 22 22 20 15 9 15 21",
    "12 13 20 33 31 38 35 11 31 31 21 29 13 23 13 25 31 31 31 31 31 31 31 31 31 31 13 14 24 27 24 27 40 33 33 33 "
    "34 30 29 34 35 14 31 31 28 39 34 33 32 33 32 31 29 34 32 39 32 32 30 17 24 17 21 35 18 27 29 27 29 28 20 30 "
    "30 13 13 27 13 43 30 28 29 29 20 26 21 30 28 39 27 28 26 19 12 19 26",
    "14 16 24 39 37 45 42 13 37 37 25 35 15 27 15 30 37 37 37 37 37 37 37 37 37 37 16 16 29 32 29 33 48 40 40 40 "
    "40 36 35 40 42 17 38 37 33 47 41 40 38 40 39 37 35 41 39 47 38 38 36 21 29 21 26 42 22 33 35 33 35 33 24 36 "
    "36 15 16 32 15 52 36 34 35 35 25 31 25 36 33 47 33 33 31 23 14 23 32",
    "17 18 29 46 44 53 49 15 43 43 29 41 18 32 18 35 43 43 43 43 43 43 43 43 43 43 19 19 34 38 34 39 56 47 46 46 "
    "47 42 40 47 49 20 44 43 39 55 47 47 44 47 45 43 41 48 46 55 45 45 42 24 34 24 30 49 25 39 41 39 41 39 28 42 "
    "43 18 19 38 18 61 42 40 41 41 29 36 30 42 39 55 38 39 36 27 17 27 37",
    "19 21 33 52 50 61 56 18 50 50 34 46 20 36 21 40 50 50 50 50 50 50 50 50 50 50 21 22 39 43 39 44 64 54 53 53 "
    "54 48 46 54 56 23 50 49 45 62 54 54 51 54 52 50 47 55 52 63 51 51 49 28 39 28 35 56 29 44 47 44 47 45 32 48 "
    "49 21 22 43 21 69 48 46 47 47 33 41 34 48 44 63 44 45 41 31 19 31 42",
    "22 24 37 59 56 68 63 20 56 56 38 52 23 41 23 45 56 56 56 56 56 56 56 56 56 56 24 25 44 49 44 50 72 60 60 60 "
    "61 54 52 61 63 26 57 55 50 70 61 60 57 60 59 56 53 62 59 71 58 58 55 31 44 31 39 63 33 50 53 50 53 50 36 54 "
    "55 23 25 49 23 78 54 52 53 53 37 46 38 54 50 71 49 50 46 35 22 35 48",
    "24 26 41 66 62 76 70 22 62 62 42 58 25 46 26 50 62 62 62 62 62 62 62 62 62 62 27 28 49 54 49 55 80 67 66 66 "
    "68 60 58 68 70 29 63 62 56 78 68 67 64 67 65 62 59 69 65 79 64 64 61 35 49 35 43 71 36 55 59 55 59 56 41 60 "
    "61 26 27 54 26 87 60 57 59 59 41 52 43 60 56 79 55 56 52 39 24 39 53",
    "27 29 45 72 69 84 77 24 68 68 47 64 28 50 29 55 68 68 68 68 68 68 68 68 68 68 29 30 54 59 53 61 89 74 73 73 "
    "75 66 64 75 77 32 69 68 62 86 75 74 70 74 72 69 65 76 72 87 71 71 67 38 54 38 48 78 40 61 65 61 65 61 45 66 "
    "67 29 30 59 29 96 67 63 65 65 46 57 47 66 61 87 60 61 57 43 27 43 58",
    "29 32 49 79 75 91 84 27 75 75 51 70 31 55 31 60 75 75 75 75 75 75 75 75 75 75 32 33 58 65 58 66 97 81 80 80 "
    "81 72 70 81 85 35 76 74 67 94 82 81 77 81 78 75 71 83 78 94 77 77 73 42 59 42 52 85 44 67 71 67 71 67 49 72 "
    "73 31 33 65 31 104 73 69 71 71 50 62 51 72 67 95 66 67 62 47 29 47 64",
    "32 34 53 86 81 99 91 29 81 81 55 76 33 59 34 65 81 81 81 81 81 81 81 81 81 81 35 36 63 70 63 72 105 87 86 86 "
    "88 78 76 88 92 38 82 80 73 102 89 87 83 87 85 81 77 89 85 102 84 83 79 46 64 46 56 92 47 72 77 72 77 73 53 "
    "78 79 34 36 70 34 113 79 75 77 77 54 67 55 78 73 103 71 73 67 51 32 51 69",
    "34 37 58 92 88 107 98 31 87 87 59 82 36 64 37 70 87 87 87 87 87 87 87 87 87 87 38 39 68 76 68 78 113 94 93 "
    "93 95 84 81 95 99 41 89 87 79 110 95 94 89 94 91 87 83 96 92 110 90 90 85 49 69 49 61 99 51 78 83 78 83 78 "
    "57 84 86 36 39 76 37 122 85 80 83 83 58 73 60 84 78 111 77 78 72 55 34 55 74",
    "37 40 62 99 94 114 105 34 94 94 64 88 38 69 39 75 94 94 94 94 94 94 94 94 94 94 40 42 73 81 73 83 121 101 "
    "100 100 102 90 87 102 106 44 95 93 84 118 102 101 96 101 98 94 88 103 98 118 97 96 91 53 74 53 65 106 55 83 "
    "89 83 89 84 61 90 92 39 41 81 39 131 91 86 89 89 62 78 64 90 84 119 83 84 78 59 36 59 80",
    "39 42 66 105 100 122 112 36 100 100 68 93 41 73 42 80 100 100 100 100 100 100 100 100 100 100 43 44 78 87 78 "
    "89 129 108 106 106 109 97 93 109 113 47 101 99 90 125 109 108 102 108 105 100 94 110 105 126 103 103 98 56 "
    "79 56 70 113 58 89 95 89 95 90 65 96 98 42 44 87 42 139 97 92 95 95 67 83 68 97 89 127 88 90 83 63 39 63 85",
    "42 45 70 112 107 129 119 38 106 106 72 99 44 78 45 85 106 106 106 106 106 106 106 106 106 106 46 47 83 92 83 "
    "94 137 115 113 113 116 103 99 116 120 50 108 105 96 133 116 115 109 115 111 106 100 117 111 134 110 109 104 "
    "60 84 60 74 120 62 94 101 94 101 95 69 102 104 44 47 92 45 148 103 98 101 101 71 88 73 103 95 135 94 95 88 "
    "67 41 67 90",
    "44 48 74 119 113 137 126 40 112 112 76 105 46 82 47 90 112 112 112 112 112 112 112 112 112 112 48 50 88 98 "
    "88 100 145 121 120 120 122 109 105 122 127 53 114 111 101 141 123 121 115 121 118 112 106 124 118 142 116 "
    "116 110 63 89 63 78 127 66 100 107 100 107 101 73 108 110 47 50 98 47 157 109 104 107 107 75 93 77 109 101 "
    "143 99 101 93 71 44 71 96",
    "47 50 78 125 119 145 133 43 119 119 81 111 49 87 50 95 119 119 119 119 119 119 119 119 119 119 51 53 93 103 "
    "93 105 153 128 126 126 129 115 111 129 134 56 120 118 107 149 130 128 121 128 124 119 112 131 124 150 123 "
    "122 116 67 94 67 83 134 69 106 113 106 113 106 78 114 116 50 53 103 50 166 115 109 113 113 79 99 81 115 106 "
    "151 105 106 98 74 46 74 101",
    "49 53 82 132 125 152 140 45 125 125 85 117 51 92 52 100 125 125 125 125 125 125 125 125 125 125 54 56 98 108 "
    "97 111 161 135 133 133 136 121 117 136 141 59 127 124 113 157 137 135 128 135 131 125 118 138 131 158 129 "
    "129 122 70 99 70 87 142 73 111 119 111 119 112 82 120 123 52 55 108 52 174 121 115 119 119 83 104 86 121 112 "
    "159 110 112 104 78 49 78 106",
    "52 56 87 139 132 160 147 47 131 131 89 123 54 96 55 105 131 131 131 131 131 131 131 131 131 131 57 59 103 "
    "114 102 117 170 142 140 140 143 127 122 143 148 62 133 130 118 165 143 142 134 142 137 131 124 145 138 166 "
    "136 135 128 74 104 74 91 149 77 117 125 117 125 118 86 126 129 55 58 114 55 183 127 121 125 125 87 109 90 "
    "127 118 167 116 118 109 82 51 82 112",
    "54 58 91 145 138 168 154 49 137 137 94 129 57 101 58 110 137 137 137 137 137 137 137 137 137 137 59 61 108 "
    "119 107 122 178 148 146 146 150 133 128 150 155 65 139 136 124 173 150 148 141 148 144 138 130 152 144 174 "
    "142 142 134 77 109 77 96 156 80 122 131 122 131 123 90 132 135 58 61 119 58 192 134 127 131 131 92 114 94 "
    "133 123 175 121 123 114 86 54 86 117",
    "57 61 95 152 144 175 161 52 144 144 98 135 59 105 60 115 144 144 144 144 144 144 144 144 144 144 62 64 112 "
    "125 112 128 186 155 153 153 156 139 134 156 162 68 146 143 129 181 157 155 147 155 150 144 136 159 151 181 "
    "149 148 141 81 114 81 100 163 84 128 137 128 137 129 94 138 141 60 64 125 60 201 140 133 137 137 96 120 98 "
    "139 129 183 127 129 119 90 56 90 122",
    "59 64 99 158 151 183 168 54 150 150 102 140 62 110 63 120 150 150 150 150 150 150 150 150 150 150 65 67 117 "
    "130 117 133 194 162 160 160 163 145 140 163 170 71 152 149 135 188 164 162 154 162 157 150 142 166 157 189 "
    "155 155 147 85 119 85 105 170 88 133 143 133 143 135 98 144 147 63 67 130 63 209 146 138 143 143 100 125 103 "
    "145 134 191 132 135 124 94 59 94 128",
)
_DESCENDERS = '$%&(),/03568;@CGJOQSU[\\]_abcdegjopqsuy{|}'
_DESCENT = (
    "1 1 1 2 2 1 1 1 1 1 1 1 1 2 1 1 1 1 1 1 1 2 1 2 1 1 1 1 1 1 3 2 1 2 2 1 1 2 2 2 2",
    "2 1 1 3 3 2 2 1 1 1 1 1 2 3 1 1 1 1 2 1 1 4 2 4 1 1 1 1 1 1 5 4 1 4 4 1 1 4 4 5 4",
    "3 1 1 4 4 3 3 1 1 1 1 1 3 4 1 1 1 1 2 1 1 5 3 5 2 1 1 1 1 1 7 6 1 6 6 1 1 6 5 7 5",
    "4 1 1 5 5 3 4 1 1 1 1 1 3 5 1 1 1 1 3 1 1 7 4 7 3 1 1 1 1 1 9 8 1 8 8 1 1 8 7 9 7",
    "5 1 1 6 6 4 5 1 1 1 1 1 4 7 1 1 1 1 4 1 1 8 5 8 4 1 1 1 1 1 11 10 1 10 10 1 1 10 8 11 8",
    "6 1 1 7 7 5 5 1 1 1 1 1 5 8 1 1 1 1 4 1 1 10 5 10 4 1 1 1 1 1 13 11 1 11 11 1 1 11 10 13 10",
    "7 1 1 8 8 6 6 1 1 1 1 1 6 9 1 1 1 1 5 1 1 11 6 11 5 1 1 1 1 1 15 13 1 13 13 1 1 13 11 15 11",
    "8 1 1 9 9 6 7 1 1 1 1 1 6 10 1 1 1 1 6 1 1 13 7 13 5 1 1 1 1 1 17 15 1 15 15 1 1 15 13 17 13",
    "9 1 1 11 11 7 8 1 1 2 1 1 7 12 1 1 1 1 6 1 1 14 8 14 6 1 1 1 1 1 20 17 1 17 17 1 1 17 14 19 14",
    "10 1 1 12 12 8 9 1 1 2 1 1 8 13 1 1 1 1 7 1 1 16 9 16 7 1 1 1 1 1 22 19 1 19 19 1 1 19 16 21 16",
    "11 1 2 13 13 8 9 2 2 2 2 2 8 14 2 2 2 2 7 2 2 17 9 17 7 2 2 2 2 2 24 21 2 21 21 2 2 21 17 23 17",
    "12 1 2 14 14 9 10 2 2 2 2 2 9 15 2 2 2 2 8 2 2 19 10 19 8 2 2 2 2 2 26 22 2 22 22 2 2 22 19 25 19",
    "13 1 2 15 15 10 11 2 2 2 2 2 10 17 2 2 2 2 9 2 2 20 11 20 9 2 2 2 2 2 28 24 2 24 24 2 2 24 20 27 20",
    "14 1 2 16 16 11 12 2 2 2 2 2 11 18 2 2 2 2 9 2 2 22 12 22 9 2 2 2 2 2 30 26 2 26 26 2 2 26 22 29 22",
    "15 1 2 17 17 11 13 2 2 2 2 2 11 19 2 2 2 2 10 2 2 23 13 23 10 2 2 2 2 2 32 28 2 28 28 2 2 28 23 31 23",
    "16 1 2 19 19 12 13 2 2 2 2 2 12 20 2 2 2 2 11 2 2 25 13 25 10 2 2 2 2 2 34 30 2 30 30 2 2 30 25 33 25",
    "17 1 2 20 20 13 14 2 2 2 2 2 13 21 2 2 2 2 11 2 2 27 14 27 11 2 2 2 2 2 36 32 2 32 32 2 2 32 27 35 27",
    "18 2 2 21 21 13 15 2 2 3 2 2 13 23 2 2 2 2 12 2 2 28 15 28 12 2 2 2 2 2 39 33 2 33 33 2 2 33 28 37 28",
    "19 2 2 22 22 14 16 2 2 3 2 2 14 24 2 2 2 2 12 2 2 30 16 30 12 2 2 2 2 2 41 35 2 35 35 2 2 35 30 39 30",
    "20 2 2 23 23 15 17 2 2 3 2 2 15 25 2 2 2 2 13 2 2 31 17 31 13 2 2 2 2 2 43 37 2 37 37 2 2 37 31 41 31",
    "21 2 3 24 24 16 17 3 3 3 3 3 16 26 3 3 3 3 14 3 3 33 17 33 13 3 3 3 3 3 45 39 3 39 39 3 3 39 33 43 33",
    "22 2 3 25 25 16 18 3 3 3 3 3 16 28 3 3 3 3 14 3 3 34 18 34 14 3 3 3 3 3 47 41 3 41 41 3 3 41 34 45 34",
    "23 2 3 26 26 17 19 3 3 3 3 3 17 29 3 3 3 3 15 3 3 36 19 36 15 3 3 3 3 3 49 43 3 43 43 3 3 43 36 47 36",
    "24 2 3 28 28 18 20 3 3 3 3 3 18 30 3 3 3 3 16 3 3 37 20 37 15 3 3 3 3 3 51 44 3 44 44 3 3 44 37 49 37",
)

# The port's stroke font: per character its strokes, each a run of points "xy" on a grid of x 0..4 across the cell and
# y 0..9, where 2 is the baseline, 8 the cap height and 0 the lowest descent.
_GLYPHS = {
    "!": "28 24|22 23", '"': "18 16|38 36", "#": "18 12|38 32|06 46|04 44",
    "$": "47 38 18 07 06 15 35 44 43 32 12 03|29 21", "%": "08 42|07 17 16 06 07|33 43 42 32 33",
    "&": "42 16 07 18 28 37 36 04 03 12 22 44", "'": "28 26", "(": "39 17 13 31", ")": "19 37 33 11",
    "*": "28 24|16 36|17 35|37 15", "+": "27 23|05 45", ",": "23 11", "-": "05 45", ".": "22 23", "/": "48 01",
    "0": "12 03 07 18 38 47 43 32 12", "1": "17 28 22|12 32", "2": "07 18 38 47 46 02 42",
    "3": "07 18 38 47 46 35 15|35 44 43 32 12 03", "4": "38 04 44|38 32", "5": "48 08 05 35 44 43 32 12 03",
    "6": "47 38 18 07 03 12 32 43 44 35 05", "7": "08 48 22", "8": "15 06 07 18 38 47 46 35 15 04 03 12 32 43 44 35",
    "9": "45 15 06 07 18 38 47 43 32 12 03", ":": "25 26|22 23", ";": "25 26|23 11", "<": "47 05 43",
    "=": "06 46|04 44", ">": "07 45 03", "?": "07 18 38 47 46 35 24|22 23",
    "@": "34 24 15 16 27 37 34 43 47 38 18 07 03 12 42", "A": "02 28 42|14 34",
    "B": "02 08 38 47 46 35 05|35 44 43 32 02", "C": "47 38 18 07 03 12 32 43", "D": "02 08 28 46 44 22 02",
    "E": "48 08 02 42|05 35", "F": "48 08 02|05 35", "G": "47 38 18 07 03 12 32 43 45 25", "H": "08 02|48 42|05 45",
    "I": "18 38|28 22|12 32", "J": "48 43 32 12 03", "K": "08 02|48 04|15 42", "L": "08 02 42", "M": "02 08 25 48 42",
    "N": "02 08 42 48", "O": "12 03 07 18 38 47 43 32 12", "P": "02 08 38 47 46 35 05",
    "Q": "12 03 07 18 38 47 43 32 12|24 41", "R": "02 08 38 47 46 35 05|25 42",
    "S": "47 38 18 07 06 15 35 44 43 32 12 03", "T": "08 48|28 22", "U": "08 03 12 32 43 48", "V": "08 22 48",
    "W": "08 12 25 32 48", "X": "08 42|48 02", "Y": "08 25 48|25 22", "Z": "08 48 02 42", "[": "39 19 11 31",
    "\\": "08 41", "]": "19 39 31 11", "^": "06 28 46", "_": "01 41", "`": "18 37",
    "a": "06 36 45 42 12 03 04 14 44", "b": "08 02 32 43 45 36 06", "c": "46 16 05 03 12 42",
    "d": "48 42 12 03 05 16 46", "e": "04 44 45 36 16 05 03 12 42", "f": "47 38 28 17 12|06 36",
    "g": "43 13 04 05 16 46 41 30 10", "h": "08 02|06 36 45 42", "i": "26 22|28 29", "j": "36 31 20 00|38 39",
    "k": "08 02|36 03|14 42", "l": "18 13 22 32", "m": "02 06|05 16 25 22|25 36 45 42", "n": "02 06|05 16 36 45 42",
    "o": "12 03 05 16 36 45 43 32 12", "p": "00 06 36 45 43 32 02", "q": "40 46 16 05 03 12 42", "r": "02 06|04 26 46",
    "s": "46 16 05 14 34 43 32 02", "t": "18 13 22 32|06 36", "u": "06 03 12 32 43|46 42", "v": "06 22 46",
    "w": "06 12 24 32 46", "x": "06 42|46 02", "y": "06 23|46 00", "z": "06 46 02 42",
    "{": "39 29 18 16 05 14 12 21 31", "|": "29 20", "}": "19 29 38 36 45 34 32 21 11", "~": "05 16 25 34 45",
}
_MAX_LW = len(_ADVANCE)


def _metrics(lw: int) -> tuple[list, dict]:
    adv = [int(a) for a in _ADVANCE[lw - 1].split()]
    return adv, dict(zip(_DESCENDERS, (int(d) for d in _DESCENT[lw - 1].split())))


def _line_width(font_scale: float, thickness: int) -> int:
    """The annotator's line width lw of (font_scale, thickness) = (lw / 3, max(lw - 1, 1)); other pairs are
    refused."""
    lw = round(font_scale * 3)
    if not (1 <= lw <= _MAX_LW and abs(font_scale - lw / 3) < 1e-9 and int(thickness) == max(lw - 1, 1)):
        raise ValueError(f"text at font scale {font_scale} and thickness {thickness}: the port sizes "
                         f"FONT_HERSHEY_SIMPLEX text at (lw / 3, max(lw - 1, 1)) for lw = 1..{_MAX_LW} only")
    return lw


def _codes(text: str) -> list[int]:
    codes = [ord(ch) - 32 for ch in text]
    if any(not 0 <= k < 95 for k in codes):
        raise ValueError(f"text {text!r}: the port draws printable ASCII only")
    return codes


def get_text_size(text: str, font_scale: float, thickness: int) -> tuple[tuple[int, int], int]:
    """`cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, font_scale, thickness)`: ((width, height), baseline)."""
    lw = _line_width(font_scale, thickness)
    adv, desc = _metrics(lw)
    codes = _codes(text)
    if not codes:
        return (0, 0), 0
    return (sum(adv[k] for k in codes) + 1, 9 * lw), max(desc.get(chr(k + 32), 0) for k in codes)


# How a glyph's strokes sit in its cell, per line width lw: (stroke width in px, side bearing / lw, baseline drop / lw,
# cap height / box height, ink gain). Fitted to `cv2.putText`'s Rubik (OpenCV 5.0) on labels at lw 1 and 2; from lw 3
# on (thickness >= 2) the line fitted at lw 3, 4, 5, 6 and 9. Rubik keeps side bearings of ~lw/2, sits its strokes on
# the baseline and inks more than a stroke of the text's thickness does.
_STYLE = {1: (0.575, 0.525, -0.3, 0.72, 0.925), 2: (1.6, 0.538, -0.1, 0.748, 0.963)}
_SS = 4  # the strokes are drawn at 4x and each 4x4 block's mean is a pixel's coverage: sub-pixel widths and places


def _style(lw: int) -> tuple:
    return _STYLE.get(lw) or (0.554 * lw + 1.49, 0.63, -0.16, 0.725, 1.56)


def _glyph(ch: str, lw: int, thickness: int) -> tuple[np.ndarray, int, int]:
    """Character `ch`'s strokes drawn once, anti-aliased, in white on black for line width lw: (coverage (h, w) uint8,
    left, top) of the drawing relative to the left end of its baseline; kept in `_GLYPH_CACHE`. The strokes (`_GLYPHS`)
    span the cell between its side bearings, from the baseline to the cap height (`_style`), descenders down to the
    character's descent; drawn at `_SS` times the size, averaged down and scaled by the ink gain."""
    key = (ch, lw, thickness)
    if key not in _GLYPH_CACHE:
        adv, desc = _metrics(lw)
        width, bearing, drop, cap, gain = _style(lw)
        k = ord(ch) - 32
        h = 9 * lw
        pad = math.ceil(width) + 3
        rows, cols = h + desc.get(ch, 0) + 2 * pad, adv[k] + 2 * pad
        canvas = np.zeros((rows * _SS, cols * _SS), np.uint8)
        base = pad + h + drop * lw  # the baseline on the canvas, in pixels
        y_base, y_cap = base - width / 2, base - cap * h + width / 2  # the strokes' centre lines at grid rows 2 and 8
        unit = (y_base - y_cap) / 6
        side = min(bearing * lw + width / 2, adv[k] / 2)
        left, span = pad + side, max(adv[k] - 2 * side, 0) / 4
        down = desc.get(ch, 0) / 2
        white = np.array([255], np.int64)
        scale = _SS * XY_ONE
        for stroke in _GLYPHS.get(ch, "").split("|") if ch != " " else ():
            v = []
            for p in stroke.split():
                gx, gy = int(p[0]), int(p[1]) - 2
                py = y_base - gy * (unit if gy >= 0 else down)
                v.append((int(round((left + gx * span) * scale)), int(round(py * scale))))
            _poly_line(canvas, v if len(v) > 1 else v * 2, False, white, max(round(width * _SS), 1), True, XY_SHIFT)
        cover = canvas.reshape(rows, _SS, cols, _SS).mean((1, 3)) * gain
        _GLYPH_CACHE[key] = (np.clip(np.round(cover), 0, 255).astype(np.uint8), -pad, -(pad + h))
    return _GLYPH_CACHE[key]


_GLYPH_CACHE: dict = {}


def put_text(img: np.ndarray, text: str, org, font_scale: float, color, thickness: int = 1,
             line_type: int = LINE_AA) -> np.ndarray:
    """`cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, font_scale, color, thickness, line_type)` in place, org the
    left end of the baseline: each character's strokes (`_GLYPHS`), drawn once per size inside its cell of the
    `get_text_size` box (`_glyph`), blended in the color by their coverage."""
    if line_type != LINE_AA:
        raise ValueError(f"put_text draws LINE_AA ({LINE_AA}) text only, not line type {line_type}")
    lw = _line_width(font_scale, thickness)
    adv, _ = _metrics(lw)
    c = _color(img, color)
    h, w = img.shape[:2]
    x, base = int(org[0]), int(org[1])
    for k in _codes(text):
        cover, dx, dy = _glyph(chr(k + 32), lw, int(thickness))
        y0, x0 = base + dy, x + dx
        ys, xs = slice(max(y0, 0), min(y0 + cover.shape[0], h)), slice(max(x0, 0), min(x0 + cover.shape[1], w))
        if ys.start < ys.stop and xs.start < xs.stop:
            a = cover[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0].astype(np.int64)
            a += a == 255  # full coverage gives the color itself
            region = img[ys, xs]
            v = region.astype(np.int64)
            if img.ndim == 3:
                a = a[..., None]
            img[ys, xs] = v + (((c if img.ndim == 3 else c[0]) - v) * a + 127 >> 8)
        x += adv[k]
    return img


# -- colormaps ---------------------------------------------------------------------------------------------------------
(COLORMAP_AUTUMN, COLORMAP_BONE, COLORMAP_JET, COLORMAP_WINTER, COLORMAP_RAINBOW, COLORMAP_OCEAN, COLORMAP_SUMMER,
 COLORMAP_SPRING, COLORMAP_COOL, COLORMAP_HSV, COLORMAP_PINK, COLORMAP_HOT, COLORMAP_PARULA, COLORMAP_MAGMA,
 COLORMAP_INFERNO, COLORMAP_PLASMA, COLORMAP_VIRIDIS, COLORMAP_CIVIDIS, COLORMAP_TWILIGHT, COLORMAP_TWILIGHT_SHIFTED,
 COLORMAP_TURBO, COLORMAP_DEEPGREEN) = range(22)
# the 22 tables (colormap, channel B G R, level) as differences from the level below, modulo 256, zlib, base64
_COLORMAPS = (
    "eNrtWzmSGzcUBdAkR+UqJy6fwKEjJS4HShU78hl8DmU6o1Mdw2Lji2jgr/joYQ+Hs5hEY+0hie39FZgQbjzE2w5w3/9U1oEy3XrSe24tOUEsqOLZ"
    "2rbc9PdwhYHpcsNaPr6gXvbG59+Xz9lfXZ5EmVOu/v3Lbj1MF5IXHC8K31+dP+0uC5eu33zZ+h1fe/nShesXr7x+cALYxWnteY7fv2K6df0n3MMb"
    "1crTfmOYUkrb9zNNp+8tqTxeXabR+z6Vh8oiq7eJTYD8fWOYc86bxeXLyNfChTfN5fT5eTNmUlnw3bZ4539Xkfon8q06ZlUzr5cu+f3yvCOeOF0j"
    "/HPjguZLkTU3nG7e/3Xj4e7/vO1w8/O/0/9d/332cDgznEyQKT1353me5+N/Z4b3NNRX5X+vP9Tr7NTh4fBQnRolsEklTl58wjG5SFzoqEqZ+ZVz"
    "nnYIpAdsz4fkLOyErjv/1qU9jlkdoXgRBr3KnpdHRt0av2vxp1OoJxUFNtXJVRwpZSloRWhdupnYw85uMjzCKMai62uZ2xi+2j7//084bd602+o0"
    "faGhVUid5zl9cnqSOH+b/t8XC18Xop9Url4sp1jtMMvLbGErubiylzhKGDN4UWjoftX8VJfWw++pMrqYREW2PPa8qSlkmifqGhPirGuDVFS6hpGt"
    "VswixzbXAKj4Iy8rn92iVLS4DV2z33jVbp2lYTGAHWaLNGoSyVSqyF6R8MQQwNP3am1XvdTtx1ISnUzIsrAgecjSWctfJVCi1zPUpAloOSUWsaIb"
    "sxbrF8SP0w5b7CWx6bjKLQqIt5J/KnTampwV4w54ehIVDvx6wLtIMj13F4foIIFnwHPoK+oDg5yrrCKItWRQye5jkoNgpUivdF/pM78qvkdKlmIm"
    "3c7Enm+cZ+twreDfgb0APeGexoKDGGlQiHSD8pohxmHsesk2d4QFFVDpol2Gals74VSQnxTVqDwt7NvlnHI9J0oSYFiKmYFCvgB+8I2ZgUXTUZiG"
    "u2ZgRMiGlA0lRA/6HKLTxjO52hdOXw5CMRBaUwv/lWz1hQv0kUmhzZ3wKA14rBaM9oKsc+nuq71FGGK0hqq0IXrAg8R6x8UNzg3oQ1cz5VrhviXS"
    "QnpDwQFKt4jN9zl/AKNTmNJRPuQPCTPcit/UMdO1UjdT9C+BJmPuO1qNehyua3D886JokPg3SI/K9h3ANzl3LB1fRPTdCcHzKASLRE+q9qYtozMG"
    "u2/2nloDyN+GBI3CqwcSrL4Te+ETtzneOq2IiFWMU5IT9Jo/GxCounJsqTSquCi/TQpG6mAjIKYcNb2bY8Wp5O3u8E1Ya1t0WJAoj1OIA/eZ6wSp"
    "xedgjZAQztNZVy49euaiKGU1gIQCYilKhQyvOCeW7zJMSessE1rpTfp3Ea3y5Rt/GQm30LZWeAf80b2CpCvakqM1V/LEtRVC1z/4G+HSNFgrApQq"
    "VcnhFIp1+JvLaKySYj9xTmP0C1L3CZ3vVKVBpa+ObuArYvKOukZ+8lh0QxYKyie8Ru8uzfr/gBBWhvXotYx0xusU10RxM46/BYJKFjhp2GH9ASyT"
    "1qhDnFWOnBvA8lyeEo4lLlkNuVxWXIBYCUF6y6M1rsfUZjRXqf8rzb9GuvbXnHLl+beRGc09gyNAaEI6zJjNHFuG9SVVqYRLyoRehg4gdDNp1tOi"
    "EP8zzK832JJgbKIi3SUCzktX3ypLwN1SIddE0yDHUPkOIcSwcKFwMDrsqgKuBwSeXFJGm+DhbRJ8KCE1MAV6oalYn4ZmCmTC/oldI1x2hJXmiKor"
    "F9kCTsYaMdLVHluos6DubCQgN66Lz3SiiKXRS9sCJlE2aYZKFgTX0q6SIsCvACCdSjhSvSMKTZMQuQSrybE6Y6dL834F8tUT61A0RlRF9KSqHHFl"
    "ZiZTxFdmw4jUSW0LxfhRHNKpkcZFDxBMyKjW2v8V2VxPHZRVoCO2+vnAuq41B6UKHHq7Umq/DUSgV689mPHKZabjTx8elnA4PBz2h1Pc7/e7/R7d"
    "I0gC6GmtmhFySt4j6oE2B5nJkeNxRkyXP5dPIR/QTNFY3IRkPXXtChKu/iC3W/In6HW1+IvcGPI5e8riZPVL7RieWImMLmMiXiGMM1DkSboZ9PJm"
    "zryl82w5teQTs5VSmulmvVwfk9U7KqKNRQmCUjNpkMCyLTcvdaWK6tlvPLU53ibxT3ELtnaTUcuNp13KKnWUzIyDBYxSP8CsoAAprVwF45X+P+4d"
    "3X+/3/+66fv/PwDVgfqu"
)
_COLORMAP_TABLES = np.cumsum(np.frombuffer(zlib.decompress(base64.b64decode("".join(_COLORMAPS))), np.uint8)
                             .reshape(22, 3, 256), axis=2, dtype=np.uint8).transpose(0, 2, 1).copy()  # (22, 256, 3)


def apply_color_map(gray: np.ndarray, colormap: int) -> np.ndarray:
    """`cv2.applyColorMap(gray, colormap)` for a (H, W) or (H, W, 1) uint8 image: (H, W, 3) BGR, each level its
    colormap's color."""
    gray = np.asarray(gray)
    if gray.ndim == 3 and gray.shape[2] == 1:
        gray = gray[..., 0]
    if gray.dtype != np.uint8 or gray.ndim != 2:
        raise ValueError(f"apply_color_map takes a one-channel uint8 image, got {gray.dtype} {gray.shape}")
    if not 0 <= int(colormap) < 22:
        raise ValueError(f"colormap {colormap}: OpenCV 5.0 has colormaps 0..21")
    return _COLORMAP_TABLES[int(colormap)][gray]

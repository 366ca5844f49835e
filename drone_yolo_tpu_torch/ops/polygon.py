"""Polygons to masks and masks to polygons without an image library: OpenCV's rasterizer and border follower in numpy.

The segment task of the JAX package draws label polygons with `cv2.fillPoly` (`drone_yolo_tpu/data/utils.py:
polygon2mask`, `data/augment.py:CopyPaste`) and reads mask outlines with `cv2.findContours` (`engine/results.py:
Masks.xy`). The port computes the same pixels and points:

- `fill_poly`: `cv2.fillPoly(img, polygons, color)` for integer vertices (shift 0, LINE_8), as OpenCV 5.0 draws
  it. Each edge is first drawn as an 8-connected Bresenham line (`cv::LineIterator`, clipped to the image, left to
  right); then the interior is filled from an edge table (`FillEdgeCollection`): per edge its top row y0, bottom
  row y1 (exclusive), x in 16.16 fixed point at y0 with a vertex at its pixel's centre, and dx = (x1 - x0) /
  (y1 - y0) truncated, an edge that leaves the image taking the x of its end points clipped to the image; on each
  row the active edges' x, sorted, fill in pairs the pixels whose centres lie between them;
- `find_contours`: `cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`: Suzuki and Abe's border
  following over the mask padded by a row and column of zeros, outer borders only, a contour started where the
  raster scan enters an object from outside every traced outer border, points kept where the chain turns,
  contours in OpenCV's order (the last found first);
- `contour_area`: `cv2.contourArea`, the shoelace formula in double.
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16  # OpenCV's drawing fixed point: x in 16.16
XY_ONE = 1 << XY_SHIFT
_DIRS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))  # chain codes: dx, dy (y down)


def _trunc_div(a: int, b: int) -> int:
    """C's integer division, which truncates toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(w: int, h: int, p1: list, p2: list) -> bool:
    """`cv::clipLine` of the segment p1-p2 ([x, y] lists, changed in place) to the (w, h) image: Cohen-Sutherland,
    each moved coordinate by a double product truncated toward zero. Returns whether a part lies inside."""
    right, bottom = w - 1, h - 1

    def code(x, y, full=True):
        return (x < 0) + (x > right) * 2 + ((y < 0) * 4 + (y > bottom) * 8 if full else 0)

    c1, c2 = code(*p1), code(*p2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            p1[0] += int((a - p1[1]) * (p2[0] - p1[0]) / (p2[1] - p1[1]))
            p1[1] = a
            c1 = code(p1[0], p1[1], full=False)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            p2[0] += int((a - p2[1]) * (p2[0] - p1[0]) / (p2[1] - p1[1]))
            p2[1] = a
            c2 = code(p2[0], p2[1], full=False)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                p1[1] += int((a - p1[0]) * (p2[1] - p1[1]) / (p2[0] - p1[0]))
                p1[0] = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                p2[1] += int((a - p2[0]) * (p2[1] - p1[1]) / (p2[0] - p1[0]))
                p2[0] = a
                c2 = 0
    return (c1 | c2) == 0


def line_pixels(w: int, h: int, p1, p2) -> tuple[np.ndarray, np.ndarray]:
    """(xs, ys) of the 8-connected line p1-p2 that `cv::LineIterator(img, p1, p2, 8, leftToRight=true)` visits:
    clipped to the (w, h) image, from the left end, the major axis stepping every pixel and the minor one while
    the error term err = dx - 2 dy (+ 2 dx per minor step, - 2 dy per step) is negative."""
    p1, p2 = [int(p1[0]), int(p1[1])], [int(p2[0]), int(p2[1])]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h) and not clip_line(w, h, p1, p2):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if p2[0] < p1[0]:
        p1, p2 = p2, p1
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = max(dx, dy), min(dx, dy)
    i = np.arange(major + 1, dtype=np.int64)
    # the minor axis has stepped m_i = ceil((2 minor i - major) / (2 major)) times before pixel i
    m = -((major - 2 * minor * i) // (2 * major)) if major else i
    if dx >= dy:
        return p1[0] + i, p1[1] + sy * m
    return p1[0] + m, p1[1] + sy * i


def _poly_edges(w: int, h: int, pts: list, lines: list) -> list:
    """`CollectPolyEdges` for one polygon of integer vertices (shift 0, LINE_8): appends each edge's line pixels to
    `lines` and returns its non-horizontal edges as (y0, y1, x, dx), x (at row y0) and dx in 16.16 fixed point with
    the vertex x at the pixel's centre (+ one half). An edge that leaves the image takes the x of its end points
    clipped to the image (`clip_line`), and their rows too unless clipping leaves both on one row."""
    edges = []
    for i in range(len(pts)):
        (x0, y0), (x1, y1) = pts[i - 1], pts[i]
        lines.append(line_pixels(w, h, (x0, y0), (x1, y1)))
        c0, c1 = [x0, y0], [x1, y1]
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
            t0, t1 = [x0, y0], [x1, y1]
            clip_line(w, h, t0, t1)
            c0[0], c1[0] = t0[0], t1[0]
            if t0[1] != t1[1]:
                c0[1], c1[1] = t0[1], t1[1]
        if y0 == y1:
            continue
        c0[0], c1[0] = (c0[0] << XY_SHIFT) + (XY_ONE >> 1), (c1[0] << XY_SHIFT) + (XY_ONE >> 1)
        dx = _trunc_div(c1[0] - c0[0], c1[1] - c0[1])
        if y0 > y1:
            (x0, y0), (x1, y1), c0 = (x1, y1), (x0, y0), c1
        edges.append((y0, y1, c0[0] + (y0 - c0[1]) * dx, dx))  # x moved from the clipped end's row to y0
    return edges


def fill_poly(img: np.ndarray, polygons, color: int = 1) -> np.ndarray:
    """`cv2.fillPoly(img, polygons, color)` in place on a 2-D uint8 image for integer vertices (each polygon (K, 2)
    x, y); returns `img`. The fill of a row covers the pixels whose centre lies between a pair of edges:
    ceil(x_a - 1/2) .. floor(x_b - 1/2)."""
    h, w = img.shape
    lines, edges = [], []
    for poly in polygons:
        pts = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
        if pts:
            edges += _poly_edges(w, h, pts, lines)
    for xs, ys in lines:
        img[ys, xs] = color
    if len(edges) < 2:
        return img
    e = np.array(edges, dtype=np.int64)  # (E, 4): y0, y1, x, dx
    y0, y1, x, dx = e.T
    x_end = x + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= h or max(x.max(), x_end.max()) < 0
            or min(x.min(), x_end.min()) >= (w << XY_SHIFT)):
        return img
    # every active edge's x on every drawn row: rows y0 .. y1 - 1 inside the image
    lo, hi = np.maximum(y0, 0), np.minimum(y1, h)
    n = np.maximum(hi - lo, 0)
    if n.sum() == 0:
        return img
    ei = np.repeat(np.arange(len(e)), n)
    rows = lo[ei] + (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n))
    xs = x[ei] + (rows - y0[ei]) * dx[ei]
    order = np.lexsort((xs, rows))
    rows, xs = rows[order], xs[order]
    half = XY_ONE >> 1
    ra, xa, xb = rows[0::2], (xs[0::2] + half - 1) >> XY_SHIFT, (xs[1::2] - half) >> XY_SHIFT  # each row's pairs
    keep = (xa < w) & (xb >= 0) & (xa <= xb)
    ra, xa, xb = ra[keep], np.maximum(xa[keep], 0), np.minimum(xb[keep], w - 1)
    if not len(ra):
        return img
    r0, c0 = ra.min(), xa.min()  # the spans' bounding box: +1 at each span's start, -1 after its end, summed
    bh, bw = ra.max() - r0 + 1, xb.max() - c0 + 2
    starts = np.bincount((ra - r0) * bw + xa - c0, minlength=bh * bw)
    ends = np.bincount((ra - r0) * bw + xb + 1 - c0, minlength=bh * bw)
    inside = np.cumsum((starts - ends).reshape(bh, bw), axis=1)[:, :-1] > 0
    img[r0:r0 + bh, c0:c0 + bw - 1][inside] = color
    return img


def _trace(img: np.ndarray, y: int, x: int) -> list:
    """Follow the outer border starting at (y, x) of the padded int8 image `img`, marking it as OpenCV's
    `icvFetchContour` does (2 for a border pixel, -126 for one whose right neighbour is background); returns the
    points where the chain code changes (CHAIN_APPROX_SIMPLE), in padded coordinates."""
    s = s_end = 4
    while True:
        s = (s - 1) & 7
        y1, x1 = y + _DIRS[s][1], x + _DIRS[s][0]
        if img[y1, x1] != 0 or s == s_end:
            break
    if s == s_end:  # a single pixel
        img[y, x] = -126
        return [(x, y)]
    pts = []
    y3, x3 = y, x
    prev_s = s ^ 4
    px, py = x, y
    while True:
        s_end = s
        while True:
            s += 1
            y4, x4 = y3 + _DIRS[s & 7][1], x3 + _DIRS[s & 7][0]
            if img[y4, x4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:  # the right neighbour was searched and is background
            img[y3, x3] = -126
        elif img[y3, x3] == 1:
            img[y3, x3] = 2
        if s != prev_s:
            pts.append((px, py))
            prev_s = s
        px, py = px + _DIRS[s][0], py + _DIRS[s][1]
        if (y4, x4) == (y, x) and (y3, x3) == (y1, x1):
            return pts
        y3, x3 = y4, x4
        s = (s + 4) & 7


def find_contours(mask: np.ndarray) -> list[np.ndarray]:
    """`cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0]`: the outer borders of the nonzero pixels of a
    2-D mask as (K, 1, 2) int32 arrays of x, y, in OpenCV's order."""
    nz = np.flatnonzero(np.asarray(mask).any(1))
    if not len(nz):
        return []
    r0, r1 = nz[0], nz[-1] + 1  # rows without an object start no contour: trace the band that holds them
    img = np.zeros((r1 - r0 + 2, mask.shape[1] + 2), np.int8)
    img[1:-1, 1:-1] = np.asarray(mask[r0:r1]) != 0
    found = []
    for y in range(1, img.shape[0] - 1):
        row = img[y]
        lnbd, prev, x = 0, 0, 1
        while x < img.shape[1] - 1:
            change = np.flatnonzero(row[x:-1] != prev)
            if not len(change):
                break
            x += int(change[0])
            p = int(row[x])
            if prev == 0 and p == 1 and row[lnbd] <= 0:  # an outer border outside every traced one
                pts = _trace(img, y, x)
                found.append(np.array([(px - 1, py - 1 + r0) for px, py in pts], np.int32).reshape(-1, 1, 2))
                prev = int(row[x])  # the scan resumes after the start pixel, now marked
            else:
                if p == 0 and prev >= 1 and prev & -2:  # a hole's start (not traced): its border pixel on the left
                    lnbd = x - 1
                prev = p
                if prev & -2:
                    lnbd = x
            x += 1
    return found[::-1]


def contour_area(contour: np.ndarray) -> float:
    """`cv2.contourArea(contour)`: |shoelace sum| / 2 in double over the closed polygon."""
    p = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(p) == 0:
        return 0.0
    q = np.roll(p, 1, axis=0)
    return abs(float(np.sum(q[:, 0] * p[:, 1] - q[:, 1] * p[:, 0]))) * 0.5

"""Rotated boxes without an image library: corners, canonical angles, and OpenCV's `minAreaRect` in numpy.

Counterpart of `drone_yolo_tpu/ops/convert.py` (`xywhr2xyxyxyxy`, `regularize_rboxes`, `xyxyxyxy2xywhr`) and of the
`cv2.minAreaRect` calls of the JAX package's OBB task (`drone_yolo_tpu/models/yolo/obb.py:_rboxes_from_segments`,
the training targets and the validation GT). A rotated box is (cx, cy, w, h, angle), the angle in radians.

`min_area_rect` is `cv2.minAreaRect` for float32 points as OpenCV 5.0 computes it, so that a polygon label gives the
same (w, h, angle) branch as in the JAX package: the v8 OBB loss takes its DFL target from the unrotated w and h,
which a swap would change. It is

- `convex_hull`: `cv2.convexHull(points, clockwise=False)`: the points sorted by x (then y), Sklansky's scan of the
  upper and lower chains with float32 differences and a double cross product, the mirrored-chain rule for points on
  one line, and the cyclic shift that makes the hull's input indices ascend or descend;
- the rotating calipers over the hull (`rotatingCalipers`, CALIPERS_MINAREARECT), in float32 as OpenCV computes
  them, except the cosine that picks the next caliper edge, which is taken in double (OpenCV 5.0 settles near-ties
  between parallel edges that way); the last rectangle of least area wins, and its corner, width and height
  vectors give centre and size;
- the angle of the width vector in degrees, in double, brought into [-90, 0) by steps of 90 that swap w and h
  (an axis-aligned rectangle reads -90; OpenCV 4.5-4.x reported (0, 90]).

The result equals the installed OpenCV bit for bit on general polygons and within a float32 ulp or two, on the same
branch, for rectangles at exact angles, clipped and integer points; point sets that are collinear only within
float rounding (their hull has no area) may give another hull than OpenCV's.
"""

from __future__ import annotations

import math

import numpy as np

_F = np.float32


def _sign(v) -> int:
    return int(v > 0) - int(v < 0)


def _sklansky(px, py, start: int, end: int, nsign: int, sign2: int) -> list[int]:
    """One chain of OpenCV's `Sklansky_` over x-sorted points (px, py: float32 lists) from `start` toward `end`:
    the stack of sorted positions, its last entry dropped, as OpenCV returns it."""
    incr = 1 if end > start else -1
    if start == end or (px[start] == px[end] and py[start] == py[end]):
        return [start]
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    stack = [pprev, pcur, pnext] + [0] * len(px)
    size = 3
    end += incr
    while pnext != end:
        by = py[pnext] - py[pcur]
        if _sign(by) != nsign:
            ax = px[pcur] - px[pprev]
            bx = px[pnext] - px[pcur]
            ay = py[pcur] - py[pprev]
            convexity = float(ay) * float(bx) - float(ax) * float(by)
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack[size] = pnext
                size += 1
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[size - 2] = pnext
                pcur = pprev
                pprev = stack[size - 4]
                size -= 1
        else:
            pnext += incr
            stack[size - 1] = pnext
    return stack[: size - 1]


def convex_hull(points) -> np.ndarray:
    """`cv2.convexHull(points, clockwise=False, returnPoints=True)` of (N, 2) float32 points -> (n, 2) float32."""
    pts = np.asarray(points, np.float32).reshape(-1, 2)
    total = len(pts)
    if total == 0:
        return pts
    order = sorted(range(total), key=lambda i: (pts[i, 0], pts[i, 1]))
    px = [_F(pts[i, 0]) for i in order]
    py = [_F(pts[i, 1]) for i in order]
    miny = maxy = 0
    for i in range(1, total):
        if py[miny] > py[i]:
            miny = i
        if py[maxy] < py[i]:
            maxy = i
    if px[0] == px[-1] and py[0] == py[-1]:
        return pts[[order[0]]]
    # upper chain, then lower chain, counter-clockwise (clockwise=False swaps the upper stacks)
    tr = _sklansky(px, py, 0, maxy, -1, 1)
    tl = _sklansky(px, py, total - 1, maxy, -1, -1)
    hull = [order[i] for i in tl[:-1]] + [order[tr[i]] for i in range(len(tr) - 1, 0, -1)]
    stop = tr[1] if len(tr) > 2 else (tl[-2] if len(tl) > 2 else -1)
    bl = _sklansky(px, py, 0, miny, 1, -1)
    br = _sklansky(px, py, total - 1, miny, 1, 1)
    nbl, nbr = len(bl), len(br)
    if stop >= 0:
        check = bl[1] if nbl > 2 else (br[2 - nbl] if nbl + nbr > 2 else -1)
        if check == stop or (check >= 0 and px[check] == px[stop] and py[check] == py[stop]):
            nbl, nbr = min(nbl, 2), min(nbr, 2)  # all points on one line: the lower chain mirrors the upper
    hull += [order[bl[i]] for i in range(nbl - 1)] + [order[br[i]] for i in range(nbr - 1, 0, -1)]
    return pts[_cyclic_shift(hull)]


def _cyclic_shift(hull: list[int]) -> list[int]:
    """OpenCV's rotation of the hull so that its input indices ascend or descend, where a rotation can do that."""
    n = len(hull)
    if n < 3:
        return hull
    min_i = max_i = lt = 0
    for i in range(1, n):
        idx = hull[i]
        lt += hull[i - 1] < idx
        if 1 < lt <= i - 2:
            break
        if idx < hull[min_i]:
            min_i = i
        if idx > hull[max_i]:
            max_i = i
    if abs(max_i - min_i) not in (1, n - 1) or not (lt <= 1 or lt >= n - 2):
        return hull
    ascending = (max_i + 1) % n == min_i
    i0 = min_i if ascending else max_i
    if i0 == 0:
        return hull
    out = hull[i0:] + hull[:i0]
    if all(ascending == (out[i] < out[i + 1]) for i in range(n - 1)):
        return out
    return hull


def _rotating_calipers(hx, hy):
    """OpenCV's `rotatingCalipers(CALIPERS_MINAREARECT)` over n > 2 hull points (float32 lists) -> the rectangle's
    corner (x, y), width vector and height vector, float32. A repeated hull point (a zero-length edge) divides by
    zero as OpenCV's float arithmetic does, to inf or nan, and raises nothing."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return _calipers(hx, hy)


def _calipers(hx, hy):
    n = len(hx)
    vx, vy, inv, length = [], [], [], []
    left = bottom = right = top = 0
    left_x = right_x = hx[0]
    top_y = bottom_y = hy[0]
    for i in range(n):
        if hx[i] < left_x:
            left_x, left = hx[i], i
        if hx[i] > right_x:
            right_x, right = hx[i], i
        if hy[i] > top_y:
            top_y, top = hy[i], i
        if hy[i] < bottom_y:
            bottom_y, bottom = hy[i], i
        j = (i + 1) % n
        dx, dy = float(hx[j] - hx[i]), float(hy[j] - hy[i])  # float32 differences
        vx.append(_F(dx))
        vy.append(_F(dy))
        inv.append(_F(np.float64(1.0) / math.sqrt(dx * dx + dy * dy)))
        length.append(np.float64(math.hypot(dx, dy)))
    orientation = 0.0
    ax, ay = float(vx[-1]), float(vy[-1])
    for i in range(n):
        cross = ax * float(vy[i]) - ay * float(vx[i])
        if cross != 0:
            orientation = 1.0 if cross > 0 else -1.0
            break
        ax, ay = float(vx[i]), float(vy[i])
    base_a, base_b = _F(orientation), _F(0.0)
    seq = [bottom, right, top, left]
    min_area, best = None, None
    for _ in range(n):
        a, b = float(base_a), float(base_b)
        x, y = [float(vx[q]) for q in seq], [float(vy[q]) for q in seq]
        cosines = ((a * x[0] + b * y[0]) / length[seq[0]], (-b * x[1] + a * y[1]) / length[seq[1]],
                   (-a * x[2] - b * y[2]) / length[seq[2]], (b * x[3] - a * y[3]) / length[seq[3]])
        main = 0
        for i in range(1, 4):
            if cosines[i] > cosines[main]:
                main = i
        q = seq[main]
        lead_x, lead_y = vx[q] * inv[q], vy[q] * inv[q]
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x), (-lead_x, -lead_y), (-lead_y, lead_x))[main]
        seq[main] = (q + 1) % n
        width = (hx[seq[1]] - hx[seq[3]]) * base_a + (hy[seq[1]] - hy[seq[3]]) * base_b
        height = -(hx[seq[2]] - hx[seq[0]]) * base_b + (hy[seq[2]] - hy[seq[0]]) * base_a
        area = width * height
        if min_area is None or area <= min_area:
            min_area, best = area, (seq[3], base_a, width, base_b, height, seq[0])
    i0, a1, w, b1, h, i5 = best
    a2, b2 = -b1, a1
    c1 = a1 * hx[i0] + hy[i0] * b1
    c2 = a2 * hx[i5] + hy[i5] * b2
    idet = _F(1.0) / (a1 * b2 - a2 * b1)
    corner = ((c1 * b2 - c2 * b1) * idet, (a1 * c2 - a2 * c1) * idet)
    return corner, (a1 * w, b1 * w), (a2 * h, b2 * h)


def min_area_rect(points) -> tuple[tuple[float, float], tuple[float, float], float]:
    """`cv2.minAreaRect(points)` of (N, 2) points taken as float32 -> ((cx, cy), (w, h), angle in degrees, in
    [-90, 0)), as OpenCV 5.0 returns it."""
    hull = convex_hull(points)
    n = len(hull)
    cx = cy = w = h = _F(0.0)
    ang = 0.0
    if n > 2:
        corner, vw, vh = _rotating_calipers([_F(v) for v in hull[:, 0]], [_F(v) for v in hull[:, 1]])
        half = _F(0.5)
        cx = corner[0] + (vw[0] + vh[0]) * half
        cy = corner[1] + (vw[1] + vh[1]) * half
        w = _F(math.sqrt(float(vw[0]) ** 2 + float(vw[1]) ** 2))
        h = _F(math.sqrt(float(vh[0]) ** 2 + float(vh[1]) ** 2))
        ang = math.atan2(float(vw[1]), float(vw[0]))
    elif n == 2:
        (x0, y0), (x1, y1) = (_F(v) for v in hull[0]), (_F(v) for v in hull[1])
        cx, cy = (x0 + x1) * _F(0.5), (y0 + y1) * _F(0.5)
        dx, dy = float(x1 - x0), float(y1 - y0)
        w = _F(math.sqrt(dx * dx + dy * dy))
        ang = math.atan2(dy, dx)
    elif n == 1:
        cx, cy = _F(hull[0, 0]), _F(hull[0, 1])
    deg = ang * 180 / math.pi
    while deg >= 0:
        deg, w, h = deg - 90, h, w
    while deg < -90:
        deg, w, h = deg + 90, h, w
    return (float(cx), float(cy)), (float(w), float(h)), float(_F(deg))


def xyxyxyxy2xywhr(x) -> np.ndarray:
    """(n, 8) or (n, 4, 2) corner boxes -> (n, 5) float32 xywhr by `min_area_rect`, the angle in radians as
    `angle / 180 * pi` (`drone_yolo_tpu/ops/convert.py:xyxyxyxy2xywhr`)."""
    points = np.asarray(x, np.float32).reshape(len(x), -1, 2)
    out = []
    for pts in points:
        (cx, cy), (w, h), angle = min_area_rect(pts)
        out.append([cx, cy, w, h, angle / 180 * np.pi])
    return np.asarray(out, np.float32).reshape(-1, 5)


def xywhr2xyxyxyxy(x) -> np.ndarray:
    """(..., 5) xywhr -> (..., 4, 2) float32 corners: centre + w/2 (cos, sin) + h/2 (-sin, cos), then +-, --, -+."""
    x = np.asarray(x, np.float32)
    ctr = x[..., :2]
    w, h, angle = (x[..., i : i + 1] for i in range(2, 5))
    cos_v, sin_v = np.cos(angle), np.sin(angle)
    vec1 = np.concatenate([w / 2 * cos_v, w / 2 * sin_v], -1)
    vec2 = np.concatenate([-h / 2 * sin_v, h / 2 * cos_v], -1)
    return np.stack([ctr + vec1 + vec2, ctr + vec1 - vec2, ctr - vec1 - vec2, ctr - vec1 + vec2], axis=-2)


def regularize_rboxes(rboxes) -> np.ndarray:
    """xywhr boxes with the angle brought into [0, pi/2), w and h swapped where the angle mod pi is at least pi/2."""
    rboxes = np.asarray(rboxes, np.float32)
    x, y, w, h, t = (rboxes[..., i] for i in range(5))
    swap = (t % math.pi) >= (math.pi / 2)
    return np.stack([x, y, np.where(swap, h, w), np.where(swap, w, h), t % (math.pi / 2)], axis=-1)

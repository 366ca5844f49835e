"""Sparse optical flow in tensor operations on the frame's device: OpenCV's corner detector, pyramidal Lucas-Kanade
tracker and RANSAC similarity fit, as the JAX package's camera-motion compensation calls them through cv2
(`drone_yolo_tpu/trackers/gmc.py:_apply_sparse_optflow`).

- `corner_min_eigen_val`: `cv2.cornerMinEigenVal(gray, 3, 3)`: Sobel derivatives in float32 scaled by
  1 / (4 * 3 * 255), with the fused multiply-adds of OpenCV's AVX2 filters and the plain sums of their scalar tails;
  unnormalized 3x3 box sums of dx^2, dx*dy, dy^2 (exact, rounded to float32 once); the smaller eigenvalue.
  REFLECT_101 borders.
- `good_features_to_track`: `cv2.goodFeaturesToTrack(gray, 1000, 0.01, 1, blockSize=3)`: values at most
  0.01 x max set to 0, local maxima of a 3x3 max filter that are not 0, the 1-pixel border left out, the
  strongest 1000 first, ties by the later pixel in row-major order first. At minDistance 1 OpenCV's distance
  test rejects no point, so nothing else is needed.
- `build_pyramid`, `calc_optical_flow_pyr_lk`: `cv2.calcOpticalFlowPyrLK(prev, next, pts, None)` at its defaults
  (winSize 21x21, maxLevel 3, 30 iterations or a step under 0.01 px, minEigThreshold 1e-4): levels by pyrDown,
  each padded by the window with REFLECT_101; Scharr derivatives in integers, padded with zeros; bilinear
  window samples with 14-bit fixed-point weights; window sums exact, scaled by 2**-20 in float32; OpenCV's
  minimum-eigenvalue test, its stop on a small step and its half step when a step undoes the last one. All points
  run at once; a point that has stopped keeps its position while the others iterate. On a CUDA device the whole
  tracker replays as a CUDA graph (`FlowGraphs`): its ~8,000 small launches a 1080p frame cost no host dispatch.
- `estimate_affine_partial_2d`: `cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)` at its defaults
  (3 px, 2000 iterations, confidence 0.99, refinement on): the 2-point subsets that OpenCV's `RNG((uint64)-1)`
  draws, the models and inlier counts of all of them at once on the device, OpenCV's adaptive iteration count
  replayed over the counts on the host, then the least-squares similarity on the best model's inliers (the
  Levenberg-Marquardt refinement that OpenCV runs converges to it: the model is linear in its parameters).

OpenCV accumulates the tracker's window sums in float32: the port copies the order of its SSE code for the
gradient matrix (once a level) and sums the per-iteration mismatch vector exactly, rounding once.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from drone_yolo_tpu_torch.ops.image import _fma  # a * b + c rounded once: exact in float64 for these operands

WIN = 21  # calcOpticalFlowPyrLK's winSize
HALF_WIN = (WIN - 1) * 0.5
MAX_LEVEL = 3
LK_ITERS, LK_EPS, MIN_EIG = 30, 0.01, 1e-4
W_BITS = 14  # the tracker's bilinear weights, in 2**-14
FLT_EPSILON = float(np.finfo(np.float32).eps)
SIMD_COLS = 32  # columns per iteration of OpenCV's AVX2 row filter; the rest take its scalar loop
RANSAC_THRESHOLD, RANSAC_ITERS, RANSAC_CONFIDENCE = 3.0, 2000, 0.99
RNG_COEFF = 4164903690  # cv::RNG's multiply-with-carry multiplier


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (the CPU's vectorized float32 sqrt is not; float64's is)."""
    return torch.sqrt(x.double()).float()


def _reflect101(i: torch.Tensor, n: int) -> torch.Tensor:
    """OpenCV's BORDER_REFLECT_101 index of `i` in a length-n axis (any number of reflections)."""
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _pad_reflect101(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the last two axes by `pad` on each side with REFLECT_101."""
    h, w = x.shape[-2:]
    rows = _reflect101(torch.arange(-pad, h + pad, device=x.device), h)
    cols = _reflect101(torch.arange(-pad, w + pad, device=x.device), w)
    return x[..., rows[:, None], cols[None, :]]


def corner_min_eigen_val(gray: torch.Tensor) -> torch.Tensor:
    """(H, W) uint8 -> (H, W) float32: cv2.cornerMinEigenVal(gray, blockSize=3, ksize=3)."""
    if gray.dtype != torch.uint8 or gray.dim() != 2:
        raise ValueError(f"expected a uint8 (H, W) image, got {gray.dtype} {tuple(gray.shape)}")
    h, w = gray.shape
    k1 = torch.tensor(1.0 / (4 * 3 * 255), dtype=torch.float32).item()  # the smoothing taps [k1, 2 k1, k1]
    k0 = 2 * k1
    p = _pad_reflect101(gray.float(), 1)
    body = (w // SIMD_COLS) * SIMD_COLS

    # dx: the row difference (exact), then the column smoothing fma(S0 + S2, k1, S1 * k0)
    r = p[:, 2:] - p[:, :-2]
    dx = _fma(r[:-2] + r[2:], k1, r[1:-1] * k0)
    # dy: the row smoothing, k1*c0 then fused k0*c1 and k1*c2 (the scalar tail: plain left-to-right sums), then
    # the column difference
    c0, c1, c2 = p[:, :-2], p[:, 1:-1], p[:, 2:]
    t0 = c0 * k1
    vec = _fma(c2, k1, _fma(c1, k0, t0))
    tail = (t0 + c1 * k0) + c2 * k1
    rows = torch.cat([vec[:, :body], tail[:, body:]], 1)
    dy = rows[2:] - rows[:-2]

    cov = torch.stack([dx * dx, dx * dy, dy * dy]).double()
    cov = _pad_reflect101(cov, 1)
    box = sum(cov[:, i : i + h, j : j + w] for i in range(3) for j in range(3)).float()
    a, b, c = box[0] * 0.5, box[1], box[2] * 0.5
    t = a - c
    return (a + c) - _sqrt(b * b + t * t)


def good_features_to_track(gray: torch.Tensor, max_corners: int = 1000, quality_level: float = 0.01):
    """(H, W) uint8 -> (N, 1, 2) float32 corners (x, y), strongest first, or None where no pixel qualifies:
    cv2.goodFeaturesToTrack(gray, max_corners, quality_level, minDistance=1, blockSize=3)."""
    eig = corner_min_eigen_val(gray)
    thr = torch.tensor(eig.max().double().item() * quality_level, dtype=torch.float32, device=eig.device)
    eig = torch.where(eig > thr, eig, torch.zeros_like(eig))
    dil = torch.nn.functional.max_pool2d(eig[None, None], 3, stride=1, padding=1)[0, 0]
    peak = (eig != 0) & (eig == dil)
    peak[0, :] = peak[-1, :] = False
    peak[:, 0] = peak[:, -1] = False
    idx = peak.flatten().nonzero()[:, 0].flip(0)  # later pixels first: the stable sort keeps them first on ties
    vals = eig.flatten()[idx]
    order = torch.sort(vals, descending=True, stable=True).indices[:max_corners]
    if len(order) == 0:
        return None
    sel = idx[order]
    w = gray.shape[1]
    return torch.stack([sel % w, sel // w], 1).float()[:, None, :]


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """(H, W) integer image -> ((H + 1) // 2, (W + 1) // 2): cv2.pyrDown, the 5x5 binomial kernel with REFLECT_101,
    (sum + 128) >> 8."""
    h, w = img.shape
    k = (1, 4, 6, 4, 1)
    dev = img.device
    taps = torch.arange(-2, 3, device=dev)[:, None]
    cols = _reflect101(2 * torch.arange((w + 1) // 2, device=dev)[None, :] + taps, w)
    rows = _reflect101(2 * torch.arange((h + 1) // 2, device=dev)[None, :] + taps, h)
    x = img.int()
    r = sum(k[i] * x[:, cols[i]] for i in range(5))
    return (sum(k[i] * r[rows[i]] for i in range(5)) + 128) >> 8


def scharr_deriv(img: torch.Tensor) -> torch.Tensor:
    """(H, W) integer image -> (2, H, W) int32 (Ix, Iy): OpenCV's calcSharrDeriv of the tracker (3, 10, 3 smoothing,
    a central difference, REFLECT_101)."""
    p = _pad_reflect101(img.int(), 1)
    t0 = (p[:-2] + p[2:]) * 3 + p[1:-1] * 10  # vertical smoothing
    t1 = p[2:] - p[:-2]  # vertical difference
    ix = t0[:, 2:] - t0[:, :-2]
    iy = (t1[:, 2:] + t1[:, :-2]) * 3 + t1[:, 1:-1] * 10
    return torch.stack([ix, iy])


def build_pyramid(gray: torch.Tensor, max_level: int = MAX_LEVEL) -> list[torch.Tensor]:
    """cv2.buildOpticalFlowPyramid(gray, (21, 21), max_level): int32 levels, each padded by the window (21 px) with
    REFLECT_101; fewer levels where the next one would be at most 21 px on a side."""
    levels, img = [], gray.int()
    for level in range(max_level + 1):
        if level:
            img = pyr_down(img)
        levels.append(_pad_reflect101(img, WIN))
        h, w = img.shape
        if (w + 1) // 2 <= WIN or (h + 1) // 2 <= WIN:
            break
    return levels


def _window(padded: torch.Tensor, ip: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The (WIN + 1) x (WIN + 1) patches of `padded` (..., Hp, Wp) whose top-left pixels are `ip` (N, 2) (x, y) in
    unpadded coordinates, clamped into the padding: (..., N, WIN + 1, WIN + 1)."""
    ar = torch.arange(WIN + 1, device=ip.device)
    x = ip[:, 0].clamp(-WIN, cols - 1) + WIN
    y = ip[:, 1].clamp(-WIN, rows - 1) + WIN
    wp = padded.shape[-1]
    flat = ((y * wp + x)[:, None, None] + (ar[:, None] * wp + ar)).flatten()
    return padded.flatten(-2)[..., flat].unflatten(-1, (len(ip), WIN + 1, WIN + 1))


def _bilinear(pt: torch.Tensor):
    """(N, 2) float32 window corners -> their floors (N, 2) int64 and the 14-bit weights (N, 4) int32 of the taps
    (0, 0), (1, 0), (0, 1), (1, 1): round((1 - a)(1 - b) 2**14), round(a (1 - b) 2**14), round((1 - a) b 2**14) in
    float32, and the rest of 2**14."""
    ip = torch.floor(pt)
    frac = pt - ip
    f = torch.stack([1.0 - frac, frac], -1)  # (N, x|y, 1 - f|f)
    w = torch.round((f[:, 1, :, None] * f[:, 0, None, :]).flatten(1) * float(1 << W_BITS)).int()
    w[:, 3] = (1 << W_BITS) - w[:, :3].sum(1, dtype=torch.int32)
    return ip.long(), w


def _inside(ip: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Window corners from which the tracker may read: within the window's padding of the image."""
    return (ip[:, 0] >= -WIN) & (ip[:, 0] < cols) & (ip[:, 1] >= -WIN) & (ip[:, 1] < rows)


def _interp(patch: torch.Tensor, w: torch.Tensor, shift: int) -> torch.Tensor:
    """Bilinear samples of (..., N, 22, 22) integer patches at the WIN x WIN window: CV_DESCALE(sum, shift)."""
    taps = torch.stack([patch[..., :-1, :-1], patch[..., :-1, 1:], patch[..., 1:, :-1], patch[..., 1:, 1:]], -3)
    s = (taps * w[:, :, None, None]).sum(-3, dtype=torch.int32)
    return (s + (1 << (shift - 1))) >> shift


def _sum_scaled_sse(x: torch.Tensor) -> torch.Tensor:
    """Window sums of integer products (..., WIN, WIN) in float32 in OpenCV's order, scaled by 2**-20: columns 0-15 in
    four vector lanes (lane k takes the columns k, k + 4, k + 8, k + 12 of each row in turn), columns 16-20 in a
    scalar sum, row by row; then the scalar sum + ((lane 0 + lane 2) + (lane 1 + lane 3))."""
    x = x.float()
    lanes = x[..., :16].unflatten(-1, (4, 4))  # (..., row, group, lane)
    steps = torch.cat([torch.nn.functional.pad(lanes, (0, 0, 0, 1)), x[..., 16:, None]], -1)  # (..., row, 5, 5)
    steps = steps.flatten(-3, -2)  # (..., 105 steps, 4 lanes + the scalar sum)
    acc = torch.zeros_like(steps[..., 0, :])
    for i in range(steps.shape[-2]):
        acc = acc + steps[..., i, :]
    return (acc[..., 4] + ((acc[..., 0] + acc[..., 2]) + (acc[..., 1] + acc[..., 3]))) * float(2.0 ** -20)


def _lk_step(st: dict, J: torch.Tensor, rows: int, cols: int, level0: bool, first: bool) -> None:
    """One Lucas-Kanade iteration of the points in `st` (per-point tensors, updated in place of the dict); a point
    that has stopped (`active` False) keeps its position."""
    ip, w = _bilinear(st["pt"])
    inside = _inside(ip, rows, cols)
    if level0:
        st["status"] = st["status"] & ~(st["active"] & ~inside)
    active = st["active"] & inside
    jv = _interp(_window(J, ip, rows, cols), w, W_BITS - 5).flatten(1)
    b = ((jv - st["ival"])[:, None, :] * st["dxy"]).sum(-1).float() * float(2.0 ** -20)  # (b1, b2), exact sums
    delta = (st["p"] * b.flip(1) - st["q"] * b) * st["inv"]  # (a12 b2 - a22 b1, a12 b1 - a11 b2) / det
    new = st["pt"] + delta
    act = active[:, None]
    st["pt"] = torch.where(act, new, st["pt"])
    dd = delta.double()
    small = (dd * dd).sum(1) <= LK_EPS * LK_EPS
    undo = (((delta + st["prev"]).abs().double() < LK_EPS).all(1) & ~small) if not first else torch.zeros_like(small)
    moved = new + HALF_WIN
    st["nxt"] = torch.where(act, torch.where(undo[:, None], moved - delta * 0.5, moved), st["nxt"])
    st["active"] = active & ~(small | undo)
    st["prev"] = delta


def calc_optical_flow_pyr_lk(prev_gray: torch.Tensor, next_gray: torch.Tensor, prev_pts: torch.Tensor,
                             max_level: int = MAX_LEVEL, graphs: FlowGraphs | None = None):
    """Track (N, 1, 2) float32 points from one uint8 (H, W) frame to the next: (next_pts (N, 1, 2) float32,
    status (N, 1) uint8), as cv2.calcOpticalFlowPyrLK(prev_gray, next_gray, prev_pts, None, maxLevel=max_level)
    at its other defaults.

    On a CUDA device every point runs the 30 iterations of each level, a stopped one unchanged, with no host sync,
    through `graphs` where given; on the CPU the points that still iterate are gathered after each iteration, and a
    level ends when none does."""
    if graphs is not None and prev_pts.is_cuda:
        return graphs.run(prev_gray, next_gray, prev_pts, max_level)
    return _track(prev_gray, next_gray, prev_pts, max_level)


class FlowGraphs:
    """The tracker on a CUDA device as CUDA graphs, one per frame shape and point-count bucket (a power of two, 64 at
    least; the points padded at (0, 0)), captured at its first call and replayed after: the ~8,000 small launches of
    a 1080p frame's flow then cost no host dispatch each. The graphs' memory lives as long as the object."""

    def __init__(self):
        self.graphs = {}

    def run(self, prev_gray: torch.Tensor, next_gray: torch.Tensor, prev_pts: torch.Tensor, max_level: int):
        pts = prev_pts.reshape(-1, 1, 2).float()
        n, dev = len(pts), pts.device
        bucket = max(64, 1 << (n - 1).bit_length())
        key = (tuple(prev_gray.shape), bucket, max_level)
        if key not in self.graphs:
            static = (prev_gray.clone(), next_gray.clone(), torch.zeros((bucket, 1, 2), device=dev))
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                _track(*static, max_level)  # warm-up, as CUDA graph capture asks
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = _track(*static, max_level)
            self.graphs[key] = (graph, static, out)
        graph, static, out = self.graphs[key]
        static[0].copy_(prev_gray)
        static[1].copy_(next_gray)
        static[2].zero_()
        static[2][:n] = pts
        graph.replay()
        return out[0][:n].clone(), out[1][:n].clone()


def _track(prev_gray: torch.Tensor, next_gray: torch.Tensor, prev_pts: torch.Tensor, max_level: int):
    prev_pyr, next_pyr = build_pyramid(prev_gray, max_level), build_pyramid(next_gray, max_level)
    pts = prev_pts.reshape(-1, 2).float()
    n, dev = len(pts), pts.device
    compact = not pts.is_cuda
    status = torch.ones(n, dtype=torch.bool, device=dev)
    nxt = pts
    for level in range(len(prev_pyr) - 1, -1, -1):
        I, J = prev_pyr[level], next_pyr[level]
        rows, cols = I.shape[0] - 2 * WIN, I.shape[1] - 2 * WIN
        deriv = torch.nn.functional.pad(scharr_deriv(I[WIN:-WIN, WIN:-WIN]), (WIN, WIN, WIN, WIN))
        prev_pt = pts * float(1.0 / (1 << level))
        nxt = prev_pt if level == len(prev_pyr) - 1 else nxt * 2.0
        ip, w = _bilinear(prev_pt - HALF_WIN)
        ival = _interp(_window(I, ip, rows, cols), w, W_BITS - 5)
        d = _interp(_window(deriv, ip, rows, cols), w, W_BITS)  # (2, N, WIN, WIN): Ix, Iy
        a11, a12, a22 = _sum_scaled_sse(torch.stack([d[0] * d[0], d[0] * d[1], d[1] * d[1]]))
        det = a11 * a22 - a12 * a12
        t = a11 - a22
        min_eig = ((a22 + a11) - _sqrt(t * t + (4.0 * a12) * a12)) / float(2 * WIN * WIN)
        ok = _inside(ip, rows, cols) & (min_eig >= MIN_EIG) & (det >= FLT_EPSILON)
        if level == 0:
            status = status & ok
        st = {"pt": nxt - HALF_WIN, "prev": torch.zeros_like(nxt), "active": ok, "status": status, "nxt": nxt,
              "ival": ival.flatten(1), "dxy": d.flatten(2).transpose(0, 1), "p": torch.stack([a12, a12], 1),
              "q": torch.stack([a22, a11], 1), "inv": (1.0 / torch.where(ok, det, torch.ones_like(det)))[:, None]}
        nxt, status = nxt.clone(), status.clone()
        rows_of = torch.arange(n, device=dev)  # the rows of `st` in the full arrays
        for j in range(LK_ITERS):
            if compact:  # write the rows back, keep those still iterating
                nxt[rows_of], status[rows_of] = st["nxt"], st["status"]
                live = st["active"].nonzero()[:, 0]
                if len(live) == 0:
                    break
                st, rows_of = {k: v[live] for k, v in st.items()}, rows_of[live]
            _lk_step(st, J, rows, cols, level == 0, j == 0)
        nxt[rows_of], status[rows_of] = st["nxt"], st["status"]
    return nxt[:, None, :], status.to(torch.uint8)[:, None]


class _MWC:
    """cv::RNG: a 64-bit multiply-with-carry generator; `uniform(0, n)` is next() % n."""

    def __init__(self, state: int = 2**64 - 1):
        self.state = state

    def next(self) -> int:
        self.state = ((self.state & 0xFFFFFFFF) * RNG_COEFF + (self.state >> 32)) & 0xFFFFFFFFFFFFFFFF
        return self.state & 0xFFFFFFFF


@functools.lru_cache(maxsize=8)
def ransac_subsets(count: int, iters: int = RANSAC_ITERS) -> np.ndarray:
    """(iters, 2) indices of the 2-point subsets that OpenCV's RANSAC draws from `count` points, in order: RNG seeded
    with (uint64)-1, each index redrawn while it repeats the first. (OpenCV's subset check rejects no pair.)"""
    rng, out = _MWC(), np.empty((iters, 2), np.int64)
    for it in range(iters):
        i0 = rng.next() % count
        i1 = rng.next() % count
        while i1 == i0:
            i1 = rng.next() % count
        out[it] = i0, i1
    return out


def _update_iters(p: float, ep: float, model_points: int, max_iters: int) -> int:
    """OpenCV's RANSACUpdateNumIters."""
    p, ep = min(max(p, 0.0), 1.0), min(max(ep, 0.0), 1.0)
    num = max(1.0 - p, 2.2250738585072014e-308)
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < 2.2250738585072014e-308:
        return 0
    num, denom = math.log(num), math.log(denom)
    return max_iters if denom >= 0 or -num >= max_iters * (-denom) else round(num / denom)


def ransac_best(counts: list[int], n: int) -> int:
    """OpenCV's RANSAC loop over the inlier counts of its subsets, in order: the first subset whose count beats the
    best so far (and 1) is the best, and each new best cuts the iteration count (`_update_iters`). Returns its
    index, or -1 where none has 2 inliers."""
    best_it, max_good, niters, it = -1, 0, min(RANSAC_ITERS, len(counts)), 0
    while it < niters:
        if counts[it] > max(max_good, 1):
            best_it, max_good = it, counts[it]
            niters = _update_iters(RANSAC_CONFIDENCE, (n - max_good) / n, 2, niters)
        it += 1
    return best_it


def _two_point_models(s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(M, 2, 2) source and destination point pairs (float64) -> (M, 4) similarity (a, b, tx, ty), as OpenCV's
    AffinePartial2DEstimatorCallback::runKernel solves them."""
    x1, y1, x2, y2 = s[:, 0, 0], s[:, 0, 1], s[:, 1, 0], s[:, 1, 1]
    X1, Y1, X2, Y2 = d[:, 0, 0], d[:, 0, 1], d[:, 1, 0], d[:, 1, 1]
    inv = 1.0 / ((x1 - x2) * (x1 - x2) + (y1 - y2) * (y1 - y2))
    s0 = inv * ((X1 - X2) * (x1 - x2) + (Y1 - Y2) * (y1 - y2))
    s1 = inv * ((Y1 - Y2) * (x1 - x2) - (X1 - X2) * (y1 - y2))
    s2 = inv * ((Y1 - Y2) * (x1 * y2 - x2 * y1) - (X1 * y2 - X2 * y1) * (y1 - y2) - (X1 * x2 - X2 * x1) * (x1 - x2))
    s3 = inv * (-(X1 - X2) * (x1 * y2 - x2 * y1) - (Y1 * x2 - Y2 * x1) * (x1 - x2) - (Y1 * y2 - Y2 * y1) * (y1 - y2))
    return torch.stack([s0, s1, s2, s3], 1)


def _inliers(models: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(M, N) bool: squared reprojection error within the threshold, in float32 as OpenCV's computeError."""
    f = models.float()
    a, b, tx, ty = (f[:, i, None] for i in range(4))
    x, y, X, Y = src[None, :, 0], src[None, :, 1], dst[None, :, 0], dst[None, :, 1]
    ex = ((a * x + (-b) * y) + tx) - X
    ey = ((b * x + a * y) + ty) - Y
    return ex * ex + ey * ey <= float(RANSAC_THRESHOLD * RANSAC_THRESHOLD)


def estimate_affine_partial_2d(src_pts: torch.Tensor, dst_pts: torch.Tensor):
    """(N, 1, 2) float32 point pairs -> ((2, 3) float64 numpy [[a, -b, tx], [b, a, ty]], (N, 1) uint8 inliers), or
    (None, zeros) where OpenCV finds no model: cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)."""
    src, dst = src_pts.reshape(-1, 2).float(), dst_pts.reshape(-1, 2).float()
    n, dev = len(src), src.device
    if n < 2:
        raise ValueError(f"estimate_affine_partial_2d needs at least 2 point pairs, got {n} (as cv2)")
    if n == 2:
        best = _two_point_models(src.double()[None], dst.double()[None])[0]
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        sub = torch.from_numpy(ransac_subsets(n)).to(dev)
        models = _two_point_models(src.double()[sub], dst.double()[sub])
        inl = _inliers(models, src, dst)
        best_it = ransac_best(inl.sum(1).tolist(), n)
        if best_it < 0:
            return None, torch.zeros((n, 1), dtype=torch.uint8, device=dev)
        best, mask = models[best_it], inl[best_it]
        # refinement: the least-squares similarity over the inliers
        s, d = src.double()[mask], dst.double()[mask]
        sc, dc = s - s.mean(0), d - d.mean(0)
        den = (sc * sc).sum()
        a = ((sc * dc).sum() / den)
        b = ((sc[:, 0] * dc[:, 1] - sc[:, 1] * dc[:, 0]).sum() / den)
        sm, dm = s.mean(0), d.mean(0)
        best = torch.stack([a, b, dm[0] - a * sm[0] + b * sm[1], dm[1] - b * sm[0] - a * sm[1]])
    a, b, tx, ty = best.tolist()
    return np.array([[a, -b, tx], [b, a, ty]]), mask.to(torch.uint8)[:, None]

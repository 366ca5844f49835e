"""Trajectory statistics, confidence statistics, KDE density maps and speed imputation, on the host.

Counterpart of `drone_yolo_tpu/apps/analytics.py` (the same arithmetic; the density
by `scipy.stats.gaussian_kde`).
"""

from __future__ import annotations

import numpy as np
from scipy.stats import gaussian_kde


def trajectory_statistics(traj_csv_or_rows, fps: float = 30.0, meters_per_pixel: float | None = None, min_len: int = 5):
    """Per-track summary statistics from a trajectory table.

    Accepts the pipeline CSV path or an iterable of (frame, id, cx, cy, ...)
    rows. Returns {track_id: {n, duration_s, path_len, mean_speed, max_speed,
    straightness}} (units = meters when meters_per_pixel given else pixels).
    """
    rows = _load_rows(traj_csv_or_rows)
    scale = meters_per_pixel or 1.0
    out = {}
    for tid in np.unique(rows[:, 1]).astype(int):
        r = rows[rows[:, 1] == tid]
        if len(r) < min_len:
            continue
        r = r[np.argsort(r[:, 0])]
        xy = r[:, 2:4] * scale
        d = np.linalg.norm(np.diff(xy, axis=0), axis=1)
        dt = np.diff(r[:, 0]) / fps
        ok = dt > 0
        speeds = d[ok] / dt[ok]
        net = float(np.linalg.norm(xy[-1] - xy[0]))
        path = float(d.sum())
        out[int(tid)] = {
            "n": int(len(r)),
            "duration_s": float((r[-1, 0] - r[0, 0]) / fps),
            "path_len": path,
            "mean_speed": float(speeds.mean()) if len(speeds) else 0.0,
            "max_speed": float(speeds.max()) if len(speeds) else 0.0,
            "straightness": net / (path + 1e-9),
        }
    return out


def confidence_statistics(traj_csv_or_rows):
    """Mean/median/std of detection confidences (置信度分析.py)."""
    rows = _load_rows(traj_csv_or_rows)
    conf = rows[:, 4]
    return {"mean": float(conf.mean()), "median": float(np.median(conf)), "std": float(conf.std()), "n": int(len(conf))}


def kde_density(points, grid_shape=(100, 100), extent=None, bandwidth: float | None = None):
    """Gaussian-KDE density map over 2-D points (核密度图画图.py).

    Returns (density (H, W), extent (xmin, xmax, ymin, ymax)).
    """
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    if extent is None:
        pad = 0.05 * (pts.max(0) - pts.min(0) + 1e-9)
        xmin, ymin = pts.min(0) - pad
        xmax, ymax = pts.max(0) + pad
    else:
        xmin, xmax, ymin, ymax = extent
    h, w = grid_shape
    try:
        kde = gaussian_kde(pts.T, bw_method=bandwidth)
        xs = np.linspace(xmin, xmax, w)
        ys = np.linspace(ymin, ymax, h)
        xx, yy = np.meshgrid(xs, ys)
        dens = kde(np.vstack([xx.ravel(), yy.ravel()])).reshape(h, w)
    except np.linalg.LinAlgError:  # points on a line: the histogram, scaled to a maximum of 1
        dens, _, _ = np.histogram2d(pts[:, 1], pts[:, 0], bins=grid_shape, range=[[ymin, ymax], [xmin, xmax]])
        dens = dens / (dens.max() + 1e-9)
    return dens, (float(xmin), float(xmax), float(ymin), float(ymax))


def impute_speeds(known_xy, known_speeds, query_xy, k: int = 5):
    """KNN speed imputation at query locations (步速填充.py)."""
    known_xy = np.asarray(known_xy, np.float64)
    known_speeds = np.asarray(known_speeds, np.float64)
    query_xy = np.asarray(query_xy, np.float64).reshape(-1, 2)
    out = np.zeros(len(query_xy))
    for i, q in enumerate(query_xy):
        d = np.linalg.norm(known_xy - q, axis=1)
        idx = np.argsort(d)[:k]
        wgt = 1.0 / (d[idx] + 1e-6)
        out[i] = float((known_speeds[idx] * wgt).sum() / wgt.sum())
    return out


def _load_rows(src):
    if isinstance(src, (str,)) or hasattr(src, "read_text"):
        import csv as _csv

        with open(src, encoding="utf-8") as f:
            rdr = _csv.reader(f)
            header = next(rdr)
            rows = [[float(v) if v != "" else np.nan for v in row[: len(header)]] for row in rdr]
        return np.asarray(rows, np.float64)
    return np.asarray(list(src), np.float64)

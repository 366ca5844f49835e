"""Gait statistics over pose tracks (counterpart of `drone_yolo_tpu/apps/gait.py`).

Cubic-spline smoothing of skeleton trajectories (scipy's `UnivariateSpline`), per-track gait features (cadence, step
length, speed, joint-angle ranges, symmetry), per-group one-way ANOVA and Kruskal-Wallis (scipy), and a random forest
group classifier with its cross-validated accuracy and feature importances: `apps/forest.py`, the numpy counterpart of
the sklearn forest and `cross_val_score` the JAX package calls, which grows the same trees for the same seed.

Inputs are COCO-17 keypoint tracks: {track_id: (T, 17, >=2) array of pixel coordinates}, typically from the pose
predictor and a tracker (`apps/pipeline.py`). Everything runs on the host.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from drone_yolo_tpu_torch.apps.forest import RandomForestClassifier, cross_val_score

LOGGER = logging.getLogger("drone_yolo_tpu_torch")

# COCO-17 keypoint indices
L_SHOULDER, R_SHOULDER = 5, 6
L_HIP, R_HIP = 11, 12
L_KNEE, R_KNEE = 13, 14
L_ANKLE, R_ANKLE = 15, 16

FEATURE_NAMES = (
    "speed",  # m/s (or px/s when gsd=1)
    "cadence",  # steps / s
    "step_length",  # m per step
    "stance_width",  # mean lateral ankle separation
    "knee_angle_range_l",
    "knee_angle_range_r",
    "hip_sway",  # lateral hip-center oscillation amplitude
    "symmetry",  # L/R ankle oscillation amplitude ratio (1 = symmetric)
)


def smooth_track(kpts: np.ndarray, smoothing: float = 0.0) -> np.ndarray:
    """Cubic-spline smooth each keypoint coordinate over time (reference:
    scipy spline smoothing of per-joint trajectories)."""
    from scipy.interpolate import UnivariateSpline

    kpts = np.asarray(kpts, np.float64)
    t = np.arange(len(kpts))
    if len(kpts) < 8:
        return kpts
    out = kpts.copy()
    s = smoothing if smoothing > 0 else len(kpts) * 2.0
    for k in range(kpts.shape[1]):
        for d in range(2):
            y = kpts[:, k, d]
            good = np.isfinite(y)
            if good.sum() < 8:
                continue
            spl = UnivariateSpline(t[good], y[good], k=3, s=s)
            out[:, k, d] = spl(t)
    return out


def _angle(a, b, c):
    """Angle at b (degrees) for points (T, 2)."""
    v1, v2 = a - b, c - b
    cos = np.sum(v1 * v2, -1) / (np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1) + 1e-9)
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))


def _oscillation(signal: np.ndarray, fps: float):
    """(dominant frequency Hz, amplitude) of a 1-D oscillation via FFT."""
    x = signal - np.nanmean(signal)
    x = np.nan_to_num(x)
    if len(x) < 8 or np.allclose(x, 0):
        return 0.0, 0.0
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    freqs = np.fft.rfftfreq(len(x), d=1.0 / fps)
    lo = freqs > 0.2  # ignore DC / drift
    if not lo.any():
        return 0.0, 0.0
    i = np.argmax(spec[lo])
    return float(freqs[lo][i]), float(2 * np.std(x))


def gait_features(kpts: np.ndarray, fps: float = 30.0, gsd: float = 1.0, smooth: bool = True) -> dict:
    """Per-track gait feature vector. kpts (T, 17, >=2) pixels; gsd = meters per
    pixel (from `apps/geo.py` ground-sample distance)."""
    k = smooth_track(kpts[..., :2]) if smooth else np.asarray(kpts[..., :2], np.float64)
    hip_c = (k[:, L_HIP] + k[:, R_HIP]) / 2
    # walking direction = principal axis of hip-center motion
    disp = hip_c - hip_c.mean(0)
    u, _, vt = np.linalg.svd(disp, full_matrices=False)
    fwd = vt[0]
    lat = np.array([-fwd[1], fwd[0]])

    dt = 1.0 / fps
    speed = float(np.linalg.norm(np.diff(hip_c, axis=0), axis=1).mean() / dt * gsd)

    ankle_rel_l = (k[:, L_ANKLE] - hip_c) @ fwd
    ankle_rel_r = (k[:, R_ANKLE] - hip_c) @ fwd
    f_l, a_l = _oscillation(ankle_rel_l, fps)
    f_r, a_r = _oscillation(ankle_rel_r, fps)
    stride_freq = (f_l + f_r) / 2  # strides/s per leg
    cadence = float(stride_freq * 2)  # steps/s
    step_length = float(speed / cadence) if cadence > 1e-3 else 0.0

    stance = float(np.abs((k[:, L_ANKLE] - k[:, R_ANKLE]) @ lat).mean() * gsd)
    knee_l = _angle(k[:, L_HIP], k[:, L_KNEE], k[:, L_ANKLE])
    knee_r = _angle(k[:, R_HIP], k[:, R_KNEE], k[:, R_ANKLE])
    hip_sway = float(2 * np.std((hip_c - hip_c.mean(0)) @ lat) * gsd)
    symmetry = float(min(a_l, a_r) / max(a_l, a_r)) if max(a_l, a_r) > 1e-9 else 1.0

    return {
        "speed": speed,
        "cadence": cadence,
        "step_length": step_length,
        "stance_width": stance,
        "knee_angle_range_l": float(np.nanmax(knee_l) - np.nanmin(knee_l)),
        "knee_angle_range_r": float(np.nanmax(knee_r) - np.nanmin(knee_r)),
        "hip_sway": hip_sway,
        "symmetry": symmetry,
    }


def group_stats(features: list[dict], groups: list) -> dict:
    """Per-feature one-way ANOVA + Kruskal-Wallis across groups (reference:
    scipy.stats.f_oneway / kruskal per age group)."""
    from scipy import stats as sps

    groups = np.asarray(groups)
    out = {}
    for name in FEATURE_NAMES:
        vals = np.array([f[name] for f in features], np.float64)
        samples = [vals[groups == g] for g in np.unique(groups)]
        samples = [s[np.isfinite(s)] for s in samples]
        if any(len(s) < 2 for s in samples) or len(samples) < 2:
            continue
        f, p_anova = sps.f_oneway(*samples)
        h, p_kw = sps.kruskal(*samples)
        out[name] = {
            "anova_F": float(f),
            "anova_p": float(p_anova),
            "kruskal_H": float(h),
            "kruskal_p": float(p_kw),
            "group_means": {str(g): float(np.mean(s)) for g, s in zip(np.unique(groups), samples)},
        }
    return out


def classify_groups(features: list[dict], groups: list, n_estimators: int = 200, cv: int = 3, seed: int = 0) -> dict:
    """Random forest group classifier with cross-validated accuracy (stratified folds) and feature importances, as
    sklearn's `RandomForestClassifier(n_estimators, random_state=seed)` and `cross_val_score` give them."""
    X = np.array([[f[n] for n in FEATURE_NAMES] for f in features], np.float64)
    y = np.asarray(groups)
    clf = RandomForestClassifier(n_estimators=n_estimators, random_state=seed)
    scores = cross_val_score(clf, X, y, cv=cv)
    clf.fit(X, y)
    return {
        "cv_accuracy": float(scores.mean()),
        "cv_std": float(scores.std()),
        "importances": dict(zip(FEATURE_NAMES, map(float, clf.feature_importances_))),
    }


@dataclass
class GaitStudy:
    """End-to-end study: tracks -> features -> group stats + classifier report."""

    fps: float = 30.0
    gsd: float = 1.0

    def run(self, tracks: dict, groups: dict) -> dict:
        """tracks: {tid: (T, 17, >=2)}; groups: {tid: group label}."""
        feats, labels, ids = [], [], []
        for tid, kpts in tracks.items():
            if tid not in groups or len(kpts) < 16:
                continue
            feats.append(gait_features(np.asarray(kpts), fps=self.fps, gsd=self.gsd))
            labels.append(groups[tid])
            ids.append(tid)
        if len(set(labels)) < 2:
            LOGGER.warning("gait study needs >= 2 groups")
            return {"features": dict(zip(ids, feats))}
        report = {
            "features": dict(zip(ids, feats)),
            "stats": group_stats(feats, labels),
            "classifier": classify_groups(feats, labels),
        }
        sig = [k for k, v in report["stats"].items() if v["anova_p"] < 0.05]
        LOGGER.info(
            f"gait study: {len(feats)} tracks, {len(set(labels))} groups; "
            f"significant features (ANOVA p<0.05): {sig}; "
            f"RF cv accuracy {report['classifier']['cv_accuracy']:.3f}"
        )
        return report

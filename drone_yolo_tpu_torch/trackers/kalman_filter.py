"""Kalman filter for ByteTrack's track states, in float64 numpy.

Counterpart of `drone_yolo_tpu/trackers/kalman_filter.py` `KalmanFilterXYAH` (the
same arithmetic, in the same order): a constant-velocity model over the 8-D state
(x, y, aspect, height and their velocities), with process and observation noise
scaled by the height. The JAX package's `gating_distance` and `KalmanFilterXYWH`
serve BoT-SORT, which is not ported yet.
"""

from __future__ import annotations

import numpy as np


class KalmanFilterXYAH:
    """State: (x, y, a, h, vx, vy, va, vh); measurement: (x, y, aspect, height)."""

    def __init__(self):
        ndim, dt = 4, 1.0
        self._motion_mat = np.eye(2 * ndim)
        for i in range(ndim):
            self._motion_mat[i, ndim + i] = dt
        self._update_mat = np.eye(ndim, 2 * ndim)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    def initiate(self, measurement):
        mean_pos = measurement
        mean_vel = np.zeros_like(mean_pos)
        mean = np.concatenate([mean_pos, mean_vel])
        h = measurement[3]
        std = [
            2 * self._std_weight_position * h,
            2 * self._std_weight_position * h,
            1e-2,
            2 * self._std_weight_position * h,
            10 * self._std_weight_velocity * h,
            10 * self._std_weight_velocity * h,
            1e-5,
            10 * self._std_weight_velocity * h,
        ]
        return mean, np.diag(np.square(std))

    def _motion_cov(self, mean):
        h = mean[3]
        std_pos = [self._std_weight_position * h] * 2 + [1e-2, self._std_weight_position * h]
        std_vel = [self._std_weight_velocity * h] * 2 + [1e-5, self._std_weight_velocity * h]
        return np.diag(np.square(np.array(std_pos + std_vel)))

    def predict(self, mean, covariance):
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + self._motion_cov(mean)
        return mean, covariance

    def project(self, mean, covariance):
        h = mean[3]
        std = [self._std_weight_position * h] * 2 + [1e-1, self._std_weight_position * h]
        innovation_cov = np.diag(np.square(np.array(std)))
        mean_p = self._update_mat @ mean
        cov_p = self._update_mat @ covariance @ self._update_mat.T + innovation_cov
        return mean_p, cov_p

    def update(self, mean, covariance, measurement):
        proj_mean, proj_cov = self.project(mean, covariance)
        chol = np.linalg.cholesky(proj_cov)
        kalman_gain = np.linalg.solve(
            chol.T, np.linalg.solve(chol, (covariance @ self._update_mat.T).T)
        ).T
        innovation = measurement - proj_mean
        new_mean = mean + kalman_gain @ innovation
        new_cov = covariance - kalman_gain @ proj_cov @ kalman_gain.T
        return new_mean, new_cov

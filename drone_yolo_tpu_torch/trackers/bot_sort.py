"""BoT-SORT: ByteTrack's association with (cx, cy, w, h) Kalman states, camera-motion compensation and optional
appearance features, on the host in numpy; the motion is estimated on the frame's device (`trackers/gmc.py`).

Counterpart of `drone_yolo_tpu/trackers/bot_sort.py` (BOTrack, BOTSORT), in the same dtypes and order. Each
frame's warp moves the tracked and lost tracks' states before `BYTETracker.update` runs the Kalman predict, as the
JAX package orders it (Ultralytics predicts first and warps after; under rotation the process noise differs).
`encoder` is None, as there: appearance features come in only where a caller sets an encoder with an
`inference(img, xywhs)` method.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from drone_yolo_tpu_torch.trackers import matching
from drone_yolo_tpu_torch.trackers.byte_tracker import BYTETracker, STrack, TrackState
from drone_yolo_tpu_torch.trackers.gmc import GMC
from drone_yolo_tpu_torch.trackers.kalman_filter import KalmanFilterXYWH


class BOTrack(STrack):
    """STrack with XYWH Kalman state and EMA appearance features."""

    shared_kalman = KalmanFilterXYWH()

    def __init__(self, xywh, score, cls, feat=None, feat_history: int = 50):
        super().__init__(xywh, score, cls)
        self.smooth_feat = None
        self.curr_feat = None
        self.features = deque([], maxlen=feat_history)
        self.alpha = 0.9
        if feat is not None:
            self.update_features(feat)

    def update_features(self, feat):
        feat = feat / (np.linalg.norm(feat) + 1e-9)
        self.curr_feat = feat
        self.smooth_feat = feat if self.smooth_feat is None else self.alpha * self.smooth_feat + (1 - self.alpha) * feat
        self.features.append(feat)
        self.smooth_feat /= np.linalg.norm(self.smooth_feat) + 1e-9

    def _to_xyah(self, tlwh):
        # BoT-SORT measures (cx, cy, w, h)
        ret = np.asarray(tlwh, np.float32).copy()
        ret[:2] += ret[2:] / 2
        return ret

    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()  # cx, cy, w, h
        ret[:2] -= ret[2:] / 2
        return ret

    def predict(self):
        mean_state = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean_state[6] = 0
            mean_state[7] = 0
        self.mean, self.covariance = self.kalman_filter.predict(mean_state, self.covariance)

    def re_activate(self, new_track, frame_id, new_id=False):
        if new_track.curr_feat is not None:
            self.update_features(new_track.curr_feat)
        super().re_activate(new_track, frame_id, new_id)

    def update(self, new_track, frame_id):
        if new_track.curr_feat is not None:
            self.update_features(new_track.curr_feat)
        super().update(new_track, frame_id)

    @staticmethod
    def multi_gmc(stracks, h):
        """Warp track states by the camera-motion affine (reference bot_sort.py:97)."""
        if len(stracks) == 0:
            return
        r = h[:2, :2]
        r8 = np.kron(np.eye(4), r)
        t = h[:2, 2]
        for st in stracks:
            if st.mean is None:
                continue
            mean = r8 @ st.mean
            mean[:2] += t
            st.mean = mean
            st.covariance = r8 @ st.covariance @ r8.T


class BOTSORT(BYTETracker):
    """BoT-SORT tracker (reference bot_sort.py:147). `device` is where GMC uploads numpy frames (CUDA by default)."""

    def __init__(self, args, frame_rate: int = 30, device=None):
        super().__init__(args, frame_rate)
        self.proximity_thresh = args.proximity_thresh
        self.appearance_thresh = args.appearance_thresh
        self.with_reid = getattr(args, "with_reid", False)
        self.encoder = None  # ReID model hook; detector features suffice for parity
        self.gmc = GMC(method=args.gmc_method, device=device)

    def get_kalmanfilter(self):
        return KalmanFilterXYWH()

    def init_track(self, xywhs, scores, cls, img=None):
        if len(xywhs) == 0:
            return []
        feats = None
        if self.with_reid and self.encoder is not None:
            feats = self.encoder.inference(img, xywhs)
        return [
            BOTrack(xywh, s, c, feats[i] if feats is not None else None)
            for i, (xywh, s, c) in enumerate(zip(xywhs, scores, cls))
        ]

    def get_dists(self, tracks, detections):
        dists = matching.iou_distance(tracks, detections)
        # reference bot_sort.py:214 masks iou-DISTANCE (1 - IoU) directly
        dists_mask = dists > self.proximity_thresh
        if self.args.fuse_score:
            dists = matching.fuse_score(dists, detections)
        if self.with_reid and self.encoder is not None and len(tracks) and len(detections):
            emb = matching.embedding_distance(tracks, detections) / 2.0
            emb[emb > self.appearance_thresh] = 1.0
            emb[dists_mask] = 1.0
            dists = np.minimum(dists, emb)
        return dists

    def multi_predict(self, tracks):
        BOTrack.multi_predict(tracks)

    def update(self, boxes_xyxy, scores, cls, img=None, feats=None):
        if img is not None:
            warp = self.gmc.apply(img)
            BOTrack.multi_gmc(self.tracked_stracks, warp)
            BOTrack.multi_gmc(self.lost_stracks, warp)
        return super().update(boxes_xyxy, scores, cls, img)

    def reset(self):
        super().reset()
        self.gmc.reset_params()

"""ByteTrack: two-stage IoU association with Kalman motion, on the host in numpy.

Counterpart of `drone_yolo_tpu/trackers/byte_tracker.py` (STrack, BYTETracker), with
the same dtypes (boxes in float32, the Kalman state in float64) and the same order
of operations, so equal detection streams give equal tracks. High-confidence
detections associate first; low-confidence ones rescue still-alive tracks in a
second pass; unconfirmed tracks get one more chance. Track ids come from one
counter shared by every tracker in the process (`STrack._count`), which a new
tracker and `reset` set back to 0.
"""

from __future__ import annotations

import numpy as np

from drone_yolo_tpu_torch.trackers import matching
from drone_yolo_tpu_torch.trackers.kalman_filter import KalmanFilterXYAH


class TrackState:
    """Track lifecycle states (reference trackers/basetrack.py)."""
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


class STrack:
    """Single tracked object with Kalman XYAH state (reference byte_tracker.py:27)."""

    shared_kalman = KalmanFilterXYAH()
    _count = 0

    def __init__(self, xywh, score, cls):
        # xywh may carry a detection index as 5th element (reference convention)
        self._tlwh = np.asarray(
            [xywh[0] - xywh[2] / 2, xywh[1] - xywh[3] / 2, xywh[2], xywh[3]], np.float32
        )
        self.kalman_filter = None
        self.mean, self.covariance = None, None
        self.is_activated = False
        self.score = float(score)
        self.cls = cls
        self.idx = int(xywh[-1]) if len(xywh) > 4 else -1
        self.tracklet_len = 0
        self.state = TrackState.New
        self.track_id = 0
        self.frame_id = 0
        self.start_frame = 0

    @staticmethod
    def next_id():
        STrack._count += 1
        return STrack._count

    @staticmethod
    def reset_id():
        STrack._count = 0

    # -- geometry -------------------------------------------------------------
    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()  # xyah
        ret[2] *= ret[3]  # a*h = w
        ret[:2] -= ret[2:] / 2
        return ret

    @property
    def xyxy(self):
        t = self.tlwh
        return np.array([t[0], t[1], t[0] + t[2], t[1] + t[3]], np.float32)

    @property
    def xywh(self):
        t = self.tlwh
        return np.array([t[0] + t[2] / 2, t[1] + t[3] / 2, t[2], t[3]], np.float32)

    @property
    def result(self):
        """[x1, y1, x2, y2, track_id, score, cls, det_idx]."""
        return [*self.xyxy.tolist(), self.track_id, self.score, int(self.cls), self.idx]

    def _to_xyah(self, tlwh):
        ret = np.asarray(tlwh, np.float32).copy()
        ret[:2] += ret[2:] / 2
        ret[2] /= ret[3]
        return ret

    # -- lifecycle --------------------------------------------------------------
    def activate(self, kalman_filter, frame_id):
        self.kalman_filter = kalman_filter
        self.track_id = self.next_id()
        self.mean, self.covariance = kalman_filter.initiate(self._to_xyah(self._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = frame_id == 1
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(self, new_track, frame_id, new_id: bool = False):
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self._to_xyah(new_track._tlwh)
        )
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        if new_id:
            self.track_id = self.next_id()
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def update(self, new_track, frame_id):
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self._to_xyah(new_track._tlwh)
        )
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def predict(self):
        mean_state = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean_state[7] = 0
        self.mean, self.covariance = self.kalman_filter.predict(mean_state, self.covariance)

    @staticmethod
    def multi_predict(stracks):
        for st in stracks:
            st.predict()

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed

    @property
    def end_frame(self):
        return self.frame_id


class BYTETracker:
    """Two-stage Hungarian association tracker (reference byte_tracker.py:235)."""

    def __init__(self, args, frame_rate: int = 30):
        self.tracked_stracks: list[STrack] = []
        self.lost_stracks: list[STrack] = []
        self.removed_stracks: list[STrack] = []
        self.frame_id = 0
        self.args = args
        self.max_time_lost = int(frame_rate / 30.0 * args.track_buffer)
        self.kalman_filter = self.get_kalmanfilter()
        STrack.reset_id()

    def get_kalmanfilter(self):
        return KalmanFilterXYAH()

    def init_track(self, xywhs, scores, cls):
        return [STrack(xywh, s, c) for xywh, s, c in zip(xywhs, scores, cls)] if len(xywhs) else []

    def get_dists(self, tracks, detections):
        dists = matching.iou_distance(tracks, detections)
        if self.args.fuse_score:
            dists = matching.fuse_score(dists, detections)
        return dists

    def multi_predict(self, tracks):
        STrack.multi_predict(tracks)

    def update(self, boxes_xyxy, scores, cls):
        """One frame step. Returns (N, 8) [x1,y1,x2,y2,id,score,cls,det_idx]."""
        self.frame_id += 1
        scores = np.asarray(scores, np.float32)
        cls = np.asarray(cls)
        boxes_xyxy = np.asarray(boxes_xyxy, np.float32).reshape(-1, 4)
        xywh = np.concatenate(
            [
                (boxes_xyxy[:, :2] + boxes_xyxy[:, 2:]) / 2,
                boxes_xyxy[:, 2:] - boxes_xyxy[:, :2],
                np.arange(len(boxes_xyxy), dtype=np.float32)[:, None],
            ],
            axis=1,
        )
        remain_inds = scores >= self.args.track_high_thresh
        inds_low = (scores > self.args.track_low_thresh) & (scores < self.args.track_high_thresh)

        dets = self.init_track(xywh[remain_inds], scores[remain_inds], cls[remain_inds])
        dets_second = self.init_track(xywh[inds_low], scores[inds_low], cls[inds_low])

        activated, refound, lost, removed = [], [], [], []
        unconfirmed = [t for t in self.tracked_stracks if not t.is_activated]
        tracked = [t for t in self.tracked_stracks if t.is_activated]
        strack_pool = joint_stracks(tracked, self.lost_stracks)
        self.multi_predict(strack_pool)

        # stage 1: high-confidence associations
        dists = self.get_dists(strack_pool, dets)
        matches, u_track, u_det = matching.linear_assignment(dists, self.args.match_thresh)
        for it, idet in matches:
            track, det = strack_pool[it], dets[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id, new_id=False)
                refound.append(track)

        # stage 2: rescue with low-confidence detections (pure IoU)
        r_tracked = [strack_pool[i] for i in u_track if strack_pool[i].state == TrackState.Tracked]
        dists2 = matching.iou_distance(r_tracked, dets_second)
        matches2, u_track2, _ = matching.linear_assignment(dists2, 0.5)
        for it, idet in matches2:
            track, det = r_tracked[it], dets_second[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id, new_id=False)
                refound.append(track)
        for i in u_track2:
            track = r_tracked[i]
            if track.state != TrackState.Lost:
                track.mark_lost()
                lost.append(track)

        # unconfirmed tracks get one chance against leftover detections
        left_dets = [dets[i] for i in u_det]
        dists3 = self.get_dists(unconfirmed, left_dets)
        matches3, u_unconfirmed, u_det3 = matching.linear_assignment(dists3, 0.7)
        for it, idet in matches3:
            unconfirmed[it].update(left_dets[idet], self.frame_id)
            activated.append(unconfirmed[it])
        for i in u_unconfirmed:
            track = unconfirmed[i]
            track.mark_removed()
            removed.append(track)

        # births
        for i in u_det3:
            track = left_dets[i]
            if track.score >= self.args.new_track_thresh:
                track.activate(self.kalman_filter, self.frame_id)
                activated.append(track)

        # deaths
        for track in self.lost_stracks:
            if self.frame_id - track.end_frame > self.max_time_lost:
                track.mark_removed()
                removed.append(track)

        self.tracked_stracks = [t for t in self.tracked_stracks if t.state == TrackState.Tracked]
        self.tracked_stracks = joint_stracks(self.tracked_stracks, activated)
        self.tracked_stracks = joint_stracks(self.tracked_stracks, refound)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.tracked_stracks)
        self.lost_stracks.extend(lost)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.removed_stracks)
        self.tracked_stracks, self.lost_stracks = remove_duplicate_stracks(self.tracked_stracks, self.lost_stracks)
        self.removed_stracks.extend(removed)
        if len(self.removed_stracks) > 1000:
            self.removed_stracks = self.removed_stracks[-999:]

        return np.asarray([t.result for t in self.tracked_stracks if t.is_activated], dtype=np.float32)

    def reset(self):
        self.tracked_stracks = []
        self.lost_stracks = []
        self.removed_stracks = []
        self.frame_id = 0
        self.kalman_filter = self.get_kalmanfilter()
        STrack.reset_id()


def joint_stracks(a, b):
    """Union of two track lists, keeping the first occurrence per track_id."""
    seen = {t.track_id for t in a}
    return a + [t for t in b if t.track_id not in seen]


def sub_stracks(a, b):
    """Tracks of `a` whose track_id does not appear in `b`."""
    ids_b = {t.track_id for t in b}
    return [t for t in a if t.track_id not in ids_b]


def remove_duplicate_stracks(a, b):
    """Drop cross-list duplicates (IoU distance < 0.15), keeping the longer-lived track."""
    dists = matching.iou_distance(a, b)
    pairs = np.argwhere(dists < 0.15)
    dup_a, dup_b = set(), set()
    for i, j in pairs:
        time_a = a[i].frame_id - a[i].start_frame
        time_b = b[j].frame_id - b[j].start_frame
        if time_a > time_b:
            dup_b.add(j)
        else:
            dup_a.add(i)
    return [t for i, t in enumerate(a) if i not in dup_a], [t for j, t in enumerate(b) if j not in dup_b]

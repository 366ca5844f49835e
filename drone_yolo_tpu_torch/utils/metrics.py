"""Detection, segmentation, pose and oriented box metrics on the host, in numpy: box IoU, keypoint OKS, TP matching,
101-point AP, per-class P/R/AP; and the classifiers' top-1 and top-5 accuracy (`ClassifyMetrics`).

A copy of `drone_yolo_tpu/utils/metrics.py` (`box_iou_np`, `match_predictions`,
`compute_ap`, `ap_per_class`, `smooth`, `Metric`, `DetMetrics`, `SegmentMetrics`, `kpt_iou`, `PoseMetrics`,
`OBBMetrics`, `ClassifyMetrics`, `ConfusionMatrix`) and of
the COCO keypoint sigmas of `drone_yolo_tpu/models/yolo/pose.py:OKS_SIGMA_NP`, which follow the
reference ultralytics `utils/metrics.py`. The card produces the detections; matching
and accumulation are host work, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 has only the old name

# COCO's 17 keypoint sigmas (nose, eyes, ears, shoulders, elbows, wrists, hips, knees, ankles)
OKS_SIGMA = np.array([0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07, 1.07, 0.87, 0.87, 0.89,
                      0.89]) / 10.0


def kpt_sigmas(nk: int) -> np.ndarray:
    """The OKS sigmas of `nk` keypoints: COCO's for 17, else uniform 1 / nk (as the JAX package)."""
    return OKS_SIGMA if nk == 17 else np.ones(nk) / nk


def box_iou_np(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Pairwise IoU (N, 4) x (M, 4) xyxy -> (N, M)."""
    a1, a2 = box1[:, None, :2], box1[:, None, 2:4]
    b1, b2 = box2[None, :, :2], box2[None, :, 2:4]
    inter = np.clip(np.minimum(a2, b2) - np.maximum(a1, b1), 0, None).prod(-1)
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return inter / (area1[:, None] + area2[None, :] - inter + eps)


def match_predictions(pred_classes, true_classes, iou, iouv) -> np.ndarray:
    """(N, T) bool: whether each of N predictions is a true positive at each of T IoU thresholds.

    `iou` is the (M, N) IoU of M GT boxes against the predictions. Matching is greedy and
    one-to-one as in the reference: matches above the threshold by descending IoU, then the
    first `np.unique` keeps each prediction's best GT and reorders by prediction index (its
    side effect), and the second gives each GT the first of its predictions in that order,
    which is the most confident one (NMS emits predictions by descending confidence).
    """
    n, t = len(pred_classes), len(iouv)
    correct = np.zeros((n, t), dtype=bool)
    if len(true_classes) == 0 or n == 0:
        return correct
    cls_ok = true_classes[:, None] == pred_classes[None, :]
    iou = np.where(cls_ok, iou, 0.0)
    for ti, thr in enumerate(iouv):
        m_gt, m_pred = np.nonzero(iou >= thr)
        if len(m_gt):
            vals = iou[m_gt, m_pred]
            order = vals.argsort()[::-1]
            m_gt, m_pred = m_gt[order], m_pred[order]
            _, ip = np.unique(m_pred, return_index=True)
            m_gt, m_pred = m_gt[ip], m_pred[ip]
            _, ig = np.unique(m_gt, return_index=True)
            m_gt, m_pred = m_gt[ig], m_pred[ig]
            correct[m_pred, ti] = True
    return correct


def compute_ap(recall, precision):
    """AP of one PR curve by 101-point interpolation; returns (ap, envelope precision, recall)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = _trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls, eps: float = 1e-16):
    """Per-class AP at each IoU threshold, and P, R, F1 at the confidence of the best mean F1.

    Args:
        tp: (N, T) bool TP matrix. conf: (N,). pred_cls: (N,). target_cls: (M,).

    Returns a dict with p, r, f1 (C,), ap (C, T), unique_classes, the curves and nt.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = len(unique_classes)
    t_dim = tp.shape[1] if tp.ndim > 1 else 1

    ap = np.zeros((nc, t_dim))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    x = np.linspace(0, 1, 1000)

    for ci, c in enumerate(unique_classes):
        mask = pred_cls == c
        n_l, n_p = nt[ci], mask.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[mask]).cumsum(0)
        tpc = tp[mask].cumsum(0)
        recall = tpc / (n_l + eps)
        precision = tpc / (tpc + fpc)
        r_curve[ci] = np.interp(-x, -conf[mask], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-x, -conf[mask], precision[:, 0], left=1)
        for ti in range(t_dim):
            ap[ci, ti], _, _ = compute_ap(recall[:, ti], precision[:, ti])

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = smooth(f1_curve.mean(0), 0.1).argmax()
    p, r, f1 = p_curve[:, i], r_curve[:, i], f1_curve[:, i]
    return {"p": p, "r": r, "f1": f1, "ap": ap, "unique_classes": unique_classes.astype(int), "p_curve": p_curve,
            "r_curve": r_curve, "f1_curve": f1_curve, "x": x, "nt": nt}


def smooth(y, f=0.05):
    """Box-filter smoothing over a window of `f` of the length on each side."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]))
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


class Metric:
    """Per-class P, R, F1 and AP (C, T) of one evaluation, with the means over classes."""

    def __init__(self):
        self.p = []
        self.r = []
        self.f1 = []
        self.all_ap = []
        self.ap_class_index = []
        self.nc = 0

    @property
    def ap50(self):
        return self.all_ap[:, 0] if len(self.all_ap) else []

    @property
    def ap(self):
        return self.all_ap.mean(1) if len(self.all_ap) else []

    @property
    def mp(self):
        return self.p.mean() if len(self.p) else 0.0

    @property
    def mr(self):
        return self.r.mean() if len(self.r) else 0.0

    @property
    def map50(self):
        return self.all_ap[:, 0].mean() if len(self.all_ap) else 0.0

    @property
    def map75(self):
        return self.all_ap[:, 5].mean() if len(self.all_ap) else 0.0

    @property
    def map(self):
        return self.all_ap.mean() if len(self.all_ap) else 0.0

    def mean_results(self):
        return [self.mp, self.mr, self.map50, self.map]

    def class_result(self, i):
        return self.p[i], self.r[i], self.all_ap[i, 0], self.all_ap[i].mean()

    @property
    def maps(self):
        """mAP50-95 per class over all `nc` classes; classes without GT take the mean."""
        maps = np.zeros(self.nc) + self.map
        for i, c in enumerate(self.ap_class_index):
            maps[int(c)] = self.ap[i]
        return maps

    def fitness(self):
        """0.1 * mAP50 + 0.9 * mAP50-95."""
        w = np.array([0.0, 0.0, 0.1, 0.9])
        return float((np.array(self.mean_results()) * w).sum())

    def update(self, results):
        self.p, self.r, self.f1, self.all_ap, self.ap_class_index = (
            results["p"], results["r"], results["f1"], results["ap"], results["unique_classes"])


class ConfusionMatrix:
    """Detection confusion matrix (nc + 1 square for detect, with the background last; nc otherwise), rows the
    predicted class, columns the true one. Detections at conf <= `conf` (0.25 when given None or 0.001) are left
    out; GT and detections pair greedily by IoU > `iou_thres`, the largest first."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45, task: str = "detect"):
        self.task = task
        self.nc = nc
        self.conf = 0.25 if conf in {None, 0.001} else conf
        self.iou_thres = iou_thres
        n = nc + 1 if task == "detect" else nc
        self.matrix = np.zeros((n, n))

    def process_cls_preds(self, preds, targets):
        for p, t in zip(np.asarray(preds), np.asarray(targets)):
            self.matrix[int(p), int(t)] += 1

    def process_batch(self, detections, gt_bboxes, gt_cls):
        """detections (N, 6+) x1, y1, x2, y2, conf, cls; gt_bboxes (M, 4) xyxy; gt_cls (M,)."""
        if detections is None or len(detections) == 0:
            for c in np.asarray(gt_cls).astype(int):
                self.matrix[self.nc, c] += 1  # background FN
            return
        detections = np.asarray(detections)
        detections = detections[detections[:, 4] > self.conf]
        gt_cls = np.asarray(gt_cls).astype(int)
        dc = detections[:, 5].astype(int)
        if len(gt_cls) == 0:
            for c in dc:
                self.matrix[c, self.nc] += 1  # background FP
            return
        iou = box_iou_np(np.asarray(gt_bboxes), detections[:, :4])
        m_gt, m_pred = np.nonzero(iou > self.iou_thres)
        matched_gt, matched_pred = set(), set()
        if len(m_gt):
            for k in iou[m_gt, m_pred].argsort()[::-1]:
                g, p = int(m_gt[k]), int(m_pred[k])
                if g in matched_gt or p in matched_pred:
                    continue
                matched_gt.add(g)
                matched_pred.add(p)
                self.matrix[dc[p], gt_cls[g]] += 1
        for g in range(len(gt_cls)):
            if g not in matched_gt:
                self.matrix[self.nc, gt_cls[g]] += 1
        for p in range(len(dc)):
            if p not in matched_pred:
                self.matrix[dc[p], self.nc] += 1

    def tp_fp(self):
        tp = self.matrix.diagonal()
        fp = self.matrix.sum(1) - tp
        return (tp[:-1], fp[:-1]) if self.task == "detect" else (tp, fp)


class DetMetrics:
    """Box metrics of a detection validation: `process` the accumulated matches, then read the means."""

    def __init__(self, names=None):
        self.names = names or {}
        self.box = Metric()
        self.speed = {"preprocess": 0.0, "inference": 0.0, "loss": 0.0, "postprocess": 0.0}
        self.task = "detect"

    def process(self, tp, conf, pred_cls, target_cls):
        results = ap_per_class(np.asarray(tp), np.asarray(conf), np.asarray(pred_cls), np.asarray(target_cls))
        self.box.nc = len(self.names)
        self.box.update(results)

    @property
    def keys(self):
        return ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)"]

    def mean_results(self):
        return self.box.mean_results()

    def class_result(self, i):
        return self.box.class_result(i)

    @property
    def maps(self):
        return self.box.maps

    @property
    def fitness(self):
        return self.box.fitness()

    @property
    def ap_class_index(self):
        return self.box.ap_class_index

    @property
    def results_dict(self):
        return dict(zip(self.keys + ["fitness"], self.mean_results() + [self.fitness]))


def kpt_iou(gt_kpts, pred_kpts, area, sigmas, eps: float = 1e-7) -> np.ndarray:
    """OKS of (M, K, 3) GT keypoints against (N, K, 2|3) predicted ones, with (M,) GT areas -> (M, N): the mean over
    the GT's labelled points (visibility != 0) of exp(-d^2 / (2 sigma)^2 / (area + eps) / 2)."""
    d = (gt_kpts[:, None, :, 0] - pred_kpts[None, :, :, 0]) ** 2 + (gt_kpts[:, None, :, 1] - pred_kpts[None, :, :, 1]) ** 2
    sigmas = np.asarray(sigmas)
    kpt_mask = gt_kpts[..., 2] != 0  # (M, K)
    e = d / ((2 * sigmas) ** 2)[None, None, :] / (area[:, None, None] + eps) / 2
    oks = np.exp(-e) * kpt_mask[:, None, :]
    return oks.sum(-1) / (kpt_mask.sum(-1)[:, None] + eps)


class PoseMetrics(DetMetrics):
    """Box metrics and keypoint (OKS) metrics of a pose validation: 8 means, fitness = box fitness + pose fitness."""

    def __init__(self, names=None):
        super().__init__(names)
        self.pose = Metric()
        self.task = "pose"

    def process(self, tp, tp_p, conf, pred_cls, target_cls):
        super().process(tp, conf, pred_cls, target_cls)
        results = ap_per_class(np.asarray(tp_p), np.asarray(conf), np.asarray(pred_cls), np.asarray(target_cls))
        self.pose.nc = len(self.names)
        self.pose.update(results)

    @property
    def keys(self):
        return ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)",
                "metrics/precision(P)", "metrics/recall(P)", "metrics/mAP50(P)", "metrics/mAP50-95(P)"]

    def mean_results(self):
        return self.box.mean_results() + self.pose.mean_results()

    def class_result(self, i):
        return self.box.class_result(i) + self.pose.class_result(i)

    @property
    def fitness(self):
        return self.box.fitness() + self.pose.fitness()


class SegmentMetrics(DetMetrics):
    """Box metrics and mask metrics of a segmentation validation: 8 means, fitness = box fitness + mask fitness."""

    def __init__(self, names=None):
        super().__init__(names)
        self.seg = Metric()
        self.task = "segment"

    def process(self, tp, tp_m, conf, pred_cls, target_cls):
        super().process(tp, conf, pred_cls, target_cls)
        results = ap_per_class(np.asarray(tp_m), np.asarray(conf), np.asarray(pred_cls), np.asarray(target_cls))
        self.seg.nc = len(self.names)
        self.seg.update(results)

    @property
    def keys(self):
        return ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)",
                "metrics/precision(M)", "metrics/recall(M)", "metrics/mAP50(M)", "metrics/mAP50-95(M)"]

    def mean_results(self):
        return self.box.mean_results() + self.seg.mean_results()

    def class_result(self, i):
        return self.box.class_result(i) + self.seg.class_result(i)

    @property
    def fitness(self):
        return self.box.fitness() + self.seg.fitness()


class OBBMetrics(DetMetrics):
    """Rotated-box AP: `DetMetrics` over TP matched by probiou, by the box metrics' keys."""

    def __init__(self, names=None):
        super().__init__(names)
        self.task = "obb"


class ClassifyMetrics:
    """Top-1 and top-5 accuracy: `process(targets (N,), preds (N, k) class indices, best first)`; fitness is their
    mean. `names` is accepted, as by the other metrics, and not used."""

    def __init__(self, names=None):
        self.top1 = 0.0
        self.top5 = 0.0
        self.speed = {"preprocess": 0.0, "inference": 0.0, "loss": 0.0, "postprocess": 0.0}
        self.task = "classify"

    def process(self, targets, preds) -> None:
        targets, preds = np.asarray(targets), np.asarray(preds)
        correct = preds == targets[:, None]
        self.top1 = float(correct[:, 0].mean()) if len(targets) else 0.0
        self.top5 = float(correct.any(1).mean()) if len(targets) else 0.0

    @property
    def fitness(self) -> float:
        return (self.top1 + self.top5) / 2

    @property
    def keys(self) -> list[str]:
        return ["metrics/accuracy_top1", "metrics/accuracy_top5"]

    @property
    def results_dict(self) -> dict:
        return dict(zip(self.keys + ["fitness"], [self.top1, self.top5, self.fitness]))

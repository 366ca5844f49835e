"""Batched greedy NMS with static output shapes, in three phases.

Counterpart of `drone_yolo_tpu/ops/nms.py:non_max_suppression`:

1. select the top K candidates per image, by best-class score (predict) or,
   with `multi_label` (validate), over all A * nc (anchor, class) scores (ties:
   lower index first, as `jax.lax.top_k`), gather the columns after the class
   scores (a pose model's keypoints) of each candidate's anchor, and offset each
   box by `class * MAX_WH`, so that boxes of different classes never overlap;
2. greedy keep mask over the K score-sorted candidates: on a CUDA tensor the
   hand-written kernels (`ops/cuda_nms.py`: a suppression bitmask, then a sweep
   over it), on a CPU tensor the plain version `greedy_keep_reference` below.
   `suppression_words_reference` and `sweep_reference` are the plain versions of
   the two kernels, one each; composed they give `greedy_keep_reference`'s mask;
3. compact the kept candidates, with their extra columns, into `max_det` slots,
   zero-padded, with a count.

`end2end_detections` takes the place of NMS for YOLOv10's NMS-free head (`v10Detect`), whose detections come sorted
from the model: it cuts them to `max_det` and keeps those above `conf_thres`, as the JAX package's end-to-end branch
(`drone_yolo_tpu/engine/predictor.py:147-152`), and with `classes` those of the classes given, as Ultralytics 8.3
(the JAX package ignores `classes` there).

`nms_rotated` is the oriented boxes' NMS (`drone_yolo_tpu/ops/nms.py:nms_rotated`): fast (matrix) suppression by
probiou, in plain tensor operations on the device, as the JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from drone_yolo_tpu_torch.ops import cuda_nms
from drone_yolo_tpu_torch.ops.boxes import probiou, xywh2xyxy

MAX_WH = 7680  # class offset: boxes of different classes never overlap


def iou_matrix(boxes: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., K, 4) -> (..., K, K), as `inter / (area_i + area_j - inter + eps)`."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    iw = (torch.minimum(x2[..., :, None], x2[..., None, :]) - torch.maximum(x1[..., :, None], x1[..., None, :])).clamp(min=0)
    ih = (torch.minimum(y2[..., :, None], y2[..., None, :]) - torch.maximum(y1[..., :, None], y1[..., None, :])).clamp(min=0)
    inter = iw * ih
    return inter / (area[..., :, None] + area[..., None, :] - inter + eps)


def greedy_keep_reference(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Plain greedy-NMS keep mask: (B, K, 4) score-sorted xyxy boxes, (B, K) bool -> (B, K) bool.

    Iterates `keep[j] = valid[j] and no kept i < j has iou(i, j) > thr` from
    keep = valid to its unique fixed point, which is sequential greedy NMS.
    """
    k = boxes.shape[1]
    adj = torch.triu(iou_matrix(boxes.float()) > iou_thres, 1).float()  # adj[i, j]: i suppresses j
    keep, prev = valid, torch.zeros_like(valid)
    for _ in range(k):
        if torch.equal(keep, prev):
            break
        received = torch.bmm(keep.float()[:, None, :], adj)[:, 0]
        keep, prev = valid & (received == 0), keep
    return keep


def suppression_words_reference(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Plain suppression bitmask: (B, K, 4) score-sorted xyxy boxes, (B, K) bool -> (B, K, ceil(K/64)) int64.

    Bit t of word [b, i, c] says that row i suppresses column j = 64 c + t: `valid[b, i]`, j > i, j < K and
    iou(i, j) > thr. Bit 63 is the sign bit of the int64 word.
    """
    b, k = valid.shape
    nb = -(-k // cuda_nms.WORD_BITS)
    sup = torch.triu(iou_matrix(boxes.float()) > iou_thres, 1) & valid[:, :, None]
    bits = torch.nn.functional.pad(sup, (0, nb * cuda_nms.WORD_BITS - k)).view(b, k, nb, cuda_nms.WORD_BITS)
    shifts = torch.arange(cuda_nms.WORD_BITS, device=boxes.device)
    return (bits.long() << shifts).sum(-1)  # distinct bits: the sum is their OR, 1 << 63 wraps to the sign bit


def sweep_reference(words: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain sweep over a suppression bitmask: (B, K, ceil(K/64)) int64 words, (B, K) bool -> (B, K) bool keep.

    Row i is kept if it is valid and no kept row before it has i's bit; a kept row ORs its words into `removed`.
    """
    b, k = valid.shape
    keep = torch.zeros_like(valid)
    removed = torch.zeros((b, words.shape[2]), dtype=torch.int64, device=words.device)
    zero = torch.zeros((), dtype=torch.int64, device=words.device)
    for i in range(k):
        c, t = divmod(i, cuda_nms.WORD_BITS)
        keep[:, i] = valid[:, i] & ((removed[:, c] >> t) & 1 == 0)
        removed |= torch.where(keep[:, i, None], words[:, i], zero)
    return keep


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Greedy keep mask: the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if boxes.is_cuda:
        return cuda_nms.greedy_keep_cuda(boxes, valid, iou_thres)
    if boxes.device.type != "cpu":
        raise ValueError(f"greedy_keep runs on cuda or cpu tensors, got {boxes.device}")
    return greedy_keep_reference(boxes, valid, iou_thres)


def select_candidates(preds: torch.Tensor, conf_thres: float, pre_topk: int, classes=None, agnostic: bool = False,
                      multi_label: bool = False, nc: int = 0):
    """Phase 1: per image the top-K candidates: anchors by best-class score, or with `multi_label` the
    (anchor, class) pairs of the flat A * nc scores, K = min(pre_topk, A * nc); anchor idx // nc, class idx % nc.
    `nc` = 0 reads every column after the box as a class score; otherwise the columns after the nc scores are
    extra columns, gathered by each candidate's anchor.

    Returns xyxy boxes (B, K, 4), scores (B, K), classes as float (B, K),
    validity `score > conf_thres` (B, K), the class-offset boxes (B, K, 4) and the extra columns (B, K, ch - 4 - nc).
    """
    b, a, ch = preds.shape
    nc = nc or ch - 4
    boxes = xywh2xyxy(preds[..., :4])
    scores, extra = preds[..., 4:4 + nc], preds[..., 4 + nc:]
    if classes is not None:  # zero the scores of the other classes
        mask = torch.zeros(nc, dtype=scores.dtype, device=preds.device)
        mask[torch.as_tensor(classes, dtype=torch.long).reshape(-1)] = 1.0
        scores = scores * mask
    if multi_label:
        k = min(pre_topk, a * nc)
        # a stable descending sort puts equal scores in index order, as jax.lax.top_k
        top_scores, top_idx = scores.reshape(b, a * nc).sort(dim=-1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        anchor_idx, cls_idx = top_idx // nc, (top_idx % nc).to(preds.dtype)
    else:
        k = min(pre_topk, a)
        per_anchor, cls_all = scores.amax(-1), scores.argmax(-1)  # argmax: first maximum, as jnp.argmax
        top_scores, anchor_idx = per_anchor.sort(dim=-1, descending=True, stable=True)
        top_scores, anchor_idx = top_scores[:, :k], anchor_idx[:, :k]
        cls_idx = cls_all.gather(1, anchor_idx).to(preds.dtype)
    cand_boxes = boxes.gather(1, anchor_idx[..., None].expand(b, k, 4))
    cand_extra = extra.gather(1, anchor_idx[..., None].expand(b, k, extra.shape[2]))
    offset = torch.zeros_like(cls_idx) if agnostic else cls_idx * MAX_WH
    return cand_boxes, top_scores, cls_idx, top_scores > conf_thres, cand_boxes + offset[..., None], cand_extra


def compact(keep: torch.Tensor, cand_boxes, top_scores, cls_idx, max_det: int, cand_extra):
    """Phase 3: kept candidates first, in score order, into min(K, max_det) zero-padded slots, with their extra
    columns after the class."""
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)[:, :max_det]
    sel_valid = keep.gather(1, order)
    det = torch.cat((cand_boxes.gather(1, order[..., None].expand(-1, -1, 4)), top_scores.gather(1, order)[..., None],
                     cls_idx.gather(1, order)[..., None],
                     cand_extra.gather(1, order[..., None].expand(-1, -1, cand_extra.shape[2]))), -1)
    return det * sel_valid[..., None].to(det.dtype), sel_valid.sum(1, dtype=torch.int32)


def non_max_suppression(preds: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.7, max_det: int = 300,
                        pre_topk: int = 1024, classes=None, agnostic: bool = False, multi_label: bool = False,
                        nc: int = 0):
    """Batched NMS of decoded predictions.

    Args:
        preds: (B, A, 4 + nc [+ extra]) float32: xywh pixel boxes, sigmoid class scores, then extra columns (a pose
            model's decoded keypoints), which ride along with their candidates.
        classes: optional list of class indices to keep.
        multi_label: every (anchor, class) pair is a candidate (the validator's NMS), not only each
            anchor's best class (predict's).
        nc: the class count; 0 takes every column after the box as a class score.

    Returns:
        dets: (B, min(K, max_det), 6 + extra) [x1, y1, x2, y2, conf, cls, extra...], zero-padded.
        n_valid: (B,) int32 count of real detections per image.
    """
    cand_boxes, top_scores, cls_idx, valid, off_boxes, cand_extra = select_candidates(
        preds, conf_thres, pre_topk, classes, agnostic, multi_label, nc)
    keep = greedy_keep(off_boxes, valid, iou_thres)
    return compact(keep, cand_boxes, top_scores, cls_idx, max_det, cand_extra)


def end2end_detections(dets: torch.Tensor, conf_thres: float = 0.25, max_det: int = 300, classes=None):
    """An NMS-free head's detections (B, k, 6) [x1, y1, x2, y2, conf, cls], sorted by score -> (dets (B, min(k,
    max_det), 6), n_valid (B,) int32): the first `max_det` rows, those above `conf_thres` (of `classes`, when given)
    first and in order, the others zeroed. No NMS runs."""
    dets = dets[:, :max_det]
    keep = dets[..., 4] > conf_thres
    if classes is not None:
        keep &= torch.isin(dets[..., 5], torch.as_tensor(classes, dtype=dets.dtype, device=dets.device).reshape(-1))
    return compact(keep, dets[..., :4], dets[..., 4], dets[..., 5], max_det, dets[..., 6:])


def _fast_suppress(scores: torch.Tensor, over: torch.Tensor, conf_thres: float, same_cls=None) -> torch.Tensor:
    """Fast-NMS survivors of K candidates with `scores` (K,): valid (score > conf_thres) and not overlapped (`over`
    (K, K) bool, probiou >= iou) by any valid, higher-scored candidate (of the same class, where `same_cls` (K, K)
    says so), whether or not that one survives; equal scores rank by index, the lower first."""
    k = scores.shape[0]
    valid = scores > conf_thres
    idx = torch.arange(k, device=scores.device)
    si, sj = scores[:, None], scores[None, :]
    higher = (si > sj) | ((si == sj) & (idx[:, None] < idx[None, :]))
    sup = higher & over & valid[:, None]
    if same_cls is not None:
        sup &= same_cls
    return valid & ~sup.any(0)


def nms_rotated(preds: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.45, max_det: int = 300,
                pre_topk: int = 1024, nc: int = 0, multi_label: bool = False, classes=None):
    """Batched NMS of oriented boxes by probiou, with the JAX package's fast (matrix) suppression.

    Args:
        preds: (B, A, 4 + nc + 1) float32: cx, cy, w, h in pixels, the nc sigmoid class scores, the angle in radians.
        multi_label: every (anchor, class) score of the top K anchors is a candidate, each class suppressed on its
            own (the validator's NMS); otherwise each anchor's best class (the predictor's), suppressed within it.
        classes: optional list of class indices to keep: the other classes' scores are zeroed first, as in
            `non_max_suppression` (the JAX `nms_rotated` has no such filter).

    Per image the top K = min(pre_topk, A) anchors by best class score (ties to the lower index), their (K, K)
    probiou once, then fast suppression: a candidate goes if a valid, higher-scored candidate of its class overlaps
    it with probiou >= iou_thres. The kept ones are compacted by score (ties to the lower index).

    Returns:
        dets: (B, min(max_det, K [* nc]), 7) [cx, cy, w, h, angle, conf, cls], zero-padded.
        n_valid: (B,) int32 count of real detections per image.
    """
    b, a, _ = preds.shape
    nc = nc or preds.shape[2] - 5
    k = min(pre_topk, a)
    keep_cls = None
    if classes is not None:
        keep_cls = torch.zeros(nc, dtype=preds.dtype, device=preds.device)
        keep_cls[torch.as_tensor(classes, dtype=torch.long).reshape(-1)] = 1.0
    dets, counts = [], []
    for i in range(b):
        boxes, scores, angle = preds[i, :, :4], preds[i, :, 4:4 + nc], preds[i, :, 4 + nc:5 + nc]
        if keep_cls is not None:
            scores = scores * keep_cls
        _, idx = scores.amax(-1).sort(descending=True, stable=True)
        idx = idx[:k]
        sc = scores[idx]  # (K, nc)
        rb = torch.cat((boxes[idx], angle[idx]), -1)  # (K, 5)
        over = probiou(rb[:, None, :], rb[None, :, :]) >= iou_thres
        if multi_label and nc > 1:
            keep = torch.stack([_fast_suppress(sc[:, c], over, conf_thres) for c in range(nc)], 1)  # (K, nc)
            flat = torch.where(keep, sc, 0.0).reshape(-1)
            top_s, flat_idx = flat.sort(descending=True, stable=True)
            top_s, flat_idx = top_s[:max_det], flat_idx[:max_det]
            ai, ci = flat_idx // nc, (flat_idx % nc).to(preds.dtype)
        else:
            s, cls = sc.amax(-1), sc.argmax(-1).to(preds.dtype)  # argmax: the first maximum, as jnp.argmax
            keep = _fast_suppress(s, over, conf_thres, cls[:, None] == cls[None, :])
            top_s, ai = torch.where(keep, s, 0.0).sort(descending=True, stable=True)
            top_s, ai = top_s[:max_det], ai[:max_det]
            ci = cls[ai]
        sel = top_s > conf_thres
        det = torch.cat((rb[ai], top_s[:, None], ci[:, None]), -1)
        dets.append(det * sel[:, None].to(det.dtype))
        counts.append(sel.sum(dtype=torch.int32))
    return torch.stack(dets), torch.stack(counts)

"""Batched greedy NMS with static output shapes, in three phases.

Counterpart of `drone_yolo_tpu/ops/nms.py:non_max_suppression`:

1. select the top K candidates per image by best-class score (ties: lower
   anchor index first, as `jax.lax.top_k`) and offset each box by
   `class * MAX_WH`, so that boxes of different classes never overlap;
2. greedy keep mask over the K score-sorted candidates: on a CUDA tensor the
   hand-written kernel (`ops/cuda_nms.py`), on a CPU tensor its plain version
   `greedy_keep_reference` below;
3. compact the kept candidates into `max_det` slots, zero-padded, with a count.
"""

from __future__ import annotations

import torch

from drone_yolo_tpu_torch.ops import cuda_nms
from drone_yolo_tpu_torch.ops.boxes import xywh2xyxy

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


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Greedy keep mask: the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if boxes.is_cuda:
        return cuda_nms.greedy_keep_cuda(boxes, valid, iou_thres)
    if boxes.device.type != "cpu":
        raise ValueError(f"greedy_keep runs on cuda or cpu tensors, got {boxes.device}")
    return greedy_keep_reference(boxes, valid, iou_thres)


def select_candidates(preds: torch.Tensor, conf_thres: float, pre_topk: int, classes=None, agnostic: bool = False):
    """Phase 1: per image the top-K anchors by best-class score.

    Returns xyxy boxes (B, K, 4), scores (B, K), classes as float (B, K),
    validity `score > conf_thres` (B, K) and the class-offset boxes (B, K, 4).
    """
    b, a, ch = preds.shape
    boxes = xywh2xyxy(preds[..., :4])
    scores = preds[..., 4:]
    if classes is not None:  # zero the scores of the other classes
        mask = torch.zeros(ch - 4, dtype=scores.dtype, device=preds.device)
        mask[torch.as_tensor(classes, dtype=torch.long).reshape(-1)] = 1.0
        scores = scores * mask
    k = min(pre_topk, a)
    per_anchor, cls_all = scores.amax(-1), scores.argmax(-1)  # argmax: first maximum, as jnp.argmax
    top_scores, anchor_idx = per_anchor.sort(dim=-1, descending=True, stable=True)
    top_scores, anchor_idx = top_scores[:, :k], anchor_idx[:, :k]
    cls_idx = cls_all.gather(1, anchor_idx).to(preds.dtype)
    cand_boxes = boxes.gather(1, anchor_idx[..., None].expand(b, k, 4))
    offset = torch.zeros_like(cls_idx) if agnostic else cls_idx * MAX_WH
    return cand_boxes, top_scores, cls_idx, top_scores > conf_thres, cand_boxes + offset[..., None]


def compact(keep: torch.Tensor, cand_boxes, top_scores, cls_idx, max_det: int):
    """Phase 3: kept candidates first, in score order, into min(K, max_det) zero-padded slots."""
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)[:, :max_det]
    sel_valid = keep.gather(1, order)
    det = torch.cat((cand_boxes.gather(1, order[..., None].expand(-1, -1, 4)),
                     top_scores.gather(1, order)[..., None], cls_idx.gather(1, order)[..., None]), -1)
    return det * sel_valid[..., None].to(det.dtype), sel_valid.sum(1, dtype=torch.int32)


def non_max_suppression(preds: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.7, max_det: int = 300,
                        pre_topk: int = 1024, classes=None, agnostic: bool = False):
    """Batched NMS of decoded predictions.

    Args:
        preds: (B, A, 4 + nc) float32: xywh pixel boxes, then sigmoid class scores.
        classes: optional list of class indices to keep.

    Returns:
        dets: (B, min(K, max_det), 6) [x1, y1, x2, y2, conf, cls], zero-padded.
        n_valid: (B,) int32 count of real detections per image.
    """
    cand_boxes, top_scores, cls_idx, valid, off_boxes = select_candidates(preds, conf_thres, pre_topk, classes, agnostic)
    keep = greedy_keep(off_boxes, valid, iou_thres)
    return compact(keep, cand_boxes, top_scores, cls_idx, max_det)

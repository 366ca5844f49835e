"""Tiled (SAHI-style) inference over large aerial frames, and dataset tiling.

Counterpart of `drone_yolo_tpu/ops/tiling.py`. `get_windows`, `crop_windows` and `crop_labels` are integer-exact
copies, in numpy on the host. `tiled_inference` uploads the crops of one frame in one copy, runs
`forward_fn(variables, batch)` on batches of `max_crop_batch` crops (the last one padded with zero crops, as the
JAX package keeps its batch shape static), offsets each crop's detections to frame coordinates and merges them with
one greedy NMS on the device (`ops/nms.py:greedy_keep`: the CUDA kernel on the card, its plain version on the CPU)
over the merged set sorted by score, boxes offset by class x 7680. Its keep set is that of the JAX package's host
loop `_greedy_nms_np`, which computes the same IoU, where scores are distinct; on tied scores the two may keep
different members of a tie (numpy's `argsort(-scores)` is not stable). The kept rows come out in score order, cut
to `max_det`.
"""

from __future__ import annotations

import numpy as np
import torch

from drone_yolo_tpu_torch.ops import nms


def get_windows(im_shape, crop_size: int = 640, gap: int = 128, im_rate_thr: float = 0.6):
    """Sliding windows covering (h, w): (N, 4) xyxy (reference split_dota.py:97).

    Windows step by crop_size - gap; edge windows are shifted inside the image.
    """
    h, w = im_shape
    step = crop_size - gap
    if step <= 0:
        raise ValueError("gap must be smaller than crop_size")

    xs = list(range(0, max(w - gap, 1), step))
    if xs and xs[-1] + crop_size > w:
        xs[-1] = max(w - crop_size, 0)
    ys = list(range(0, max(h - gap, 1), step))
    if ys and ys[-1] + crop_size > h:
        ys[-1] = max(h - crop_size, 0)

    wins = []
    for y in sorted(set(ys)):
        for x in sorted(set(xs)):
            wins.append([x, y, min(x + crop_size, w), min(y + crop_size, h)])
    return np.asarray(wins, dtype=np.int64)


def crop_windows(img: np.ndarray, windows: np.ndarray, crop_size: int, pad_value: int = 114):
    """Extract fixed-size crops (padding bottom/right when a window is clipped)."""
    n = len(windows)
    out = np.full((n, crop_size, crop_size, img.shape[2]), pad_value, dtype=img.dtype)
    for i, (x1, y1, x2, y2) in enumerate(windows):
        out[i, : y2 - y1, : x2 - x1] = img[y1:y2, x1:x2]
    return out


def tiled_inference(forward_fn, variables, img: np.ndarray, crop_size: int = 640, gap: int = 128,
                    max_crop_batch: int = 16, conf: float = 0.25, iou: float = 0.7, max_det: int = 300, device=None):
    """Run `forward_fn(variables, batch) -> (dets, n_valid)` over the tiles of one frame and merge them.

    Args:
        forward_fn: forward + NMS over a (B, 3, crop, crop) float32 batch in [0, 1] on `device` (the frame's
            channels in their order), returning per-crop detections (B, max_det, 6+) and counts (B,).
        img: HWC uint8 frame of arbitrary size.
        device: where the crops go (CUDA by default).

    Returns (M, 6+) float32 numpy merged detections in frame coordinates.
    """
    dev = torch.device(device if device is not None else "cuda")
    windows = get_windows(img.shape[:2], crop_size, gap)
    crops = torch.from_numpy(crop_windows(img, windows, crop_size)).to(dev)  # one upload
    # / 255 by a tensor on the device: CUDA divides by a Python scalar as a product with its reciprocal
    crops = crops.permute(0, 3, 1, 2).float() / torch.tensor(255.0, device=dev)

    all_dets = []
    for s in range(0, len(crops), max_crop_batch):
        batch = crops[s : s + max_crop_batch]
        if len(batch) < max_crop_batch:  # static batch shape: pad with zeros
            batch = torch.cat([batch, batch.new_zeros((max_crop_batch - len(batch), *batch.shape[1:]))])
        dets, n_valid = forward_fn(variables, batch)
        n_valid = torch.as_tensor(n_valid).tolist()
        for i in range(min(len(crops) - s, max_crop_batch)):
            d = torch.as_tensor(dets[i, : int(n_valid[i])], device=dev).float().clone()
            if len(d):
                d[:, [0, 2]] += int(windows[s + i, 0])
                d[:, [1, 3]] += int(windows[s + i, 1])
                all_dets.append(d)

    if not all_dets:
        return np.zeros((0, 6), np.float32)
    merged = torch.cat(all_dets)
    merged = merged[torch.argsort(merged[:, 4], descending=True, stable=True)]
    boxes = (merged[:, :4] + merged[:, 5:6] * nms.MAX_WH).contiguous()
    keep = nms.greedy_keep(boxes[None], torch.ones_like(boxes[None, :, 0], dtype=torch.bool), iou)[0]
    return merged[keep][:max_det].cpu().numpy()


def crop_labels(labels_xyxy: np.ndarray, cls: np.ndarray, window, iof_thr: float = 0.7):
    """Clip labels into a window, keeping boxes with intersection-over-foreground
    >= iof_thr (reference split_dota.py get_window_obj semantics)."""
    x1, y1, x2, y2 = window
    if len(labels_xyxy) == 0:
        return labels_xyxy, cls
    ix1 = np.maximum(labels_xyxy[:, 0], x1)
    iy1 = np.maximum(labels_xyxy[:, 1], y1)
    ix2 = np.minimum(labels_xyxy[:, 2], x2)
    iy2 = np.minimum(labels_xyxy[:, 3], y2)
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area = (labels_xyxy[:, 2] - labels_xyxy[:, 0]) * (labels_xyxy[:, 3] - labels_xyxy[:, 1])
    keep = inter / (area + 1e-9) >= iof_thr
    out = np.stack([ix1, iy1, ix2, iy2], 1)[keep] - np.array([x1, y1, x1, y1])
    return out.astype(np.float32), cls[keep]

"""Dataset helpers of the train slice: the static GT-slot count of a collated batch.

The collate format (`drone_yolo_tpu/data/dataset.py:YOLODataset.collate`) is a dict of
numpy arrays: `img` (B, H, W, 3) uint8 RGB, `cls` (B, M) float32 class ids, `bboxes`
(B, M, 4) float32 xyxy pixels and `mask` (B, M) float32 slot validity, with M from
`round_label_slots`. The file dataset and its loader come with the trainer loop.
"""

from __future__ import annotations


def round_label_slots(n_max: int, headroom: float) -> int:
    """GT slots per image: n_max labels x augmentation headroom, rounded up to a multiple of 32 (up to 128
    needed) or 128, at least 32 and at most 2048 (`drone_yolo_tpu/data/dataset.py:round_label_slots`)."""
    need = int(max(n_max * headroom, 1))
    q = 32 if need <= 128 else 128
    return min(max(32, -(-need // q) * q), 2048)

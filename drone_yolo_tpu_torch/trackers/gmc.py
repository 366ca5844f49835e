"""Global motion compensation for BoT-SORT: the camera's motion from one frame to the next, by sparse optical flow
on the frame's device.

Counterpart of `drone_yolo_tpu/trackers/gmc.py` (`GMC`), whose sparseOptFlow path calls cv2; the port computes
the same steps in tensor operations (`ops/image.py:bgr_to_gray_u8`, `ops/letterbox.py:resize_linear_u8`,
`ops/flow.py`), branch for branch: the frame in grey, halved (`downscale` 2); its corners; the first frame stores
them and gives the identity; a frame without corners gives the identity and is not stored; otherwise the previous
corners are tracked into this frame, and the similarity (rotation, scale, translation) fitted by RANSAC to the
tracked pairs, its translation scaled back by `downscale`, is the warp; with 4 tracked pairs or fewer a warning
and the identity. A tensor frame is used where it lies (the predictor's upload); a numpy frame is uploaded to
`device` (CUDA by default). On a CUDA device the optical flow runs as CUDA graphs (`ops/flow.py:FlowGraphs`). Only
the 2x3 float32 warp comes back to the host.

Method `none` and any unknown method give the identity, as in the JAX package. Its `orb`, `sift` and `ecc`
methods are refused by name (ROADMAP.md queue 1).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from drone_yolo_tpu_torch.ops import flow
from drone_yolo_tpu_torch.ops.image import bgr_to_gray_u8
from drone_yolo_tpu_torch.ops.letterbox import resize_linear_u8

LOGGER = logging.getLogger("drone_yolo_tpu_torch")
UNPORTED_METHODS = ("orb", "sift", "ecc")


class GMC:
    """Global motion compensation between frames for BoT-SORT (reference utils/gmc.py:11)."""

    def __init__(self, method: str = "sparseOptFlow", downscale: int = 2, device=None):
        if method in UNPORTED_METHODS:
            raise NotImplementedError(f"gmc_method {method!r} is not ported yet (ported: sparseOptFlow, none; "
                                      "ROADMAP.md queue 1 item 5)")
        self.method = method
        self.downscale = max(1, int(downscale))
        self.device = torch.device(device if device is not None else "cuda")
        self.graphs = flow.FlowGraphs()  # the optical flow's CUDA graphs, for frames on a CUDA device
        self.prev_frame = None
        self.prev_kpts = None
        self.initialized = False

    def apply(self, raw_frame, detections=None) -> np.ndarray:
        """Returns 2x3 affine warp from previous to current frame."""
        if self.method == "sparseOptFlow":
            return self._apply_sparse_optflow(raw_frame)
        return np.eye(2, 3, dtype=np.float32)

    def preprocess(self, raw_frame) -> torch.Tensor:
        """A uint8 BGR frame (H, W, 3), tensor or numpy -> its grey (H, W) uint8 on the device, `downscale` times
        smaller (cv2.resize's INTER_LINEAR)."""
        if not torch.is_tensor(raw_frame):
            raw_frame = torch.from_numpy(np.ascontiguousarray(raw_frame)).to(self.device)
        frame = bgr_to_gray_u8(raw_frame)
        if self.downscale > 1:
            h, w = frame.shape
            frame = resize_linear_u8(frame[None, :, :, None], (h // self.downscale, w // self.downscale))[0, :, :, 0]
        return frame

    def _apply_sparse_optflow(self, raw_frame) -> np.ndarray:
        h = np.eye(2, 3, dtype=np.float32)
        frame = self.preprocess(raw_frame)
        kpts = flow.good_features_to_track(frame)
        if not self.initialized or self.prev_kpts is None:
            self.prev_frame, self.prev_kpts = frame, kpts
            self.initialized = True
            return h
        if kpts is None:
            return h
        next_kpts, status = flow.calc_optical_flow_pyr_lk(self.prev_frame, frame, self.prev_kpts, graphs=self.graphs)
        ok = status.flatten() == 1
        prev_pts, curr_pts = self.prev_kpts[ok], next_kpts[ok]
        if len(prev_pts) > 4:
            m, _ = flow.estimate_affine_partial_2d(prev_pts, curr_pts)
            if m is not None:
                h = m.astype(np.float32)
                if self.downscale > 1:
                    h[0, 2] *= self.downscale
                    h[1, 2] *= self.downscale
        else:
            LOGGER.warning("GMC: not enough matching points")
        self.prev_frame, self.prev_kpts = frame, kpts
        return h

    def reset_params(self) -> None:
        self.prev_frame = None
        self.prev_kpts = None
        self.initialized = False

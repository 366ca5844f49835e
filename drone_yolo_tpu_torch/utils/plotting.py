"""Drawing results and train batches: the color palette, `Annotator` and `plot_images`, without cv2.

Counterpart of `drone_yolo_tpu/utils/plotting.py` (`Colors`, `colors`, `SKELETON`, `Annotator`'s `box_label`,
`obb_label`, `masks`, `kpts`, `text` and `result`, `plot_images`). Every call the JAX package makes to cv2 goes to
`ops/draw.py`, which draws the same pixels; only the glyphs of text differ (the port's stroke font inside the same
text box). `plot_images` writes its mosaic with the port's JPEG encoder at quality 95, `cv2.imwrite`'s default, and
runs in a daemon thread unless called with `threaded=False`; a mosaic larger than `max_size` is shrunk with
`ops/letterbox.py:resize_linear_u8` (INTER_LINEAR; equal to cv2 at integer factors, within 1 at others).

The solution primitives of the JAX Annotator (`draw_region`, `draw_centroid_and_tracks`, `queue_counts_display`,
`display_objects_labels`, `display_analytics`, `estimate_pose_angle`, `plot_angle_and_count_and_stage`,
`plot_distance_and_line`, `visioneye`) draw the same shapes through `ops/draw.py`. `plot_results`, `plot_labels` and
`feature_visualization`, which draw with matplotlib, are not ported.
"""

from __future__ import annotations

import functools
import math
import threading
from pathlib import Path

import numpy as np
import torch

from drone_yolo_tpu_torch.data.jpeg import encode_jpeg
from drone_yolo_tpu_torch.ops import draw
from drone_yolo_tpu_torch.ops.letterbox import resize_linear_u8, resize_nearest


class Colors:
    """The Ultralytics palette: 20 class colors (RGB, or BGR with `bgr=True`) and the 20 pose colors."""

    def __init__(self):
        hexs = ("042AFF", "0BDBEB", "F3F3F3", "00DFB7", "111F68", "FF6FDD", "FF444F", "CCED00", "00F344", "BD00FF",
                "00B4FF", "DD00BA", "00FFFF", "26C000", "01FFB3", "7D24FF", "7B0068", "FF1B6C", "FC6D2F", "A2FF0B")
        self.palette = [self.hex2rgb(f"#{c}") for c in hexs]
        self.n = len(self.palette)
        self.pose_palette = np.array(
            [[255, 128, 0], [255, 153, 51], [255, 178, 102], [230, 230, 0], [255, 153, 255], [153, 204, 255],
             [255, 102, 255], [255, 51, 255], [102, 178, 255], [51, 153, 255], [255, 153, 153], [255, 102, 102],
             [255, 51, 51], [153, 255, 153], [102, 255, 102], [51, 255, 51], [0, 255, 0], [0, 0, 255], [255, 0, 0],
             [255, 255, 255]], dtype=np.uint8)

    def __call__(self, i, bgr: bool = False):
        c = self.palette[int(i) % self.n]
        return (c[2], c[1], c[0]) if bgr else c

    @staticmethod
    def hex2rgb(h):
        return tuple(int(h[1 + i:1 + i + 2], 16) for i in (0, 2, 4))


colors = Colors()

# the COCO keypoint skeleton, 1-based keypoint indices
SKELETON = [[16, 14], [14, 12], [17, 15], [15, 13], [12, 13], [6, 12], [7, 13], [6, 7], [6, 8], [7, 9], [8, 10],
            [9, 11], [2, 3], [1, 2], [1, 3], [2, 4], [3, 5], [4, 6], [5, 7]]


class Annotator:
    """Draws on a copy-free, contiguous BGR uint8 image: line width lw (by default max(round((h + w + c) / 2 *
    0.003), 2)), font scale lw / 3 and font thickness max(lw - 1, 1)."""

    def __init__(self, im, line_width=None, font_size=None, example: str = ""):
        self.im = np.ascontiguousarray(im if im.flags.writeable else im.copy())
        self.lw = line_width or max(round(sum(im.shape) / 2 * 0.003), 2)
        self.sf = self.lw / 3
        self.tf = max(self.lw - 1, 1)
        self.limb_color = colors.pose_palette[[9, 9, 9, 9, 7, 7, 7, 0, 0, 0, 0, 0, 16, 16, 16, 16, 16, 16, 16]]
        self.kpt_color = colors.pose_palette[[16, 16, 16, 16, 16, 0, 0, 0, 0, 0, 0, 9, 9, 9, 9, 9, 9]]

    def box_label(self, box, label: str | None = None, color=(128, 128, 128), txt_color=(255, 255, 255)):
        """The box (x1, y1, x2, y2, truncated to int) outlined anti-aliased; the label on a filled rectangle above it,
        or below its top edge when there are fewer than 3 pixels above."""
        p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
        draw.rectangle(self.im, p1, p2, color, thickness=self.lw, line_type=draw.LINE_AA)
        if label:
            w, h = draw.get_text_size(label, self.sf, self.tf)[0]
            outside = p1[1] - h >= 3
            p2 = p1[0] + w, p1[1] - h - 3 if outside else p1[1] + h + 3
            draw.rectangle(self.im, p1, p2, color, draw.FILLED, draw.LINE_AA)
            draw.put_text(self.im, label, (p1[0], p1[1] - 2 if outside else p1[1] + h + 2), self.sf, txt_color,
                          self.tf, draw.LINE_AA)

    def obb_label(self, corners, label: str | None = None, color=(128, 128, 128), txt_color=(255, 255, 255)):
        """The rotated box's four corners (truncated to int) as a closed LINE_8 polyline; the label at its first
        corner, without a background."""
        pts = np.asarray(corners, dtype=np.int32).reshape(-1, 1, 2)
        draw.polylines(self.im, [pts], True, color, self.lw)
        if label:
            draw.put_text(self.im, label, tuple(pts[0, 0]), self.sf, txt_color, self.tf, draw.LINE_AA)

    def masks(self, masks, mask_colors, alpha: float = 0.5):
        """Overlay (N, H, W) binary masks (resized nearest to the image when their size differs) in their colors,
        then blend the overlay into the image with weight `alpha`."""
        if len(masks) == 0:
            return
        h, w = self.im.shape[:2]
        overlay = self.im.copy()
        for m, c in zip(masks, mask_colors):
            m8 = np.asarray(m).astype(np.uint8)
            if m8.shape != (h, w):
                m8 = resize_nearest(torch.from_numpy(m8), (h, w)).numpy()
            overlay[m8.astype(bool)] = c
        self.im = draw.add_weighted(self.im, 1 - alpha, overlay, alpha, 0)

    def kpts(self, kpts, shape=(640, 640), radius: int = 5, kpt_line: bool = True, conf_thres: float = 0.25):
        """Keypoints (K, 2 or 3) as filled anti-aliased circles inside `shape` (h, w), those under `conf_thres`
        left out; for 17 COCO keypoints in the pose colors with the skeleton, else in the class palette (RGB)."""
        nk, nd = kpts.shape
        is_pose = nk == 17 and nd in {2, 3}
        for i, k in enumerate(kpts):
            if nd == 3 and k[2] < conf_thres:
                continue
            x, y = int(k[0]), int(k[1])
            if 0 < x < shape[1] and 0 < y < shape[0]:
                color = tuple(int(c) for c in self.kpt_color[i]) if is_pose else colors(i)
                draw.circle(self.im, (x, y), radius, color, -1, line_type=draw.LINE_AA)
        if kpt_line and is_pose:
            for i, sk in enumerate(SKELETON):
                p1, p2 = kpts[sk[0] - 1], kpts[sk[1] - 1]
                if nd == 3 and (p1[2] < conf_thres or p2[2] < conf_thres):
                    continue
                draw.line(self.im, (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1])),
                          tuple(int(c) for c in self.limb_color[i]), thickness=2, line_type=draw.LINE_AA)

    def text(self, xy, text: str, txt_color=(255, 255, 255)):
        """Lines of text, the i-th (from 1) with its baseline 20 i pixels below xy."""
        for i, line in enumerate(text.split("\n")):
            draw.put_text(self.im, line, (xy[0], xy[1] + 20 * (i + 1)), self.sf, txt_color, self.tf, draw.LINE_AA)

    # -- solution primitives -------------------------------------------------------------------------------------
    def draw_region(self, reg_pts, color=(0, 255, 0), thickness: int = 5):
        """The region's closed polygon and a filled pin of radius 2 x thickness at each vertex."""
        pts = np.asarray(reg_pts, np.int32).reshape(-1, 1, 2)
        draw.polylines(self.im, [pts], True, color, thickness)
        for p in pts[:, 0]:
            draw.circle(self.im, (int(p[0]), int(p[1])), thickness * 2, color, -1)

    def draw_centroid_and_tracks(self, track, color=(255, 0, 255), track_thickness: int = 2):
        """A track's open polyline and a dot of radius 2 x thickness at its last point."""
        pts = np.asarray(track, np.int32).reshape(-1, 1, 2)
        draw.polylines(self.im, [pts], False, color, track_thickness)
        draw.circle(self.im, (int(track[-1][0]), int(track[-1][1])), track_thickness * 2, color, -1)

    def _label_box(self, center, label, bg_color, txt_color, margin: int = 5):
        """`label` on a filled box centred at `center`, `margin` px around the text."""
        (tw, th), _ = draw.get_text_size(label, self.sf, self.tf)
        x, y = int(center[0] - tw / 2), int(center[1] + th / 2)
        draw.rectangle(self.im, (x - margin, y - th - margin), (x + tw + margin, y + margin), bg_color, -1)
        draw.put_text(self.im, label, (x, y), self.sf, txt_color, self.tf, draw.LINE_AA)

    def queue_counts_display(self, label, points=None, region_color=(255, 255, 255), txt_color=(0, 0, 0)):
        """The queue count on a box at the mean of the region's points."""
        pts = np.asarray(points, np.float32)
        self._label_box((pts[:, 0].mean(), pts[:, 1].mean()), label, region_color, txt_color, margin=10)

    def display_objects_labels(self, im0, text, txt_color, bg_color, x_center, y_center, margin: int = 5):
        """A region's count label centred at (x_center, y_center), drawn on im0."""
        self.im = im0
        self._label_box((x_center, y_center), text, bg_color, txt_color, margin)

    def display_analytics(self, im0, text: dict, txt_color=(255, 255, 255), bg_color=(104, 31, 17), margin: int = 10):
        """`key: value` lines on filled boxes down the top-right corner of im0."""
        self.im = im0
        offset = 0
        for k, v in text.items():
            line = f"{k}: {v}"
            (tw, th), _ = draw.get_text_size(line, self.sf, self.tf)
            x, y = im0.shape[1] - tw - 2 * margin, th + 2 * margin + offset
            draw.rectangle(self.im, (x - margin, y - th - margin), (x + tw + margin, y + margin), bg_color, -1)
            draw.put_text(self.im, line, (x, y), self.sf, txt_color, self.tf, draw.LINE_AA)
            offset += th + 3 * margin

    @staticmethod
    def estimate_pose_angle(a, b, c):
        """The inner angle ABC in degrees (float32 points)."""
        a, b, c = (np.asarray(p, np.float32) for p in (a, b, c))
        ang = abs(np.degrees(np.arctan2(c[1] - b[1], c[0] - b[0]) - np.arctan2(a[1] - b[1], a[0] - b[0])))
        return 360.0 - ang if ang > 180.0 else ang

    def plot_angle_and_count_and_stage(self, angle_text, count_text, stage_text, center_kpt, color=(104, 31, 17),
                                       txt_color=(255, 255, 255)):
        """Angle, reps and stage, each on a filled box, stacked down from a joint."""
        x, y = int(center_kpt[0]), int(center_kpt[1])
        for i, line in enumerate((f"Angle: {angle_text}", f"Reps: {count_text}", f"Stage: {stage_text}")):
            (tw, th), _ = draw.get_text_size(line, self.sf, self.tf)
            yy = y + i * (th + 12)
            draw.rectangle(self.im, (x - 5, yy - th - 5), (x + tw + 5, yy + 5), color, -1)
            draw.put_text(self.im, line, (x, yy), self.sf, txt_color, self.tf, draw.LINE_AA)

    def plot_distance_and_line(self, pixels_distance, centroids, line_color=(104, 31, 17),
                               centroid_color=(255, 0, 255)):
        """The pixel distance on a box at the top left; a line between the two centroids and a dot on each."""
        label = f"Pixels Distance: {pixels_distance:.2f}"
        (tw, th), _ = draw.get_text_size(label, self.sf, self.tf)
        draw.rectangle(self.im, (15, 25), (15 + tw + 20, 25 + th + 20), line_color, -1)
        draw.put_text(self.im, label, (25, 25 + th + 10), self.sf, (255, 255, 255), self.tf, draw.LINE_AA)
        c0 = (int(centroids[0][0]), int(centroids[0][1]))
        c1 = (int(centroids[1][0]), int(centroids[1][1]))
        draw.line(self.im, c0, c1, line_color, 3)
        draw.circle(self.im, c0, 6, centroid_color, -1)
        draw.circle(self.im, c1, 6, centroid_color, -1)

    def visioneye(self, box, center_point, color=(235, 219, 11), pin_color=(255, 0, 255)):
        """A dot at the box's centre, a pin at `center_point` and a line between them."""
        cx, cy = int((box[0] + box[2]) / 2), int((box[1] + box[3]) / 2)
        draw.circle(self.im, (cx, cy), 6, color, -1)
        draw.circle(self.im, (int(center_point[0]), int(center_point[1])), 6, pin_color, -1)
        draw.line(self.im, (int(center_point[0]), int(center_point[1])), (cx, cy), color, 2)

    def result(self):
        return self.im


def threaded(func):
    """Run the decorated function in a daemon thread and return the thread, unless called with threaded=False."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if kwargs.pop("threaded", True):
            t = threading.Thread(target=func, args=args, kwargs=kwargs, daemon=True)
            t.start()
            return t
        return func(*args, **kwargs)

    return wrapper


@threaded
def plot_images(images, batch_idx, cls, bboxes=None, paths=None, fname="images.jpg", names=None, max_size: int = 1920,
                max_subplots: int = 16, save: bool = True):
    """Tile a batch (B, H, W, 3) RGB (uint8, or float in [0, 1]) into a mosaic of ceil(sqrt(B)) columns, column by
    column, and draw its labels: `bboxes` pixel xyxy of image `batch_idx` with class `cls`, named by `names`. Writes
    `fname` (JPEG, quality 95) when `save`; returns the BGR mosaic."""
    images = np.asarray(images)
    if images.dtype in (np.float32, np.float64):
        images = (np.asarray(images, np.float32) * 255).astype(np.uint8)
    bs, h, w, _ = images.shape
    bs = min(bs, max_subplots)
    ns = math.ceil(bs ** 0.5)
    mosaic = np.full((int(ns * h), int(ns * w), 3), 255, dtype=np.uint8)
    for i in range(bs):
        x, y = int(w * (i // ns)), int(h * (i % ns))
        mosaic[y:y + h, x:x + w] = images[i][..., ::-1]  # RGB -> BGR
    scale = max_size / ns / max(h, w)
    if scale < 1:
        size = (int(ns * h * scale), int(ns * w * scale))
        mosaic = resize_linear_u8(torch.from_numpy(mosaic)[None], size)[0].numpy()
    ann = Annotator(mosaic, line_width=2)
    for i in range(bs):
        x, y = int(w * (i // ns) * min(scale, 1)), int(h * (i % ns) * min(scale, 1))
        if bboxes is not None and len(bboxes):
            sel = np.asarray(batch_idx) == i
            bb = np.asarray(bboxes)[sel] * min(scale, 1)
            for b, c in zip(bb, np.asarray(cls)[sel]):
                ann.box_label([b[0] + x, b[1] + y, b[2] + x, b[3] + y], (names or {}).get(int(c), str(int(c))),
                              color=colors(int(c), True))
    if save:
        Path(fname).write_bytes(encode_jpeg(np.ascontiguousarray(ann.result()[..., ::-1]), quality=95))
    return ann.result()

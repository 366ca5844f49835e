"""The port's host image operations (`drone_yolo_tpu_torch/ops/image.py`) against cv2 on uint8 images.

- `warp_affine_u8` against `cv2.warpAffine(borderValue=114)` at the matrices that seeded
  `RandomPerspective` draws give (default hyperparameters, and with rotation and shear), on
  a mosaic-sized canvas warped to the train size: within 1 everywhere, and exact at integer
  translations;
- `get_rotation_matrix_2d` against `cv2.getRotationMatrix2D`;
- RGB -> HSV exactly equal; HSV -> RGB equal to cv2 pixel by pixel (OpenCV's scalar code) and
  within 1 of cv2 on whole images (its vector code rounds differently); `RandomHSV` within 1 of
  the JAX package's on the same draws;
- `resize_area_u8` within 1 of INTER_AREA and exact at a factor of 2;
- the letterbox without enlarging equal to the JAX package's `letterbox_np(scaleup=False)`.
"""

import math
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from drone_yolo_tpu.data import augment as JA
from drone_yolo_tpu.ops.letterbox import letterbox_np
from drone_yolo_tpu_torch.data import augment as A
from drone_yolo_tpu_torch.ops.image import (get_rotation_matrix_2d, hsv_to_rgb_u8, resize_area_u8, rgb_to_hsv_u8,
                                            warp_affine_u8)
from drone_yolo_tpu_torch.ops.letterbox import letterbox_u8

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from dense_dataset import make_dense_image  # noqa: E402

DEFAULT = dict(degrees=0.0, translate=0.1, scale=0.5, shear=0.0)
ROTATE_SHEAR = dict(degrees=10.0, translate=0.1, scale=0.5, shear=5.0)


@pytest.fixture(scope="module")
def canvas():
    """A (320, 320) mosaic-like canvas of dense-proxy content with a 114 margin, as a 160 px train size sees it."""
    img, _ = make_dense_image(np.random.default_rng(3), size=256, obj_px=(4, 12))
    out = np.full((320, 320, 3), 114, np.uint8)
    out[20:276, 40:296] = img
    return out


@pytest.mark.parametrize("hyp", [DEFAULT, ROTATE_SHEAR], ids=["default", "rotate_shear"])
@pytest.mark.parametrize("index", range(4))
def test_warp_affine_within_one_of_cv2(canvas, hyp, index):
    A.seed_sample(0, 0, index)
    m, _ = A.RandomPerspective(**hyp).matrix(320, 320, 160, 160)
    m[:2, 2] += (-80, -80)  # the mosaic's border crop (out size 160 of a 320 canvas)
    got = warp_affine_u8(canvas, m[:2], (160, 160), border=114)
    want = cv2.warpAffine(canvas, m[:2], dsize=(160, 160), borderValue=(114, 114, 114))
    diff = np.abs(got.astype(int) - want)
    print(f"{hyp} sample {index}: largest difference {diff.max()}, share equal {(diff == 0).mean():.6f}")
    assert diff.max() <= 1


@pytest.mark.parametrize("shift", [(7, -5), (0, 0), (-40, 13)])
def test_warp_affine_exact_at_integer_translations(canvas, shift):
    m = np.array([[1.0, 0.0, shift[0]], [0.0, 1.0, shift[1]]])
    want = cv2.warpAffine(canvas, m, dsize=(300, 330), borderValue=(114, 114, 114))
    np.testing.assert_array_equal(warp_affine_u8(canvas, m, (300, 330), border=114), want)


@pytest.mark.parametrize("angle,scale,center", [(0.0, 1.0, (0, 0)), (-7.3, 0.6, (0, 0)), (33.0, 1.4, (12.5, -3.0))])
def test_rotation_matrix_equals_cv2(angle, scale, center):
    np.testing.assert_allclose(get_rotation_matrix_2d(center, angle, scale),
                               cv2.getRotationMatrix2D(center=center, angle=angle, scale=scale), rtol=0, atol=1e-12)


def all_colours():
    """Every 8-bit grey level and a seeded sample of 2**16 colours, with ties between channels."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    x[0] = np.arange(256)[:, None]
    x[1, :, 1] = x[1, :, 0]
    x[2, :, 2] = x[2, :, 0]
    return x


def test_rgb_to_hsv_equals_cv2():
    x = all_colours()
    np.testing.assert_array_equal(rgb_to_hsv_u8(x), cv2.cvtColor(x, cv2.COLOR_RGB2HSV))


def test_hsv_to_rgb_equals_cv2_per_pixel_and_within_one_on_images():
    hsv = cv2.cvtColor(all_colours(), cv2.COLOR_RGB2HSV)
    hsv[..., 0] = np.random.default_rng(1).integers(0, 180, hsv.shape[:2])
    got = hsv_to_rgb_u8(hsv)
    per_pixel = cv2.cvtColor(hsv.reshape(-1, 1, 3), cv2.COLOR_HSV2RGB).reshape(hsv.shape)
    np.testing.assert_array_equal(got, per_pixel)
    diff = np.abs(got.astype(int) - cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    print(f"against cv2 on the whole image: share equal {(diff == 0).mean():.4f}")
    assert diff.max() <= 1


@pytest.mark.parametrize("index", range(3))
def test_random_hsv_within_one_of_jax(canvas, index):
    """The same three gain draws (the thread's numpy generator after `seed_sample`), LUTs, and conversions."""
    A.seed_sample(0, 1, index)
    JA.seed_sample(0, 1, index)
    got = A.RandomHSV(0.015, 0.7, 0.4)({"img": canvas.copy()})["img"]
    want = JA.RandomHSV(0.015, 0.7, 0.4)({"img": canvas.copy()})["img"]
    assert np.abs(got.astype(int) - want).max() <= 1
    assert A._np_rng().random() == JA._np_rng().random()  # both generators are at the same place afterwards


@pytest.mark.parametrize("dsize", [(160, 160), (80, 80), (100, 100), (213, 120), (107, 160)])
def test_resize_area_within_one_of_cv2(canvas, dsize):
    got = resize_area_u8(canvas, dsize)
    want = cv2.resize(canvas, dsize, interpolation=cv2.INTER_AREA)
    diff = np.abs(got.astype(int) - want)
    assert got.shape == want.shape and diff.max() <= 1
    if dsize == (160, 160):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(100, 60), (160, 160), (333, 517)])
def test_letterbox_without_enlarging_equals_jax(shape):
    img = np.random.default_rng(shape[0]).integers(0, 256, (*shape, 3), dtype=np.uint8)
    want, r, pad = letterbox_np(img, (160, 160), scaleup=False)
    got = letterbox_u8(torch.from_numpy(img)[None], (160, 160), scaleup=False)[0].numpy()
    diff = np.abs(got.astype(int) - want)
    assert got.shape == want.shape and diff.max() <= 1
    if max(shape) <= 160:
        np.testing.assert_array_equal(got, want)


def test_random_perspective_draws_like_jax():
    """Eight draws in the JAX order: the matrices of one seeded sample are equal, for both hyperparameter sets."""
    for hyp in (DEFAULT, ROTATE_SHEAR):
        A.seed_sample(5, 2, 9)
        got, s = A.RandomPerspective(**hyp).matrix(320, 320, 160, 160)
        JA.seed_sample(5, 2, 9)
        r = JA._rng()
        want = [r.uniform(0, 0), r.uniform(0, 0), r.uniform(-hyp["degrees"], hyp["degrees"]),
                r.uniform(1 - hyp["scale"], 1 + hyp["scale"])]
        rot = cv2.getRotationMatrix2D(angle=want[2], center=(0, 0), scale=want[3])
        sh = [math.tan(r.uniform(-hyp["shear"], hyp["shear"]) * math.pi / 180) for _ in range(2)]
        t = [r.uniform(0.5 - hyp["translate"], 0.5 + hyp["translate"]) * 160 for _ in range(2)]
        C = np.eye(3)
        C[0, 2] = C[1, 2] = -160
        R = np.eye(3)
        R[:2] = rot
        S = np.eye(3)
        S[0, 1], S[1, 0] = sh
        T = np.eye(3)
        T[0, 2], T[1, 2] = t
        np.testing.assert_allclose(got, T @ S @ R @ C, rtol=0, atol=1e-9)
        assert s == want[3] and A._rng().random() == JA._rng().random()

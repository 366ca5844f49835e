"""The port's JPEG decoder and encoder (`drone_yolo_tpu_torch/data/jpeg.py`) against OpenCV's libjpeg-turbo.

`decode_jpeg` must equal `cv2.imdecode(..., IMREAD_COLOR_RGB)` exactly (the JAX package reads
images with `cv2.imread(path, IMREAD_COLOR_RGB)`): streams written by cv2 at qualities 75 and
95 with 4:2:0, 4:2:2 and 4:4:4 sampling, grey images, odd sizes, a restart interval, and the
images of the repo's two synthetic datasets. Progressive and arithmetic-coded streams are
refused by name. `encode_jpeg` writes streams that cv2 reads, with libjpeg's quality-scaled
Annex K tables, and the port decodes them exactly as cv2 does.
"""

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from make_dataset import make_dataset, make_image_with_boxes
from drone_yolo_tpu_torch.data.jpeg import _segments, decode_jpeg, encode_jpeg, jpeg_shape, quality_tables

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from dense_dataset import make_dense_image  # noqa: E402

SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}


def smooth_noise(rng, shape):
    """Random noise blurred by a 5x5 box: many nonzero AC coefficients, values across 0..255."""
    img = rng.integers(0, 256, shape).astype(np.float64)
    k = np.ones(5) / 5
    for ax in (0, 1):
        img = np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"), ax, img)
    return np.clip(img * 1.6 - 80, 0, 255).astype(np.uint8)


def assert_decodes_like_cv2(data: bytes):
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR_RGB)
    got = decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("shape", [(97, 161), (64, 48)])
def test_decode_equals_cv2(quality, sampling, shape):
    """cv2-written colour streams: two qualities, three samplings, an odd size (partial MCUs on both edges)."""
    img = smooth_noise(np.random.default_rng(quality + shape[0]), (*shape, 3))
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         SAMPLING[sampling]])
    assert ok
    assert_decodes_like_cv2(buf.tobytes())


@pytest.mark.parametrize("shape", [(97, 161), (8, 8), (33, 1)])
def test_decode_grey_equals_cv2(shape):
    img = smooth_noise(np.random.default_rng(shape[0]), shape)
    assert_decodes_like_cv2(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes())


@pytest.mark.parametrize("interval", [1, 3, 7])
def test_decode_with_restart_markers_equals_cv2(interval):
    img = smooth_noise(np.random.default_rng(interval), (120, 200, 3))
    data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, interval])[1].tobytes()
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    assert_decodes_like_cv2(data)


def test_decode_repo_datasets_equal_cv2(tmp_path):
    """The files `tests/make_dataset.py` writes, and dense-proxy images written as `tools/dense_dataset.py` does."""
    make_dataset(tmp_path / "ds", n_train=3, n_val=1, size=160)
    files = sorted((tmp_path / "ds" / "images").rglob("*.jpg"))
    assert len(files) == 4
    for f in files:
        np.testing.assert_array_equal(decode_jpeg(f.read_bytes()), cv2.imread(str(f), cv2.IMREAD_COLOR_RGB))
    rng = np.random.default_rng(1)
    for size in (320, 160):
        img, _ = make_dense_image(rng, size=size, obj_px=(4, 12))
        assert_decodes_like_cv2(cv2.imencode(".jpg", img[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes())


def test_refuses_progressive_arithmetic_and_corrupt_streams():
    img = smooth_noise(np.random.default_rng(0), (64, 64, 3))
    prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    with pytest.raises(ValueError, match="progressive"):
        decode_jpeg(prog)
    base = cv2.imencode(".jpg", img)[1].tobytes()
    arith = base.replace(b"\xff\xc0", b"\xff\xc9", 1)  # the frame header of an arithmetic-coded sequential stream
    with pytest.raises(ValueError, match="arithmetic"):
        decode_jpeg(arith)
    with pytest.raises(ValueError):
        decode_jpeg(base[: len(base) // 3])
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n" + base)


def test_jpeg_shape(tmp_path):
    for shape in ((97, 161), (480, 64)):
        f = tmp_path / f"{shape[0]}.jpg"
        cv2.imwrite(str(f), smooth_noise(np.random.default_rng(1), (*shape, 3)))
        assert jpeg_shape(f) == shape


def _tables(data: bytes):
    """(DQT payloads, DHT payloads) of a stream, by table id."""
    dqt, dht = {}, {}
    for marker, start, end in _segments(data):
        if marker == 0xDB:
            o = start
            while o < end:
                dqt[data[o] & 15] = data[o + 1:o + 65]
                o += 65
        elif marker == 0xC4:
            o = start
            while o < end:
                n = sum(data[o + 1:o + 17])
                dht[data[o]] = data[o + 1:o + 17 + n]
                o += 17 + n
        elif marker == 0xDA:
            break
    return dqt, dht


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_encoder_tables_equal_libjpeg(quality):
    """The quantisation tables scaled by quality and the four Huffman tables equal what cv2 writes."""
    img = smooth_noise(np.random.default_rng(0), (32, 32, 3))
    cv_dqt, cv_dht = _tables(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes())
    dqt, dht = _tables(encode_jpeg(img, quality))
    assert dqt == cv_dqt and dht == cv_dht
    from drone_yolo_tpu_torch.data.jpeg import ZIGZAG
    luma, chroma = quality_tables(quality)
    assert bytes(luma[ZIGZAG].astype(np.uint8)) == cv_dqt[0] and bytes(chroma[ZIGZAG].astype(np.uint8)) == cv_dqt[1]


@pytest.mark.parametrize("shape", [(160, 160, 3), (97, 161, 3), (17, 9, 3), (97, 161)])
@pytest.mark.parametrize("quality", [75, 95])
def test_encode_is_read_by_cv2_and_decoded_like_cv2(shape, quality):
    rng = np.random.default_rng(shape[0])
    if len(shape) == 3 and shape[0] == 160:
        img, _ = make_image_with_boxes(rng, size=160)
    else:
        img = smooth_noise(rng, shape)
    data = encode_jpeg(img, quality)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR_RGB)
    assert want is not None and want.shape[:2] == img.shape[:2]
    np.testing.assert_array_equal(decode_jpeg(data), want)
    ref = img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
    err = np.abs(want.astype(int) - ref).mean()
    cv_err = np.abs(cv2.imdecode(cv2.imencode(".jpg", ref[..., ::-1] if img.ndim == 3 else img,
                                              [cv2.IMWRITE_JPEG_QUALITY, quality])[1], cv2.IMREAD_COLOR_RGB).astype(int)
                    - ref).mean()
    print(f"{shape} q{quality}: mean round-trip error {err:.3f}, cv2's encoder {cv_err:.3f}")
    assert err <= 1.05 * cv_err + 0.05  # as close to the source as libjpeg's own encoder at that quality

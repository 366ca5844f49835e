"""The port's sources against cv2 and the JAX package's loader: PNG, MJPEG AVI, `LoadImagesAndVideos`.

- `decode_png` equals `cv2.imread(path, IMREAD_COLOR)` bit for bit on grey, RGB, RGBA and 16-bit files written by
  cv2 with each of its zlib strategies, and on palette (with and without transparency), grey + alpha and 1-bit
  files written by PIL; Adam7 interlacing is refused by name. `encode_png` round-trips through cv2.
- `read_avi` gives the raw packets, the frame rate and the frame count of `cv2.VideoCapture` on cv2-written MJPEG
  AVIs (its raw packets with CAP_PROP_FORMAT -1); each frame equals `cv2.imdecode` of its payload. A payload
  without Huffman tables (a DHT-less AVI written here) decodes with the standard ones, equal to the original.
- `LoadImagesAndVideos` over a directory, a glob, a .txt list and a list of paths that mix JPEG, PNG and AVI:
  files, batches, `mode`, frame counters and info strings equal the JAX loader's; pixels equal for images (the
  JAX loader's video frames come from FFmpeg, whose pixels differ from `imdecode`'s: ROADMAP.md queue 3).
"""

import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from drone_yolo_tpu.data.loaders import LoadImagesAndVideos as JaxLoader
from drone_yolo_tpu_torch.data.avi import AviReader, read_avi
from drone_yolo_tpu_torch.data.dataset import YOLODataset
from drone_yolo_tpu_torch.data.jpeg import decode_jpeg
from drone_yolo_tpu_torch.data.loaders import LoadImagesAndVideos, load_inference_source
from drone_yolo_tpu_torch.data.png import decode_png, encode_png


def smooth(rng, shape, scale=255, dtype=np.uint8):
    """A smooth random image (so PNG filters and JPEG both have structure to work on) plus a little noise."""
    x = rng.normal(size=shape).cumsum(0).cumsum(1)
    x = (x - x.min()) / (np.ptp(x) + 1e-9) * scale
    return np.clip(x + rng.normal(0, scale / 100, shape), 0, scale).astype(dtype)


def cv2_images(rng):
    return {"grey": smooth(rng, (29, 41)), "rgb": smooth(rng, (37, 53, 3)), "noise": rng.integers(0, 256, (17, 23, 3), np.uint8),
            "rgba": np.dstack([smooth(rng, (31, 45, 3)), rng.integers(0, 256, (31, 45), np.uint8)]),
            "rgb16": smooth(rng, (21, 33, 3), 65535, np.uint16), "grey16": smooth(rng, (19, 27), 65535, np.uint16)}


@pytest.mark.parametrize("strategy", range(5))  # cv2's IMWRITE_PNG_STRATEGY: default, filtered, Huffman only, RLE, fixed
def test_png_decodes_like_cv2(tmp_path, strategy):
    for name, img in cv2_images(np.random.default_rng(strategy)).items():
        f = tmp_path / f"{name}.png"
        cv2.imwrite(str(f), img, [cv2.IMWRITE_PNG_STRATEGY, strategy])
        want = cv2.imread(str(f), cv2.IMREAD_COLOR)
        got = decode_png(f.read_bytes())
        assert got.shape == want.shape and got.dtype == np.uint8, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_png_palette_alpha_and_low_depths_decode_like_cv2(tmp_path):
    rng = np.random.default_rng(7)
    rgb = Image.fromarray(smooth(rng, (33, 47, 3)))
    files = {"palette": rgb.quantize(200), "palette16": rgb.quantize(16), "grey_alpha": rgb.convert("LA"),
             "bilevel": rgb.convert("1")}
    trns = rgb.quantize(64)
    trns.info["transparency"] = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
    files["palette_trns"] = trns
    for name, im in files.items():
        f = tmp_path / f"{name}.png"
        im.save(f, bits=4) if name == "palette16" else im.save(f)
        np.testing.assert_array_equal(decode_png(f.read_bytes()), cv2.imread(str(f), cv2.IMREAD_COLOR), err_msg=name)


def test_png_refuses_adam7_and_corrupt_streams():
    data = bytearray(encode_png(np.zeros((8, 8, 3), np.uint8)))
    data[28] = 1  # IHDR's interlace byte
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with pytest.raises(ValueError, match="Adam7"):
        decode_png(bytes(data))
    good = encode_png(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="CRC"):
        decode_png(good[:40] + bytes([good[40] ^ 1]) + good[41:])
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"\xff\xd8" + good)


def test_encode_png_round_trips_through_cv2(tmp_path):
    rng = np.random.default_rng(3)
    for img in (smooth(rng, (45, 61, 3)), smooth(rng, (20, 31))):
        f = tmp_path / "x.png"
        f.write_bytes(encode_png(img))
        want = img[..., ::-1] if img.ndim == 3 else np.repeat(img[..., None], 3, 2)
        np.testing.assert_array_equal(cv2.imread(str(f), cv2.IMREAD_COLOR), want)
        np.testing.assert_array_equal(decode_png(f.read_bytes()), want)


def write_cv2_avi(path, rng, n, hw, fps):
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps, (hw[1], hw[0]))
    for _ in range(n):
        w.write(smooth(rng, (*hw, 3)))
    w.release()
    return path


@pytest.mark.parametrize("n,hw,fps", [(5, (48, 64), 10.0), (7, (37, 90), 12.5), (4, (64, 48), 30000 / 1001)])
def test_read_avi_matches_videocapture(tmp_path, n, hw, fps):
    f = write_cv2_avi(tmp_path / "clip.avi", np.random.default_rng(n), n, hw, fps)
    cap = cv2.VideoCapture(str(f))
    cap.set(cv2.CAP_PROP_FORMAT, -1)  # raw packets: the payloads
    packets = []
    while True:
        ok, pkt = cap.read()
        if not ok:
            break
        packets.append(bytes(pkt.reshape(-1)))
    info = read_avi(f)
    assert info.fps == cap.get(cv2.CAP_PROP_FPS) and len(info.frames) == int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == n
    assert (info.fourcc, info.width, info.height) == (
        "MJPG", int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    with AviReader(f) as reader:
        assert [reader.payload(i) for i in range(len(reader))] == packets
        for i, p in enumerate(packets):
            np.testing.assert_array_equal(reader.frame(i), cv2.imdecode(np.frombuffer(p, np.uint8), cv2.IMREAD_COLOR))
    assert b"00dc" in f.read_bytes()[: f.read_bytes().index(b"movi")]  # the stray id in the headers' JUNK


def strip_dht(jpeg: bytes) -> bytes:
    """The stream without its DHT segments (as some Motion JPEG writers store frames)."""
    out, pos = bytearray(jpeg[:2]), 2
    while True:
        marker, length = jpeg[pos + 1], struct.unpack(">H", jpeg[pos + 2:pos + 4])[0]
        if marker != 0xC4:
            out += jpeg[pos:pos + 2 + length]
        if marker == 0xDA:
            return bytes(out + jpeg[pos + 2 + length:])
        pos += 2 + length


def chunk(cid: bytes, payload: bytes) -> bytes:
    return cid + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def riff_list(kind: bytes, body: bytes, cid: bytes = b"LIST") -> bytes:
    return cid + struct.pack("<I", len(body) + 4) + kind + body


def test_avi_payload_without_dht_decodes_with_the_standard_tables(tmp_path):
    rng = np.random.default_rng(11)
    frames = [smooth(rng, (40, 56, 3)) for _ in range(3)]
    full = [cv2.imencode(".jpg", f)[1].tobytes() for f in frames]  # libjpeg's standard (Annex K) Huffman tables
    bare = [strip_dht(p) for p in full]
    assert all(b"\xff\xc4" not in b[:b.index(b"\xff\xda")] for b in bare)
    strh = b"vidsMJPG" + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, 15, 0, 3, 0, 0xFFFFFFFF, 0, 0, 0, 56, 40)
    strf = struct.pack("<IiiHH4sIiiII", 40, 56, 40, 1, 24, b"MJPG", 56 * 40 * 3, 0, 0, 0, 0)
    hdrl = riff_list(b"hdrl", chunk(b"avih", bytes(56)) + riff_list(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi = riff_list(b"movi", b"".join(chunk(b"00dc", b) for b in bare))
    f = tmp_path / "bare.avi"
    f.write_bytes(riff_list(b"AVI ", hdrl + chunk(b"JUNK", b"00dc" + bytes(9)) + movi, cid=b"RIFF"))
    with AviReader(f) as reader:
        assert reader.fps == 15.0 and len(reader) == 3
        for i, p in enumerate(full):
            np.testing.assert_array_equal(reader.frame(i), cv2.imdecode(np.frombuffer(p, np.uint8), cv2.IMREAD_COLOR))
            np.testing.assert_array_equal(decode_jpeg(bare[i]), decode_jpeg(p))


def test_avi_other_codecs_and_containers_are_refused(tmp_path):
    w = cv2.VideoWriter(str(tmp_path / "x.avi"), cv2.VideoWriter_fourcc(*"XVID"), 10, (64, 48))
    for _ in range(2):
        w.write(np.zeros((48, 64, 3), np.uint8))
    w.release()
    with pytest.raises(ValueError, match="'XVID' is not supported"):
        read_avi(tmp_path / "x.avi")
    (tmp_path / "y.mp4").write_bytes(b"")
    with pytest.raises(NotImplementedError, match=r"\.mp4 videos are not decoded"):
        LoadImagesAndVideos(str(tmp_path / "y.mp4"))
    (tmp_path / "w").mkdir()
    (tmp_path / "w" / "z.webp").write_bytes(b"")
    with pytest.raises(NotImplementedError, match=r"\.webp images"):
        LoadImagesAndVideos(str(tmp_path / "w"))
    with pytest.raises(NotImplementedError, match=r"\.webp images are not decoded"):  # a dataset refuses it too
        YOLODataset(str(tmp_path / "w"), augment=False)
    for source in ("rtsp://localhost/x", "0", "screen 0"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            load_inference_source(source)
    with pytest.raises(TypeError, match="PIL"):
        load_inference_source(Image.new("RGB", (8, 8)))


@pytest.fixture(scope="module")
def mixed_dir(tmp_path_factory):
    """A directory of 2 JPEGs, 2 PNGs (one of them 16-bit) and 2 AVIs of 5 and 4 frames, plus a label file that
    neither loader lists."""
    d = tmp_path_factory.mktemp("mixed")
    rng = np.random.default_rng(0)
    cv2.imwrite(str(d / "a.jpg"), smooth(rng, (40, 64, 3)))
    cv2.imwrite(str(d / "c.png"), smooth(rng, (48, 32, 3)))
    cv2.imwrite(str(d / "e.JPG"), smooth(rng, (30, 50, 3)))
    cv2.imwrite(str(d / "f.png"), smooth(rng, (24, 40, 3), 65535, np.uint16))
    write_cv2_avi(d / "b.avi", rng, 5, (32, 48), 10.0)
    write_cv2_avi(d / "d.avi", rng, 4, (40, 40), 25.0)
    (d / "notes.txt").write_text("not an image\n")
    (d / "list.txt").write_text("e.JPG\nb.avi\na.jpg\n")
    return d


@pytest.mark.parametrize("batch,stride", [(1, 1), (2, 1), (3, 2)])
@pytest.mark.parametrize("kind", ["dir", "glob", "txt", "list"])
def test_loader_matches_jax(mixed_dir, kind, batch, stride):
    source = {"dir": str(mixed_dir), "glob": str(mixed_dir / "*.*g"), "txt": str(mixed_dir / "list.txt"),
              "list": [str(mixed_dir / "d.avi"), str(mixed_dir / "c.png")]}[kind]
    port, ref = LoadImagesAndVideos(source, batch=batch, vid_stride=stride), JaxLoader(source, batch=batch, vid_stride=stride)
    assert (port.files, port.video_flag, port.nf, port.ni, port.mode, len(port)) == \
           (ref.files, ref.video_flag, ref.nf, ref.ni, ref.mode, len(ref))
    n = 0
    for (pp, pi, ps), (rp, ri, rs) in zip(port, ref, strict=True):
        assert (pp, ps, port.mode, port.frame, port.frames, port.count) == (rp, rs, ref.mode, ref.frame, ref.frames, ref.count)
        for path, a, b in zip(pp, pi, ri):
            assert a.shape == b.shape and a.dtype == np.uint8
            if not path.endswith(".avi"):
                np.testing.assert_array_equal(a, b)
        n += len(pi)
    assert n > 0

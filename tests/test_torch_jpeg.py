"""The port's JPEG decoder (``utils/jpeg.py``, ``native/jpeg.cpp``) against
``cv2.imread``, byte for byte.

Files are written in the test by ``cv2.imwrite`` in every mode the decoder
reads (baseline and progressive; 4:4:4, 4:2:2, 4:4:0, 4:2:0 and 4:1:1
chroma; greyscale; restart intervals; optimised Huffman tables; odd sizes;
each EXIF orientation, spliced in by hand) and decoded through
``utils/png.py::imread_color``, the path every loader takes. The committed
fixtures of tests/data/torch_jpeg/ are held to the SHA-256 of
``cv2.imread``'s output recorded in their ``expected.json``. Files the
decoder does not read (arithmetic coding, CMYK, 12-bit, lossless) are made
by editing a baseline file's frame header, and must raise ``ValueError``
naming the marker.
"""

import hashlib
import json
import os
import struct

import cv2
import numpy as np
import pytest

from d3fields_tpu_torch.utils.jpeg import decode_jpeg, imread_jpeg
from d3fields_tpu_torch.utils.png import imread_color
from d3fields_tpu_torch.utils.synthetic import render_sphere_scene

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "torch_jpeg")
SAMPLING = {"444": 0x111111, "422": 0x211111, "440": 0x121111, "420": 0x221111,
            "411": 0x411111}


def _frame(h, w, seed=0):
    """A drifting-sphere frame with noise: smooth regions and edges."""
    sc = render_sphere_scene(num_views=1, H=120, W=160, feat_dim=4,
                             sphere_offsets=np.full((2, 3), 0.004 * seed) * [1, 1, 0])
    img = cv2.resize(np.ascontiguousarray(sc["color"][0][..., ::-1]), (w, h))
    noise = np.random.RandomState(seed).randint(-12, 13, img.shape)
    return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)


def _roundtrip(path, img, flags):
    assert cv2.imwrite(str(path), img, flags)
    got, want = imread_color(str(path)), cv2.imread(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_colour_modes_equal_cv2(tmp_path, sampling, progressive):
    for i, (h, w, q) in enumerate([(96, 128, 90), (75, 113, 75), (17, 9, 100), (1, 30, 50)]):
        flags = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                 SAMPLING[sampling], cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
        _roundtrip(tmp_path / f"{i}.jpg", _frame(h, w, i), flags)


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_greyscale_restart_and_optimised_equal_cv2(tmp_path, progressive):
    rs = np.random.RandomState(1)
    p = [cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    _roundtrip(tmp_path / "grey.jpg", _frame(61, 83, 1)[..., 0].copy(), p)
    for interval in (1, 3, 7):
        _roundtrip(tmp_path / f"rst{interval}.jpg", _frame(70, 90, interval),
                   p + [cv2.IMWRITE_JPEG_RST_INTERVAL, interval])
    _roundtrip(tmp_path / "opt.jpg", _frame(64, 64, 2), p + [cv2.IMWRITE_JPEG_OPTIMIZE, 1])
    # white noise at low quality drives coefficients to the range limits
    _roundtrip(tmp_path / "noise.jpg", rs.randint(0, 256, (40, 56, 3), np.uint8),
               p + [cv2.IMWRITE_JPEG_QUALITY, 5])
    _roundtrip(tmp_path / "noise100.jpg", rs.randint(0, 256, (40, 56, 3), np.uint8),
               p + [cv2.IMWRITE_JPEG_QUALITY, 100])


def _exif(orientation: int, little_endian: bool) -> bytes:
    e = "<" if little_endian else ">"
    tiff = (b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
    ifd = struct.pack(e + "H", 2) + struct.pack(e + "HHIHH", 0x010F, 2, 2, 0x4100, 0) \
        + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0)
    body = b"Exif\x00\x00" + tiff + ifd
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_equals_cv2(tmp_path, orientation):
    ok, buf = cv2.imencode(".jpg", _frame(30, 44, orientation))
    data = buf.tobytes()
    path = tmp_path / "o.jpg"
    path.write_bytes(data[:2] + _exif(orientation, orientation % 2 == 0) + data[2:])
    got, want = imread_jpeg(str(path)), cv2.imread(str(path))
    assert got.shape == want.shape == ((44, 30, 3) if orientation >= 5 else (30, 44, 3))
    np.testing.assert_array_equal(got, want)


def test_committed_fixtures_equal_recorded_cv2_output():
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        expected = json.load(f)
    assert len(expected) >= 8
    for name, want in expected.items():
        img = imread_color(os.path.join(FIXTURES, name))
        assert list(img.shape) == want["shape"], name
        assert hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"], name


def _sof(data: bytes) -> int:
    i = 2
    while data[i + 1] not in (0xC0, 0xC1, 0xC2):
        i += 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    return i


@pytest.mark.parametrize("edit, message", [
    ("SOF9", "arithmetic-coded JPEG \\(SOF9 0xFFC9\\)"),
    ("SOF10", "arithmetic-coded JPEG \\(SOF10 0xFFCA\\)"),
    ("SOF3", "lossless JPEG \\(SOF3 0xFFC3\\)"),
    ("12-bit", "12-bit JPEG \\(SOF1 0xFFC1\\)"),
    ("CMYK", "four-component JPEG \\(CMYK / YCCK, SOF0 0xFFC0\\)"),
])
def test_unsupported_files_raise_naming_the_marker(tmp_path, edit, message):
    ok, buf = cv2.imencode(".jpg", _frame(16, 16))
    data = bytearray(buf.tobytes())
    i = _sof(bytes(data))
    if edit.startswith("SOF"):
        data[i + 1] = 0xC0 + int(edit[3:])
    elif edit == "12-bit":
        data[i + 1] = 0xC1
        data[i + 4] = 12
    else:  # a fourth component in the frame header
        n = data[i + 9]
        comps = data[i + 10:i + 10 + 3 * n] + bytes([4, 0x11, 1])
        seg = struct.pack(">HBHHB", 8 + 3 * (n + 1), 8, 16, 16, n + 1) + comps
        data = data[:i + 2] + seg + data[i + 10 + 3 * n:]
    path = tmp_path / "bad.jpg"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=message):
        imread_color(str(path))


def test_truncated_and_foreign_files_raise():
    ok, buf = cv2.imencode(".jpg", _frame(16, 16))
    with pytest.raises(ValueError, match="<bytes>"):
        decode_jpeg(buf.tobytes()[:40])
    with pytest.raises(ValueError, match="no SOI"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n")

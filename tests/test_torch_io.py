"""The port's PNG codec and recorded-scene loader against OpenCV and the
JAX package.

The reader is held to ``cv2.imread`` byte for byte (files written by
OpenCV at several compression levels and zlib strategies, by ``save_png``
with each of the five row filters forced, greyscale and RGBA files, a
1-pixel-wide and an odd-width image); what ``save_png`` writes,
``cv2.imread`` reads back unchanged; the C++ unfilter equals a numpy
per-row version exactly; ``load_frame`` and ``num_frames`` equal the JAX
functions exactly on the same written scene. Only the tests import cv2.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from d3fields_tpu.utils import io as jio
from d3fields_tpu_torch.utils import io as tio
from d3fields_tpu_torch.utils import png


def _color(H=37, W=53, seed=0):
    """Noise, a smooth gradient and a flat block: every filter has work."""
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, (H, W, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:H, :W]
    img[: H // 2] = ((yy[: H // 2, :, None] * 3 + xx[: H // 2, :, None] * np.array([1, 2, 5]))
                     % 256).astype(np.uint8)
    img[H // 2: H // 2 + 4, : W // 2] = 17
    return img


def _depth(H=37, W=53, seed=1):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W]
    d = (400 + 7 * yy + 3 * xx + rs.randint(0, 40, (H, W))).astype(np.uint16)
    d[:3, :5] = 65535
    d[-2:] = 0
    return d


def _unfilter_np(filtered: np.ndarray, bpp: int) -> np.ndarray:
    """The PNG unfilter row by row in numpy: the oracle of the C++ one."""
    H, stride = filtered.shape[0], filtered.shape[1] - 1
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(H):
        kind, src = filtered[y, 0], filtered[y, 1:].astype(np.int64)
        row = np.zeros(stride, np.int64)
        if kind == 0:
            row = src
        elif kind == 2:
            row = (src + prev) % 256
        elif kind == 1:
            for x in range(stride):
                row[x] = (src[x] + (row[x - bpp] if x >= bpp else 0)) % 256
        elif kind == 3:
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                row[x] = (src[x] + (a + prev[x]) // 2) % 256
        else:
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                b, c = prev[x], (prev[x - bpp] if x >= bpp else 0)
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[x] = (src[x] + pred) % 256
        out[y] = row
        prev = row
    return out


@pytest.mark.parametrize("level, strategy", [
    (0, cv2.IMWRITE_PNG_STRATEGY_DEFAULT), (1, cv2.IMWRITE_PNG_STRATEGY_DEFAULT),
    (3, cv2.IMWRITE_PNG_STRATEGY_FILTERED), (6, cv2.IMWRITE_PNG_STRATEGY_HUFFMAN_ONLY),
    (9, cv2.IMWRITE_PNG_STRATEGY_RLE), (9, cv2.IMWRITE_PNG_STRATEGY_FIXED),
])
def test_reader_matches_cv2_on_opencv_files(tmp_path, level, strategy):
    params = [cv2.IMWRITE_PNG_COMPRESSION, level, cv2.IMWRITE_PNG_STRATEGY, strategy]
    c, d = str(tmp_path / "c.png"), str(tmp_path / "d.png")
    assert cv2.imwrite(c, _color(), params) and cv2.imwrite(d, _depth(), params)
    got, want = png.imread_color(c), cv2.imread(c)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    got, want = png.imread_anydepth(d), cv2.imread(d, cv2.IMREAD_ANYDEPTH)
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filter_type", [None, 0, 1, 2, 3, 4])
def test_writer_round_trips_through_cv2(tmp_path, filter_type):
    """save_png with the filter forced (or picked per row): cv2.imread reads
    back the input, and so does the port's reader."""
    c, d = str(tmp_path / "c.png"), str(tmp_path / "d.png")
    color, depth = _color(seed=filter_type or 0), _depth()
    png.save_png(c, color, filter_type)
    png.save_png(d, depth, filter_type)
    np.testing.assert_array_equal(cv2.imread(c), color)
    np.testing.assert_array_equal(cv2.imread(d, cv2.IMREAD_ANYDEPTH), depth)
    np.testing.assert_array_equal(png.imread_color(c), color)
    np.testing.assert_array_equal(png.imread_anydepth(d), depth)
    with open(c, "rb") as f:
        raw = f.read()
    start = raw.index(b"IDAT") + 4
    rows = np.frombuffer(zlib.decompress(raw[start:]), np.uint8).reshape(color.shape[0], -1)
    if filter_type is not None:
        assert set(rows[:, 0].tolist()) == {filter_type}


@pytest.mark.parametrize("shape", [(9, 1), (1, 7), (11, 13)], ids=["1px_wide", "1px_high", "odd"])
def test_reader_matches_cv2_on_narrow_and_odd_images(tmp_path, shape):
    c, d = str(tmp_path / "c.png"), str(tmp_path / "d.png")
    cv2.imwrite(c, _color(*shape))
    cv2.imwrite(d, _depth(*shape))
    np.testing.assert_array_equal(png.imread_color(c), cv2.imread(c))
    np.testing.assert_array_equal(png.imread_anydepth(d), cv2.imread(d, cv2.IMREAD_ANYDEPTH))
    for f in range(5):
        png.save_png(c, _color(*shape), f)
        np.testing.assert_array_equal(cv2.imread(c), _color(*shape))


def test_reader_converts_grey_and_rgba_as_cv2(tmp_path):
    grey, rgba = str(tmp_path / "g.png"), str(tmp_path / "a.png")
    cv2.imwrite(grey, _color()[..., 1])
    alpha = np.random.RandomState(3).randint(0, 256, _color().shape[:2] + (1,)).astype(np.uint8)
    cv2.imwrite(rgba, np.concatenate([_color(), alpha], axis=2))
    assert png.read_png(rgba).shape[-1] == 4
    np.testing.assert_array_equal(png.imread_color(grey), cv2.imread(grey))
    np.testing.assert_array_equal(png.imread_anydepth(grey), cv2.imread(grey, cv2.IMREAD_ANYDEPTH))
    np.testing.assert_array_equal(png.imread_color(rgba), cv2.imread(rgba))


def _raw_png(path, W, H, depth, ctype, interlace=0, data=b"\0"):
    chunk = lambda k, b: (struct.pack(">I", len(b)) + k + b  # noqa: E731
                          + struct.pack(">I", zlib.crc32(k + b)))
    with open(path, "wb") as f:
        f.write(png.SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, interlace))
                + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))


def test_reader_refuses_what_it_does_not_read(tmp_path):
    p = str(tmp_path / "x.png")
    _raw_png(p, 1, 1, 8, 2, interlace=1, data=b"\0\1\2\3")
    with pytest.raises(ValueError, match="interlaced"):
        png.read_png(p)
    # indexed colour reads at 1, 2, 4 and 8 bits; the spec allows no 16-bit palette
    for depth, ctype, name in ((16, 3, "indexed colour"), (8, 4, "greyscale with alpha"),
                               (16, 2, "truecolour"), (4, 0, "greyscale")):
        _raw_png(p, 1, 1, depth, ctype)
        with pytest.raises(ValueError, match=f"colour type {ctype} \\({name}.* bit depth {depth}"):
            png.read_png(p)
    cv2.imwrite(p, _depth())
    with pytest.raises(ValueError, match="16-bit"):
        png.imread_color(p)
    cv2.imwrite(p, _color())
    with pytest.raises(ValueError, match="colour PNG"):
        png.imread_anydepth(p)
    with pytest.raises(ValueError, match="save_png writes"):
        png.save_png(p, np.zeros((4, 4, 3), np.uint16))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_equals_numpy(bpp):
    rs = np.random.RandomState(bpp)
    filtered = rs.randint(0, 256, (12, 1 + 5 * bpp)).astype(np.uint8)
    filtered[:, 0] = np.arange(12) % 5
    np.testing.assert_array_equal(png.unfilter(filtered, bpp), _unfilter_np(filtered, bpp))
    filtered[7, 0] = 5
    with pytest.raises(ValueError, match="row 7 has filter type 5"):
        png.unfilter(filtered, bpp)


def _scene(t):
    from d3fields_tpu_torch.utils.synthetic import render_sphere_scene

    offs = np.array([[0.008 * t, 0.004 * t, 0.0], [-0.005 * t, 0.006 * t, 0.0]])
    return render_sphere_scene(num_views=4, H=48, W=64, feat_dim=8, sphere_offsets=offs)


def test_load_frame_equals_jax(tmp_path):
    """A 4-view scene written by save_frame: every array of every frame
    equal to the JAX loader's (cv2), and the frame count equal."""
    root = str(tmp_path / "scene")
    scenes = [_scene(t) for t in range(2)]
    for t, sc in enumerate(scenes):
        tio.save_frame(root, t, sc)
    assert tio.num_frames(root) == jio.num_frames(root) == 2
    for t, sc in enumerate(scenes):
        got, want = tio.load_frame(root, t, 4), jio.load_frame(root, t, 4)
        assert sorted(got) == sorted(want) == ["K", "color", "depth", "pose"]
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got["color"], sc["color"])
        np.testing.assert_allclose(got["depth"], sc["depth"], atol=5e-4)
        np.testing.assert_array_equal(got["pose"], sc["pose"])
        np.testing.assert_array_equal(got["K"], sc["K"])
    os.remove(os.path.join(root, "camera_2", "depth", "1.png"))
    with pytest.raises(FileNotFoundError, match=r"camera_2/depth/1\.png"):
        tio.load_frame(root, 1, 4)


@pytest.mark.parametrize("colors,bits", [(2, 1), (4, 2), (16, 4), (256, 8)])
@pytest.mark.parametrize("W", [1, 7, 33])
def test_paletted_png_reads_its_indices(tmp_path, colors, bits, W):
    """Paletted files that Pillow writes at 1, 2, 4 and 8 bits (from the
    palette's size): read_png gives np.array(Image.open(p)), the indices;
    imread_color the palette's colours as cv2.imread does."""
    from PIL import Image

    rs = np.random.RandomState(colors + W)
    m = rs.randint(0, colors, (9, W)).astype(np.uint8)
    p = str(tmp_path / "p.png")
    img = Image.fromarray(m, mode="P")
    img.putpalette(rs.randint(0, 256, 3 * colors).tolist())
    img.save(p)
    with open(p, "rb") as f:
        assert f.read()[24] == bits  # IHDR's bit depth
    np.testing.assert_array_equal(png.read_png(p), np.array(Image.open(p)))
    np.testing.assert_array_equal(png.imread_color(p), cv2.imread(p))


def test_paletted_png_round_trip_and_index_masks(tmp_path):
    """save_png(palette=) writes a P file Pillow reads back with its palette;
    the port's load_index_mask equals the JAX one on paletted, greyscale and
    RGB masks; a JPEG file (once refused) reads as ``cv2.imread`` reads it,
    whatever its extension's case."""
    from PIL import Image

    from d3fields_tpu.models.xmem.data import load_index_mask as jload
    from d3fields_tpu_torch.models.xmem.data import load_index_mask as tload

    rs = np.random.RandomState(3)
    m = rs.randint(0, 5, (13, 17)).astype(np.uint8)
    pal = rs.randint(0, 256, (5, 3)).astype(np.uint8)
    p = str(tmp_path / "m.png")
    png.save_png(p, m, palette=pal)
    img = Image.open(p)
    assert img.mode == "P"
    np.testing.assert_array_equal(np.array(img), m)
    np.testing.assert_array_equal(np.array(img.getpalette(), np.uint8).reshape(-1, 3)[:5], pal)
    np.testing.assert_array_equal(tload(p), jload(p))
    g, c = str(tmp_path / "g.png"), str(tmp_path / "c.png")
    cv2.imwrite(g, m)
    cv2.imwrite(c, np.stack([m, m + 1, m + 2], -1))
    for q in (g, c):
        np.testing.assert_array_equal(tload(q), jload(q))
    with pytest.raises(ValueError, match="past the 5-entry palette"):
        png.save_png(p, m + 1, palette=pal)
    j = str(tmp_path / "00000.JPG")
    cv2.imwrite(j, np.stack([m * 40, m * 20, 255 - m * 30], -1).astype(np.uint8))
    np.testing.assert_array_equal(png.imread_color(j), cv2.imread(j))

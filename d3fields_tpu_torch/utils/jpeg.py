"""JPEG files without OpenCV or Pillow: a host C++ decoder.

:func:`imread_jpeg` gives what ``cv2.imread(path)`` gives for a JPEG file,
byte for byte: BGR uint8 (H, W, 3) after the EXIF orientation, from the
same arithmetic as the libjpeg-turbo that OpenCV bundles (the accurate
integer IDCT, fancy chroma upsampling, the integer YCbCr tables). The
decoder (``native/jpeg.cpp``) is built with g++ on first use
(:mod:`d3fields_tpu_torch.native_build`); there is no fallback. It reads
8-bit Huffman-coded baseline, extended sequential and progressive files,
with restart intervals, greyscale or YCbCr (any integral subsampling, e.g.
4:4:4, 4:2:2, 4:4:0, 4:2:0) or RGB. Arithmetic coding, lossless and
hierarchical frames, 12-bit samples and CMYK / YCCK files raise
``ValueError`` naming the marker or the property.
"""

from __future__ import annotations

import ctypes

import numpy as np

from d3fields_tpu_torch.native_build import PORT_NATIVE_DIR, load_native

SOI = b"\xff\xd8"


def _declare(lib: ctypes.CDLL) -> None:
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.jpeg_header.restype = i64
    lib.jpeg_header.argtypes = [ptr, i64, ptr, ctypes.c_char_p, i64]
    lib.jpeg_decode.restype = i64
    lib.jpeg_decode.argtypes = [ptr, i64, ptr, i64, ptr, ctypes.c_char_p, i64]


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """An image with its EXIF orientation (1-8) applied, as OpenCV's
    ``ApplyExifOrientation`` does: transpose for 5-8, then flip."""
    if orientation >= 5:
        img = img.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flip:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The BGR uint8 (H, W, 3) image of JPEG file contents ``data``."""
    lib = load_native("jpeg", _declare, PORT_NATIVE_DIR)
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(512)
    info = np.zeros(4, np.int64)
    if lib.jpeg_header(buf.ctypes.data, buf.size, info.ctypes.data, err, len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((int(info[0]), int(info[1]), 3), np.uint8)
    orientation = np.ones(1, np.int64)
    if lib.jpeg_decode(buf.ctypes.data, buf.size, out.ctypes.data, out.size,
                       orientation.ctypes.data, err, len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    return orient(out, int(orientation[0]))


def imread_jpeg(path: str) -> np.ndarray:
    """``cv2.imread(path)`` of a JPEG file: BGR uint8 (H, W, 3)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != SOI:
        raise ValueError(f"{path}: not a JPEG file")
    return decode_jpeg(data, path)

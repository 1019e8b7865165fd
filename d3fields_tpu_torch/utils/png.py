"""PNG files without OpenCV or Pillow: numpy, zlib and a C++ row unfilter.

The recorded scenes hold colour frames as 8-bit RGB PNGs and depth frames
as 16-bit greyscale PNGs (millimetres), written by OpenCV. The readers
give what ``cv2.imread`` gives:

- :func:`imread_color` is ``cv2.imread(path)``: BGR uint8 (H, W, 3); an
  8-bit greyscale file is repeated into three channels and an RGBA file
  loses its alpha. A JPEG file (by its SOI marker) goes to
  :mod:`d3fields_tpu_torch.utils.jpeg`;
- :func:`imread_gray` is ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``: an
  8-bit greyscale file as stored, a colour one through libpng's
  ``rgb_to_gray`` with OpenCV's coefficients (0.299, 0.587);
- :func:`imread_anydepth` is ``cv2.imread(path, cv2.IMREAD_ANYDEPTH)`` of a
  greyscale file: (H, W) uint8 or uint16;
- :func:`imread_rgba` is Pillow's ``Image.open(path).convert("RGBA")`` of
  an RGB, RGBA, greyscale or paletted file without a transparency chunk.

An indexed-colour (paletted) file at 1, 2, 4 or 8 bits reads as its
palette indices, (H, W) uint8, as ``np.array(Image.open(path))`` gives a
P-mode file: the annotation masks of DAVIS and YouTube-VOS are stored so.
Other colour types, bit depths and interlaced files raise ``ValueError``
naming what the file holds. The row unfilter (PNG filter types 0-4) is
``native/png.cpp``, built with g++ on first use
(:mod:`d3fields_tpu_torch.native_build`); Average and Paeth are recurrences
along each row that numpy cannot vectorise. There is no numpy fallback.

:func:`save_png` writes uint8 BGR and uint16 greyscale images that
``cv2.imread`` reads back unchanged, and with ``palette=`` uint8 (H, W)
index images as 8-bit indexed colour with a PLTE chunk. Each row takes the filter
with the least sum of absolute residuals (libpng's heuristic), unless
``filter_type`` fixes one.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional

import numpy as np

from d3fields_tpu_torch.native_build import PORT_NATIVE_DIR, load_native
from d3fields_tpu_torch.utils.jpeg import SOI, imread_jpeg

SIGNATURE = b"\x89PNG\r\n\x1a\n"
COLOR_TYPES = {0: "greyscale", 2: "truecolour (RGB)", 3: "indexed colour",
               4: "greyscale with alpha", 6: "truecolour with alpha (RGBA)"}
# the (colour type, bit depth) pairs read here -> samples per pixel
_SUPPORTED = {(0, 8): 1, (0, 16): 1, (2, 8): 3, (6, 8): 4,
              (3, 1): 1, (3, 2): 1, (3, 4): 1, (3, 8): 1}


def _declare(lib: ctypes.CDLL) -> None:
    lib.png_unfilter.restype = ctypes.c_int64
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_void_p]


def unfilter(filtered: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + stride) uint8 rows, each a filter-type byte and its filtered
    bytes -> the (H, stride) uint8 raw rows. ``bpp``: bytes per pixel."""
    lib = load_native("png", _declare, PORT_NATIVE_DIR)
    filtered = np.ascontiguousarray(filtered, dtype=np.uint8)
    if filtered.ndim != 2 or filtered.shape[1] < 1 or bpp < 1:
        raise ValueError(f"filtered rows of shape {filtered.shape}, bpp {bpp}")
    H, stride = filtered.shape[0], filtered.shape[1] - 1
    out = np.empty((H, stride), np.uint8)
    bad = lib.png_unfilter(filtered.ctypes.data, H, stride, bpp, out.ctypes.data)
    if bad >= 0:
        raise ValueError(f"row {bad} has filter type {filtered[bad, 0]}, not one of 0-4")
    return out


def _unpack_indices(rows: np.ndarray, depth: int, W: int) -> np.ndarray:
    """(H, stride) raw rows of 1-, 2- or 4-bit samples, most significant
    first -> (H, W) uint8."""
    bits = np.unpackbits(rows, axis=1)
    groups = bits[:, : W * depth].reshape(rows.shape[0], W, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (groups * weights).sum(-1).astype(np.uint8)


def _read_png(path: str, allow_trns: bool = True):
    """The samples of a PNG file as stored, and its palette ((n, 3) uint8
    RGB, or None). ``allow_trns=False`` raises on a transparency (tRNS)
    chunk, which the readers here otherwise ignore as ``cv2.imread`` does."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat, palette = 8, None, [], None
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind.decode('latin-1')}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tRNS" and not allow_trns:
            raise ValueError(f"{path}: a PNG with a transparency (tRNS) chunk is not supported")
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    W, H, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG files are not supported")
    if (ctype, depth) not in _SUPPORTED:
        raise ValueError(
            f"{path}: PNG colour type {ctype} ({COLOR_TYPES.get(ctype, 'unknown')}) at bit "
            f"depth {depth} is not supported (8-bit greyscale, RGB and RGBA, 16-bit "
            "greyscale, and indexed colour at 1, 2, 4 and 8 bits are)")
    spp = _SUPPORTED[(ctype, depth)]
    stride = -(-W * spp * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + stride):
        raise ValueError(f"{path}: {raw.size} image bytes for {H} rows of {stride} + 1")
    # sub-byte samples unfilter byte by byte (the PNG spec's bpp of 1)
    rows = unfilter(raw.reshape(H, 1 + stride), max(1, spp * depth // 8))
    if depth < 8:
        img = _unpack_indices(rows, depth, W)[..., None]
    elif depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(H, W, spp)
    else:
        img = rows.reshape(H, W, spp)
    return (img[..., 0] if spp == 1 else img), palette


def read_png(path: str) -> np.ndarray:
    """The samples of a PNG file as stored: (H, W) greyscale or palette
    indices, (H, W, 3) RGB or (H, W, 4) RGBA, uint8 or uint16."""
    return _read_png(path)[0]


def imread_color(path: str) -> np.ndarray:
    """``cv2.imread(path)`` of an 8-bit PNG or a JPEG file: BGR uint8 (H, W,
    3). A paletted PNG gives its palette's colours."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head == SOI:
        return imread_jpeg(path)
    img, palette = _read_png(path)
    if palette is not None:
        return np.ascontiguousarray(palette[img][..., ::-1])
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a 16-bit PNG is not read as a colour image here")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])  # RGB(A) -> BGR, alpha dropped


def imread_rgba(path: str) -> np.ndarray:
    """``np.array(Image.open(path).convert("RGBA"))`` of an 8-bit PNG: (H,
    W, 4) uint8 RGBA. RGB, greyscale and paletted pixels take alpha 255; a
    file with a transparency (tRNS) chunk raises."""
    img, palette = _read_png(path, allow_trns=False)
    if palette is not None:
        img = palette[img]
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a 16-bit PNG is not read as an RGBA image here")
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    if img.shape[2] == 4:
        return np.ascontiguousarray(img)
    return np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=2)


def imread_anydepth(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_ANYDEPTH)`` of a greyscale PNG: (H, W)
    uint8 or uint16."""
    img, palette = _read_png(path)
    if img.ndim != 2 or palette is not None:
        raise ValueError(f"{path}: a colour PNG is not read as a depth image here")
    return img


def imread_gray(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` of an 8-bit PNG: (H, W)
    uint8. Colour (and paletted) pixels become libpng's
    ``(9797 r + 19234 g + 3737 b) >> 15``, grey ones keep their value."""
    img, palette = _read_png(path)
    if palette is not None:
        img = palette[img]
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a 16-bit PNG is not read as a greyscale image here")
    if img.ndim == 2:
        return img
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    grey = (9797 * r + 19234 * g + 3737 * b) >> 15
    return np.where((r == g) & (r == b), r, grey).astype(np.uint8)


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows: np.ndarray, bpp: int, filter_type: Optional[int] = None) -> np.ndarray:
    """(H, stride) uint8 raw rows -> (H, 1 + stride) filtered rows. Every
    filter reads raw bytes only, so all five vectorise over the image."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    residuals = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - _paeth(a, b, c)])
    residuals = (residuals & 0xFF).astype(np.uint8)  # (5, H, stride)
    if filter_type is None:
        # libpng's heuristic: the least sum of the residuals as signed bytes
        cost = np.abs(residuals.view(np.int8).astype(np.int64)).sum(-1)  # (5, H)
        types = cost.argmin(0)
    elif filter_type in range(5):
        types = np.full(rows.shape[0], filter_type)
    else:
        raise ValueError(f"filter_type must be None or 0-4, got {filter_type!r}")
    chosen = residuals[types, np.arange(rows.shape[0])]
    return np.concatenate([types.astype(np.uint8)[:, None], chosen], axis=1)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def save_png(path: str, image: np.ndarray, filter_type: Optional[int] = None,
             palette: Optional[np.ndarray] = None) -> None:
    """Write uint8 BGR (H, W, 3) or uint16 (H, W) greyscale as a PNG that
    ``cv2.imread`` reads back to ``image``; with ``palette`` ((n, 3) uint8
    RGB, n <= 256), uint8 (H, W) indices as 8-bit indexed colour.
    ``filter_type`` 0-4 fixes every row's filter; None picks one per row."""
    image = np.asarray(image)
    chunks = []
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        if image.dtype != np.uint8 or image.ndim != 2:
            raise ValueError(f"a paletted PNG holds uint8 (H, W) indices, got {image.dtype} "
                             f"{image.shape}")
        if palette.ndim != 2 or palette.shape[1] != 3 or not 1 <= palette.shape[0] <= 256:
            raise ValueError(f"palette must be (n <= 256, 3) RGB, got {palette.shape}")
        if image.size and int(image.max()) >= palette.shape[0]:
            raise ValueError(f"index {int(image.max())} lies past the {palette.shape[0]}-entry "
                             "palette")
        ctype, depth, samples = 3, 8, image
        chunks.append(_chunk(b"PLTE", palette.tobytes()))
    elif image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3:
        ctype, depth, samples = 2, 8, image[..., ::-1]  # BGR -> the file's RGB
    elif image.dtype == np.uint16 and image.ndim == 2:
        ctype, depth, samples = 0, 16, image.astype(">u2")
    else:
        raise ValueError(f"save_png writes uint8 (H, W, 3) BGR or uint16 (H, W) greyscale, "
                         f"got {image.dtype} {image.shape}")
    H, W = image.shape[:2]
    rows = np.ascontiguousarray(samples).view(np.uint8).reshape(H, -1)
    bpp = rows.shape[1] // W
    body = zlib.compress(_filter_rows(rows, bpp, filter_type).tobytes())
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0)))
        for c in chunks:
            f.write(c)
        f.write(_chunk(b"IDAT", body))
        f.write(_chunk(b"IEND", b""))

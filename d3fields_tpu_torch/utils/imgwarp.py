"""OpenCV's uint8 geometric transforms without OpenCV, byte for byte.

The XMem training pipeline (``models/xmem/data.py``) augments with
``cv2.resize``, ``cv2.warpAffine``, ``cv2.remap`` and
``cv2.getRotationMatrix2D``; the port reproduces what OpenCV 5.0 gives:

- :func:`resize_u8`: ``cv2.resize`` with ``INTER_LINEAR`` (through
  ``models/resize.py::linear_resize_u8``, which also equals OpenCV's
  switch of an exact 2x downscale to its area average) or
  ``INTER_NEAREST`` (``floor(x * (1 / (dst / src)))`` in double);
- :func:`warp_affine_u8` and :func:`remap_u8`: float32 coordinates and
  fused multiply-adds, in ``native/imgwarp.cpp`` (built with g++ on first
  use, no fallback);
- :func:`rotation_matrix_2d`: ``cv2.getRotationMatrix2D`` in double, with
  the centre rounded to float32 as OpenCV's ``Point2f`` does.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np

from d3fields_tpu_torch.models.resize import linear_resize_u8
from d3fields_tpu_torch.native_build import PORT_NATIVE_DIR, load_native


def _declare(lib: ctypes.CDLL) -> None:
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.warp_affine_u8.restype = None
    lib.warp_affine_u8.argtypes = [ptr, i64, i64, i64, ptr, i64, ptr, ptr, i64, i64]
    lib.remap_u8.restype = None
    lib.remap_u8.argtypes = [ptr, i64, i64, i64, ptr, ptr, i64, ptr, ptr, i64, i64]


def _lib() -> ctypes.CDLL:
    return load_native("imgwarp", _declare, PORT_NATIVE_DIR)


def resize_u8(img: np.ndarray, out_hw: Tuple[int, int], nearest: bool = False) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_NEAREST if nearest
    else INTER_LINEAR)`` of an (H, W) or (H, W, C) uint8 image."""
    if not nearest:
        return linear_resize_u8(img, out_hw)
    H, W = img.shape[:2]
    h, w = out_hw
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))).astype(np.int64), W - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))).astype(np.int64), H - 1)
    return np.ascontiguousarray(img[ys][:, xs])


def _prepare(img: np.ndarray, border) -> Tuple[np.ndarray, int, np.ndarray]:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim not in (2, 3):
        raise ValueError(f"an (H, W) or (H, W, C) uint8 image, got {img.shape}")
    c = 1 if img.ndim == 2 else img.shape[2]
    cval = np.zeros(c, np.float64)
    b = np.atleast_1d(np.asarray(border, np.float64))
    cval[: min(c, b.size)] = b[:c]
    return img, c, cval


def warp_affine_u8(img: np.ndarray, M: np.ndarray, dsize: Tuple[int, int], *,
                   nearest: bool = False, border: Sequence[float] = 0) -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize, flags=INTER_NEAREST if nearest else
    INTER_LINEAR, borderValue=border)``: ``M`` the 2x3 source-to-destination
    matrix, ``dsize`` (width, height), a constant border."""
    img, c, cval = _prepare(img, border)
    m = np.ascontiguousarray(np.asarray(M, np.float64).reshape(2, 3))
    dw, dh = int(dsize[0]), int(dsize[1])
    out = np.empty((dh, dw, c), np.uint8)
    _lib().warp_affine_u8(img.ctypes.data, img.shape[0], img.shape[1], c, m.ctypes.data,
                          0 if nearest else 1, cval.ctypes.data, out.ctypes.data, dh, dw)
    return out if img.ndim == 3 else out[..., 0]


def remap_u8(img: np.ndarray, mapx: np.ndarray, mapy: np.ndarray, *, nearest: bool = False,
             border: Sequence[float] = 0) -> np.ndarray:
    """``cv2.remap(img, mapx, mapy, INTER_NEAREST if nearest else
    INTER_LINEAR)`` with float32 maps and a constant border."""
    img, c, cval = _prepare(img, border)
    mapx = np.ascontiguousarray(mapx, dtype=np.float32)
    mapy = np.ascontiguousarray(mapy, dtype=np.float32)
    if mapx.shape != mapy.shape or mapx.ndim != 2:
        raise ValueError(f"maps of one (h, w) shape, got {mapx.shape} and {mapy.shape}")
    dh, dw = mapx.shape
    out = np.empty((dh, dw, c), np.uint8)
    _lib().remap_u8(img.ctypes.data, img.shape[0], img.shape[1], c, mapx.ctypes.data,
                    mapy.ctypes.data, 0 if nearest else 1, cval.ctypes.data, out.ctypes.data,
                    dh, dw)
    return out if img.ndim == 3 else out[..., 0]


def rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: (2, 3) float64;
    ``angle`` in degrees, counter-clockwise."""
    cx, cy = (float(np.float32(v)) for v in center)
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])

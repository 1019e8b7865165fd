"""Pillow's ``Image.resize(size, Image.BILINEAR)`` of 8-bit images, in numpy.

Written from Pillow's ``libImaging/Resample.c``: per output pixel the
triangle filter's taps around ``(x + 0.5) * scale`` (support 1, widened
by the scale on a reduction), normalised, then turned into fixed-point
integers with 22 fractional bits (``PRECISION_BITS = 32 - 8 - 2``); each
pass sums in integers from a half-unit start, shifts down and clips to
0..255. The horizontal pass runs first, then the vertical one on its uint8
result.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _coefficients(in_size: int, out_size: int):
    """(first tap per output pixel (out,), fixed-point weights (out, k))."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) / filterscale)) for x in range(xmax)]
        total = sum(k)
        for x in range(xmax):
            w = k[x] / total if total else 0.0
            kk[xx, x] = int(0.5 + w * (1 << PRECISION_BITS)) if w >= 0 else \
                int(-0.5 + w * (1 << PRECISION_BITS))
        first[xx] = xmin
    return first, kk


def _pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    in_size = img.shape[axis]
    first, kk = _coefficients(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    for j in range(kk.shape[1]):
        idx = np.minimum(first + j, in_size - 1)
        acc += src[idx] * kk[:, j].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_bilinear_u8(images: np.ndarray, out_hw) -> np.ndarray:
    """(..., H, W, C) uint8 -> (..., h, w, C) uint8."""
    h, w = out_hw
    out = np.asarray(images)
    if out.shape[-2] != w:
        out = _pass(out, out.ndim - 2, w)
    if out.shape[-3] != h:
        out = _pass(out, out.ndim - 3, h)
    return out

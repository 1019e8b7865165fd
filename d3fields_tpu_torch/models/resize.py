"""Image / grid resize primitives with torch-parity semantics.

Counterpart of ``d3fields_tpu/models/resize.py``:

- :func:`cubic_resize_np` — host-side bicubic (a=-0.75, half-pixel centres,
  edge clamp, no antialias) matching ``F.interpolate(mode='bicubic',
  align_corners=False)``; used once per resolution for DINOv2's
  positional-embedding interpolation. A numpy copy, so that the positional
  table is the JAX package's to the bit.
- :func:`pil_bilinear_resize_u8` — bit-exact Pillow 8bpc bilinear resize,
  reimplemented in integer torch arithmetic on the images' device (the
  port does not depend on Pillow).
- :func:`bilinear_resize` — device-side antialiased bilinear resize of
  float images (the JAX package's ``jax.image.resize`` 'bilinear'), for the
  detectors' and SAM's preprocessing.
- :func:`bilinear_resize_exact` — the same without antialiasing on
  downscales (``F.interpolate``'s plain bilinear), for SAM's mask
  postprocessing; :func:`_linear_weights_1d` gives its two taps and
  weights per output pixel, for reading an upsampled map at a few pixels;
- :func:`linear_resize_u8` — OpenCV's default uint8 resize (``cv2.resize``,
  INTER_LINEAR) in numpy, bit for bit: 11-bit fixed-point weights and
  OpenCV's rounding shifts.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    at = np.abs(t)
    return np.where(
        at <= 1,
        (a + 2) * at**3 - (a + 3) * at**2 + 1,
        np.where(at < 2, a * at**3 - 5 * a * at**2 + 8 * a * at - 4 * a, 0.0),
    )


def _resize_weights_1d(in_size: int, out_size: int,
                       scale: float | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-pixel 4-tap indices (clamped) and cubic weights.

    ``scale`` overrides the in/out ratio — F.interpolate(scale_factor=s)
    samples with the GIVEN scale, not the realised size ratio (torch-hub
    DINOv2's interpolate_offset=0.1 pos-embed path depends on this).
    """
    scale = (in_size / out_size) if scale is None else 1.0 / scale
    dst = np.arange(out_size)
    src = (dst + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    t = src - base
    taps = np.stack([base - 1, base, base + 1, base + 2], axis=1)
    w = _cubic_kernel(np.stack([t + 1, t, t - 1, t - 2], axis=1))
    return np.clip(taps, 0, in_size - 1), w


def cubic_resize_np(img: np.ndarray, out_hw: tuple[int, int],
                    scale_hw: tuple[float, float] | None = None) -> np.ndarray:
    """Separable bicubic resize of (H, W, C) -> (h, w, C), torch semantics.

    ``scale_hw`` forwards explicit per-axis scale factors."""
    H, W = img.shape[:2]
    h, w = out_hw
    sy, sx = scale_hw if scale_hw is not None else (None, None)
    ty, wy = _resize_weights_1d(H, h, sy)
    tx, wx = _resize_weights_1d(W, w, sx)
    rows = (img[ty] * wy[..., None, None]).sum(axis=1)  # (h, W, C)
    out = (rows[:, tx] * wx[None, ..., None]).sum(axis=2)  # (h, w, C)
    return out.astype(img.dtype)


# ---------------------------------------------------------------------------
# PIL-exact bilinear resize (the reference's preprocessing resampler)
# ---------------------------------------------------------------------------

_PIL_PRECISION_BITS = 32 - 8 - 2  # Pillow Resample.c 8bpc fixed point


@functools.lru_cache(maxsize=32)
def _pil_coeffs_1d(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bilinear (triangle, support=1) filter: per-output-pixel first tap index
    and fixed-point weights (22 fractional bits)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        pts = (np.arange(xmax) + xmin - center + 0.5) / filterscale
        w = np.clip(1.0 - np.abs(pts), 0.0, None)
        w = w / w.sum()
        # triangle-filter weights are non-negative, so Pillow's
        # round-half-away-from-zero reduces to the positive arm
        xmins[xx] = xmin
        weights[xx, :xmax] = (0.5 + w * (1 << _PIL_PRECISION_BITS)).astype(np.int64)
    return xmins, weights


@functools.lru_cache(maxsize=32)
def _pil_taps(in_size: int, out_size: int, device: torch.device):
    """One pass's (flat tap indices, (out_size, ksize) int64 weights) on
    ``device``, copied there once per (sizes, device): a copy from the host
    at every resize would wait for the device's queued work."""
    xmins, weights = _pil_coeffs_1d(in_size, out_size)
    taps = np.clip(xmins[:, None] + np.arange(weights.shape[1]), 0, in_size - 1).reshape(-1)
    return torch.as_tensor(taps, device=device), torch.as_tensor(weights, device=device)


def _pil_pass_u8(img: torch.Tensor, in_size: int, out_size: int, dim: int) -> torch.Tensor:
    """One 8bpc resample pass along ``dim`` (non-negative) with Pillow's
    rounding: start the accumulator at 1 << (PRECISION_BITS-1), shift down,
    clip to u8. In int64 on the image's device, so exact."""
    taps, weights = _pil_taps(in_size, out_size, img.device)
    ksize = weights.shape[1]
    g = img.index_select(dim, taps).to(torch.int64)
    split = list(g.shape[:dim]) + [out_size, ksize] + list(g.shape[dim + 1:])
    wshape = [1] * len(split)
    wshape[dim], wshape[dim + 1] = out_size, ksize
    w = weights.reshape(wshape)
    acc = (g.reshape(split) * w).sum(dim + 1) + (1 << (_PIL_PRECISION_BITS - 1))
    return torch.clamp(acc >> _PIL_PRECISION_BITS, 0, 255).to(torch.uint8)


def pil_bilinear_resize_u8(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bit-exact Pillow ``Image.resize(..., BILINEAR)`` on uint8 images.

    The reference's preprocessing (torchvision ``T.Resize`` on a PIL image,
    ``fusion.py:603-607``), reimplemented in integer arithmetic: a
    horizontal pass at the original height, then a vertical pass, each
    rounded to uint8 as Pillow rounds. ``img`` is an (H, W, C) or
    (K, H, W, C) uint8 tensor, resized on its device.
    """
    if img.dtype != torch.uint8:
        raise TypeError("the PIL 8bpc path takes uint8 images only")
    h, w = out_hw
    H, W = img.shape[-3], img.shape[-2]
    out = img
    if W != w:  # Pillow: horizontal pass first, at the original height
        out = _pil_pass_u8(out, W, w, out.dim() - 2)
    if H != h:
        out = _pil_pass_u8(out, H, h, out.dim() - 3)
    return out


def bilinear_resize(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of (K, H, W, C) float images, half-pixel
    centres: the filter of ``jax.image.resize(..., 'bilinear')``."""
    x = img.permute(0, 3, 1, 2)
    out = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def _linear_weights_1d(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """2-tap half-pixel linear taps (out_size, 2) and float64 weights
    without antialiasing (``F.interpolate(mode='bilinear',
    align_corners=False)``)."""
    src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    base = np.floor(src).astype(np.int64)
    t = src - base
    taps = np.clip(np.stack([base, base + 1], axis=1), 0, in_size - 1)
    return taps, np.stack([1.0 - t, t], axis=1)


def bilinear_resize_exact(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Non-antialiased bilinear resize of (K, H, W, C), half-pixel centres:
    ``F.interpolate(mode='bilinear', align_corners=False, antialias=False)``
    on up- and downscales alike (the JAX package's ``bilinear_resize_exact``).
    The original SAM postprocess thresholds logits resized this way."""
    out = F.interpolate(img.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1)


def _cv2_linear_taps(ssize: int, dsize: int, clamp: bool, area: bool = False):
    """OpenCV's INTER_LINEAR taps and 11-bit weights along one axis:
    fx = float32((d + 0.5) * scale - 0.5), split at its floor. Along x an
    out-of-range tap takes the edge pixel at weight 1 (``clamp``); along y
    the weights stay and only the row indices are clipped. ``area`` gives
    the taps OpenCV's INTER_AREA takes when it enlarges: s = floor(d *
    scale), fx = (d + 1) - (s + 1) / scale, its fractional part where it
    is positive and 0 elsewhere."""
    inv = dsize / ssize
    if area:
        d = np.arange(dsize)
        s = np.floor(d * (1.0 / inv)).astype(np.int64)
        f = ((d + 1) - (s + 1) * inv).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    else:
        f = ((np.arange(dsize) + 0.5) * (1.0 / inv) - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        edge = (s < 0) | (s >= ssize - 1)
        f[edge] = 0.0
        s = np.clip(s, 0, ssize - 1)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    return np.clip(s, 0, ssize - 1), np.clip(s + 1, 0, ssize - 1), w0, w1


def linear_resize_u8(img: np.ndarray, out_hw: tuple[int, int], area: bool = False) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` of an (H, W) or (H, W, C) uint8 image:
    each row's two taps in integers, then the two rows combined as OpenCV's
    vector path does, ``((b0 (r0 >> 4)) >> 16 + (b1 (r1 >> 4)) >> 16 + 2) >> 2``.
    ``area`` takes INTER_AREA's taps for a resize that enlarges along
    either axis (``_cv2_linear_taps``)."""
    h, w = out_hw
    x0, x1, a0, a1 = _cv2_linear_taps(img.shape[1], w, clamp=True, area=area)
    y0, y1, b0, b1 = _cv2_linear_taps(img.shape[0], h, clamp=False, area=area)
    s = img.astype(np.int64)
    col = (1, w) + (1,) * (img.ndim - 2)
    rows = s[:, x0] * a0.reshape(col) + s[:, x1] * a1.reshape(col)
    row = (h,) + (1,) * (img.ndim - 1)
    out = (((b0.reshape(row) * (rows[y0] >> 4)) >> 16)
           + ((b1.reshape(row) * (rows[y1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)

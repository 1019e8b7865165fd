"""Image / grid resize primitives with torch-parity semantics.

Counterpart of ``d3fields_tpu/models/resize.py``:

- :func:`cubic_resize_np` — host-side bicubic (a=-0.75, half-pixel centres,
  edge clamp, no antialias) matching ``F.interpolate(mode='bicubic',
  align_corners=False)``; used once per resolution for DINOv2's
  positional-embedding interpolation. A numpy copy, so that the positional
  table is the JAX package's to the bit.
- :func:`pil_bilinear_resize_u8` — bit-exact Pillow 8bpc bilinear resize,
  with an in-tree numpy reimplementation used where Pillow is missing.
- :func:`bilinear_resize` — device-side antialiased bilinear resize of
  float images (the JAX package's ``jax.image.resize`` 'bilinear'), for the
  detectors' and SAM's preprocessing.
- :func:`bilinear_resize_exact` — the same without antialiasing on
  downscales (``F.interpolate``'s plain bilinear), for SAM's mask
  postprocessing.
"""

from __future__ import annotations

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


def _pil_pass_u8(img: np.ndarray, xmins: np.ndarray, weights: np.ndarray,
                 axis: int) -> np.ndarray:
    """One 8bpc resample pass along ``axis`` with Pillow's rounding: start
    the accumulator at 1 << (PRECISION_BITS-1), shift down, clip to u8.

    The arithmetic is float64 multiply-adds, exact because every
    intermediate is an integer below ksize * 255 * 2^22 << 2^53.
    """
    img = np.moveaxis(img, axis, 0).astype(np.float64)
    out_size, ksize = weights.shape
    acc = np.full((out_size,) + img.shape[1:], float(1 << (_PIL_PRECISION_BITS - 1)))
    for k in range(ksize):
        taps = np.clip(xmins + k, 0, img.shape[0] - 1)
        w = weights[:, k].astype(np.float64)
        acc += img[taps] * w.reshape((out_size,) + (1,) * (img.ndim - 1))
    out = np.clip(np.floor(acc / (1 << _PIL_PRECISION_BITS)), 0, 255)
    return np.moveaxis(out.astype(np.uint8), 0, axis)


def pil_bilinear_resize_u8(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Bit-exact Pillow ``Image.resize(..., BILINEAR)`` on uint8 images.

    The reference's preprocessing (torchvision ``T.Resize`` on a PIL image,
    ``fusion.py:603-607``). Accepts (H, W, C) or (K, H, W, C). Uses
    Pillow's C resampler where Pillow is importable, else the numpy
    reimplementation :func:`_pil_bilinear_resize_u8_np`, which gives the
    same bytes.
    """
    if img.dtype != np.uint8:
        raise TypeError("the PIL 8bpc path takes uint8 images only")
    h, w = out_hw
    try:
        from PIL import Image
    except ImportError:
        return _pil_bilinear_resize_u8_np(img, out_hw)
    if img.ndim == 3:
        return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))
    return np.stack([
        np.asarray(Image.fromarray(im).resize((w, h), Image.BILINEAR)) for im in img
    ])


def _pil_bilinear_resize_u8_np(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Numpy reimplementation of Pillow's 8bpc bilinear resample."""
    h, w = out_hw
    H, W = img.shape[-3], img.shape[-2]
    out = img
    if W != w:  # Pillow: horizontal pass first, at the original height
        xm, wx = _pil_coeffs_1d(W, w)
        out = _pil_pass_u8(out, xm, wx, axis=-2)
    if H != h:
        ym, wy = _pil_coeffs_1d(H, h)
        out = _pil_pass_u8(out, ym, wy, axis=-3)
    return out


def bilinear_resize(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of (K, H, W, C) float images, half-pixel
    centres: the filter of ``jax.image.resize(..., 'bilinear')``."""
    x = img.permute(0, 3, 1, 2)
    out = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def bilinear_resize_exact(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Non-antialiased bilinear resize of (K, H, W, C), half-pixel centres:
    ``F.interpolate(mode='bilinear', align_corners=False, antialias=False)``
    on up- and downscales alike (the JAX package's ``bilinear_resize_exact``).
    The original SAM postprocess thresholds logits resized this way."""
    out = F.interpolate(img.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1)

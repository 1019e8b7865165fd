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
  postprocessing.
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


def _pil_pass_u8(img: torch.Tensor, in_size: int, out_size: int, dim: int) -> torch.Tensor:
    """One 8bpc resample pass along ``dim`` (non-negative) with Pillow's
    rounding: start the accumulator at 1 << (PRECISION_BITS-1), shift down,
    clip to u8. In int64 on the image's device, so exact."""
    xmins, weights = _pil_coeffs_1d(in_size, out_size)
    ksize = weights.shape[1]
    taps = np.clip(xmins[:, None] + np.arange(ksize), 0, in_size - 1).reshape(-1)
    g = img.index_select(dim, torch.as_tensor(taps, device=img.device)).to(torch.int64)
    split = list(g.shape[:dim]) + [out_size, ksize] + list(g.shape[dim + 1:])
    wshape = [1] * len(split)
    wshape[dim], wshape[dim + 1] = out_size, ksize
    w = torch.as_tensor(weights, device=img.device).reshape(wshape)
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


def bilinear_resize_exact(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Non-antialiased bilinear resize of (K, H, W, C), half-pixel centres:
    ``F.interpolate(mode='bilinear', align_corners=False, antialias=False)``
    on up- and downscales alike (the JAX package's ``bilinear_resize_exact``).
    The original SAM postprocess thresholds logits resized this way."""
    out = F.interpolate(img.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1)

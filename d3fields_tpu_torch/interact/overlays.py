"""Overlay visualization modes of the interactive GUI.

Counterpart of ``d3fields_tpu/interact/overlays.py``, a copy in numpy (the
port imports nothing of the JAX package) over the port's
:func:`~d3fields_tpu_torch.utils.visualization.davis_palette`. It rebuilds
``XMem/inference/interact/interactive_utils.py:26-175``: the five viewer
modes (davis / fade / light / popup / layered) in the hard-mask form
(``get_visualization``) and the soft-probability form the reference runs
on the GPU (``get_visualization_torch``); both are per-frame 8-bit
compositing on the host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from d3fields_tpu_torch.utils.visualization import davis_palette

#: the reference brightens the DAVIS palette 1.5x for display
#: (``interactive_utils.py:29-31``)
_COLOR_MAP = (davis_palette().astype(np.float32) * 1.5).clip(0, 255)
_GRAY = np.array([0.3, 0.59, 0.11], np.float32)  # interactive_utils.py:36


def overlay_davis(image: np.ndarray, mask: np.ndarray, alpha: float = 0.5,
                  fade: bool = False) -> np.ndarray:
    """Alpha-blend the palette color over object pixels; ``fade`` dims
    the background (``interactive_utils.py:76-89``)."""
    img = image.astype(np.float32)
    out = img.copy()
    colored = _COLOR_MAP[mask.astype(np.int64)]
    fg = img * alpha + (1 - alpha) * colored
    binary = mask > 0
    out[binary] = fg[binary]
    if fade:
        out[~binary] *= 0.6
    return out.astype(image.dtype)


def overlay_popup(image: np.ndarray, mask: np.ndarray,
                  target_objects: Sequence[int]) -> np.ndarray:
    """Keep target objects colored, gray out the rest
    (``interactive_utils.py:91-99``)."""
    out = image.astype(np.float32).copy()
    bg = ~np.isin(mask, list(target_objects))
    out[bg] = (out[bg] * _GRAY).sum(-1, keepdims=True)
    return out.astype(image.dtype)


def overlay_layer(image: np.ndarray, mask: np.ndarray, layer: np.ndarray,
                  target_objects: Sequence[int]) -> np.ndarray:
    """Insert an RGBA layer between the target objects and the
    background (``interactive_utils.py:101-112``)."""
    img = image.astype(np.float32)
    obj = np.isin(mask, list(target_objects)).astype(np.float32)
    la = layer[..., 3].astype(np.float32) / 255.0
    lrgb = layer[..., :3].astype(np.float32)
    bga = np.maximum(obj, la)[..., None]
    obj = obj[..., None]
    out = (img * (1 - bga) + lrgb * (1 - obj) + img * obj).clip(0, 255)
    return out.astype(image.dtype)


def get_visualization(mode: str, image: np.ndarray, mask: np.ndarray,
                      layer: Optional[np.ndarray],
                      target_objects: Sequence[int]) -> np.ndarray:
    """Hard-mask composition dispatch (``interactive_utils.py:40-57``)."""
    if mode == "fade":
        return overlay_davis(image, mask, fade=True)
    if mode == "davis":
        return overlay_davis(image, mask)
    if mode == "light":
        return overlay_davis(image, mask, 0.9)
    if mode == "popup":
        return overlay_popup(image, mask, target_objects)
    if mode == "layered":
        if layer is None:
            return overlay_davis(image, mask)
        return overlay_layer(image, mask, layer, target_objects)
    raise ValueError(f"unknown visualization mode {mode!r}")


# ---------------------------------------------------------------------------
# soft-probability variants (the reference's *_torch GPU path,
# interactive_utils.py:115-175) — softer edges from the (K+1, H, W) probs
# ---------------------------------------------------------------------------

def overlay_davis_soft(image01: np.ndarray, prob: np.ndarray,
                       alpha: float = 0.5, fade: bool = False) -> np.ndarray:
    """``overlay_davis_torch``: image in [0,1] float (H, W, 3), prob
    (K+1, H, W) -> uint8 overlay. The reference still hardens via argmax
    here; softness only enters popup/layered."""
    mask = np.argmax(prob, axis=0)
    img = image01.astype(np.float32)
    out = img.copy()
    colored = _COLOR_MAP[mask] / 255.0
    fg = img * alpha + (1 - alpha) * colored
    binary = mask > 0
    out[binary] = fg[binary]
    if fade:
        out[~binary] *= 0.6
    return (out * 255).astype(np.uint8)


def overlay_popup_soft(image01: np.ndarray, prob: np.ndarray,
                       target_objects: Sequence[int]) -> np.ndarray:
    """``overlay_popup_torch``: soft per-pixel blend between color and
    grayscale by the summed target-object probability."""
    img = image01.astype(np.float32)
    if len(target_objects) == 0:
        obj = np.zeros(prob.shape[1:], np.float32)[..., None]
    else:
        obj = prob[np.asarray(target_objects, np.int32)].sum(0)[..., None]
    gray = (img * _GRAY).sum(-1, keepdims=True)
    out = obj * img + (1 - obj) * gray
    return (out * 255).astype(np.uint8)


def overlay_layer_soft(image01: np.ndarray, prob: np.ndarray,
                       layer01: np.ndarray,
                       target_objects: Sequence[int]) -> np.ndarray:
    """``overlay_layer_torch``: RGBA layer (floats in [0,1]) composited
    with the soft object probability."""
    img = image01.astype(np.float32)
    if len(target_objects) == 0:
        obj = np.zeros(prob.shape[1:], np.float32)
    else:
        obj = prob[np.asarray(target_objects, np.int32)].sum(0)
    la = layer01[..., 3]
    lrgb = layer01[..., :3]
    bga = np.maximum(obj, la)[..., None]
    obj = obj[..., None]
    out = (img * (1 - bga) + lrgb * (1 - obj) + img * obj).clip(0, 1)
    return (out * 255).astype(np.uint8)


def get_visualization_soft(mode: str, image01: np.ndarray, prob: np.ndarray,
                           layer01: Optional[np.ndarray],
                           target_objects: Sequence[int]) -> np.ndarray:
    """Soft-probability dispatch (``interactive_utils.py:58-74``)."""
    if mode == "fade":
        return overlay_davis_soft(image01, prob, fade=True)
    if mode == "davis":
        return overlay_davis_soft(image01, prob)
    if mode == "light":
        return overlay_davis_soft(image01, prob, 0.9)
    if mode == "popup":
        return overlay_popup_soft(image01, prob, target_objects)
    if mode == "layered":
        if layer01 is None:
            return overlay_davis_soft(image01, prob)
        return overlay_layer_soft(image01, prob, layer01, target_objects)
    raise ValueError(f"unknown visualization mode {mode!r}")

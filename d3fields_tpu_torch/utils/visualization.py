"""Colour helpers of the visualization layer.

Counterpart of ``d3fields_tpu/utils/visualization.py:24-50``: the
matplotlib-free ``jet_colors``, ``instance_palette`` and
``blend_instance_mask``. ``TrackVis`` (the tracking video) is not ported
yet.
"""

from __future__ import annotations

import numpy as np


def jet_colors(values: np.ndarray) -> np.ndarray:
    """values in [0,1] -> (N, 3) RGB in [0,1] (matplotlib 'jet')."""
    v = np.clip(np.asarray(values, np.float64), 0, 1)
    r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
    return np.stack([r, g, b], -1)


def instance_palette(n: int) -> np.ndarray:
    """(n, 3) uint8 distinct colours (jet-spread, the reference's
    ``vis_curr_mask`` / ``create_instance_mask_mesh`` convention)."""
    if n <= 1:
        return np.zeros((max(n, 1), 3), np.uint8)
    return (jet_colors(np.arange(n) / (n - 1)) * 255).astype(np.uint8)


def blend_instance_mask(color_bgr: np.ndarray, index_mask: np.ndarray,
                        alpha: float = 0.5) -> np.ndarray:
    """Jet-coloured instance overlay (``Fusion.vis_curr_mask``,
    ``fusion.py:1687-1697``): color (H, W, 3) BGR uint8, index_mask (H, W)."""
    palette = instance_palette(int(index_mask.max()) + 1)
    overlay = palette[index_mask.astype(np.int64)][..., ::-1]  # BGR
    out = (1 - alpha) * color_bgr.astype(np.float32) + alpha * overlay
    return out.astype(np.uint8)

"""Colour helpers of the visualization layer.

Counterpart of ``d3fields_tpu/utils/visualization.py:24-31``: the
matplotlib-free ``jet_colors``. ``TrackVis`` (the tracking video) is not
ported yet.
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

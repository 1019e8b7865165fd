"""Per-view open-text segmentation output.

The part of ``d3fields_tpu/seg/instances.py`` that segmentation returns:
:class:`ViewMasks`. The cross-view instance association of that module
comes with the ``vis_repr`` slice.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class ViewMasks:
    """Per-view open-text segmentation output (grounded-SAM contract,
    ``utils/grounded_sam.py:404-442``): mask 0 is the background complement."""

    masks: np.ndarray           # (num_inst, H, W) bool
    labels: List[str]           # len num_inst, labels[0] == 'background'
    confidences: np.ndarray     # (num_inst,)

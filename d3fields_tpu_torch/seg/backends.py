"""Mask backends: sources of per-view open-text instance masks.

Counterpart of ``d3fields_tpu/seg/backends.py``. Segmentation is a
protocol, so the pipeline runs with :class:`PrecomputedMaskBackend` (masks
exported offline) or ``GroundedSAMBackend`` (``seg/grounded_sam.py``,
GroundingDINO + SAM).

Contract (``grounded_instance_sam_new_ver``): ``segment`` returns a
:class:`ViewMasks` whose mask 0 is the background = complement of the union
of detections, confidence 1.0, labels led by 'background'. The robot
point-cloud filters of the JAX module come with the host geometry helpers
of the ``vis_repr`` slice.
"""

from __future__ import annotations

from typing import List, Protocol, Sequence

import numpy as np

from d3fields_tpu_torch.seg.instances import ViewMasks


class MaskBackend(Protocol):
    def segment(
        self,
        image: np.ndarray,
        queries: Sequence[str],
        thresholds: Sequence[float],
    ) -> ViewMasks:
        ...


def with_background(masks: np.ndarray, labels: List[str], confs: np.ndarray) -> ViewMasks:
    """Prepend the background mask = NOT(union of instance masks), conf 1.0
    (``utils/grounded_sam.py:437-440``)."""
    bg = ~np.any(masks, axis=0) if masks.shape[0] else np.ones(masks.shape[1:], bool)
    return ViewMasks(
        masks=np.concatenate([bg[None], masks], axis=0),
        labels=["background"] + list(labels),
        confidences=np.concatenate([[1.0], confs]).astype(np.float32),
    )


class PrecomputedMaskBackend:
    """Serves masks recorded per view (list of ViewMasks), in turn."""

    def __init__(self, per_view: List[ViewMasks]):
        self.per_view = per_view
        self._cursor = 0

    def segment(self, image, queries, thresholds) -> ViewMasks:
        vm = self.per_view[self._cursor % len(self.per_view)]
        self._cursor += 1
        return vm

    def reset(self):
        self._cursor = 0

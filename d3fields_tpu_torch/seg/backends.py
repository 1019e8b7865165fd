"""Mask backends: sources of per-view open-text instance masks.

Counterpart of ``d3fields_tpu/seg/backends.py``. Segmentation is a
protocol, so the pipeline runs with :class:`PrecomputedMaskBackend` (masks
exported offline) or ``GroundedSAMBackend`` (``seg/grounded_sam.py``,
GroundingDINO + SAM).

Contract (``grounded_instance_sam_new_ver``): ``segment`` returns a
:class:`ViewMasks` whose mask 0 is the background = complement of the union
of detections, confidence 1.0, labels led by 'background'.
:func:`filter_masks_by_robot_pcd` removes mask pixels that back-project
onto a given (robot) point cloud.
"""

from __future__ import annotations

from typing import List, Protocol, Sequence

import numpy as np

from d3fields_tpu_torch.fields.geometry import camera_to_world_np, depth_to_points_np
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


def rm_mask_close_to_pcd(
    depth: np.ndarray,
    mask: np.ndarray,
    pcd: np.ndarray,
    K: np.ndarray,
    pose44: np.ndarray,
    threshold: float = 0.02,
) -> np.ndarray:
    """Remove mask pixels whose backprojection lies within ``threshold`` of a
    given (robot) point cloud (``rm_mask_close_to_pcd``, ``fusion.py:182-200``)."""
    cam_params = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    pts_cam = depth_to_points_np(depth, mask, cam_params)
    pts_world = camera_to_world_np(pts_cam, pose44)
    if pts_world.shape[0] == 0:
        return mask
    close = (
        np.linalg.norm(pts_world[:, None, :] - pcd[None], axis=-1).min(axis=-1)
        < threshold
    )
    valid = np.logical_and(mask, depth > 0)
    ys, xs = np.nonzero(valid)
    out = mask.copy()
    out[ys[close], xs[close]] = False
    return out


def filter_masks_by_robot_pcd(
    view: ViewMasks,
    depth: np.ndarray,
    K: np.ndarray,
    pose44: np.ndarray,
    robot_pcd: np.ndarray,
    min_pixels: int = 10,
) -> ViewMasks:
    """Apply the robot filter per instance and drop nearly-empty masks
    (``fusion.py:1121-1136``)."""
    keep_masks, keep_labels, keep_confs = [], [], []
    for i in range(view.masks.shape[0]):
        m = rm_mask_close_to_pcd(depth, view.masks[i], robot_pcd, K, pose44)
        if m.sum() < min_pixels:
            continue
        keep_masks.append(m)
        keep_labels.append(view.labels[i])
        keep_confs.append(view.confidences[i])
    return ViewMasks(
        masks=np.stack(keep_masks, axis=0) if keep_masks else np.zeros((0,) + depth.shape, bool),
        labels=keep_labels,
        confidences=np.asarray(keep_confs, np.float32),
    )

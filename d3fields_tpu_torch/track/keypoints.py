"""Keypoint selection on the fused field.

Counterpart of ``d3fields_tpu/track/keypoints.py:28-92``, the reference's
``select_features_rand`` / ``select_features_from_pcd``
(``fusion.py:1418-1540``): evaluate the field over a fine grid (or a given
cloud), keep near-surface points (|dist| < 5 mm) with instance probability
> 0.6, farthest-point-sample N keypoints per instance (native C++), and
read their descriptors from the field. The grid query runs on the state's
device; the per-instance bookkeeping stays on the host. The depth-image
variant (``select_keypoints_from_depth``) is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from d3fields_tpu_torch.fields import fusion as ffusion
from d3fields_tpu_torch.fields.geometry import create_grid
from d3fields_tpu_torch.fields.state import FieldState
from d3fields_tpu_torch.ops.pointcloud_native import fps_native

DIST_THRESHOLD = 0.005
PROB_THRESHOLD = 0.6


def select_keypoints(
    state: FieldState,
    consensus_labels: Sequence[str],
    boundaries,
    num_per_instance: int,
    *,
    res: float = 0.001,
    per_instance: bool = True,
    init_idx: int = -1,
    pcd: Optional[np.ndarray] = None,
    tile: int = 32768,
) -> Tuple[List[np.ndarray], List[np.ndarray], List[int]]:
    """Returns (src_feats_list, src_pts_list, instance_ids), numpy arrays.

    ``pcd`` switches from grid sampling (``select_features_rand``) to cloud
    sampling (``select_features_from_pcd``). ``init_idx=-1`` keeps the
    reference's random FPS start; pass a fixed index for determinism.
    """
    if pcd is None:
        grid, _ = create_grid(boundaries, res)
        cand = grid.astype(np.float32)
    else:
        cand = np.asarray(pcd, np.float32)

    out = ffusion.batch_eval(state, cand, ("mask",), tile=tile)
    dist = out["dist"].cpu().numpy()
    valid = out["valid_mask"].cpu().numpy()
    mask = out["mask"].cpu().numpy()
    del out
    mask = mask / (mask.sum(axis=1, keepdims=True) + 1e-7)
    near_surface = np.abs(dist) < DIST_THRESHOLD

    src_feats_list: List[np.ndarray] = []
    src_pts_list: List[np.ndarray] = []
    instance_ids: List[int] = []
    last_label = consensus_labels[0]
    for i in range(1, len(consensus_labels)):
        if consensus_labels[i] == last_label and not per_instance:
            continue
        sel = (mask[:, i] > PROB_THRESHOLD) & near_surface & valid
        pts = cand[sel]
        if pts.shape[0] == 0:
            continue
        sample_pts, _ = fps_native(pts, num_per_instance, init_idx=init_idx)
        with torch.no_grad():
            feats = ffusion.eval_field(
                state, torch.as_tensor(sample_pts, device=state.device), ("dino_feats",)
            )["dino_feats"]
        src_feats_list.append(feats.cpu().numpy())
        src_pts_list.append(sample_pts)
        instance_ids.append(i)
        last_label = consensus_labels[i]
    return src_feats_list, src_pts_list, instance_ids


def project_to_view(
    pts: np.ndarray, pose34: np.ndarray, K: np.ndarray
) -> np.ndarray:
    """World points -> integer pixel coords in one view (visualization path,
    ``fusion.py:1459-1470``)."""
    h = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=-1)
    cam = (pose34 @ h.T)[:3].T
    uv = cam[:, :2] / cam[:, 2:]
    uv[:, 0] = uv[:, 0] * K[0, 0] + K[0, 2]
    uv[:, 1] = uv[:, 1] * K[1, 1] + K[1, 2]
    return uv.astype(np.int32)

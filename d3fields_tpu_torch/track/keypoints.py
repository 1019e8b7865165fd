"""Keypoint selection on the fused field.

Counterpart of ``d3fields_tpu/track/keypoints.py:28-92``, the reference's
``select_features_rand`` / ``select_features_from_pcd``
(``fusion.py:1418-1540``): evaluate the field over a fine grid (or a given
cloud), keep near-surface points (|dist| < 5 mm) with instance probability
> 0.6, farthest-point-sample N keypoints per instance (native C++), and
read their descriptors from the field. The grid query runs on the state's
device; the per-instance bookkeeping stays on the host.

:func:`select_keypoints_from_depth` is the depth-image variant
(``select_features_rand_v2``): FPS over each view's eroded mask pixels,
back-projected through the depth map. :func:`select_src_feats_at_pixels`
reads descriptors of a patch map at image pixels (the reference's
interactive picker, headless).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from d3fields_tpu_torch.fields import fusion as ffusion
from d3fields_tpu_torch.fields.geometry import create_grid
from d3fields_tpu_torch.fields.state import FieldState
from d3fields_tpu_torch.models.resize import _linear_weights_1d
from d3fields_tpu_torch.ops.pointcloud_native import fps_native
from d3fields_tpu_torch.seg.instances import erode_mask

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
        src_feats_list.append(_descriptors(state, sample_pts))
        src_pts_list.append(sample_pts)
        instance_ids.append(i)
        last_label = consensus_labels[i]
    return src_feats_list, src_pts_list, instance_ids


def _descriptors(state: FieldState, pts: np.ndarray) -> np.ndarray:
    """The field's fused descriptors at ``pts`` (the unfused query)."""
    with torch.no_grad():
        feats = ffusion.eval_field(
            state, torch.as_tensor(pts, device=state.device), ("dino_feats",))["dino_feats"]
    return feats.cpu().numpy()


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


def select_keypoints_from_depth(
    state: FieldState,
    consensus_labels: Sequence[str],
    num_per_cam: int,
    *,
    per_instance: bool = True,
    max_depth: float = 1.5,
    erode_px: int = 15,
    init_idx: int = 0,
) -> Tuple[List[np.ndarray], List[np.ndarray], List[int]]:
    """Depth-backprojection keypoints (``select_features_rand_v2``,
    ``fusion.py:1543-1606``): per view, FPS over the pixels of the eroded
    instance mask (``erode_px`` square), back-projected through the depth
    map to world points, concatenated across views and padded by
    duplication to ``V * num_per_cam`` (a view with an empty eroded mask
    gives nothing, where the reference asserts), with their descriptors
    read from the field."""
    depth = state.depth.cpu().numpy()
    Ks = state.K.cpu().numpy()
    poses = state.pose.cpu().numpy()
    mask = state.mask.cpu().numpy()
    V = depth.shape[0]

    src_feats_list: List[np.ndarray] = []
    src_pts_list: List[np.ndarray] = []
    instance_ids: List[int] = []
    last_label = consensus_labels[0]
    for i in range(1, len(consensus_labels)):
        if consensus_labels[i] == last_label and not per_instance:
            continue
        pts_all = []
        for v in range(V):
            m = mask[v, :, :, i].astype(bool) & (depth[v] > 0.0) & (depth[v] < max_depth)
            pix = np.argwhere(erode_mask(m, erode_px)).astype(np.float32)  # (n, 2) = (y, x)
            if pix.shape[0] == 0:
                continue
            # FPS pads a small set by duplication, so every view that
            # contributes gives num_per_cam points
            sel, _ = fps_native(np.concatenate([pix, np.zeros_like(pix[:, :1])], 1),
                                num_per_cam, init_idx=init_idx)
            ys, xs = sel[:, 0].astype(int), sel[:, 1].astype(int)
            z = depth[v][ys, xs]
            K = Ks[v]
            cam = np.stack([(xs - K[0, 2]) * z / K[0, 0], (ys - K[1, 2]) * z / K[1, 1], z],
                           axis=1)
            R, t = poses[v][:, :3], poses[v][:, 3]
            pts_all.append((cam - t) @ R)  # camera -> world
        if not pts_all:
            continue
        sample_pts = np.concatenate(pts_all, axis=0).astype(np.float32)
        want = V * num_per_cam
        if sample_pts.shape[0] < want:
            reps = np.resize(np.arange(sample_pts.shape[0]), want - sample_pts.shape[0])
            sample_pts = np.concatenate([sample_pts, sample_pts[reps]], axis=0)
        src_feats_list.append(_descriptors(state, sample_pts))
        src_pts_list.append(sample_pts)
        instance_ids.append(i)
        last_label = consensus_labels[i]
    return src_feats_list, src_pts_list, instance_ids


def select_src_feats_at_pixels(
    feat_map: np.ndarray, pixels: np.ndarray, image_hw: Tuple[int, int]
) -> np.ndarray:
    """Descriptors at (x, y) image pixels of a (ph, pw, D) patch map
    upsampled bilinearly (align_corners=False) to ``image_hw``
    (``select_src_feats_from_online``, ``utils/my_utils.py:781-860``),
    evaluated at the pixels only."""
    ph, pw = feat_map.shape[:2]
    H, W = image_hw
    ty, wy = _linear_weights_1d(ph, H)
    tx, wx = _linear_weights_1d(pw, W)
    px = np.asarray(pixels, np.int64)
    xs, ys = px[:, 0], px[:, 1]
    out = 0.0
    for a in range(2):
        for b in range(2):
            w = (wy[ys, a] * wx[xs, b])[:, None]
            out = out + w * feat_map[ty[ys, a], tx[xs, b]]
    return np.asarray(out, feat_map.dtype)

"""Farthest point sampling.

Counterpart of ``d3fields_tpu/ops/fps.py``. The reference keeps FPS on the
host as a python loop over numpy (``fps_np``, ``utils/my_utils.py:478-497``),
the keypoint-selection hot loop (``fusion.py:1447,1505,1566``). Here:

- :func:`fps`: the device version, a loop of O(N) distance updates on the
  points' device;
- :func:`fps_np`: the host version with reference-identical semantics
  (random or given start index, returns (samples, indices, max residual)).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


@torch.no_grad()
def fps(
    pts: Tensor,
    num_samples: int,
    init_idx: int = 0,
    valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Farthest point sampling on the points' device.

    Args:
      pts: (N, C) points.
      num_samples: number of samples.
      init_idx: index of the first sample.
      valid: optional (N,) bool; invalid points are never selected (their
        distance is pinned to -inf).

    Returns: (samples (S, C), indices (S,) int64, max residual distance).
    """
    pin = None
    if valid is not None:
        pin = torch.where(valid, 0.0, float("-inf")).to(pts.dtype)

    def dist_to(i):
        d = torch.linalg.norm(pts - pts[i], dim=1)
        return d if pin is None else d + pin

    idxs = torch.zeros(num_samples, dtype=torch.int64, device=pts.device)
    idxs[0] = init_idx
    dist = dist_to(init_idx)
    for i in range(1, num_samples):
        nxt = torch.argmax(dist)
        idxs[i] = nxt
        dist = torch.minimum(dist, dist_to(nxt))
    return pts[idxs], idxs, torch.max(dist)


def fps_np(
    pcd: np.ndarray, particle_num: int, init_idx: int = -1
) -> Tuple[np.ndarray, list, float]:
    """Host FPS with the reference contract (``utils/my_utils.py:478-497``):
    ``init_idx=-1`` draws a random start via ``np.random.randint``."""
    assert pcd.shape[0] > 0
    start = np.random.randint(pcd.shape[0]) if init_idx == -1 else init_idx
    fps_idx = [int(start)]
    dist = np.linalg.norm(pcd - pcd[start], axis=1)
    while len(fps_idx) < particle_num:
        nxt = int(dist.argmax())
        fps_idx.append(nxt)
        dist = np.minimum(dist, np.linalg.norm(pcd - pcd[nxt], axis=1))
    return pcd[fps_idx], fps_idx, float(dist.max())

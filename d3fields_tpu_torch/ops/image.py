"""Image-space ops: distance maps and depth normals.

Counterpart of ``d3fields_tpu/ops/image.py``, in torch on the caller's
device:

- :func:`seed_distance_maps`: the fbrs click-distance maps
  (``XMem/inference/interact/fbrs/utils/cython/_get_dist_maps.pyx``) as an
  exact Euclidean distance field from a few seed points;
- :func:`depth_to_normal`: ``depth2normal`` (``utils/my_utils.py:891-926``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def seed_distance_maps(seeds: Tensor, valid: Tensor, hw: Tuple[int, int],
                       norm_radius: float = 1.0) -> Tensor:
    """seeds (S, 2) (y, x) float, valid (S,) bool -> (H, W) distance to the
    nearest valid seed over ``norm_radius`` (invalid seeds count as +inf)."""
    H, W = hw
    ys = torch.arange(H, dtype=torch.float32, device=seeds.device)
    xs = torch.arange(W, dtype=torch.float32, device=seeds.device)
    d2 = ((ys[:, None, None] - seeds[None, None, :, 0]).square()
          + (xs[None, :, None] - seeds[None, None, :, 1]).square())  # (H, W, S)
    d2 = torch.where(valid[None, None, :], d2, torch.full_like(d2, float("inf")))
    return d2.min(dim=-1).values.sqrt() / norm_radius


def depth_to_normal(depth: Tensor, K: Tensor) -> Tensor:
    """(H, W) metric depth -> (H, W, 3) camera-space unit normals from
    central differences of the back-projected point map (one-sided at the
    border), oriented toward the camera."""
    H, W = depth.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=depth.dtype, device=depth.device),
                            torch.arange(W, dtype=depth.dtype, device=depth.device),
                            indexing="ij")
    x = (xs - K[0, 2]) / K[0, 0] * depth
    y = (ys - K[1, 2]) / K[1, 1] * depth
    pts = torch.stack([x, y, depth], dim=0)[None]  # (1, 3, H, W)
    p = F.pad(pts, (1, 1, 1, 1), mode="replicate")[0]
    du = ((p[:, 1:-1, 2:] - p[:, 1:-1, :-2]) * 0.5).permute(1, 2, 0)
    dv = ((p[:, 2:, 1:-1] - p[:, :-2, 1:-1]) * 0.5).permute(1, 2, 0)
    n = torch.linalg.cross(du, dv, dim=-1)
    n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-9)
    return n * torch.sign(-n[..., 2:3] + 1e-12)

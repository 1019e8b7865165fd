"""SO(3) exponential map and rigid transforms, hand-rolled (no pytorch3d).

Counterpart of ``d3fields_tpu/ops/so3.py``. The reference parameterizes
per-instance rigid motion as (t, log_r) and maps it through pytorch3d's
``so3_exp_map`` + ``Transform3d().rotate(R).translate(t)``
(``fusion.py:1643-1646``), i.e. the row-vector convention ``p' = p @ R + t``.
The exponential is the eps-regularized Rodrigues formula of the JAX package,
not ``torch.linalg.matrix_exp``: the tracker starts at ``log_r = 0``, where
the two give different gradients.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def hat(w: Tensor) -> Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrices."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(log_r: Tensor, eps: float = 1e-8) -> Tensor:
    """Rodrigues exponential map: (..., 3) axis-angle -> (..., 3, 3) rotation,
    finite with finite gradients at the identity."""
    theta2 = torch.sum(log_r * log_r, dim=-1)
    theta = torch.sqrt(theta2 + eps)
    K = hat(log_r)
    K2 = K @ K
    s = torch.sin(theta) / theta
    c = (1.0 - torch.cos(theta)) / (theta2 + eps)
    eye = torch.eye(3, dtype=log_r.dtype, device=log_r.device).expand(K.shape)
    return eye + s[..., None, None] * K + c[..., None, None] * K2


def rigid_transform_points(pts: Tensor, log_r: Tensor, t: Tensor) -> Tensor:
    """Apply per-instance rigid motion in the reference's row convention.

    Args:
      pts: (I, P, 3) per-instance points.
      log_r: (I, 3) axis-angle.
      t: (I, 3) translation.

    Returns (I, P, 3): ``pts @ so3_exp(log_r) + t``.
    """
    return pts @ so3_exp(log_r) + t[:, None, :]

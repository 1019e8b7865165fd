"""Constrained volume smoothing on the device.

Counterpart of ``d3fields_tpu/mesh/smoothing.py``, with its PyMCubes
contract (reference ``fusion.py:1323``: ``mcubes.smooth`` before marching
cubes): the volume is binarized at 0.5, and the output is a smooth field
whose zero level set approximates the 0.5 level set of the binarized
input, positive inside the ``>0.5`` region and negative outside. Repeated
6-neighbour Jacobi averaging with edge replication, every voxel's sign
clamped back to its binary side (magnitude at least 1e-3) after each step.
The sum is taken in the JAX order: six neighbours, then ``+ 2*phi``, then
``/ 8``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

SIGN_EPS = 1e-3


def _diffuse_step(phi: Tensor) -> Tensor:
    """One 6-neighbour Jacobi averaging step with edge replication."""
    p = F.pad(phi[None, None], (1, 1, 1, 1, 1, 1), mode="replicate")[0, 0]
    return (
        p[:-2, 1:-1, 1:-1]
        + p[2:, 1:-1, 1:-1]
        + p[1:-1, :-2, 1:-1]
        + p[1:-1, 2:, 1:-1]
        + p[1:-1, 1:-1, :-2]
        + p[1:-1, 1:-1, 2:]
        + 2.0 * phi
    ) / 8.0


@torch.no_grad()
def smooth_volume(volume: Tensor, iters: int = 20) -> Tensor:
    """Smooth a (possibly binary) (n0, n1, n2) volume into a signed
    float32 field on the volume's device, positive where ``volume > 0.5``."""
    inside = volume > 0.5
    phi = torch.where(inside, 0.5, -0.5).to(torch.float32)
    for _ in range(iters):
        phi = _diffuse_step(phi)
        phi = torch.where(inside, torch.clamp(phi, min=SIGN_EPS), torch.clamp(phi, max=-SIGN_EPS))
    return phi

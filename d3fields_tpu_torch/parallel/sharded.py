"""Multi-device field evaluation: the query points split over a mesh.

Counterpart of ``d3fields_tpu/parallel/sharded.py``. The observation state
is small (a few feature maps) and is replicated; the points are padded to
a whole number of tiles per device and split; each device runs
:func:`fusion.batch_eval` on its shard, and no collective is needed until
the outputs are gathered on the mesh's first device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from d3fields_tpu_torch.fields import fusion, kernels
from d3fields_tpu_torch.fields.state import FieldState
from d3fields_tpu_torch.parallel.mesh import Mesh, gather_leading, replicate, shard_leading

Tensor = torch.Tensor


def sharded_batch_eval(mesh: Mesh, state: FieldState, pts,
                       return_names: Tuple[str, ...] = ("dino_feats", "mask"), *,
                       tile: int = 32768, fused: bool = False,
                       matmul_dtype: str = "float32") -> Dict[str, Tensor]:
    """:func:`fusion.batch_eval` with the points split over the mesh: the
    state replicated to each device (its patch maps rounded once first on
    the bf16 route), the points padded with zeros to a multiple of ``tile``
    x the mesh size and split evenly, each shard evaluated ``tile`` points
    at a time on its device (``fused`` and ``matmul_dtype`` as in
    ``batch_eval``), and the outputs cut back to the points given and
    gathered on the mesh's first device."""
    pts = torch.as_tensor(pts)
    n = pts.shape[0]
    per = tile * mesh.size
    padded = -(-n // per) * per
    if padded != n:
        pts = torch.cat([pts, pts.new_zeros((padded - n,) + tuple(pts.shape[1:]))])
    if fused:
        state = kernels.round_patch_maps(state, return_names, matmul_dtype)
    states = replicate(mesh, state)
    outs = [fusion.batch_eval(states[d], shard, return_names, tile=tile, fused=fused,
                              matmul_dtype=matmul_dtype)
            for d, shard in zip(mesh.devices, shard_leading(mesh, pts))]
    return {k: v[:n] for k, v in gather_leading(mesh, outs).items()}

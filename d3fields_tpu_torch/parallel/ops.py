"""Cross-process collective ops.

Counterpart of ``d3fields_tpu/parallel/ops.py``: the fbrs SyncBN CUDA
extension of the reference (``XMem/inference/interact/fbrs/model/syncbn``)
is, in the JAX package, a ``psum`` over a mesh axis; here an all-reduce
over a ``torch.distributed`` process group (NCCL on the card, gloo on the
CPU). Both go through ``torch.distributed.nn.functional``, whose backward
is the collective's transpose, so gradients flow through the global
moments as they do through ``psum``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

Tensor = torch.Tensor


def _group(group) -> dict:
    return {} if group is None else {"group": group}


def sync_batch_norm(x: Tensor, scale: Tensor, bias: Tensor, group=None, *, eps: float = 1e-5,
                    reduce_axes: Tuple[int, ...] = (0, 1, 2)) -> Tuple[Tensor, Tensor, Tensor]:
    """Training-mode batch norm with the statistics of every rank of
    ``group`` (the default group when None).

    ``x`` is this rank's shard, (B, H, W, C) with the default
    ``reduce_axes``. The sum, the sum of squares and the element count are
    all-reduced before normalising (fbrs syncbn's forward). Returns
    (normalised, mean, var) with the global moments."""
    from torch.distributed.nn.functional import all_reduce

    s = x.sum(dim=reduce_axes)
    ss = (x * x).sum(dim=reduce_axes)
    n_local = math.prod(x.shape[a] for a in reduce_axes)
    count = torch.full((1,), float(n_local), dtype=x.dtype, device=x.device)
    stats = all_reduce(torch.cat([s.reshape(-1), ss.reshape(-1), count]), **_group(group))
    k = s.numel()
    n = stats[2 * k]
    mean = stats[:k].reshape(s.shape) / n
    var = stats[k:2 * k].reshape(s.shape) / n - mean * mean
    return (x - mean) * (torch.rsqrt(var + eps) * scale) + bias, mean, var


def all_gather_points(x: Tensor, group=None) -> Tensor:
    """Every rank's shard of points concatenated along axis 0, in rank
    order (a tiled all-gather; the shards share one shape)."""
    from torch.distributed.nn.functional import all_gather

    return torch.cat(all_gather(x, **_group(group)), dim=0)

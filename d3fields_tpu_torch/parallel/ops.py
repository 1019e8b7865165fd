"""Cross-process collective ops.

Counterpart of ``d3fields_tpu/parallel/ops.py``: the fbrs SyncBN CUDA
extension of the reference (``XMem/inference/interact/fbrs/model/syncbn``)
is, in the JAX package, a ``psum`` over a mesh axis; here an all-reduce
over a ``torch.distributed`` process group (NCCL on the card, gloo on the
CPU). Both go through ``torch.distributed.nn.functional``, whose backward
is the collective's transpose, so gradients flow through the global
moments as they do through ``psum``.

The data-parallel train step needs two more, which the JAX package never
names because ``jit`` inserts the ``psum`` of the gradients itself:
:func:`average_gradients` and :func:`broadcast_tensors`. They use only
``all_reduce`` and ``broadcast``, the two collectives a gloo group also
runs on CUDA tensors.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

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


def _flat_layout(tensors: Sequence[Tensor]) -> None:
    if len({(t.dtype, t.device) for t in tensors}) > 1:
        raise ValueError("the tensors of one flattened collective share a dtype and a device")


def average_gradients(leaves: Sequence[Tensor], group=None) -> None:
    """Replace each leaf's ``.grad`` by its mean over the ranks of ``group``
    (the default group when None): one all-reduce of every gradient
    flattened together, divided by the world size. A leaf whose ``.grad``
    is None counts as zeros, as ``jax.grad`` gives zeros, so every rank
    reduces the same layout; after the call every leaf has a ``.grad``
    (a view of the one reduced buffer)."""
    import torch.distributed as dist

    _flat_layout(leaves)
    flat = torch.cat([(t.grad if t.grad is not None else torch.zeros_like(t)).reshape(-1)
                      for t in leaves])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for t in leaves:
        t.grad = flat[offset:offset + t.numel()].view_as(t)
        offset += t.numel()


def broadcast_tensors(tensors: Sequence[Tensor]) -> None:
    """Overwrite ``tensors`` on every rank of the default group with rank
    0's, in place and flattened into one broadcast: DDP's broadcast of the
    state when it wraps a model."""
    import torch.distributed as dist

    _flat_layout(tensors)
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, 0)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

"""Descriptor correspondence: similarity fields between feature sets.

Counterpart of ``d3fields_tpu/ops/corr.py`` (the reference's
``utils/corr_utils.py``: ``compute_similarity_tensor[_multi]``,
``compute_dist_tensor``): a softmax over negative scaled distances between
source descriptors and a target descriptor set. The reference catches GPU
OOM and rebatches; here the pairwise distance runs in fixed-size tiles of
the target set, so the products' working memory does not grow with it.
The product in each tile is ``torch.matmul`` on the caller's device, as
the JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def pairwise_sq_dist(src: Tensor, tgt: Tensor, *, tile: int = 4096) -> Tensor:
    """src (S, D), tgt (N, D) -> (S, N) squared L2, tiled over N."""
    s_sq = src.square().sum(1)
    out = torch.empty(src.shape[0], tgt.shape[0], dtype=src.dtype, device=src.device)
    for i in range(0, tgt.shape[0], tile):
        t = tgt[i:i + tile]
        out[:, i:i + tile] = s_sq[:, None] - 2.0 * (src @ t.T) + t.square().sum(1)[None, :]
    return out


def similarity_softmax(src: Tensor, tgt: Tensor, scale: float = 0.5, *,
                       tile: int = 4096) -> Tensor:
    """(S, N) correspondence distribution: softmax_n(-scale * ||s - t_n||)
    (``compute_similarity_tensor``, ``corr_utils.py:20-40``)."""
    dist = pairwise_sq_dist(src, tgt, tile=tile).clamp_min(0.0).sqrt()
    return torch.softmax(-scale * dist, dim=1)


def best_matches(src: Tensor, tgt: Tensor, tgt_pts: Tensor, *,
                 tile: int = 4096) -> Tuple[Tensor, Tensor]:
    """Hard correspondence: each source's nearest target point and its
    distance (the DON-style best-match search,
    ``network/dense_correspondence_network.py:488-551``)."""
    d = pairwise_sq_dist(src, tgt, tile=tile)
    best, idx = d.min(dim=1)
    return tgt_pts[idx], best.clamp_min(0.0).sqrt()

"""BERT-base as GroundingDINO's text encoder runs it, in plain PyTorch.

Written from the BERT paper (arXiv:1810.04805) and huggingface
``BertModel`` (no pooler), which GroundingDINO calls with a 3-D attention
mask and explicit position ids (``gdino.text_masks``): word, position and
type embeddings summed and layer-normed (eps 1e-12), then post-norm layers
of (self-attention over the tokens the mask allows, residual, layer norm,
exact-GELU MLP, residual, layer norm). A masked pair takes -inf before the
soft-max (huggingface adds the dtype's smallest value: the same weights).
Float32 in every mode but ``f64`` (the program keeps BERT in f32).
"""

from __future__ import annotations

import math

import torch

from port_bench.reference import layers as nn_
from port_bench.reference.precision import Precision

Tensor = torch.Tensor
LN_EPS = 1e-12


def forward(w: dict, ids: Tensor, mask3d: Tensor, position_ids: Tensor, heads: int,
            layers: int, P: Precision) -> Tensor:
    """ids (B, L), mask3d (B, L, L) bool (True: attends), position_ids
    (B, L); ``w`` the text backbone's leaves -> (B, L, D)."""
    x = (w["embeddings.word_embeddings.weight"][ids]
         + w["embeddings.position_embeddings.weight"][position_ids]
         + w["embeddings.token_type_embeddings.weight"][torch.zeros_like(ids)])
    x = nn_.layer_norm(P.r(x), w, "embeddings.LayerNorm", LN_EPS, P)
    B, L, D = x.shape
    hd = D // heads
    for i in range(layers):
        pre = f"encoder.layer.{i}."

        def split(t):
            return t.reshape(B, L, heads, hd).transpose(1, 2)

        q, k, v = (split(nn_.linear(x, w, pre + "attention.self." + n, P))
                   for n in ("query", "key", "value"))
        logits = nn_.matmul(q, k.transpose(-1, -2), P) / math.sqrt(hd)
        logits = logits.masked_fill(~mask3d[:, None], -math.inf)
        out = nn_.matmul(nn_.softmax(logits, P, x.dtype), v, P)
        out = out.transpose(1, 2).reshape(B, L, D)
        x = nn_.layer_norm(x + nn_.linear(out, w, pre + "attention.output.dense", P), w,
                           pre + "attention.output.LayerNorm", LN_EPS, P)
        h = nn_.gelu(nn_.linear(x, w, pre + "intermediate.dense", P), P)
        x = nn_.layer_norm(x + nn_.linear(h, w, pre + "output.dense", P), w,
                           pre + "output.LayerNorm", LN_EPS, P)
    return x

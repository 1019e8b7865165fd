"""BERT text encoder in PyTorch (GroundingDINO's text trunk).

Counterpart of ``d3fields_tpu/models/groundingdino/bert.py``. GroundingDINO
feeds BERT a 3D per-caption self-attention mask and explicit position ids
that restart after every special token (``model.generate_text_masks``).
Parameter names are huggingface ``BertModel``'s (``model.text_backbone.*``
inside a GroundingDINO state dict), without the pooler.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from d3fields_tpu_torch.models.common import embedding, linear, named

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2


class _BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        D, I = cfg.hidden_size, cfg.intermediate_size
        self.num_heads = cfg.num_heads
        self.attention = named(
            self=named(query=linear(D, D, device), key=linear(D, D, device),
                       value=linear(D, D, device)),
            output=named(dense=linear(D, D, device),
                         LayerNorm=nn.LayerNorm(D, eps=1e-12, device=device)))
        self.intermediate = named(dense=linear(D, I, device))
        self.output = named(dense=linear(I, D, device),
                            LayerNorm=nn.LayerNorm(D, eps=1e-12, device=device))

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        B, L, D = x.shape
        nh = self.num_heads
        hd = D // nh
        att = self.attention

        def heads(t: Tensor) -> Tensor:
            return t.reshape(B, L, nh, hd).transpose(1, 2)

        q, k, v = heads(att.self.query(x)), heads(att.self.key(x)), heads(att.self.value(x))
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd) + bias
        probs = torch.softmax(logits, dim=-1)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, D)
        x = att.output.LayerNorm(x + att.output.dense(out))
        h = F.gelu(self.intermediate.dense(x), approximate="none")
        return self.output.LayerNorm(x + self.output.dense(h))


class Bert(nn.Module):
    """BERT with huggingface ``BertModel`` parameter names (no pooler)."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        self.embeddings = named(
            word_embeddings=embedding(cfg.vocab_size, D, device),
            position_embeddings=embedding(cfg.max_position, D, device),
            token_type_embeddings=embedding(cfg.type_vocab_size, D, device),
            LayerNorm=nn.LayerNorm(D, eps=1e-12, device=device))
        self.encoder = named(layer=nn.ModuleList(
            [_BertLayer(cfg, device) for _ in range(cfg.num_layers)]))

    def forward(self, input_ids: Tensor, attention_mask_3d: Tensor, token_type_ids: Tensor,
                position_ids: Tensor) -> Tensor:
        """input_ids (B, L); attention_mask_3d (B, L, L) bool, True where a
        token attends. Returns the last hidden state (B, L, D)."""
        e = self.embeddings
        x = (e.word_embeddings(input_ids) + e.position_embeddings(position_ids)
             + e.token_type_embeddings(token_type_ids))
        x = e.LayerNorm(x)
        bias = torch.where(attention_mask_3d[:, None], 0.0, -1e30)  # (B, 1, L, L)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x

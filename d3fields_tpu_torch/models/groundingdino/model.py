"""GroundingDINO open-set detector in PyTorch.

Counterpart of ``d3fields_tpu/models/groundingdino/model.py``: Swin
backbone (``swin.py``), BERT text trunk (``bert.py``), the feature-enhancer
encoder (bi-directional vision/text fusion, text self-attention,
multi-scale deformable vision self-attention), language-guided top-k query
selection, and the cross-modality decoder with iterative box refinement.

- :class:`GroundingDino` keeps the parameter names of huggingface
  ``GroundingDinoForObjectDetection``, so its state dict loads with
  ``load_state_dict(strict=True)``; :func:`load_jax_params` carries the JAX
  package's parameter pytree across, and :func:`init_params` draws random
  weights as huggingface initialises them.
- Both deformable-attention sites, the 6 encoder layers (Q = S) and the 6
  decoder layers (Q = 900), sample through
  :func:`deform_gather.deform_gather`: the CUDA kernel on the card. The
  forward's ``gather=deform_gather_plain`` runs the same forward through the
  kernel's plain version, as an oracle.
- The gated trunk (Swin, the input projections with the extra level, and
  the 6 encoder layers, vision and text) runs in the dtype of its weights:
  float32, or bfloat16 under the detector's ``compute_dtype``
  (:func:`gated_copy`, JAX ``model.py:600-630, 742-802``). Inside it the
  layer and group norms, softmaxes, sampling offsets, attention weights
  and reference points are f32, and the encoder's gather reads the bf16
  ``value`` and returns f32. BERT, query selection, the decoder and the
  heads are always f32.
- Host-side constants (sine tables, reference grids, proposals, text
  masks) are numpy copies of the JAX package's, so they are its values to
  the bit.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from d3fields_tpu_torch.models.common import (
    cast_copy, embedding, host_to_device, linear, named)
from d3fields_tpu_torch.models.groundingdino import bert as B
from d3fields_tpu_torch.models.groundingdino import swin as SW
from d3fields_tpu_torch.models.groundingdino.deform_gather import deform_gather
from d3fields_tpu_torch.utils.device import resolve_device
from d3fields_tpu_torch.utils.profiling import tracer

Tensor = torch.Tensor
Gather = Callable[[Tensor, Sequence[Tuple[int, int]], Tensor, Tensor], Tensor]

# BERT ids treated as caption separators: [CLS], [SEP], '.', '?'
SPECIAL_TOKEN_IDS = (101, 102, 1012, 1029)


@dataclasses.dataclass(frozen=True)
class GroundingDinoConfig:
    d_model: int = 256
    num_feature_levels: int = 4
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_heads: int = 8
    decoder_heads: int = 8
    encoder_ffn_dim: int = 2048
    decoder_ffn_dim: int = 2048
    encoder_points: int = 4
    decoder_points: int = 4
    num_queries: int = 900
    max_text_len: int = 256
    pe_temperature: float = 20.0
    swin: SW.SwinConfig = SW.SwinConfig.tiny()
    text: B.BertConfig = B.BertConfig()

    @staticmethod
    def swin_b() -> "GroundingDinoConfig":
        """groundingdino_swinb_cogcoor (HF grounding-dino-base), the larger
        of the two checkpoints the reference downloads (its runtime default
        is swin-t)."""
        return GroundingDinoConfig(swin=SW.SwinConfig.base())

    @staticmethod
    def tiny_test() -> "GroundingDinoConfig":
        return GroundingDinoConfig(
            d_model=32, num_feature_levels=3, encoder_layers=2,
            decoder_layers=2, encoder_heads=4, decoder_heads=4,
            encoder_ffn_dim=64, decoder_ffn_dim=64, num_queries=16,
            max_text_len=32,
            swin=SW.SwinConfig(embed_dim=8, depths=(1, 1), num_heads=(2, 4),
                               window_size=4, out_stages=(0, 1)),
            text=B.BertConfig(vocab_size=2000, hidden_size=24, num_layers=2,
                              num_heads=2, intermediate_size=48, max_position=64),
        )


# the one trunk-width table: 96 = swin-t (the reference's runtime default),
# 128 = swin-b; trunk_name() and config_for_trunk() both read it
_TRUNKS = {
    96: ("swin_t", GroundingDinoConfig),
    128: ("swin_b", GroundingDinoConfig.swin_b),
}


def _require_trunk(embed_dim: int):
    if embed_dim not in _TRUNKS:
        known = ", ".join(f"{w} = {n}" for w, (n, _) in sorted(_TRUNKS.items()))
        raise ValueError(
            f"unsupported GroundingDINO trunk width {embed_dim} (know "
            f"{known}) — pass an explicit cfg"
        )
    return _TRUNKS[embed_dim]


def config_for_trunk(embed_dim: int) -> GroundingDinoConfig:
    """The config of a Swin patch-embed width, as the checkpoint loaders
    (``apps/_backends.py``) read it from a checkpoint."""
    return _require_trunk(embed_dim)[1]()


def trunk_name(embed_dim: int) -> str:
    """The trunk's label for a Swin embed width."""
    return _require_trunk(embed_dim)[0]


# ---------------------------------------------------------------------------
# host-side constants (numpy copies of the JAX package's)
# ---------------------------------------------------------------------------

def sine_position_embedding(h: int, w: int, d_model: int, temperature: float) -> np.ndarray:
    """DETR-style 2D sine embedding for an unpadded (h, w) map -> (h*w, D)
    (``GroundingDinoSinePositionEmbedding`` with an all-ones mask)."""
    half = d_model // 2
    scale = 2.0 * np.pi
    y = (np.arange(h, dtype=np.float32) + 1.0) / h * scale
    x = (np.arange(w, dtype=np.float32) + 1.0) / w * scale
    dim_t = temperature ** (2.0 * (np.arange(half) // 2) / half)
    py = y[:, None] / dim_t
    px = x[:, None] / dim_t

    def interleave(p):
        return np.stack([np.sin(p[:, 0::2]), np.cos(p[:, 1::2])], -1).reshape(p.shape[0], -1)

    py, px = interleave(py), interleave(px)
    pos = np.concatenate([np.broadcast_to(py[:, None], (h, w, half)),
                          np.broadcast_to(px[None, :], (h, w, half))], axis=-1)
    return pos.reshape(h * w, d_model).astype(np.float32)


def generate_text_masks(input_ids: np.ndarray):
    """Per-caption self-attention masks and restarting position ids
    (``generate_masks_with_special_tokens_and_transfer_map``)."""
    bsz, L = input_ids.shape
    special = np.isin(input_ids, SPECIAL_TOKEN_IDS)
    attn = np.eye(L, dtype=bool)[None].repeat(bsz, 0)
    pos_ids = np.zeros((bsz, L), np.int64)
    for b in range(bsz):
        prev = 0
        for col in np.nonzero(special[b])[0]:
            if col == 0 or col == L - 1:
                attn[b, col, col] = True
                pos_ids[b, col] = 0
            else:
                attn[b, prev + 1: col + 1, prev + 1: col + 1] = True
                pos_ids[b, prev + 1: col + 1] = np.arange(0, col - prev)
            prev = col
    return attn, pos_ids


def _grid_proposals(spatial_shapes, d_level_scale=0.05):
    """Per-pixel box proposals (``generate_encoder_output_proposals`` with an
    all-valid mask): (S, 4) (cx, cy, w, h) in inverse-sigmoid space, +inf
    at invalid positions, and the (S,) validity."""
    parts = []
    for level, (h, w) in enumerate(spatial_shapes):
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        grid = np.stack([(gx + 0.5) / w, (gy + 0.5) / h], -1)
        wh = np.full_like(grid, d_level_scale * (2.0 ** level))
        parts.append(np.concatenate([grid, wh], -1).reshape(-1, 4))
    props = np.concatenate(parts, 0)
    valid = ((props > 0.01) & (props < 0.99)).all(-1, keepdims=True)
    out = np.log(props / (1 - props))
    out[~valid[:, 0]] = np.inf
    return out, valid[:, 0]


def _encoder_reference_points(spatial_shapes) -> np.ndarray:
    """(S, 2) normalised pixel-centre grids of every level (valid ratios 1)."""
    refs = []
    for h, w in spatial_shapes:
        gy, gx = np.meshgrid(np.linspace(0.5, h - 0.5, h, dtype=np.float32) / h,
                             np.linspace(0.5, w - 0.5, w, dtype=np.float32) / w,
                             indexing="ij")
        refs.append(np.stack([gx, gy], -1).reshape(-1, 2))
    return np.concatenate(refs, 0)


@functools.lru_cache(maxsize=16)
def _sine_dim_t(num_pos_feats: int, temperature: float, device: torch.device) -> Tensor:
    """:func:`get_sine_pos_embed`'s frequencies on ``device``, copied there
    once: a copy from the host inside a forward waits for the device."""
    return torch.as_tensor(
        temperature ** (2.0 * (np.arange(num_pos_feats) // 2) / num_pos_feats),
        dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=16)
def _level_constants(spatial_shapes: Tuple[Tuple[int, int], ...], d_model: int,
                     temperature: float, device: torch.device) -> Dict[str, object]:
    """The forward's host-built tables for one level layout, on ``device``,
    copied there once per (layout, device): each level's sine position
    table, the encoder's reference points, and the query selection's
    proposals and their validity. A copy from the host inside a forward
    would wait for the device's queued work (a shard's encoder, or the
    shard before it)."""
    props, valid = _grid_proposals(spatial_shapes)

    def put(a):
        return torch.as_tensor(a, device=device)

    return {"pos": tuple(put(sine_position_embedding(h, w, d_model, temperature))
                         for h, w in spatial_shapes),
            "ref": put(_encoder_reference_points(spatial_shapes)),
            "proposals": put(props), "valid": put(valid)}


@functools.lru_cache(maxsize=16)
def _level_normalizer(spatial_shapes: Tuple[Tuple[int, int], ...],
                      device: torch.device) -> Tensor:
    """The deformable attention's (L, 2) (w, h) rows on ``device``, copied
    there once per layout (as :func:`_level_constants`)."""
    return torch.as_tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                           device=device)


def get_sine_pos_embed(pos: Tensor, num_pos_feats: int, temperature: float = 10000.0,
                       exchange_xy: bool = True) -> Tensor:
    """(..., n) positions -> (..., n*num_pos_feats) sine features."""
    dim_t = _sine_dim_t(num_pos_feats, temperature, pos.device)
    sx = pos[..., None] * (2.0 * np.pi) / dim_t  # (..., n, F)
    emb = torch.stack([sx[..., 0::2].sin(), sx[..., 1::2].cos()], -1).flatten(-2)
    parts = [emb[..., i, :] for i in range(pos.shape[-1])]
    if exchange_xy and len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, dim=-1)


def _group_norm32(x: Tensor, w: Tensor, b: Tensor, groups: int = 32, eps: float = 1e-5):
    """torch GroupNorm(32, C) over an NHWC map, in f32 and rounded back to
    ``x``'s dtype."""
    Bn, H, W, C = x.shape
    g = min(groups, C)
    xg = x.reshape(Bn, H, W, g, C // g).float()
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), keepdim=True, unbiased=False)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return (xg.reshape(Bn, H, W, C) * w.float() + b.float()).to(x.dtype)


def _inverse_sigmoid(r: Tensor) -> Tensor:
    rc = r.clamp(1e-5, 1 - 1e-5)
    return torch.log(rc / (1 - rc))


def contrastive_logits(vision: Tensor, text: Tensor, text_token_mask: Tensor,
                       max_text_len: int) -> Tensor:
    """(``GroundingDinoContrastiveEmbedding``): (B, Q, max_text_len), -inf
    past the text."""
    out = torch.matmul(vision, text.transpose(1, 2))
    out = torch.where(text_token_mask[:, None, :], out, -math.inf)
    pad = max_text_len - out.shape[-1]
    if pad > 0:
        out = F.pad(out, (0, pad), value=-math.inf)
    return out[..., :max_text_len]


# ---------------------------------------------------------------------------
# modules (huggingface parameter names)
# ---------------------------------------------------------------------------

class _MLPHead(nn.Module):
    """N-layer ReLU MLP (``GroundingDinoMLPPredictionHead``)."""

    def __init__(self, d_in: int, hidden: int, d_out: int, num_layers: int, device):
        super().__init__()
        dims = [d_in] + [hidden] * (num_layers - 1)
        outs = [hidden] * (num_layers - 1) + [d_out]
        self.layers = nn.ModuleList([linear(i, o, device) for i, o in zip(dims, outs)])

    def forward(self, x: Tensor) -> Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class _MultiheadAttention(nn.Module):
    """``GroundingDinoMultiheadAttention``: an additive bias before the softmax."""

    def __init__(self, d: int, num_heads: int, device):
        super().__init__()
        self.num_heads = num_heads
        self.query = linear(d, d, device)
        self.key = linear(d, d, device)
        self.value = linear(d, d, device)
        self.out_proj = linear(d, d, device)

    def forward(self, queries: Tensor, keys: Tensor, values: Tensor, bias=None) -> Tensor:
        Bn, Tq, D = queries.shape
        nh = self.num_heads
        hd = D // nh

        def heads(t: Tensor) -> Tensor:
            return t.reshape(Bn, t.shape[1], nh, hd).transpose(1, 2)

        q, k, v = heads(self.query(queries)), heads(self.key(keys)), heads(self.value(values))
        # scaled in f32, as the JAX package's division by a numpy scalar promotes
        logits = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd)
        if bias is not None:
            logits = logits + bias
        probs = torch.softmax(logits, dim=-1).to(queries.dtype)
        return self.out_proj(torch.matmul(probs, v).transpose(1, 2).reshape(Bn, Tq, D))


class _BiAttention(nn.Module):
    """``GroundingDinoBiMultiHeadAttention``: returns (delta_vision, delta_text)."""

    def __init__(self, d: int, embed_dim: int, num_heads: int, device):
        super().__init__()
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.vision_proj = linear(d, embed_dim, device)
        self.text_proj = linear(d, embed_dim, device)
        self.values_vision_proj = linear(d, embed_dim, device)
        self.values_text_proj = linear(d, embed_dim, device)
        self.out_vision_proj = linear(embed_dim, d, device)
        self.out_text_proj = linear(embed_dim, d, device)

    def forward(self, vision: Tensor, text: Tensor, text_pad_mask: Tensor):
        Bn, Tv, _ = vision.shape
        Tt = text.shape[1]
        nh, E = self.num_heads, self.embed_dim
        hd = E // nh

        def heads(t: Tensor) -> Tensor:
            return t.reshape(Bn, t.shape[1], nh, hd).transpose(1, 2)

        vq = heads(self.vision_proj(vision) * (hd ** -0.5))
        tk = heads(self.text_proj(text))
        vv = heads(self.values_vision_proj(vision))
        tv = heads(self.values_text_proj(text))
        attn = torch.matmul(vq, tk.transpose(-1, -2))  # (B, nh, Tv, Tt)
        attn = (attn - attn.max()).clamp(-50000, 50000)  # one max over the whole batch, as HF
        attn_t = attn.transpose(-1, -2)
        attn_t = (attn_t - attn_t.amax(-1, keepdim=True)).clamp(-50000, 50000)
        t_probs = torch.softmax(attn_t.float(), dim=-1).to(text.dtype)
        attn = torch.where(text_pad_mask[:, None, None, :], -math.inf, attn)
        v_probs = torch.softmax(attn.float(), dim=-1).to(vision.dtype)
        dv = torch.matmul(v_probs, tv).transpose(1, 2).reshape(Bn, Tv, E)
        dt = torch.matmul(t_probs, vv).transpose(1, 2).reshape(Bn, Tt, E)
        return self.out_vision_proj(dv), self.out_text_proj(dt)


class _DeformableAttention(nn.Module):
    """``GroundingDinoMultiscaleDeformableAttention``."""

    def __init__(self, d: int, num_heads: int, num_levels: int, num_points: int, device):
        super().__init__()
        self.num_heads, self.num_levels, self.num_points = num_heads, num_levels, num_points
        self.sampling_offsets = linear(d, num_heads * num_levels * num_points * 2, device)
        self.attention_weights = linear(d, num_heads * num_levels * num_points, device)
        self.value_proj = linear(d, d, device)
        self.output_proj = linear(d, d, device)

    def forward(self, hidden: Tensor, encoder_hidden: Tensor, pos: Optional[Tensor],
                reference_points: Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                gather: Gather) -> Tensor:
        """hidden (B, Q, D) queries; encoder_hidden (B, S, D) values;
        reference_points (B, Q, L, 2 or 4) normalised. The sampling
        offsets, weights and positions are f32 whatever the dtype of
        ``hidden`` (a [0, 1] position in bf16 moves in steps of ~4 pixels
        at the 800 scale)."""
        Bn, Q, D = hidden.shape
        S = encoder_hidden.shape[1]
        nh, L, P = self.num_heads, self.num_levels, self.num_points
        if pos is not None:
            hidden = hidden + pos
        value = self.value_proj(encoder_hidden).reshape(Bn, S, nh, D // nh)
        offsets = self.sampling_offsets(hidden).float().reshape(Bn, Q, nh, L, P, 2)
        weights = self.attention_weights(hidden).float().reshape(Bn, Q, nh, L * P)
        weights = torch.softmax(weights, -1).reshape(Bn, Q, nh, L, P)
        reference_points = reference_points.float()
        if reference_points.shape[-1] == 2:
            normalizer = _level_normalizer(tuple(map(tuple, spatial_shapes)), hidden.device)
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / normalizer[None, None, None, :, None, :])
        else:
            loc = (reference_points[:, :, None, :, None, :2]
                   + offsets / P * reference_points[:, :, None, :, None, 2:] * 0.5)
        return self.output_proj(gather(value, spatial_shapes, loc, weights).to(hidden.dtype))


class _EncoderLayer(nn.Module):
    """``GroundingDinoEncoderLayer``: fusion -> text enhancer -> deformable
    vision self-attention."""

    def __init__(self, cfg: GroundingDinoConfig, device):
        super().__init__()
        d, ffn = cfg.d_model, cfg.encoder_ffn_dim
        self.cfg = cfg
        ln = lambda: nn.LayerNorm(d, eps=1e-5, device=device)  # noqa: E731
        self.text_enhancer_layer = named(
            self_attn=_MultiheadAttention(d, cfg.encoder_heads // 2, device),
            fc1=linear(d, ffn // 2, device), fc2=linear(ffn // 2, d, device),
            layer_norm_before=ln(), layer_norm_after=ln())
        fusion = named(layer_norm_vision=ln(), layer_norm_text=ln(),
                       attn=_BiAttention(d, ffn // 2, cfg.encoder_heads // 2, device))
        fusion.vision_param = nn.Parameter(torch.empty(d, device=device))
        fusion.text_param = nn.Parameter(torch.empty(d, device=device))
        self.fusion_layer = fusion
        self.deformable_layer = named(
            self_attn=_DeformableAttention(d, cfg.encoder_heads, cfg.num_feature_levels,
                                           cfg.encoder_points, device),
            self_attn_layer_norm=ln(), fc1=linear(d, ffn, device), fc2=linear(ffn, d, device),
            final_layer_norm=ln())

    def forward(self, vision, text, pos, reference_points, spatial_shapes, text_self_bias,
                text_pad_mask, text_pos, gather: Gather):
        fu = self.fusion_layer
        vn, tn = fu.layer_norm_vision(vision), fu.layer_norm_text(text)
        dv, dt = fu.attn(vn, tn, text_pad_mask)
        vision = vn + fu.vision_param * dv
        text = tn + fu.text_param * dt

        te = self.text_enhancer_layer
        q = text + text_pos
        text = te.layer_norm_before(text + te.self_attn(q, q, text, text_self_bias))
        text = te.layer_norm_after(text + te.fc2(F.relu(te.fc1(text))))

        de = self.deformable_layer
        att = de.self_attn(vision, vision, pos, reference_points, spatial_shapes, gather)
        vision = de.self_attn_layer_norm(vision + att)
        vision = de.final_layer_norm(vision + de.fc2(F.relu(de.fc1(vision))))
        return vision, text


class _DecoderLayer(nn.Module):
    """``GroundingDinoDecoderLayer``: self-attention -> text cross-attention
    -> deformable vision cross-attention -> FFN."""

    def __init__(self, cfg: GroundingDinoConfig, device):
        super().__init__()
        d, ffn, nh = cfg.d_model, cfg.decoder_ffn_dim, cfg.decoder_heads
        ln = lambda: nn.LayerNorm(d, eps=1e-5, device=device)  # noqa: E731
        self.self_attn = _MultiheadAttention(d, nh, device)
        self.self_attn_layer_norm = ln()
        self.encoder_attn_text = _MultiheadAttention(d, nh, device)
        self.encoder_attn_text_layer_norm = ln()
        self.encoder_attn = _DeformableAttention(d, nh, cfg.num_feature_levels,
                                                 cfg.decoder_points, device)
        self.encoder_attn_layer_norm = ln()
        self.fc1 = linear(d, ffn, device)
        self.fc2 = linear(ffn, d, device)
        self.final_layer_norm = ln()

    def forward(self, hidden, query_pos, reference_points, vision, text, spatial_shapes,
                text_bias, gather: Gather):
        q = hidden + query_pos
        hidden = self.self_attn_layer_norm(hidden + self.self_attn(q, q, hidden))
        q = hidden + query_pos
        att = self.encoder_attn_text(q, text, text, text_bias)
        hidden = self.encoder_attn_text_layer_norm(hidden + att)
        att = self.encoder_attn(hidden, vision, query_pos, reference_points, spatial_shapes,
                                gather)
        hidden = self.encoder_attn_layer_norm(hidden + att)
        return self.final_layer_norm(hidden + self.fc2(F.relu(self.fc1(hidden))))


class GroundingDino(nn.Module):
    """GroundingDINO with the parameter names of huggingface
    ``GroundingDinoForObjectDetection``. Construct with random weights
    through :func:`init_params`, or load a state dict."""

    def __init__(self, cfg: GroundingDinoConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d, L = cfg.d_model, cfg.num_feature_levels
        sw = cfg.swin
        proj = []
        for li in range(L):
            if li < len(sw.out_stages):
                conv = nn.utils.skip_init(nn.Conv2d, sw.stage_dim(sw.out_stages[li]), d, 1,
                                          device=dev)
            else:
                c_in = sw.stage_dim(sw.out_stages[-1]) if li == len(sw.out_stages) else d
                conv = nn.utils.skip_init(nn.Conv2d, c_in, d, 3, stride=2, padding=1,
                                          device=dev)
            proj.append(nn.Sequential(conv, nn.GroupNorm(32, d, device=dev)))
        bbox_head = _MLPHead(d, d, 4, 3, dev)
        self.bbox_embed = nn.ModuleList([bbox_head] * cfg.decoder_layers)  # shared, as HF
        decoder = named(
            layers=nn.ModuleList([_DecoderLayer(cfg, dev) for _ in range(cfg.decoder_layers)]),
            layer_norm=nn.LayerNorm(d, eps=1e-5, device=dev),
            reference_points_head=_MLPHead(2 * d, d, d, 2, dev),
            bbox_embed=self.bbox_embed)
        self.model = named(
            backbone=named(conv_encoder=named(model=SW.Swin(sw, dev))),
            input_proj_vision=nn.ModuleList(proj),
            text_backbone=B.Bert(cfg.text, dev),
            text_projection=linear(cfg.text.hidden_size, d, dev),
            query_position_embeddings=embedding(cfg.num_queries, d, dev),
            encoder=named(layers=nn.ModuleList(
                [_EncoderLayer(cfg, dev) for _ in range(cfg.encoder_layers)])),
            decoder=decoder,
            enc_output=linear(d, d, dev),
            enc_output_norm=nn.LayerNorm(d, eps=1e-5, device=dev),
            encoder_output_bbox_embed=_MLPHead(d, d, 4, 3, dev))
        self.model.level_embed = nn.Parameter(torch.empty(L, d, device=dev))

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype of the gated trunk (:func:`gated_copy`)."""
        return self.model.input_proj_vision[0][0].weight.dtype

    def _vision_maps(self, pixels: Tensor) -> List[Tensor]:
        """Swin's stages through the input projections, plus the extra
        stride-2 levels: NHWC maps of width d_model, in the trunk's dtype."""
        m = self.model
        feats = m.backbone.conv_encoder.model(pixels)
        maps = []
        for li, proj in enumerate(m.input_proj_vision):
            conv, gn = proj[0], proj[1]
            if li < len(feats):
                x = F.linear(feats[li], conv.weight[:, :, 0, 0], conv.bias)
            else:
                src = feats[-1] if li == len(feats) else maps[-1]
                x = F.conv2d(src.permute(0, 3, 1, 2), conv.weight, conv.bias, stride=2,
                             padding=1).permute(0, 2, 3, 1)
            maps.append(_group_norm32(x, gn.weight, gn.bias))
        return maps

    def forward(self, pixels: Tensor, input_ids: np.ndarray,
                gather: Optional[Gather] = None):
        """pixels (B, H, W, 3) normalised; input_ids (B, Lt) host integers.

        Returns (logits (B, num_queries, max_text_len), boxes
        (B, num_queries, 4) normalised cxcywh), the contract of
        ``GroundingDinoForObjectDetection``. ``gather``, a callable with
        :func:`deform_gather`'s signature, takes the place of
        :func:`deform_gather` in every layer: :func:`deform_gather_plain` as
        an oracle for the kernel on the card, or a wrapper that reads the
        layers' gather inputs.
        """
        if gather is not None and not callable(gather):
            raise TypeError(f"gather must be None or a callable, got {gather!r}")
        gather_fn = deform_gather if gather is None else gather
        cfg, m, dev = self.cfg, self.model, pixels.device
        ids_np = np.asarray(input_ids)
        self_mask_np, pos_np = generate_text_masks(ids_np)
        ids, self_mask, pos_ids = (host_to_device(a, dev)
                                   for a in (ids_np, self_mask_np, pos_np))
        token_mask = torch.ones_like(ids, dtype=torch.bool)
        with tracer.span("seg.detect.text"):
            text = m.text_backbone(ids, self_mask, torch.zeros_like(ids), pos_ids)
            text = m.text_projection(text)

        with tracer.span("seg.detect.backbone"):
            maps = self._vision_maps(pixels)
        spatial_shapes = tuple((int(x.shape[1]), int(x.shape[2])) for x in maps)
        vision = torch.cat([x.reshape(x.shape[0], -1, cfg.d_model) for x in maps], 1)
        consts = _level_constants(spatial_shapes, cfg.d_model, cfg.pe_temperature, dev)
        pos = torch.cat([p + m.level_embed[li] for li, p in enumerate(consts["pos"])], 0)[None]
        return self._transformer(vision, pos, spatial_shapes, text, self_mask, ~token_mask,
                                 pos_ids, token_mask, gather_fn)

    def _transformer(self, vision, pos, spatial_shapes, text, text_self_mask, text_pad_mask,
                     text_position_ids, text_token_mask, gather: Gather):
        """Encoder, query selection, decoder and heads."""
        cfg, m, dev = self.cfg, self.model, vision.device
        Bn, L = vision.shape[0], len(spatial_shapes)
        consts = _level_constants(tuple(spatial_shapes), cfg.d_model, cfg.pe_temperature, dev)
        ref = consts["ref"][None, :, None, :].expand(Bn, -1, L, 2)

        # the encoder runs in the trunk's dtype; everything after it in f32
        dt = self.compute_dtype
        text_pos = get_sine_pos_embed(text_position_ids[..., None].float(), cfg.d_model,
                                      exchange_xy=False).to(dt)
        text_self_bias = torch.where(text_self_mask[:, None], 0.0, -1e30)
        with tracer.span("seg.detect.encoder"):
            vision, text, pos = vision.to(dt), text.to(dt), pos.to(dt)
            for layer in m.encoder.layers:
                vision, text = layer(vision, text, pos, ref, spatial_shapes, text_self_bias,
                                     text_pad_mask, text_pos, gather)
            vision, text = vision.float(), text.float()

        with tracer.span("seg.detect.decoder"):
            # language-guided query selection (two-stage)
            proposals, valid = consts["proposals"], consts["valid"]
            obj_query = torch.where(valid[None, :, None], vision, 0.0)
            obj_query = m.enc_output_norm(m.enc_output(obj_query))
            enc_logits = contrastive_logits(obj_query, text, text_token_mask, cfg.max_text_len)
            coord_logits = m.encoder_output_bbox_embed(obj_query) + proposals[None]
            topk_idx = torch.topk(enc_logits.amax(-1), cfg.num_queries, dim=1).indices
            reference = torch.sigmoid(torch.gather(
                coord_logits, 1, topk_idx[..., None].expand(-1, -1, 4)))  # (B, Q, 4)

            # decoder with iterative box refinement
            text_bias = torch.where(text_pad_mask[:, None, None, :], -1e30, 0.0)
            hidden = m.query_position_embeddings.weight[None].expand(Bn, -1, -1)
            head = self.bbox_embed[0]
            dec = m.decoder
            for layer in dec.layers:
                ref_input = reference[:, :, None, :].expand(-1, -1, L, 4)
                qpos = dec.reference_points_head(get_sine_pos_embed(reference, cfg.d_model // 2))
                hidden = layer(hidden, qpos, ref_input, vision, text, spatial_shapes, text_bias,
                               gather)
                # the in-loop refinement uses the un-normed hidden (HF decoder)
                ref_into_last = reference
                reference = torch.sigmoid(head(hidden) + _inverse_sigmoid(reference))
            final_hidden = dec.layer_norm(hidden)
            logits = contrastive_logits(final_hidden, text, text_token_mask, cfg.max_text_len)
            # final boxes: the head on the layer-normed hidden against the
            # reference points that entered the last layer
            boxes = torch.sigmoid(head(final_hidden) + _inverse_sigmoid(ref_into_last))
            return logits, boxes


# the parameters of the gated trunk (JAX ``model.py:612-626, 742-790``)
TRUNK = ("model.backbone.", "model.input_proj_vision.", "model.encoder.")


def gated_copy(model: GroundingDino, dtype: torch.dtype) -> GroundingDino:
    """``model`` with its gated trunk (Swin, the input projections and the
    encoder layers) rounded to ``dtype`` once; BERT, query selection, the
    decoder and the heads share ``model``'s f32 weights. ``model`` itself
    when ``dtype`` is float32."""
    return cast_copy(model, dtype, TRUNK)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def init_params(cfg: GroundingDinoConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> GroundingDino:
    """A :class:`GroundingDino` with random weights drawn as huggingface's
    ``GroundingDinoPreTrainedModel._init_weights`` draws them (init_std
    0.02), from ``generator`` on ``device`` (a generator seeded with 0 when
    None), then with the randomisations of the JAX package's
    ``build_random_hf``: the bbox heads' output layers, the decoder's final
    layer norm and the encoder-output bbox head, which huggingface leaves at
    zero or identity."""
    dev = resolve_device(device)
    model = GroundingDino(cfg, device=dev)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)

    def normal(t: Tensor, mean: float, std: float):
        t.normal_(mean, std, generator=gen)

    def xavier(t: Tensor):
        bound = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
        t.uniform_(-bound, bound, generator=gen)

    with torch.no_grad():
        # reversed pre-order visits a module's children before it, as the
        # post-order nn.Module.apply of huggingface's initialisation does
        for mod in reversed(list(model.modules())):
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                normal(mod.weight, 0.0, 0.02)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                normal(mod.weight, 0.0, 0.02)
            elif isinstance(mod, SW._WindowSelfAttention):
                mod.relative_position_bias_table.zero_()
            elif isinstance(mod, _DeformableAttention):
                nh, L, P = mod.num_heads, mod.num_levels, mod.num_points
                mod.sampling_offsets.weight.zero_()
                thetas = torch.arange(nh, dtype=torch.float32) * (2.0 * math.pi / nh)
                grid = torch.stack([thetas.cos(), thetas.sin()], -1)
                grid = (grid / grid.abs().max(-1, keepdim=True)[0]).view(nh, 1, 1, 2)
                grid = grid.repeat(1, L, P, 1) * torch.arange(1, P + 1).view(1, 1, P, 1)
                mod.sampling_offsets.bias.copy_(grid.reshape(-1))
                mod.attention_weights.weight.zero_()
                mod.attention_weights.bias.zero_()
                for lin in (mod.value_proj, mod.output_proj):
                    xavier(lin.weight)
                    lin.bias.zero_()
            elif isinstance(mod, _BiAttention):
                for lin in (mod.vision_proj, mod.text_proj, mod.values_vision_proj,
                            mod.values_text_proj, mod.out_vision_proj, mod.out_text_proj):
                    xavier(lin.weight)
                    lin.bias.zero_()
            elif isinstance(mod, _MLPHead):
                mod.layers[-1].weight.zero_()
                mod.layers[-1].bias.zero_()
        for layer in model.model.encoder.layers:
            layer.fusion_layer.vision_param.fill_(1e-4)
            layer.fusion_layer.text_param.fill_(1e-4)
        normal(model.model.level_embed, 0.0, 1.0)
        for head in (model.bbox_embed[0], model.model.encoder_output_bbox_embed):
            normal(head.layers[-1].weight, 0.0, 0.05)
            normal(head.layers[-1].bias, 0.0, 0.05)
        normal(model.model.decoder.layer_norm.weight, 1.0, 0.2)
        normal(model.model.decoder.layer_norm.bias, 0.0, 0.2)
    return model


def load_jax_params(model: GroundingDino, params: Dict) -> GroundingDino:
    """Copy the JAX package's GroundingDINO parameter pytree (as built by
    ``d3fields_tpu.models.groundingdino.model.convert_hf_state_dict``,
    leaves as numpy arrays) into ``model``, in place: the inverse of that
    converter. Returns ``model``."""
    cfg = model.cfg
    a = lambda x: np.asarray(x, np.float32)  # noqa: E731
    sd: Dict[str, np.ndarray] = {}

    def lin(name: str, w, b=None):
        sd[name + ".weight"] = a(w).T
        if b is not None:
            sd[name + ".bias"] = a(b)

    def norm(name: str, w, b):
        sd[name + ".weight"], sd[name + ".bias"] = a(w), a(b)

    def mha(name: str, p):
        for ours, theirs in (("query", "q"), ("key", "k"), ("value", "v"), ("out_proj", "o")):
            lin(f"{name}.{ours}", p[theirs + "_w"], p[theirs + "_b"])

    def deform(name: str, p):
        for ours, theirs in (("value_proj", "value"), ("sampling_offsets", "offs"),
                             ("attention_weights", "attw"), ("output_proj", "out")):
            lin(f"{name}.{ours}", p[theirs + "_w"], p[theirs + "_b"])

    def head(name: str, layers):
        for i, (w, b) in enumerate(layers):
            lin(f"{name}.layers.{i}", w, b)

    # Swin
    sw, P = cfg.swin, cfg.swin.patch_size
    pre = "model.backbone.conv_encoder.model."
    p = params["swin"]
    sd[pre + "embeddings.patch_embeddings.projection.weight"] = \
        a(p["patch_w"]).reshape(P, P, 3, -1).transpose(3, 2, 0, 1)
    sd[pre + "embeddings.patch_embeddings.projection.bias"] = a(p["patch_b"])
    norm(pre + "embeddings.norm", p["embed_ln_w"], p["embed_ln_b"])
    for si, stage in enumerate(p["stages"]):
        for bi, bp in enumerate(stage["blocks"]):
            blk = f"{pre}encoder.layers.{si}.blocks.{bi}"
            norm(blk + ".layernorm_before", bp["ln1_w"], bp["ln1_b"])
            for n in ("query", "key", "value"):
                lin(f"{blk}.attention.self.{n}", bp[n[0] + "_w"], bp[n[0] + "_b"])
            sd[blk + ".attention.self.relative_position_bias_table"] = a(bp["rel_table"])
            lin(blk + ".attention.output.dense", bp["o_w"], bp["o_b"])
            norm(blk + ".layernorm_after", bp["ln2_w"], bp["ln2_b"])
            lin(blk + ".intermediate.dense", bp["fc1_w"], bp["fc1_b"])
            lin(blk + ".output.dense", bp["fc2_w"], bp["fc2_b"])
        if "merge" in stage:
            down = f"{pre}encoder.layers.{si}.downsample"
            norm(down + ".norm", stage["merge"]["ln_w"], stage["merge"]["ln_b"])
            lin(down + ".reduction", stage["merge"]["red_w"])
    for si in sw.out_stages:
        # int keys in a converted tree; str keys once it has been through
        # an .npz (save_params / load_params)
        o = p["out_norms"][si if si in p["out_norms"] else str(si)]
        norm(f"{pre}hidden_states_norms.stage{si + 1}", o["w"], o["b"])

    # BERT
    pre = "model.text_backbone."
    p = params["bert"]
    for ours, theirs in (("word_embeddings", "word_emb"), ("position_embeddings", "pos_emb"),
                         ("token_type_embeddings", "type_emb")):
        sd[f"{pre}embeddings.{ours}.weight"] = a(p[theirs])
    norm(pre + "embeddings.LayerNorm", p["emb_ln_w"], p["emb_ln_b"])
    for i, lp in enumerate(p["layers"]):
        ly = f"{pre}encoder.layer.{i}"
        for n in ("query", "key", "value"):
            lin(f"{ly}.attention.self.{n}", lp[n[0] + "_w"], lp[n[0] + "_b"])
        lin(ly + ".attention.output.dense", lp["o_w"], lp["o_b"])
        norm(ly + ".attention.output.LayerNorm", lp["att_ln_w"], lp["att_ln_b"])
        lin(ly + ".intermediate.dense", lp["fc1_w"], lp["fc1_b"])
        lin(ly + ".output.dense", lp["fc2_w"], lp["fc2_b"])
        norm(ly + ".output.LayerNorm", lp["out_ln_w"], lp["out_ln_b"])

    for li, ip in enumerate(params["input_proj"]):
        w = a(ip["conv_w"])
        pre = f"model.input_proj_vision.{li}"
        sd[pre + ".0.weight"] = (w.T[:, :, None, None] if w.ndim == 2
                                 else w.transpose(3, 2, 0, 1))
        sd[pre + ".0.bias"] = a(ip["conv_b"])
        norm(pre + ".1", ip["gn_w"], ip["gn_b"])

    for i, lp in enumerate(params["encoder_layers"]):
        pre = f"model.encoder.layers.{i}"
        fu, at = lp["fusion"], lp["fusion"]["attn"]
        norm(pre + ".fusion_layer.layer_norm_vision", fu["ln_v_w"], fu["ln_v_b"])
        norm(pre + ".fusion_layer.layer_norm_text", fu["ln_t_w"], fu["ln_t_b"])
        sd[pre + ".fusion_layer.vision_param"] = a(fu["scale_v"])
        sd[pre + ".fusion_layer.text_param"] = a(fu["scale_t"])
        for ours, theirs in (("vision_proj", "v_proj"), ("text_proj", "t_proj"),
                             ("values_vision_proj", "vv_proj"),
                             ("values_text_proj", "tv_proj"),
                             ("out_vision_proj", "out_v"), ("out_text_proj", "out_t")):
            lin(f"{pre}.fusion_layer.attn.{ours}", at[theirs + "_w"], at[theirs + "_b"])
        te, dl = lp["text"], lp["deform"]
        mha(pre + ".text_enhancer_layer.self_attn", te["attn"])
        lin(pre + ".text_enhancer_layer.fc1", te["fc1_w"], te["fc1_b"])
        lin(pre + ".text_enhancer_layer.fc2", te["fc2_w"], te["fc2_b"])
        norm(pre + ".text_enhancer_layer.layer_norm_before", te["ln1_w"], te["ln1_b"])
        norm(pre + ".text_enhancer_layer.layer_norm_after", te["ln2_w"], te["ln2_b"])
        deform(pre + ".deformable_layer.self_attn", dl["attn"])
        norm(pre + ".deformable_layer.self_attn_layer_norm", dl["ln1_w"], dl["ln1_b"])
        lin(pre + ".deformable_layer.fc1", dl["fc1_w"], dl["fc1_b"])
        lin(pre + ".deformable_layer.fc2", dl["fc2_w"], dl["fc2_b"])
        norm(pre + ".deformable_layer.final_layer_norm", dl["ln2_w"], dl["ln2_b"])

    for i, lp in enumerate(params["decoder_layers"]):
        pre = f"model.decoder.layers.{i}"
        mha(pre + ".self_attn", lp["self_attn"])
        mha(pre + ".encoder_attn_text", lp["text_attn"])
        deform(pre + ".encoder_attn", lp["cross_attn"])
        for j, n in enumerate(("self_attn_layer_norm", "encoder_attn_text_layer_norm",
                               "encoder_attn_layer_norm", "final_layer_norm")):
            norm(f"{pre}.{n}", lp[f"ln{j + 1}_w"], lp[f"ln{j + 1}_b"])
        lin(pre + ".fc1", lp["fc1_w"], lp["fc1_b"])
        lin(pre + ".fc2", lp["fc2_w"], lp["fc2_b"])

    lin("model.text_projection", params["text_proj_w"], params["text_proj_b"])
    sd["model.level_embed"] = a(params["level_embed"])
    lin("model.enc_output", params["enc_out_w"], params["enc_out_b"])
    norm("model.enc_output_norm", params["enc_out_ln_w"], params["enc_out_ln_b"])
    head("model.encoder_output_bbox_embed", params["enc_bbox_head"])
    sd["model.query_position_embeddings.weight"] = a(params["query_embed"])
    head("model.decoder.reference_points_head", params["ref_head"])
    for k in range(cfg.decoder_layers):  # one shared head under both names
        head(f"bbox_embed.{k}", params["bbox_head"])
        head(f"model.decoder.bbox_embed.{k}", params["bbox_head"])
    norm("model.decoder.layer_norm", params["dec_ln_w"], params["dec_ln_b"])

    state = {k: torch.from_numpy(np.array(v, np.float32, order="C")) for k, v in sd.items()}
    for k, v in model.state_dict().items():  # buffers: Swin's relative position index
        if k.endswith("relative_position_index"):
            state[k] = v
    model.load_state_dict(state, strict=True)
    return model

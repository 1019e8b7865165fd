"""Random GroundingDINO and SAM weights from the seed, made on the device in
one draw per model, under huggingface's names (those of
``GroundingDinoForObjectDetection`` and ``SamModel``, which the program's
modules keep), as ``weights.py`` makes DINOv2's.

One ``torch.randn`` on the device's own generator fills every floating
leaf, each a view of that draw moved to its own scale: ``x * scale +
shift``. Every leaf is drawn, none is left at zero or at a constant, and
the scales are chosen so that each mechanism moves the output:

- weight matrices and convolution kernels N(0, 1/fan_in) (fan_in: the
  inputs summed into one output, ``C_in`` for SAM's 2x2 transposed
  convolutions): each layer keeps its activations at O(1), so attention
  logits are O(1) and the attention is far from uniform;
- biases N(0, 0.02^2); layer- and group-norm scales 1 + N(0, 0.1^2), their
  shifts N(0, 0.02^2);
- Swin's relative-position bias tables and SAM's decomposed ``rel_pos_h``
  / ``rel_pos_w`` N(0, 0.1^2) (huggingface and SAM start them at zero,
  which would hide a wrong index);
- the deformable attentions' ``sampling_offsets``: weight N(0, 1/fan_in),
  which gives offsets of ~1.4 feature cells from the O(1) queries, and
  bias N(0, 1) cells (huggingface: weight zero, bias a fixed pattern), so
  the samples spread over a few cells around each reference point and
  stay mostly in the map; ``attention_weights``: weight N(0, 1/fan_in),
  bias N(0, 1) (huggingface: zero), so the softmax over the 16 levels x
  points has logits of std ~1.7, far from uniform;
- the bi-attention gates ``vision_param`` / ``text_param`` 0.5 + N(0,
  0.2^2) (huggingface: 1e-4, which switches the image-text fusion off);
- the box heads' last layers (``bbox_embed``, shared by the decoder's
  layers, and ``encoder_output_bbox_embed``): weight N(0, 0.25^2 / fan_in),
  bias N(0, 0.1^2), box deltas of ~0.25 in logit space a refinement step
  (huggingface: zero);
- the decoder's final layer norm: scale 1 + N(0, 0.2^2), shift N(0,
  0.2^2) (as the port's ``init_params`` randomises it);
- the text features: the last encoder layer's ``text_enhancer_layer.
  layer_norm_after`` scale 0.05 (1 + N(0, 0.1^2)), as
  ``chip_smoke.py::segment_models`` scales it, and shift 0.05 N(0, 1). The
  contrastive logits are dot products of the 256-wide query and text
  features; at unit scale they are O(10), the sigmoid of most queries'
  best token is 1.0 in float32 and no box threshold can pick a few boxes.
  At 0.05 they are O(1), as a trained model's are. The shift gives every
  text token one common direction u, half of its norm;
- the query selection's ``enc_output`` bias: N(0, 0.02^2) less 0.05
  sqrt(d) u / |u| (d = 256: entries ~0.05, against ~1 of the projected
  pixels).
  The proposals outside (0.01, 0.99) enter the selection as zeros, so
  they share one query, this bias through ``enc_output_norm``: pointed
  against u, its contrastive logits are about -13, and the real proposals
  (O(1)) win the top 900, as in a trained model. Drawn plainly, that shared
  query outscored the real ones in about 40% of seeds (the rig's
  background gives most pixels one common feature whose score is as often
  below 0 as above): ~700 identical (1, 1, 1, 1) boxes took the selection,
  the duplicate removal left a view one box, and the program's host
  post-processing ran over ~700 boxes a view;
- embeddings: BERT's word, position and type tables N(0, 0.02^2)
  (huggingface's init; a layer norm follows); GroundingDINO's query
  embeddings and level embeddings, SAM's prompt and output tokens N(0, 1)
  (``nn.Embedding``'s default, which SAM's published code keeps); SAM's
  random-Fourier matrix ``positional_embedding`` N(0, 1) (SAM's
  ``PositionEmbeddingRandom`` at scale 1); SAM's absolute ``pos_embed``
  N(0, 0.1^2) (published: zero-initialised).

Swin's ``relative_position_index`` buffers are integers worked out from
the window, not drawn. Tied leaves (GroundingDINO's shared box head under
both its names, SAM's Fourier matrix under both) are one tensor.

The same seed on the same device and torch build gives the same weights,
so the reference can make them again after the program's state is freed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
# (name or tuple of tied names, shape, scale, shift)
Leaf = Tuple[object, tuple, float, float]

TEXT_SCALE = 0.05
# the query selection's bias along minus the text features' common direction
SELECTION_BIAS = 0.05


def _lin(name: str, d_in: int, d_out: int, bias: bool = True) -> List[Leaf]:
    out = [(name + ".weight", (d_out, d_in), 1.0 / math.sqrt(d_in), 0.0)]
    if bias:
        out.append((name + ".bias", (d_out,), 0.02, 0.0))
    return out


def _conv(name: str, c_in: int, c_out: int, k: int, bias: bool = True) -> List[Leaf]:
    out = [(name + ".weight", (c_out, c_in, k, k), 1.0 / math.sqrt(c_in * k * k), 0.0)]
    if bias:
        out.append((name + ".bias", (c_out,), 0.02, 0.0))
    return out


def _norm(name: str, d: int, scale: float = 0.1, shift_scale: float = 0.02) -> List[Leaf]:
    return [(name + ".weight", (d,), scale, 1.0), (name + ".bias", (d,), shift_scale, 0.0)]


def _mlp_head(name: str, d_in: int, hidden: int, d_out: int, layers: int,
              last_scale: float = 1.0, last_bias: float = 0.02) -> List[Leaf]:
    dims = [d_in] + [hidden] * (layers - 1)
    outs = [hidden] * (layers - 1) + [d_out]
    leaves = []
    for i, (a, b) in enumerate(zip(dims, outs)):
        if i == layers - 1:
            leaves += [(f"{name}.layers.{i}.weight", (b, a), last_scale / math.sqrt(a), 0.0),
                       (f"{name}.layers.{i}.bias", (b,), last_bias, 0.0)]
        else:
            leaves += _lin(f"{name}.layers.{i}", a, b)
    return leaves


def swin_relative_index(window: int) -> np.ndarray:
    """(w*w, w*w) index into the (2w-1)^2 bias table (Swin's
    ``relative_position_index``)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    return (rel[0] + window - 1) * (2 * window - 1) + (rel[1] + window - 1)


# ---------------------------------------------------------------------------
# GroundingDINO Swin-T (huggingface GroundingDinoForObjectDetection)
# ---------------------------------------------------------------------------

def swin_stage_dim(sw: dict, i: int) -> int:
    return sw["embed_dim"] * 2 ** i


def gdino_leaves(g: dict) -> List[Leaf]:
    """Every floating leaf of the detector ``g`` (the configuration's
    ``gdino``), in a fixed order."""
    sw, tx, d = g["swin"], g["text"], g["d_model"]
    L, ffn = g["num_feature_levels"], g["encoder_ffn_dim"]
    leaves: List[Leaf] = []
    pre = "model.backbone.conv_encoder.model."
    P, E = sw["patch_size"], sw["embed_dim"]
    leaves += _conv(pre + "embeddings.patch_embeddings.projection", 3, E, P)
    leaves += _norm(pre + "embeddings.norm", E)
    ws = sw["window_size"]
    for si, depth in enumerate(sw["depths"]):
        dim, nh = swin_stage_dim(sw, si), sw["num_heads"][si]
        hidden = int(dim * sw["mlp_ratio"])
        for bi in range(depth):
            b = f"{pre}encoder.layers.{si}.blocks.{bi}."
            leaves += _norm(b + "layernorm_before", dim)
            leaves.append((b + "attention.self.relative_position_bias_table",
                           ((2 * ws - 1) ** 2, nh), 0.1, 0.0))
            for n in ("query", "key", "value"):
                leaves += _lin(b + "attention.self." + n, dim, dim)
            leaves += _lin(b + "attention.output.dense", dim, dim)
            leaves += _norm(b + "layernorm_after", dim)
            leaves += _lin(b + "intermediate.dense", dim, hidden)
            leaves += _lin(b + "output.dense", hidden, dim)
        if si < len(sw["depths"]) - 1:
            down = f"{pre}encoder.layers.{si}.downsample."
            leaves += _lin(down + "reduction", 4 * dim, 2 * dim, bias=False)
            leaves += _norm(down + "norm", 4 * dim)
    for si in sw["out_stages"]:
        leaves += _norm(f"{pre}hidden_states_norms.stage{si + 1}", swin_stage_dim(sw, si))
    outs = sw["out_stages"]
    for li in range(L):
        p = f"model.input_proj_vision.{li}."
        if li < len(outs):
            leaves += _conv(p + "0", swin_stage_dim(sw, outs[li]), d, 1)
        else:
            c_in = swin_stage_dim(sw, outs[-1]) if li == len(outs) else d
            leaves += _conv(p + "0", c_in, d, 3)
        leaves += _norm(p + "1", d)
    leaves.append(("model.level_embed", (L, d), 1.0, 0.0))
    # BERT
    pre = "model.text_backbone."
    D, I = tx["hidden_size"], tx["intermediate_size"]
    leaves += [(pre + "embeddings.word_embeddings.weight", (tx["vocab_size"], D), 0.02, 0.0),
               (pre + "embeddings.position_embeddings.weight", (tx["max_position"], D), 0.02, 0.0),
               (pre + "embeddings.token_type_embeddings.weight", (tx["type_vocab_size"], D),
                0.02, 0.0)]
    leaves += _norm(pre + "embeddings.LayerNorm", D)
    for i in range(tx["num_layers"]):
        ly = f"{pre}encoder.layer.{i}."
        for n in ("query", "key", "value"):
            leaves += _lin(ly + "attention.self." + n, D, D)
        leaves += _lin(ly + "attention.output.dense", D, D)
        leaves += _norm(ly + "attention.output.LayerNorm", D)
        leaves += _lin(ly + "intermediate.dense", D, I)
        leaves += _lin(ly + "output.dense", I, D)
        leaves += _norm(ly + "output.LayerNorm", D)
    leaves += _lin("model.text_projection", D, d)
    leaves.append(("model.query_position_embeddings.weight", (g["num_queries"], d), 1.0, 0.0))
    # the encoder
    nL, nP = L, g["encoder_points"]
    for i in range(g["encoder_layers"]):
        p = f"model.encoder.layers.{i}."
        te = p + "text_enhancer_layer."
        for n in ("query", "key", "value", "out_proj"):
            leaves += _lin(te + "self_attn." + n, d, d)
        leaves += _lin(te + "fc1", d, ffn // 2) + _lin(te + "fc2", ffn // 2, d)
        leaves += _norm(te + "layer_norm_before", d)
        last = i == g["encoder_layers"] - 1
        leaves += [(te + "layer_norm_after.weight", (d,), 0.1 * (TEXT_SCALE if last else 1),
                    TEXT_SCALE if last else 1.0),
                   (te + "layer_norm_after.bias", (d,), TEXT_SCALE if last else 0.02, 0.0)]
        fu = p + "fusion_layer."
        leaves += [(fu + "vision_param", (d,), 0.2, 0.5), (fu + "text_param", (d,), 0.2, 0.5)]
        leaves += _norm(fu + "layer_norm_vision", d) + _norm(fu + "layer_norm_text", d)
        for n in ("vision_proj", "text_proj", "values_vision_proj", "values_text_proj"):
            leaves += _lin(fu + "attn." + n, d, ffn // 2)
        leaves += _lin(fu + "attn.out_vision_proj", ffn // 2, d)
        leaves += _lin(fu + "attn.out_text_proj", ffn // 2, d)
        leaves += _deformable(p + "deformable_layer.self_attn", d, g["encoder_heads"], nL, nP)
        de = p + "deformable_layer."
        leaves += _norm(de + "self_attn_layer_norm", d)
        leaves += _lin(de + "fc1", d, ffn) + _lin(de + "fc2", ffn, d)
        leaves += _norm(de + "final_layer_norm", d)
    # the decoder
    dffn = g["decoder_ffn_dim"]
    for i in range(g["decoder_layers"]):
        p = f"model.decoder.layers.{i}."
        for att in ("self_attn", "encoder_attn_text"):
            for n in ("query", "key", "value", "out_proj"):
                leaves += _lin(f"{p}{att}.{n}", d, d)
            leaves += _norm(f"{p}{att}_layer_norm", d)
        leaves += _deformable(p + "encoder_attn", d, g["decoder_heads"], nL, g["decoder_points"])
        leaves += _norm(p + "encoder_attn_layer_norm", d)
        leaves += _lin(p + "fc1", d, dffn) + _lin(p + "fc2", dffn, d)
        leaves += _norm(p + "final_layer_norm", d)
    leaves += _norm("model.decoder.layer_norm", d, scale=0.2, shift_scale=0.2)
    leaves += _mlp_head("model.decoder.reference_points_head", 2 * d, d, d, 2)
    shared = _mlp_head("bbox_embed.0", d, d, 4, 3, last_scale=0.25, last_bias=0.1)
    for name, shape, scale, shift in shared:
        tail = name[len("bbox_embed.0."):]
        tied = tuple(f"{pre}.{k}.{tail}" for pre in ("bbox_embed", "model.decoder.bbox_embed")
                     for k in range(g["decoder_layers"]))
        leaves.append((tied, shape, scale, shift))
    leaves += _lin("model.enc_output", d, d)
    leaves += _norm("model.enc_output_norm", d)
    leaves += _mlp_head("model.encoder_output_bbox_embed", d, d, 4, 3, last_scale=0.25,
                        last_bias=0.1)
    return leaves


def _deformable(name: str, d: int, nh: int, L: int, P: int) -> List[Leaf]:
    return [(name + ".sampling_offsets.weight", (nh * L * P * 2, d), 1.0 / math.sqrt(d), 0.0),
            (name + ".sampling_offsets.bias", (nh * L * P * 2,), 1.0, 0.0),
            (name + ".attention_weights.weight", (nh * L * P, d), 1.0 / math.sqrt(d), 0.0),
            (name + ".attention_weights.bias", (nh * L * P,), 1.0, 0.0),
            *_lin(name + ".value_proj", d, d), *_lin(name + ".output_proj", d, d)]


def gdino_buffers(g: dict) -> Dict[str, Tensor]:
    """Swin's integer ``relative_position_index`` buffers."""
    sw = g["swin"]
    idx = torch.as_tensor(swin_relative_index(sw["window_size"]))
    return {f"model.backbone.conv_encoder.model.encoder.layers.{si}.blocks.{bi}."
            "attention.self.relative_position_index": idx
            for si, depth in enumerate(sw["depths"]) for bi in range(depth)}


# ---------------------------------------------------------------------------
# SAM (huggingface SamModel)
# ---------------------------------------------------------------------------

def sam_leaves(s: dict) -> List[Leaf]:
    """Every floating leaf of SAM ``s`` (the configuration's ``sam``)."""
    D, P, G = s["hidden_size"], s["patch_size"], s["image_size"] // s["patch_size"]
    C, Co, mc = s["prompt_hidden"], s["output_channels"], s["mask_input_channels"]
    hd = D // s["num_heads"]
    nm = s["num_multimask_outputs"] + 1
    leaves: List[Leaf] = [
        (("shared_image_embedding.positional_embedding",
          "prompt_encoder.shared_embedding.positional_embedding"), (2, C // 2), 1.0, 0.0),
        ("vision_encoder.pos_embed", (1, G, G, D), 0.1, 0.0)]
    leaves += _conv("vision_encoder.patch_embed.projection", 3, D, P)
    for i in range(s["num_layers"]):
        p = f"vision_encoder.layers.{i}."
        rel = G if i in s["global_attn_indexes"] else s["window_size"]
        leaves += _norm(p + "layer_norm1", D)
        leaves += [(p + "attn.rel_pos_h", (2 * rel - 1, hd), 0.1, 0.0),
                   (p + "attn.rel_pos_w", (2 * rel - 1, hd), 0.1, 0.0)]
        leaves += _lin(p + "attn.qkv", D, 3 * D) + _lin(p + "attn.proj", D, D)
        leaves += _norm(p + "layer_norm2", D)
        leaves += _lin(p + "mlp.lin1", D, s["mlp_dim"]) + _lin(p + "mlp.lin2", s["mlp_dim"], D)
    leaves += _conv("vision_encoder.neck.conv1", D, Co, 1, bias=False)
    leaves += _norm("vision_encoder.neck.layer_norm1", Co)
    leaves += _conv("vision_encoder.neck.conv2", Co, Co, 3, bias=False)
    leaves += _norm("vision_encoder.neck.layer_norm2", Co)
    me = "prompt_encoder.mask_embed."
    leaves += _conv(me + "conv1", 1, mc // 4, 2) + _conv(me + "conv2", mc // 4, mc, 2)
    leaves += _conv(me + "conv3", mc, C, 1)
    leaves += _norm(me + "layer_norm1", mc // 4) + _norm(me + "layer_norm2", mc)
    leaves += [("prompt_encoder.no_mask_embed.weight", (1, C), 1.0, 0.0),
               ("prompt_encoder.not_a_point_embed.weight", (1, C), 1.0, 0.0)]
    leaves += [(f"prompt_encoder.point_embed.{i}.weight", (1, C), 1.0, 0.0) for i in range(4)]
    md = "mask_decoder."
    leaves += [(md + "iou_token.weight", (1, C), 1.0, 0.0),
               (md + "mask_tokens.weight", (nm, C), 1.0, 0.0)]

    def attention(name, internal):
        return (_lin(name + ".q_proj", C, internal) + _lin(name + ".k_proj", C, internal)
                + _lin(name + ".v_proj", C, internal) + _lin(name + ".out_proj", internal, C))

    for i in range(s["decoder_layers"]):
        p = f"{md}transformer.layers.{i}."
        leaves += attention(p + "self_attn", C)
        leaves += attention(p + "cross_attn_token_to_image", C // 2)
        leaves += attention(p + "cross_attn_image_to_token", C // 2)
        leaves += _lin(p + "mlp.lin1", C, s["decoder_mlp_dim"])
        leaves += _lin(p + "mlp.lin2", s["decoder_mlp_dim"], C)
        for j in range(1, 5):
            leaves += _norm(f"{p}layer_norm{j}", C)
    leaves += attention(md + "transformer.final_attn_token_to_image", C // 2)
    leaves += _norm(md + "transformer.layer_norm_final_attn", C)
    # ConvTranspose2d(k=2, s=2): (C_in, C_out, 2, 2), C_in inputs to each output
    leaves += [(md + "upscale_conv1.weight", (C, C // 4, 2, 2), 1.0 / math.sqrt(C), 0.0),
               (md + "upscale_conv1.bias", (C // 4,), 0.02, 0.0),
               (md + "upscale_conv2.weight", (C // 4, C // 8, 2, 2), 1.0 / math.sqrt(C // 4), 0.0),
               (md + "upscale_conv2.bias", (C // 8,), 0.02, 0.0)]
    leaves += _norm(md + "upscale_layer_norm", C // 4)

    def feed_forward(name, d_in, hidden, d_out, depth):
        out = _lin(name + ".proj_in", d_in, hidden)
        for j in range(depth - 2):
            out += _lin(f"{name}.layers.{j}", hidden, hidden)
        return out + _lin(name + ".proj_out", hidden, d_out)

    for i in range(nm):
        leaves += feed_forward(f"{md}output_hypernetworks_mlps.{i}", C, C, C // 8, 3)
    leaves += feed_forward(md + "iou_prediction_head", C, s["iou_head_hidden"], nm,
                           s["iou_head_depth"])
    return leaves


# ---------------------------------------------------------------------------
# The draw
# ---------------------------------------------------------------------------

def _draw(leaves: List[Leaf], seed: int, stream: int, device) -> Dict[str, Tensor]:
    total = sum(torch.Size(s).numel() for _, s, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed((seed * 2 + stream) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for names, shape, scale, shift in leaves:
        n = torch.Size(shape).numel()
        t = flat[at:at + n].view(shape).mul_(scale).add_(shift)
        for name in (names if isinstance(names, tuple) else (names,)):
            out[name] = t
        at += n
    return out


def gdino_weights(g: dict, seed: int, device) -> Dict[str, Tensor]:
    """The detector's state dict, float32 on ``device`` (and its integer
    buffers), from one draw seeded with ``seed``, the query selection's
    bias steered away from the text (:data:`SELECTION_BIAS`)."""
    out = _draw(gdino_leaves(g), seed, 0, device)
    shift = out[f"model.encoder.layers.{g['encoder_layers'] - 1}."
                "text_enhancer_layer.layer_norm_after.bias"]
    out["model.enc_output.bias"].sub_(SELECTION_BIAS * math.sqrt(g["d_model"])
                                      * shift / shift.norm())
    out.update({k: v.to(device) for k, v in gdino_buffers(g).items()})
    return out


def sam_weights(s: dict, seed: int, device) -> Dict[str, Tensor]:
    """SAM's state dict, float32 on ``device``, from one draw seeded with
    ``seed`` (a stream of its own, apart from the detector's)."""
    return _draw(sam_leaves(s), seed, 1, device)

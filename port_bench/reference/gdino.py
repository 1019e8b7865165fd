"""GroundingDINO (Swin-T, OGC) as huggingface ``GroundingDinoForObjectDetection``
computes it, in plain PyTorch.

Written from the paper (arXiv:2303.05499), IDEA-Research/GroundingDINO's
``groundingdino/models/GroundingDINO/`` and huggingface's
``modeling_grounding_dino.py``, with huggingface's parameter names:

- the caption "[CLS] c1 . c2 . [SEP]" (:func:`caption`), per-phrase
  self-attention masks and position ids that restart after every special
  token (:func:`text_masks`, ``generate_masks_with_special_tokens_and_
  transfer_map``), BERT (``bert.py``) and a linear projection to d_model;
- the image at short side 800 (long side at most 1333), ImageNet-normalised;
  Swin (``swin.py``); per level a 1x1 convolution and GroupNorm(32), one
  more level from a stride-2 3x3 convolution of the last stage; DETR's
  normalised sine positions (temperature 20) plus a learned level
  embedding;
- 6 encoder layers, each: the image-text fusion (layer norms, the gated
  bi-directional attention, whose logits are shifted by their maximum over
  the whole batch and clamped to +-50000), the text enhancer (self-
  attention with sine text positions, post-norm ReLU MLP) and the
  deformable image self-attention (``msda.py``; offsets over each level's
  width and height from every pixel's own centre), post-norm ReLU MLP;
- language-guided query selection: the encoder's pixels through a linear
  layer and a layer norm, their contrastive logits' maximum over the text,
  the top ``num_queries``, their boxes from the box head plus the
  proposals (a box of 0.05 * 2^level around each pixel centre, in logit
  space, +inf where not within (0.01, 0.99));
- 6 decoder layers, each: self-attention, text cross-attention, deformable
  cross-attention from the box's centre scaled by its size, post-norm ReLU
  MLP; the learned query embeddings as the first content, the sine
  embedding of the boxes through a 2-layer MLP as the positions, the
  shared box head refining the boxes after every layer (on the un-normed
  output, logit space clamped at 1e-5);
- the final layer norm, contrastive logits against the text (-inf past
  it, padded to ``max_text_len``) and the boxes of the last layer's normed
  output against the boxes that entered it.

Departures from the published model: the toy crc32 tokenizer
(:func:`toy_tokenize`; the repository holds no BERT vocabulary); the
caption is built from token ids directly, as the program's
``tokenize_classes`` does, not by a tokenizer over "mug . red can ."; the
image is resized as floats with half-pixel bilinear interpolation (the
program's, after the JAX package's ``jax.image.resize``), not by
Pillow on uint8. :func:`detect` can take the query selection's indices
from elsewhere (the program's own choice), so that a flipped near-tie at
the 900th proposal does not change every box after it.

Precision: Swin, the input projections and the 6 encoder layers run in
the trunk's dtype (``layers.py``); in the deformable attention the offsets,
weights and positions are f32 and the sampled table is widened; BERT,
query selection, the decoder and the heads run outside the trunk.
"""

from __future__ import annotations

import math
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import bert, msda, swin
from port_bench.reference import layers as nn_
from port_bench.reference.precision import Precision

Tensor = torch.Tensor
CLS, SEP, DOT, QUESTION = 101, 102, 1012, 1029
LN_EPS = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BACKBONE = "model.backbone.conv_encoder.model."


def toy_tokenize(text: str) -> List[int]:
    """A toy word tokenizer, the same in every process: 200 + crc32 % 1000."""
    return [200 + zlib.crc32(word.encode()) % 1000 for word in text.split()]


def caption(classes: Sequence[str]):
    """(ids (1, L) int64, the (start, end) token span of each class)."""
    ids, spans = [CLS], []
    for c in classes:
        toks = toy_tokenize(c)
        spans.append((len(ids), len(ids) + len(toks)))
        ids += toks + [DOT]
    return np.asarray([ids + [SEP]], np.int64), spans


def text_masks(ids: np.ndarray):
    """(B, L, L) bool self-attention masks, (B, L) position ids: each phrase
    up to and with its separator attends within itself, positions 0.. in
    it; [CLS] and [SEP] attend to themselves at position 0."""
    B, L = ids.shape
    special = np.isin(ids, (CLS, SEP, DOT, QUESTION))
    mask = np.repeat(np.eye(L, dtype=bool)[None], B, 0)
    pos = np.zeros((B, L), np.int64)
    for b in range(B):
        prev = 0
        for col in np.flatnonzero(special[b]):
            if col in (0, L - 1):
                mask[b, col, col] = True
                pos[b, col] = 0
            else:
                mask[b, prev + 1:col + 1, prev + 1:col + 1] = True
                pos[b, prev + 1:col + 1] = np.arange(col - prev)
            prev = col
    return mask, pos


def resized_hw(H: int, W: int, short: int, longest: int) -> Tuple[int, int]:
    s = short / min(H, W)
    if max(H, W) * s > longest:
        s = longest / max(H, W)
    return round(H * s), round(W * s)


def pixels(images_u8: np.ndarray, g: dict, device) -> Tensor:
    """(V, H, W, 3) uint8 -> (V, 3, h, w) float32 ImageNet-normalised at the
    detector's size."""
    x = torch.as_tensor(np.asarray(images_u8), device=device).permute(0, 3, 1, 2).float() / 255.0
    x = F.interpolate(x, size=resized_hw(*x.shape[-2:], g["short_side"], g["max_side"]),
                      mode="bilinear", align_corners=False)
    mean = torch.tensor(IMAGENET_MEAN, device=device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=device)[:, None, None]
    return (x - mean) / std


def sine_table(h: int, w: int, d: int, temperature: float, dtype, device) -> Tensor:
    """(h*w, d) normalised DETR sine positions (y half first), huggingface's
    ``GroundingDinoSinePositionEmbedding`` over an all-valid mask."""
    half, eps, scale = d // 2, 1e-6, 2 * math.pi
    y = torch.arange(1, h + 1, dtype=dtype, device=device) / (h + eps) * scale
    x = torch.arange(1, w + 1, dtype=dtype, device=device) / (w + eps) * scale
    dim_t = temperature ** (2 * (torch.arange(half, dtype=dtype, device=device) // 2) / half)

    def enc(t):
        p = t[:, None] / dim_t
        return torch.stack([p[:, 0::2].sin(), p[:, 1::2].cos()], -1).flatten(1)

    py, px = enc(y), enc(x)
    return torch.cat([py[:, None].expand(h, w, half), px[None].expand(h, w, half)], -1).reshape(
        h * w, d)


def sine_embed(pos: Tensor, feats: int, exchange_xy: bool = True,
               temperature: float = 10000.0) -> Tensor:
    """huggingface ``get_sine_pos_embed``: (..., n) -> (..., n*feats)."""
    dim_t = temperature ** (2 * (torch.arange(feats, dtype=pos.dtype, device=pos.device) // 2)
                            / feats)
    parts = []
    for i in range(pos.shape[-1]):
        p = (pos[..., i] * (2 * math.pi))[..., None] / dim_t
        parts.append(torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()], -1).flatten(-2))
    if exchange_xy and len(parts) > 1:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, -1)


def proposals(shapes, dtype, device):
    """(S, 4) proposals in logit space (+inf where invalid), (S,) validity.
    Worked out on the host with correctly rounded divisions, as
    huggingface divides by a tensor: a centre on a (0.01, 0.99) edge, such
    as (49 + 0.5) / 50, is invalid, where a division by a Python number on
    the card (a product with its reciprocal) may put it inside."""
    parts = []
    for level, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.arange(h, dtype=dtype), torch.arange(w, dtype=dtype),
                                indexing="ij")
        grid = torch.stack([(gx + 0.5) / torch.tensor(w, dtype=dtype),
                            (gy + 0.5) / torch.tensor(h, dtype=dtype)], -1)
        wh = torch.full_like(grid, 0.05 * 2.0 ** level)
        parts.append(torch.cat([grid, wh], -1).reshape(-1, 4))
    p = torch.cat(parts)
    valid = ((p > 0.01) & (p < 0.99)).all(-1)
    out = torch.log(p / (1 - p)).masked_fill(~valid[:, None], math.inf)
    return out.to(device), valid.to(device)


def encoder_reference_points(shapes, dtype, device) -> Tensor:
    """(S, 2) each pixel's centre (x, y) in [0, 1] of its own map."""
    refs = []
    for h, w in shapes:
        gy, gx = torch.meshgrid((torch.arange(h, dtype=dtype, device=device) + 0.5) / h,
                                (torch.arange(w, dtype=dtype, device=device) + 0.5) / w,
                                indexing="ij")
        refs.append(torch.stack([gx, gy], -1).reshape(-1, 2))
    return torch.cat(refs)


def _mha(q_in, k_in, v_in, w, pre, heads, bias, P):
    """huggingface ``GroundingDinoMultiheadAttention``: logits in f32 (f64)
    plus an additive bias, the result in the input's dtype."""
    B, Tq, D = q_in.shape
    hd = D // heads

    def split(t):
        return t.reshape(B, t.shape[1], heads, hd).transpose(1, 2)

    q, k, v = (split(nn_.linear(t, w, pre + n, P))
               for t, n in ((q_in, "query"), (k_in, "key"), (v_in, "value")))
    logits = nn_.matmul(q, k.transpose(-1, -2), P).to(nn_.acc(q_in)) / math.sqrt(hd)
    if bias is not None:
        logits = logits + bias
    out = nn_.matmul(nn_.softmax(logits, P, q_in.dtype), v, P)
    return nn_.linear(out.transpose(1, 2).reshape(B, Tq, D), w, pre + "out_proj", P)


def _bi_attention(vision, text, w, pre, heads, P):
    """huggingface ``GroundingDinoBiMultiHeadAttention`` (no padding)."""
    B, Tv, _ = vision.shape
    Tt = text.shape[1]
    E = w[pre + "vision_proj.weight"].shape[0]
    hd = E // heads

    def split(t):
        return t.reshape(B, t.shape[1], heads, hd).transpose(1, 2)

    vq = split(P.r(nn_.linear(vision, w, pre + "vision_proj", P) * hd ** -0.5))
    tk = split(nn_.linear(text, w, pre + "text_proj", P))
    vv = split(nn_.linear(vision, w, pre + "values_vision_proj", P))
    tv = split(nn_.linear(text, w, pre + "values_text_proj", P))
    logits = nn_.matmul(vq, tk.transpose(-1, -2), P)
    logits = (logits - logits.max()).clamp(-50000, 50000)
    lt = logits.transpose(-1, -2)
    lt = (lt - lt.amax(-1, keepdim=True)).clamp(-50000, 50000)
    a = nn_.acc(vision)
    t_probs = nn_.softmax(lt.to(a), P, text.dtype)
    v_probs = nn_.softmax(logits.to(a), P, vision.dtype)
    dv = nn_.matmul(v_probs, tv, P).transpose(1, 2).reshape(B, Tv, E)
    dt = nn_.matmul(t_probs, vv, P).transpose(1, 2).reshape(B, Tt, E)
    return (nn_.linear(dv, w, pre + "out_vision_proj", P),
            nn_.linear(dt, w, pre + "out_text_proj", P))


def _deformable(query, values, w, pre, heads, L, Pn, ref, shapes, P):
    """huggingface ``GroundingDinoMultiscaleDeformableAttention``: query
    (B, Q, d) with its position added, values (B, S, d), ref (B, Q, L, 2 or
    4) in [0, 1]."""
    B, Q, d = query.shape
    S = values.shape[1]
    a = nn_.acc(query)
    value = nn_.linear(values, w, pre + "value_proj", P).reshape(B, S, heads, d // heads)
    off = nn_.linear(query, w, pre + "sampling_offsets", P).to(a).reshape(B, Q, heads, L, Pn, 2)
    att = nn_.linear(query, w, pre + "attention_weights", P).to(a).reshape(B, Q, heads, L * Pn)
    att = nn_.softmax(att, P, a).reshape(B, Q, heads, L, Pn)
    ref = ref.to(a)
    if ref.shape[-1] == 2:
        norm = torch.tensor([[ww, hh] for hh, ww in shapes], dtype=a, device=query.device)
        loc = ref[:, :, None, :, None, :] + off / norm[None, None, None, :, None, :]
    else:
        loc = ref[:, :, None, :, None, :2] + off / Pn * ref[:, :, None, :, None, 2:] * 0.5
    out = P.r(msda.sample(value, shapes, loc, att)).to(query.dtype)
    return nn_.linear(out, w, pre + "output_proj", P)


def _encoder_layer(vision, text, pos, ref, shapes, text_bias, text_pos, w, pre, g, P):
    fu = pre + "fusion_layer."
    vn = nn_.layer_norm(vision, w, fu + "layer_norm_vision", LN_EPS, P)
    tn = nn_.layer_norm(text, w, fu + "layer_norm_text", LN_EPS, P)
    dv, dt = _bi_attention(vn, tn, w, fu + "attn.", g["encoder_heads"] // 2, P)
    vision = vn + P.r(w[fu + "vision_param"] * dv)
    text = tn + P.r(w[fu + "text_param"] * dt)
    te = pre + "text_enhancer_layer."
    q = text + text_pos
    text = nn_.layer_norm(text + _mha(q, q, text, w, te + "self_attn.", g["encoder_heads"] // 2,
                                      text_bias, P), w, te + "layer_norm_before", LN_EPS, P)
    h = nn_.linear(torch.relu(nn_.linear(text, w, te + "fc1", P)), w, te + "fc2", P)
    text = nn_.layer_norm(text + h, w, te + "layer_norm_after", LN_EPS, P)
    de = pre + "deformable_layer."
    att = _deformable(vision + pos, vision, w, de + "self_attn.", g["encoder_heads"],
                      g["num_feature_levels"], g["encoder_points"], ref, shapes, P)
    vision = nn_.layer_norm(vision + att, w, de + "self_attn_layer_norm", LN_EPS, P)
    h = nn_.linear(torch.relu(nn_.linear(vision, w, de + "fc1", P)), w, de + "fc2", P)
    return nn_.layer_norm(vision + h, w, de + "final_layer_norm", LN_EPS, P), text


def _decoder_layer(hidden, qpos, ref, vision, text, shapes, w, pre, g, P):
    heads = g["decoder_heads"]
    q = hidden + qpos
    hidden = nn_.layer_norm(hidden + _mha(q, q, hidden, w, pre + "self_attn.", heads, None, P),
                            w, pre + "self_attn_layer_norm", LN_EPS, P)
    q = hidden + qpos
    hidden = nn_.layer_norm(hidden + _mha(q, text, text, w, pre + "encoder_attn_text.", heads,
                                          None, P), w, pre + "encoder_attn_text_layer_norm",
                            LN_EPS, P)
    att = _deformable(hidden + qpos, vision, w, pre + "encoder_attn.", heads,
                      g["num_feature_levels"], g["decoder_points"], ref, shapes, P)
    hidden = nn_.layer_norm(hidden + att, w, pre + "encoder_attn_layer_norm", LN_EPS, P)
    h = nn_.linear(torch.relu(nn_.linear(hidden, w, pre + "fc1", P)), w, pre + "fc2", P)
    return nn_.layer_norm(hidden + h, w, pre + "final_layer_norm", LN_EPS, P)


def _mlp(x, w, pre, layers, P):
    for i in range(layers):
        x = nn_.linear(x, w, f"{pre}layers.{i}", P)
        if i < layers - 1:
            x = torch.relu(x)
    return x


def contrastive(vision: Tensor, text: Tensor, max_len: int, P: Precision) -> Tensor:
    """(B, Q, max_len) dot products with the text tokens, -inf past them."""
    out = nn_.matmul(vision, text.transpose(1, 2), P)
    return F.pad(out, (0, max_len - out.shape[-1]), value=-math.inf)


def logit(x: Tensor, eps: float = 1e-5) -> Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def encode(w: dict, images_u8: np.ndarray, classes: Sequence[str], g: dict,
           P: Precision) -> dict:
    """Text, image trunk and encoder of a batch of views: ``vision`` (B, S,
    d) and ``text`` (B, Lt, d) after the encoder, outside the trunk's dtype,
    the level ``shapes`` and the class ``spans``."""
    dev = next(iter(w.values())).device
    T, O = P.vit_dtype, nn_.outer(P)
    sw, d = g["swin"], g["d_model"]
    ids_np, spans = caption(classes)
    B = len(images_u8)
    ids_np = np.repeat(ids_np, B, 0)
    mask_np, pos_np = text_masks(ids_np)
    ids, mask3d, pos_ids = (torch.as_tensor(a, device=dev) for a in (ids_np, mask_np, pos_np))
    tx = g["text"]
    with P.matmul_mode():
        wt = nn_.cast(w, "model.text_backbone.", O)
        text = bert.forward(wt, ids, mask3d, pos_ids, tx["num_heads"], tx["num_layers"], P)
        text = nn_.linear(text, nn_.cast(w, "model.", O), "text_projection", P)
        wb = nn_.cast(w, BACKBONE, T)
        px = pixels(images_u8, g, dev).to(T)
        feats = swin.forward(wb, px, sw, P)
        wp = nn_.cast(w, "model.input_proj_vision.", T)
        maps = []
        for li in range(g["num_feature_levels"]):
            if li < len(feats):
                x = P.r(F.conv2d(P.operand(feats[li]), P.operand(wp[f"{li}.0.weight"]),
                                 wp[f"{li}.0.bias"]))
            else:
                src = feats[-1] if li == len(feats) else maps[-1]
                x = P.r(F.conv2d(P.operand(src), P.operand(wp[f"{li}.0.weight"]),
                                 wp[f"{li}.0.bias"], stride=2, padding=1))
            maps.append(nn_.group_norm(x, wp, f"{li}.1", min(32, x.shape[1]), 1e-5, P))
        shapes = [tuple(int(s) for s in m.shape[-2:]) for m in maps]
        vision = torch.cat([m.flatten(2).transpose(1, 2) for m in maps], 1)
        level = w["model.level_embed"].to(O)
        pos = torch.cat([sine_table(h, ww, d, g["pe_temperature"], O, dev) + level[li]
                         for li, (h, ww) in enumerate(shapes)])[None].to(T)
        ref = encoder_reference_points(shapes, O, dev)[None, :, None].expand(
            B, -1, len(shapes), 2)
        text_pos = sine_embed(pos_ids[..., None].to(O), d, exchange_xy=False).to(T)
        text_bias = torch.zeros(mask3d.shape, dtype=nn_.acc(vision.to(T)), device=dev)
        text_bias = text_bias.masked_fill(~mask3d, -math.inf)[:, None]
        we = nn_.cast(w, "model.encoder.layers.", T)
        vision, text = vision.to(T), text.to(T)
        for i in range(g["encoder_layers"]):
            vision, text = _encoder_layer(vision, text, pos, ref, shapes, text_bias, text_pos,
                                          we, f"{i}.", g, P)
    return {"vision": vision.to(O), "text": text.to(O), "shapes": shapes, "spans": spans}


def selection_scores(w: dict, enc: dict, g: dict, P: Precision):
    """The query selection's (scores (B, S), box logits (B, S, 4))."""
    O = nn_.outer(P)
    wm = nn_.cast(w, "model.", O)
    props, valid = proposals(enc["shapes"], O, enc["vision"].device)
    with P.matmul_mode():
        obj = torch.where(valid[None, :, None], enc["vision"], 0.0)
        obj = nn_.layer_norm(nn_.linear(obj, wm, "enc_output", P), wm, "enc_output_norm",
                             LN_EPS, P)
        scores = contrastive(obj, enc["text"], g["max_text_len"], P).amax(-1)
        coords = _mlp(obj, wm, "encoder_output_bbox_embed.", 3, P) + props[None]
    return scores, coords


def decode(w: dict, enc: dict, coords: Tensor, select: Tensor, g: dict, P: Precision):
    """The decoder from the boxes of the proposals ``select`` (B, Q) ->
    (logits (B, Q, max_text_len), boxes (B, Q, 4) cxcywh in [0, 1])."""
    O = nn_.outer(P)
    wm = nn_.cast(w, "model.", O)
    wb = nn_.cast(w, "bbox_embed.0.", O)
    d, L = g["d_model"], g["num_feature_levels"]
    vision, text, shapes = enc["vision"], enc["text"], enc["shapes"]
    B = vision.shape[0]
    with P.matmul_mode():
        reference = torch.sigmoid(torch.gather(coords, 1, select[..., None].expand(-1, -1, 4)))
        hidden = wm["query_position_embeddings.weight"][None].expand(B, -1, -1)
        for i in range(g["decoder_layers"]):
            qpos = _mlp(sine_embed(reference, d // 2), wm, "decoder.reference_points_head.", 2, P)
            hidden = _decoder_layer(hidden, qpos, reference[:, :, None].expand(-1, -1, L, 4),
                                    vision, text, shapes, wm, f"decoder.layers.{i}.", g, P)
            entered = reference
            reference = torch.sigmoid(_mlp(hidden, wb, "", 3, P) + logit(reference))
        final = nn_.layer_norm(hidden, wm, "decoder.layer_norm", LN_EPS, P)
        logits = contrastive(final, text, g["max_text_len"], P)
        boxes = torch.sigmoid(_mlp(final, wb, "", 3, P) + logit(entered))
    return logits, boxes


def detect(w: dict, images_u8: np.ndarray, classes: Sequence[str], g: dict, P: Precision,
           select: Optional[Tensor] = None) -> dict:
    """The whole forward: ``logits``, ``boxes``, the query selection's
    ``select`` (its own top ``num_queries``, or the one given), ``scores``,
    ``spans``."""
    with torch.no_grad():
        enc = encode(w, images_u8, classes, g, P)
        scores, coords = selection_scores(w, enc, g, P)
        if select is None:
            select = torch.topk(scores, g["num_queries"], dim=1).indices
        logits, boxes = decode(w, enc, coords, select.to(scores.device), g, P)
    return {"logits": logits, "boxes": boxes, "select": select, "scores": scores,
            "spans": enc["spans"]}

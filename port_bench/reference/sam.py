"""Segment Anything (ViT-H) with box prompts, in plain PyTorch.

Written from the paper (arXiv:2304.02643) and facebookresearch/
segment-anything (``modeling/image_encoder.py``, ``prompt_encoder.py``,
``mask_decoder.py``, ``transformer.py``, ``predictor.py``), with
huggingface ``SamModel``'s parameter names:

- preprocessing: the longest side resized to 1024 (``ResizeLongestSide``:
  ``int(side * scale + 0.5)``), normalised by SAM's pixel mean and std,
  zero-padded bottom-right to 1024x1024;
- the image encoder: a stride-16 patch convolution, the absolute position
  table, 32 pre-norm blocks of (layer norm, attention, residual, layer
  norm, exact-GELU MLP, residual); attention in 14x14 windows (the 64x64
  grid zero-padded to 70x70) except at the global layers (7, 15, 23, 31),
  each adding the decomposed relative positions (``add_decomposed_rel_pos``:
  the unscaled query against ``rel_pos_h`` / ``rel_pos_w`` at every pair's
  row and column offset); the neck: a 1x1 convolution, a channel layer
  norm (eps 1e-6), a 3x3 convolution, a channel layer norm;
- the prompt encoder for boxes: each corner shifted by half a pixel,
  scaled to [0, 1] of the 1024 input, through the random-Fourier encoding
  (2x - 1, the Gaussian matrix, 2 pi, sin and cos), plus the corner's
  learned embedding; the dense prompt is the no-mask embedding; the image
  positions are the Fourier encoding of the 64x64 grid's pixel centres;
- the mask decoder: the IoU token and the 4 mask tokens before the box's
  two tokens, a two-way transformer of 2 layers (the first without the
  tokens' positions in its self-attention and without its residual) and a
  final token-to-image attention, the image upscaled by two 2x2 transposed
  convolutions (a channel layer norm and GELU between, GELU after), masks
  from the hypernetwork MLPs' dot products with it, the IoU head; with
  multimask output, masks and IoUs 1-3;
- postprocessing: the 256x256 low-resolution logits bilinearly upscaled to
  1024x1024 (align_corners False, no antialias), cropped to the resized
  image, resized to the original image, a mask being the logits above 0.

Global attention is computed in blocks of query rows (:data:`ROWS`), so
that a view's 16x4096x4096 logits never sit in memory whole.

Departures: the image is resized as floats by bilinear interpolation (the
program's, after the JAX package), not by Pillow on uint8 (SAM's
``apply_image``). Precision: the patch embedding, positions and blocks run
in the trunk's dtype (``layers.py``: the logits and the relative-position
bias summed in it, the soft-max in f32); the neck, the prompt encoder and
the mask decoder run outside the trunk.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import layers as nn_
from port_bench.reference.precision import Precision

Tensor = torch.Tensor
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
ROWS = 1024  # query rows of a block of global attention
BOXES = 32  # box prompts decoded at once


def target_hw(H: int, W: int, size: int) -> Tuple[int, int]:
    s = size / max(H, W)
    return int(H * s + 0.5), int(W * s + 0.5)


def pixels(images_u8: np.ndarray, size: int, device) -> Tensor:
    """(V, H, W, 3) uint8 -> (V, 3, size, size) float32, normalised and padded."""
    x = torch.as_tensor(np.asarray(images_u8), device=device).permute(0, 3, 1, 2).float()
    rh, rw = target_hw(*x.shape[-2:], size)
    x = F.interpolate(x, size=(rh, rw), mode="bilinear", align_corners=False)
    mean = torch.tensor(PIXEL_MEAN, device=device)[:, None, None]
    std = torch.tensor(PIXEL_STD, device=device)[:, None, None]
    return F.pad((x - mean) / std, (0, size - rw, 0, size - rh))


def _rel_table(rel: Tensor, size: int) -> Tensor:
    """(size, size, hd): ``rel`` at each (query, key) offset + size - 1."""
    idx = torch.arange(size, device=rel.device)
    return rel[idx[:, None] - idx[None, :] + size - 1]


def _attend(x: Tensor, w: dict, pre: str, heads: int, P: Precision) -> Tensor:
    """x (B, h, w, C) -> attention over its h*w tokens, query rows in blocks."""
    B, h, ww, C = x.shape
    hd = C // heads
    N = h * ww
    qkv = nn_.linear(x.reshape(B, N, C), w, pre + "qkv", P).reshape(B, N, 3, heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)  # (B, heads, N, hd)
    Rh = _rel_table(w[pre + "rel_pos_h"], h)
    Rw = _rel_table(w[pre + "rel_pos_w"], ww)
    qs = P.r(q * hd ** -0.5)
    out = torch.empty_like(q)
    for r0 in range(0, N, ROWS):
        r1 = min(N, r0 + ROWS)
        rows = torch.arange(r0, r1, device=x.device)
        qi, qj = rows // ww, rows % ww
        logits = nn_.matmul(qs[:, :, r0:r1], k.transpose(-1, -2), P)  # (B, heads, n, N)
        qb = q[:, :, r0:r1]
        bias_h = P.r(torch.einsum("bnrc,rkc->bnrk", P.operand(qb), P.operand(Rh[qi])))
        bias_w = P.r(torch.einsum("bnrc,rkc->bnrk", P.operand(qb), P.operand(Rw[qj])))
        bias = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(B, heads, r1 - r0, N)
        logits = logits + bias
        probs = nn_.softmax(logits.to(nn_.acc(x)), P, x.dtype)
        out[:, :, r0:r1] = nn_.matmul(probs, v, P)
    out = out.permute(0, 2, 1, 3).reshape(B, h, ww, C)
    return nn_.linear(out, w, pre + "proj", P)


def _block(x: Tensor, w: dict, pre: str, heads: int, window: int, P: Precision) -> Tensor:
    B, H, W, C = x.shape
    h = nn_.layer_norm(x, w, pre + "layer_norm1", 1e-6, P)
    if window:
        ph, pw = (-H) % window, (-W) % window
        h = F.pad(h, (0, 0, 0, pw, 0, ph))
        Hp, Wp = H + ph, W + pw
        h = h.reshape(B, Hp // window, window, Wp // window, window, C).permute(0, 1, 3, 2, 4, 5)
        h = _attend(h.reshape(-1, window, window, C), w, pre + "attn.", heads, P)
        h = h.reshape(B, Hp // window, Wp // window, window, window, C).permute(0, 1, 3, 2, 4, 5)
        h = h.reshape(B, Hp, Wp, C)[:, :H, :W]
    else:
        h = _attend(h, w, pre + "attn.", heads, P)
    x = x + h
    h = nn_.gelu(nn_.linear(nn_.layer_norm(x, w, pre + "layer_norm2", 1e-6, P), w,
                            pre + "mlp.lin1", P), P)
    return x + nn_.linear(h, w, pre + "mlp.lin2", P)


def _channel_norm(x: Tensor, w: dict, name: str, P: Precision) -> Tensor:
    """SAM's LayerNorm2d (eps 1e-6) of an NCHW map."""
    return nn_.layer_norm(x.permute(0, 2, 3, 1), w, name, 1e-6, P).permute(0, 3, 1, 2)


def embed(w: dict, images_u8: np.ndarray, s: dict, P: Precision) -> Tensor:
    """(V, H, W, 3) uint8 -> image embeddings (V, 64, 64, C) NHWC, one view
    at a time, outside the trunk's dtype."""
    dev = next(iter(w.values())).device
    T, O = P.vit_dtype, nn_.outer(P)
    wt = nn_.cast(w, "vision_encoder.", T)
    wo = nn_.cast(w, "vision_encoder.neck.", O)
    outs = []
    with torch.no_grad(), P.matmul_mode():
        for v in range(len(images_u8)):
            px = pixels(images_u8[v:v + 1], s["image_size"], dev).to(T)
            x = P.r(F.conv2d(P.operand(px), P.operand(wt["patch_embed.projection.weight"]),
                             wt["patch_embed.projection.bias"], stride=s["patch_size"]))
            x = x.permute(0, 2, 3, 1) + wt["pos_embed"]
            for i in range(s["num_layers"]):
                window = 0 if i in s["global_attn_indexes"] else s["window_size"]
                x = _block(x, wt, f"layers.{i}.", s["num_heads"], window, P)
            x = x.to(O).permute(0, 3, 1, 2)
            x = _channel_norm(P.r(F.conv2d(P.operand(x), P.operand(wo["conv1.weight"]))), wo,
                              "layer_norm1", P)
            x = _channel_norm(P.r(F.conv2d(P.operand(x), P.operand(wo["conv2.weight"]),
                                           padding=1)), wo, "layer_norm2", P)
            outs.append(x.permute(0, 2, 3, 1))
    return torch.cat(outs)


def _fourier(coords01: Tensor, gaussian: Tensor, P: Precision) -> Tensor:
    c = nn_.matmul(2 * coords01 - 1, gaussian, P) * (2 * math.pi)
    return torch.cat([c.sin(), c.cos()], -1)


def _attention(q, k, v, w, pre, heads, P):
    """SAM's ``Attention`` with a downsampled internal width."""
    qi, ki, vi = (nn_.linear(t, w, pre + n, P) for t, n in
                  ((q, "q_proj"), (k, "k_proj"), (v, "v_proj")))
    B, Tq, Ci = qi.shape
    hd = Ci // heads

    def split(t):
        return t.reshape(B, t.shape[1], heads, hd).transpose(1, 2)

    logits = nn_.matmul(split(qi), split(ki).transpose(-1, -2), P) / math.sqrt(hd)
    out = nn_.matmul(nn_.softmax(logits, P, qi.dtype), split(vi), P)
    return nn_.linear(out.transpose(1, 2).reshape(B, Tq, Ci), w, pre + "out_proj", P)


def _ln(x, w, name, P):
    return nn_.layer_norm(x, w, name, 1e-5, P)


def _mlp(x, w, pre, depth, P):
    x = torch.relu(nn_.linear(x, w, pre + "proj_in", P))
    for j in range(depth - 2):
        x = torch.relu(nn_.linear(x, w, f"{pre}layers.{j}", P))
    return nn_.linear(x, w, pre + "proj_out", P)


def _conv_t2(x: Tensor, w: dict, name: str, P: Precision) -> Tensor:
    return P.r(F.conv_transpose2d(P.operand(x), P.operand(w[name + ".weight"]),
                                  w[name + ".bias"], stride=2))


def decode(w: dict, emb: Tensor, boxes: Tensor, view: Tensor, s: dict, P: Precision):
    """emb (V, 64, 64, C) the image embeddings; boxes (N, 4) xyxy in the
    1024 input's pixels, each against ``emb[view[n]]`` -> (low-resolution
    mask logits (N, 3, 256, 256), IoU predictions (N, 3))."""
    O = nn_.outer(P)
    wd = nn_.cast(w, "mask_decoder.", O)
    wp = nn_.cast(w, "prompt_encoder.", O)
    gauss = w["shared_image_embedding.positional_embedding"].to(O)
    S, G = s["image_size"], s["image_size"] // s["patch_size"]
    heads, nm = s["decoder_heads"], s["num_multimask_outputs"] + 1
    with torch.no_grad(), P.matmul_mode():
        corners = (boxes.to(O).reshape(-1, 2, 2) + 0.5) / S
        sparse = _fourier(corners, gauss, P)
        sparse = torch.stack([sparse[:, 0] + wp["point_embed.2.weight"][0],
                              sparse[:, 1] + wp["point_embed.3.weight"][0]], 1)
        t = (torch.arange(G, dtype=O, device=emb.device) + 0.5) / G
        grid = torch.stack([t[None, :].expand(G, G), t[:, None].expand(G, G)], -1)
        pe = _fourier(grid, gauss, P).reshape(1, G * G, -1)
        N = boxes.shape[0]
        tokens = torch.cat([wd["iou_token.weight"], wd["mask_tokens.weight"]])[None].expand(
            N, -1, -1)
        tokens = torch.cat([tokens, sparse], 1)
        C = tokens.shape[-1]
        keys = (emb.to(O)[view] + wp["no_mask_embed.weight"][0]).reshape(N, G * G, C)
        queries = tokens
        for i in range(s["decoder_layers"]):
            p = f"transformer.layers.{i}."
            if i == 0:
                queries = _attention(queries, queries, queries, wd, p + "self_attn.", heads, P)
            else:
                q = queries + tokens
                queries = queries + _attention(q, q, queries, wd, p + "self_attn.", heads, P)
            queries = _ln(queries, wd, p + "layer_norm1", P)
            q, k = queries + tokens, keys + pe
            queries = _ln(queries + _attention(q, k, keys, wd, p + "cross_attn_token_to_image.",
                                               heads, P), wd, p + "layer_norm2", P)
            h = nn_.linear(torch.relu(nn_.linear(queries, wd, p + "mlp.lin1", P)), wd,
                           p + "mlp.lin2", P)
            queries = _ln(queries + h, wd, p + "layer_norm3", P)
            q, k = queries + tokens, keys + pe
            keys = _ln(keys + _attention(k, q, queries, wd, p + "cross_attn_image_to_token.",
                                         heads, P), wd, p + "layer_norm4", P)
        q, k = queries + tokens, keys + pe
        queries = _ln(queries + _attention(q, k, keys, wd, "transformer.final_attn_token_to_image.",
                                           heads, P), wd, "transformer.layer_norm_final_attn", P)
        src = keys.transpose(1, 2).reshape(N, C, G, G)
        up = _conv_t2(src, wd, "upscale_conv1", P)
        up = nn_.gelu(_channel_norm(up, wd, "upscale_layer_norm", P), P)
        up = nn_.gelu(_conv_t2(up, wd, "upscale_conv2", P), P)
        hyper = torch.stack([_mlp(queries[:, 1 + i], wd, f"output_hypernetworks_mlps.{i}.", 3, P)
                             for i in range(nm)], 1)
        b, c, h, ww = up.shape
        masks = nn_.matmul(hyper, up.reshape(b, c, h * ww), P).reshape(b, nm, h, ww)
        iou = _mlp(queries[:, 0], wd, "iou_prediction_head.", s["iou_head_depth"], P)
    return masks[:, 1:], iou[:, 1:]


def upscale(low_res: Tensor, image_hw, s: dict) -> Tensor:
    """(N, M, s, s) logits -> (N, M, H, W) logits at the original image."""
    S = s["image_size"]
    rh, rw = target_hw(*image_hw, S)
    x = F.interpolate(low_res, (S, S), mode="bilinear", align_corners=False)[..., :rh, :rw]
    return F.interpolate(x, tuple(image_hw), mode="bilinear", align_corners=False)


def box_prompts(boxes_per_view: Sequence[np.ndarray], image_hw, s: dict, device):
    """Boxes (N_v, 4) of each view in original pixels -> (boxes (N, 4) in the
    1024 input's pixels, their views (N,))."""
    H, W = image_hw
    rh, rw = target_hw(H, W, s["image_size"])
    scale = np.asarray([rw / W, rh / H, rw / W, rh / H], np.float32)
    flat = np.concatenate([np.asarray(b, np.float32).reshape(-1, 4) for b in boxes_per_view])
    view = np.repeat(np.arange(len(boxes_per_view)), [len(b) for b in boxes_per_view])
    return (torch.as_tensor(flat * scale, device=device),
            torch.as_tensor(view, device=device))


def segment_boxes(w: dict, emb: Tensor, boxes_per_view: List[np.ndarray], image_hw, s: dict,
                  P: Precision):
    """Every view's boxes against its own embedding -> (mask logits (N, 3,
    H, W) at the original image, IoU predictions (N, 3)), :data:`BOXES` boxes
    at a time."""
    boxes, view = box_prompts(boxes_per_view, image_hw, s, emb.device)
    logits, ious = [], []
    for i in range(0, len(boxes), BOXES):
        low, iou = decode(w, emb, boxes[i:i + BOXES], view[i:i + BOXES], s, P)
        logits.append(upscale(low, image_hw, s))
        ious.append(iou)
    return torch.cat(logits), torch.cat(ious)

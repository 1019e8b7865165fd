"""Swin-T as GroundingDINO's backbone runs it, in plain PyTorch.

Written from the Swin Transformer paper (arXiv:2103.14030) and
microsoft/Swin-Transformer's detection backbone, which GroundingDINO's
``groundingdino/models/GroundingDINO/backbone/swin_transformer.py`` copies,
with huggingface ``SwinBackbone``'s parameter names:

- the image is padded bottom-right to a multiple of the 4-pixel patch, a
  stride-4 convolution embeds the patches, a layer norm follows;
- each stage runs blocks of (layer norm, window attention, residual, layer
  norm, GELU MLP, residual); the map is padded bottom-right to a multiple
  of the 7x7 window, every second block rolls it by -3 pixels first and
  back after, and masks attention between the rolled regions with -100;
  each window adds the bias table entry of every pair's relative offset;
- patch merging pads an odd height or width by one, concatenates the four
  pixels of each 2x2 cell (x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2],
  x[1::2, 1::2]), layer-norms them and projects them to twice the width;
- the output stages are layer-normed and returned as NCHW maps.

Departures from the published code: none in the arithmetic. Precision
follows the program's compute-dtype semantics (``layers.py``): the trunk
in its dtype, the window attention's logits scaled after the product, in
f32, with the bias and mask added there.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import layers as nn_
from port_bench.reference.precision import Precision

Tensor = torch.Tensor
LN_EPS = 1e-5


def relative_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    return (rel[0] + window - 1) * (2 * window - 1) + (rel[1] + window - 1)


def shift_mask(Hp: int, Wp: int, window: int, shift: int) -> np.ndarray:
    """(windows, T, T) additive mask of the rolled regions: -100 between
    pixels of different regions."""
    img = np.zeros((Hp, Wp), np.int64)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(Hp // window, window, Wp // window, window).transpose(0, 2, 1, 3)
    win = win.reshape(-1, window * window)
    return np.where(win[:, None, :] != win[:, :, None], -100.0, 0.0)


def window_attention(x: Tensor, w: dict, pre: str, heads: int, window: int, mask,
                     P: Precision) -> Tensor:
    """x (B, nW, T, C) windows -> attended windows."""
    B, nW, T, C = x.shape
    hd = C // heads

    def split(t):
        return t.reshape(B, nW, T, heads, hd).permute(0, 1, 3, 2, 4)

    q, k, v = (split(nn_.linear(x, w, pre + "attention.self." + n, P))
               for n in ("query", "key", "value"))
    a = nn_.acc(x)
    logits = nn_.matmul(q, k.transpose(-1, -2), P).to(a) / math.sqrt(hd)
    idx = torch.as_tensor(relative_index(window), device=x.device).reshape(-1)
    table = w[pre + "attention.self.relative_position_bias_table"]
    bias = table[idx].reshape(T, T, heads).permute(2, 0, 1).to(a)
    logits = logits + bias[None, None]
    if mask is not None:
        logits = logits + mask[None, :, None]
    probs = nn_.softmax(logits, P, x.dtype)
    out = nn_.matmul(probs, v, P).permute(0, 1, 3, 2, 4).reshape(B, nW, T, C)
    return nn_.linear(out, w, pre + "attention.output.dense", P)


def block(x: Tensor, hw, w: dict, pre: str, heads: int, window: int, shift: int,
          P: Precision) -> Tensor:
    H, W = hw
    B, _, C = x.shape
    h = nn_.layer_norm(x, w, pre + "layernorm_before", LN_EPS, P).reshape(B, H, W, C)
    ph, pw = (-H) % window, (-W) % window
    h = F.pad(h, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    mask = None
    if shift:
        h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        mask = torch.as_tensor(shift_mask(Hp, Wp, window, shift), device=x.device,
                               dtype=nn_.acc(x))
    win = h.reshape(B, Hp // window, window, Wp // window, window, C).permute(0, 1, 3, 2, 4, 5)
    win = window_attention(win.reshape(B, -1, window * window, C), w, pre, heads, window, mask, P)
    h = win.reshape(B, Hp // window, Wp // window, window, window, C).permute(0, 1, 3, 2, 4, 5)
    h = h.reshape(B, Hp, Wp, C)
    if shift:
        h = torch.roll(h, (shift, shift), dims=(1, 2))
    x = x + h[:, :H, :W].reshape(B, H * W, C)
    h = nn_.layer_norm(x, w, pre + "layernorm_after", LN_EPS, P)
    h = nn_.gelu(nn_.linear(h, w, pre + "intermediate.dense", P), P)
    return x + nn_.linear(h, w, pre + "output.dense", P)


def merge(x: Tensor, hw, w: dict, pre: str, P: Precision):
    H, W = hw
    B, _, C = x.shape
    h = F.pad(x.reshape(B, H, W, C), (0, 0, 0, W % 2, 0, H % 2))
    h = torch.cat([h[:, 0::2, 0::2], h[:, 1::2, 0::2], h[:, 0::2, 1::2], h[:, 1::2, 1::2]], -1)
    nh, nw = (H + 1) // 2, (W + 1) // 2
    h = nn_.layer_norm(h.reshape(B, nh * nw, 4 * C), w, pre + "norm", LN_EPS, P)
    return nn_.linear(h, w, pre + "reduction", P, bias=False), (nh, nw)


def forward(w: dict, pixels: Tensor, sw: dict, P: Precision) -> List[Tensor]:
    """pixels (B, 3, H, W), normalised, in the trunk's dtype; ``w`` the
    backbone's leaves (names after ``...conv_encoder.model.``) in that
    dtype -> the NCHW maps of ``sw['out_stages']``."""
    p, ws = sw["patch_size"], sw["window_size"]
    H, W = pixels.shape[-2:]
    x = F.pad(pixels, (0, (-W) % p, 0, (-H) % p))
    x = P.r(F.conv2d(P.operand(x), P.operand(w["embeddings.patch_embeddings.projection.weight"]),
                     w["embeddings.patch_embeddings.projection.bias"], stride=p))
    B, C, gh, gw = x.shape
    x = nn_.layer_norm(x.flatten(2).transpose(1, 2), w, "embeddings.norm", LN_EPS, P)
    hw, outs = (gh, gw), []
    for si, depth in enumerate(sw["depths"]):
        for bi in range(depth):
            x = block(x, hw, w, f"encoder.layers.{si}.blocks.{bi}.", sw["num_heads"][si], ws,
                      0 if bi % 2 == 0 else ws // 2, P)
        if si in sw["out_stages"]:
            o = nn_.layer_norm(x, w, f"hidden_states_norms.stage{si + 1}", LN_EPS, P)
            outs.append(o.transpose(1, 2).reshape(B, -1, hw[0], hw[1]))
        if si < len(sw["depths"]) - 1:
            x, hw = merge(x, hw, w, f"encoder.layers.{si}.downsample.", P)
    return outs

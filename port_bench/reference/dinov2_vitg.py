"""DINOv2 ViT-g/14 with registers as torch hub's ``dinov2_vitg14_reg``
computes it, in plain PyTorch.

Follows facebookresearch/dinov2: ``hub/backbones.py::dinov2_vitg14_reg``
builds ``models/vision_transformer.py::vit_giant2`` (1536 wide, 40
layers, 24 heads of 64) with ``ffn_layer="swiglufused"``,
``num_register_tokens=4``, ``interpolate_antialias=True``,
``interpolate_offset=0.0``, ``init_values=1.0``, ``img_size=518``,
``patch_size=14``. The forward is ``prepare_tokens_with_masks`` then the
blocks then the final norm:

- the stride-14 patch convolution, the class token, and the positional
  table added to both, interpolated by ``interpolate_pos_encoding``:
  bicubic with antialiasing to the exact (gh, gw) grid (offset 0 passes
  ``size``, not scale factors);
- the 4 register tokens inserted after that add, between the class token
  and the patches: they carry no position;
- 40 pre-norm blocks (layer norm, attention, layer scale, layer norm,
  ``layers/swiglu_ffn.py::SwiGLUFFNFused``, layer scale), the FFN's hidden
  width ``(int(4 * 1536 * 2 / 3) + 7) // 8 * 8`` = 4096: ``w12`` (1536 ->
  8192), its output's two halves ``x1, x2``, ``w3(silu(x1) * x2)``;
- the final layer norm, whose tokens after the class token and the
  registers are ``x_norm_patchtokens``, the descriptors.

The pixels are D3Fields' (``reference/dinov2.py::pixels``). Departures from
the hub's code, each a matter of rounding alone:

- attention: xformers' memory-efficient kernel (the hub's
  ``MemEffAttention`` where xformers is installed) is replaced by the
  explicit softmax of ``reference/dinov2.py::_attention``, its logits
  scaled and soft-maxed in float32 (float64 in the f64 mode);
- ``SwiGLUFFNFused`` runs xformers' fused ``swiglu`` op where xformers is
  installed; here the hub's fallback (``SwiGLUFFN.forward``): ``w12``,
  ``chunk``, ``silu``, the product, ``w3``, each op rounded in the mode's
  dtype;
- the positional table: the hub interpolates the float32 table on the
  model's device; here it is interpolated in float64 on the host and
  stored as float32 (float64 in the f64 mode).

A mode of ``precision.py`` says how the rest is computed; this module sets
TF32 off for the float32 modes (``Precision.matmul_mode``). It imports
nothing of the program under test, of JAX or of the JAX package. The
weights are the dict ``port_bench/weights_vitg.py`` made (torch hub's
names).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.dinov2 import _attention, _layer_norm, _linear, pixels
from port_bench.reference.precision import Precision

Tensor = torch.Tensor


def ffn_hidden(hidden: int, mlp_ratio: int) -> int:
    """``SwiGLUFFNFused``'s hidden width for ``mlp_ratio * hidden`` asked."""
    return (int(mlp_ratio * hidden * 2 / 3) + 7) // 8 * 8


def pos_table(pos_embed: Tensor, patch_hw, P: Precision, antialias: bool = True,
              offset: float = 0.0) -> Tensor:
    """(1 + ph*pw, D): torch hub's ``interpolate_pos_encoding`` of the
    (1, 1 + G*G, D) table in float64 on the host (the exact grid size where
    ``offset`` is 0, else the scale factors (g + offset) / G), stored as
    the float32 parameter it is (float64 for the f64 mode)."""
    ph, pw = patch_hw
    pe = pos_embed.detach().to("cpu", torch.float64)[0]
    G = int(round((pe.shape[0] - 1) ** 0.5))
    grid = pe[1:].reshape(1, G, G, -1).permute(0, 3, 1, 2)
    if (ph, pw) != (G, G):
        size = {"scale_factor": ((ph + offset) / G, (pw + offset) / G)} if offset \
            else {"size": (ph, pw)}
        grid = F.interpolate(grid, mode="bicubic", antialias=antialias, align_corners=False,
                             **size)
    assert tuple(grid.shape[-2:]) == (ph, pw)
    table = torch.cat([pe[:1], grid[0].permute(1, 2, 0).reshape(ph * pw, -1)])
    if P.vit_dtype != torch.float64:
        table = table.float()
    return table.to(pos_embed.device)


def swiglu(h: Tensor, w: dict, pre: str, P: Precision) -> Tensor:
    """``SwiGLUFFN.forward``: ``w3(silu(x1) * x2)``, ``x1, x2`` the halves of ``w12(h)``."""
    x1, x2 = _linear(h, w[pre + "w12.weight"], w[pre + "w12.bias"], P).chunk(2, dim=-1)
    g = P.r(P.r(F.silu(x1)) * x2)
    return _linear(g, w[pre + "w3.weight"], w[pre + "w3.bias"], P)


def forward(weights: dict, px: Tensor, pos: Tensor, heads: int, layers: int,
            P: Precision) -> Tensor:
    """(V, 3, H, W) normalised pixels -> (V, 1 + R + gh*gw, D) final-norm
    tokens: the class token, the R registers, the patches."""
    dt = P.vit_dtype
    w = {k: v.to(dt) for k, v in weights.items() if k != "pos_embed"}
    with P.matmul_mode():
        x = F.conv2d(P.operand(px), P.operand(w["patch_embed.proj.weight"]),
                     w["patch_embed.proj.bias"], stride=w["patch_embed.proj.weight"].shape[-1])
        x = P.r(x).flatten(2).transpose(1, 2)
        V, _, D = x.shape
        x = torch.cat([w["cls_token"].expand(V, 1, D), x], dim=1)
        x = P.r(x + pos[None].to(dt))
        if "register_tokens" in w:
            reg = w["register_tokens"]
            x = torch.cat([x[:, :1], reg.expand(V, reg.shape[1], D), x[:, 1:]], dim=1)
        for i in range(layers):
            pre = f"blocks.{i}."
            h = _layer_norm(x, w[pre + "norm1.weight"], w[pre + "norm1.bias"], P)
            a = _attention(h, w, pre + "attn.", heads, P)
            x = P.r(x + P.r(w[pre + "ls1.gamma"] * a))
            h = _layer_norm(x, w[pre + "norm2.weight"], w[pre + "norm2.bias"], P)
            m = swiglu(h, w, pre + "mlp.", P)
            x = P.r(x + P.r(w[pre + "ls2.gamma"] * m))
        return _layer_norm(x, w["norm.weight"], w["norm.bias"], P)


def descriptors(weights: dict, images_u8: np.ndarray, model: dict, patch_hw,
                P: Precision) -> Tensor:
    """(V, ph, pw, D) patch descriptors (``x_norm_patchtokens``) of (V, H,
    W, 3) uint8 images: float64 in the f64 mode, float32 otherwise."""
    device = weights["cls_token"].device
    px = pixels(images_u8, patch_hw, model["patch_size"], P, device)
    pos = pos_table(weights["pos_embed"], patch_hw, P, model["interpolate_antialias"],
                    model["interpolate_offset"])
    with torch.no_grad():
        tok = forward(weights, px, pos, model["num_heads"], model["num_layers"], P)
    first = 1 + model["num_register_tokens"]
    out = tok[:, first:].reshape(px.shape[0], patch_hw[0], patch_hw[1], -1)
    return out if out.dtype == torch.float64 else out.float()

"""DINOv2 ViT-L/14 as torch hub's ``dinov2_vitl14`` computes it, in plain PyTorch.

Follows facebookresearch/dinov2 (``vision_transformer.py``, ``layers/``)
and the D3Fields reference's feature extraction (``fusion.py``
``extract_dinov2_features``): Pillow's bilinear resize of the uint8 image
to the patch grid times 14, ToTensor, ImageNet normalisation, the stride-14
patch convolution, the class token, the positional table interpolated
bicubically with torch hub's scale factors ((g + 0.1) / 37, its
``interpolate_offset``), 24 pre-norm blocks (layer norm, attention, layer
scale, GELU MLP, layer scale) and the final layer norm, whose patch tokens
are the descriptors. The attention logits are scaled and soft-maxed in
float32 (or float64), as the JAX package's compute-dtype semantics state.
The weights are the dict the benchmark made (torch hub's names).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.precision import Precision
from port_bench.reference.resize import pil_bilinear_u8

Tensor = torch.Tensor

# torchvision's ImageNet statistics, as the reference's T.Normalize takes them
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INTERPOLATE_OFFSET = 0.1
LN_EPS = 1e-6


def pixels(images_u8: np.ndarray, patch_hw, patch: int, P: Precision, device) -> Tensor:
    """(V, H, W, 3) uint8 -> (V, 3, ph*p, pw*p) normalised, in the ViT's
    input dtype (normalised in float32, or float64 for the f64 mode)."""
    ph, pw = patch_hw
    resized = pil_bilinear_u8(images_u8, (ph * patch, pw * patch))
    dt = torch.float64 if P.vit_dtype == torch.float64 else torch.float32
    x = torch.as_tensor(resized, device=device).to(dt) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32).to(device, dt)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32).to(device, dt)
    x = P.r((x - mean) / std)
    return x.permute(0, 3, 1, 2).contiguous().to(P.vit_dtype)


def pos_table(pos_embed: Tensor, patch_hw, P: Precision) -> Tensor:
    """(1 + ph*pw, D): torch hub's ``interpolate_pos_encoding`` of the
    (1, 1 + G*G, D) table, computed in float64 on the host and stored as
    the float32 parameter it is (float64 for the f64 mode)."""
    ph, pw = patch_hw
    pe = pos_embed.detach().to("cpu", torch.float64)[0]
    G = int(round((pe.shape[0] - 1) ** 0.5))
    grid = pe[1:].reshape(1, G, G, -1).permute(0, 3, 1, 2)
    if (ph, pw) != (G, G):
        grid = F.interpolate(grid, mode="bicubic", align_corners=False,
                             scale_factor=((ph + INTERPOLATE_OFFSET) / G,
                                           (pw + INTERPOLATE_OFFSET) / G))
    assert tuple(grid.shape[-2:]) == (ph, pw)
    table = torch.cat([pe[:1], grid[0].permute(1, 2, 0).reshape(ph * pw, -1)])
    if P.vit_dtype != torch.float64:
        table = table.float()
    return table.to(pos_embed.device)


def _linear(x: Tensor, w: Tensor, b: Tensor, P: Precision) -> Tensor:
    return P.r(F.linear(P.operand(x), P.operand(w), b))


def _layer_norm(x: Tensor, w: Tensor, b: Tensor, P: Precision) -> Tensor:
    return P.r(F.layer_norm(x, (x.shape[-1],), w, b, eps=LN_EPS))


def _attention(x: Tensor, w: dict, pre: str, heads: int, P: Precision) -> Tensor:
    B, N, D = x.shape
    dh = D // heads
    qkv = _linear(x, w[pre + "qkv.weight"], w[pre + "qkv.bias"], P)
    q, k, v = qkv.reshape(B, N, 3, heads, dh).permute(2, 0, 3, 1, 4)
    logits = torch.matmul(P.operand(q), P.operand(k).transpose(-1, -2))
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    logits = P.r(logits.to(acc) * (1.0 / np.sqrt(dh)))
    probs = P.r(torch.softmax(logits, dim=-1)).to(x.dtype)
    out = P.r(torch.matmul(P.operand(probs), P.operand(v)))
    out = out.transpose(1, 2).reshape(B, N, D)
    return _linear(out, w[pre + "proj.weight"], w[pre + "proj.bias"], P)


def forward(weights: dict, px: Tensor, pos: Tensor, heads: int, layers: int,
            P: Precision) -> Tensor:
    """(V, 3, H, W) normalised pixels -> (V, 1 + gh*gw, D) final-norm tokens."""
    dt = P.vit_dtype
    w = {k: v.to(dt) for k, v in weights.items() if k != "pos_embed"}
    with P.matmul_mode():
        x = F.conv2d(P.operand(px), P.operand(w["patch_embed.proj.weight"]),
                     w["patch_embed.proj.bias"], stride=w["patch_embed.proj.weight"].shape[-1])
        x = P.r(x).flatten(2).transpose(1, 2)
        V, _, D = x.shape
        x = torch.cat([w["cls_token"].expand(V, 1, D), x], dim=1)
        x = P.r(x + pos[None].to(dt))
        for i in range(layers):
            pre = f"blocks.{i}."
            h = _layer_norm(x, w[pre + "norm1.weight"], w[pre + "norm1.bias"], P)
            a = _attention(h, w, pre + "attn.", heads, P)
            x = P.r(x + P.r(w[pre + "ls1.gamma"] * a))
            h = _layer_norm(x, w[pre + "norm2.weight"], w[pre + "norm2.bias"], P)
            h = P.r(F.gelu(_linear(h, w[pre + "mlp.fc1.weight"], w[pre + "mlp.fc1.bias"], P),
                           approximate="none"))
            m = _linear(h, w[pre + "mlp.fc2.weight"], w[pre + "mlp.fc2.bias"], P)
            x = P.r(x + P.r(w[pre + "ls2.gamma"] * m))
        return _layer_norm(x, w["norm.weight"], w["norm.bias"], P)


def descriptors(weights: dict, images_u8: np.ndarray, model: dict, patch_hw,
                P: Precision) -> Tensor:
    """(V, ph, pw, D) patch descriptors of (V, H, W, 3) uint8 images: float64
    in the f64 mode, float32 otherwise (the values of the mode's dtype)."""
    device = weights["cls_token"].device
    px = pixels(images_u8, patch_hw, model["patch_size"], P, device)
    pos = pos_table(weights["pos_embed"], patch_hw, P)
    with torch.no_grad():
        tok = forward(weights, px, pos, model["num_heads"], model["num_layers"], P)
    out = tok[:, 1:].reshape(px.shape[0], patch_hw[0], patch_hw[1], -1)
    return out if out.dtype == torch.float64 else out.float()

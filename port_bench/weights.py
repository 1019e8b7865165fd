"""Random ViT weights from the seed, made on the device in one draw.

One ``torch.randn`` on the device's own generator fills every leaf of
torch hub's DINOv2 layout (names as in ``dinov2_vitl14``'s state dict), each
leaf a view of that draw moved to its own scale: matrices, tokens and the
positional table N(0, 0.02^2), biases N(0, 0.02^2), layer-norm scales and
layer scales 1 + N(0, 0.1^2), layer-norm shifts N(0, 0.02^2). The same seed
on the same device and torch build gives the same weights, so the
reference can make them again after the program's state is freed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Tensor = torch.Tensor


def dinov2_shapes(model: dict) -> List[Tuple[str, tuple, float, float]]:
    """(name, shape, scale, shift) of every leaf, in torch hub's order."""
    D, G, p = model["hidden_size"], model["image_size"] // model["patch_size"], model["patch_size"]
    F = model["mlp_ratio"] * D
    leaves = [("cls_token", (1, 1, D), 0.02, 0.0), ("pos_embed", (1, 1 + G * G, D), 0.02, 0.0),
              ("patch_embed.proj.weight", (D, 3, p, p), 0.02, 0.0),
              ("patch_embed.proj.bias", (D,), 0.02, 0.0)]
    for i in range(model["num_layers"]):
        b = f"blocks.{i}."
        leaves += [(b + "norm1.weight", (D,), 0.1, 1.0), (b + "norm1.bias", (D,), 0.02, 0.0),
                   (b + "attn.qkv.weight", (3 * D, D), 0.02, 0.0),
                   (b + "attn.qkv.bias", (3 * D,), 0.02, 0.0),
                   (b + "attn.proj.weight", (D, D), 0.02, 0.0),
                   (b + "attn.proj.bias", (D,), 0.02, 0.0), (b + "ls1.gamma", (D,), 0.1, 1.0),
                   (b + "norm2.weight", (D,), 0.1, 1.0), (b + "norm2.bias", (D,), 0.02, 0.0),
                   (b + "mlp.fc1.weight", (F, D), 0.02, 0.0), (b + "mlp.fc1.bias", (F,), 0.02, 0.0),
                   (b + "mlp.fc2.weight", (D, F), 0.02, 0.0), (b + "mlp.fc2.bias", (D,), 0.02, 0.0),
                   (b + "ls2.gamma", (D,), 0.1, 1.0)]
    leaves += [("norm.weight", (D,), 0.1, 1.0), ("norm.bias", (D,), 0.02, 0.0)]
    return leaves


def dinov2_weights(model: dict, seed: int, device) -> Dict[str, Tensor]:
    """Every leaf, float32 on ``device``, from one draw seeded with ``seed``."""
    leaves = dinov2_shapes(model)
    total = sum(torch.Size(s).numel() for _, s, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, scale, shift in leaves:
        n = torch.Size(shape).numel()
        out[name] = flat[at:at + n].view(shape).mul_(scale).add_(shift)
        at += n
    return out

"""Random DINOv2 ViT-g/14-reg weights from the seed, made on the device in one draw.

The leaves of torch hub's ``dinov2_vitg14_reg`` state dict (less the
unused ``mask_token``): ``weights.py``'s layout with the register tokens
after the positional table and each block's feed-forward as
``SwiGLUFFNFused``'s ``mlp.w12`` (D -> 2H) and ``mlp.w3`` (H -> D), H the
configuration's ``ffn_hidden``. The scales are ``weights.py``'s, the
register tokens N(0, 0.02^2) as the class token. One ``torch.randn`` on
the device's own generator fills them all, so the same seed on the same
device and torch build gives the same weights, and the reference can make
them again after the program's state is freed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from port_bench.weights import dinov2_shapes

Tensor = torch.Tensor


def vitg_shapes(model: dict) -> List[Tuple[str, tuple, float, float]]:
    """(name, shape, scale, shift) of every leaf, in torch hub's order."""
    D, H, R = model["hidden_size"], model["ffn_hidden"], model["num_register_tokens"]
    swiglu = {"mlp.fc1.weight": ("mlp.w12.weight", (2 * H, D)),
              "mlp.fc1.bias": ("mlp.w12.bias", (2 * H,)),
              "mlp.fc2.weight": ("mlp.w3.weight", (D, H)),
              "mlp.fc2.bias": ("mlp.w3.bias", (D,))}
    leaves = []
    for name, shape, scale, shift in dinov2_shapes(model):
        for old, (new, new_shape) in swiglu.items():
            if name.endswith("." + old):
                name, shape = name[:-len(old)] + new, new_shape
        leaves.append((name, shape, scale, shift))
        if name == "pos_embed" and R:
            leaves.append(("register_tokens", (1, R, D), 0.02, 0.0))
    return leaves


def vitg_weights(model: dict, seed: int, device) -> Dict[str, Tensor]:
    """Every leaf, float32 on ``device``, from one draw seeded with ``seed``."""
    leaves = vitg_shapes(model)
    total = sum(torch.Size(s).numel() for _, s, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, scale, shift in leaves:
        n = torch.Size(shape).numel()
        out[name] = flat[at:at + n].view(shape).mul_(scale).add_(shift)
        at += n
    return out

"""The yardstick's arithmetic for DINOv2 with the SwiGLU feed-forward and
register tokens (``configs/vitg14reg-bf16.json``).

Counted from shapes, never read from the program, as ``costs.py`` counts
ViT-L's; the interpolation and the card's peaks are ``costs.py``'s.
"""

from __future__ import annotations

from port_bench import costs


def vit_flops(tokens: int, hidden: int, layers: int, ffn_hidden: int, patch: int,
              patches: int) -> float:
    """FLOPs of one ViT forward over ``tokens`` tokens (a multiply-add is 2):
    per layer and token the qkv and output matrices (2·D·4D), the SwiGLU's
    three (``w12`` D -> 2H and ``w3`` H -> D: 2·3·D·H) and the attention's
    two products with every token (4·N·D); the patch embedding (2·3·p²·D
    per patch). Layer norms, softmax, SiLU, the gate's product and adds are
    not counted."""
    D, N, H = hidden, tokens, ffn_hidden
    per_token = 2 * D * (4 * D + 3 * H) + 4 * N * D
    return float(layers * N * per_token + patches * 2 * 3 * patch * patch * D)


def dinov2_flops(model: dict, views: int, patch_hw) -> float:
    """One observation's DINOv2 FLOPs: ``views`` images on a (ph, pw) patch
    grid, each with the class token and the registers (7.59 TFLOP for
    ViT-g/14-reg on 4 views of 24x32 patches: 4 x 773 tokens)."""
    ph, pw = patch_hw
    tokens = 1 + model["num_register_tokens"] + ph * pw
    return views * vit_flops(tokens, model["hidden_size"], model["num_layers"],
                             model["ffn_hidden"], model["patch_size"], ph * pw)


def query_flops(model: dict, rig: dict, points: int, return_channels: int) -> float:
    """One query request: the observation's DINOv2 and the interpolation of
    every returned channel at every point."""
    return (dinov2_flops(model, rig["views"], rig["patch_hw"])
            + costs.interp_flops(rig["views"], points, return_channels))

"""The yardstick's arithmetic: model FLOPs, kernel bytes, and the card's peaks.

Frozen here, beside the benchmark, so that a change to the program cannot
move it. Every count is worked out from shapes, never read from the
program.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense rates at the 700 W limit (PERF.md, §2):
PEAK_FLOPS = {
    "float32": 67e12,    # FP32 outside the tensor cores (TF32 is off)
    "bfloat16": 989e12,  # BF16 tensor cores, dense
}
PEAK_BYTES_PER_S = 3.35e12  # HBM3


def vit_flops(tokens: int, hidden: int, layers: int, mlp_ratio: int, patch: int,
              patches: int) -> float:
    """FLOPs of one ViT forward over ``tokens`` tokens (a multiply-add is 2):
    per layer and token the qkv, output and two MLP matrices (2·D·(3D + D +
    2·r·D)) and the attention's two products with every token (4·N·D); the
    patch embedding (2·3·p²·D per patch). Layer norms, softmax, GELU and
    adds are not counted."""
    D, N = hidden, tokens
    per_token = 2 * D * (3 * D + D + 2 * mlp_ratio * D) + 4 * N * D
    return float(layers * N * per_token + patches * 2 * 3 * patch * patch * D)


def dinov2_flops(model: dict, views: int, patch_hw) -> float:
    """One observation's DINOv2 FLOPs: ``views`` images on a (ph, pw) patch
    grid plus the class token (PERF.md: 2.09 TFLOP for ViT-L/14 on 4 views
    of 24x32 patches)."""
    ph, pw = patch_hw
    return views * vit_flops(ph * pw + 1, model["hidden_size"], model["num_layers"],
                             model["mlp_ratio"], model["patch_size"], ph * pw)


def interp_flops(views: int, points: int, channels: int) -> float:
    """The weighted bilinear interpolation of ``channels`` over ``views``
    views: 4 taps, a multiply-add each (the fused kernel's 2·4·V·N·C)."""
    return float(2 * 4 * views * points * channels)


def fused_interp_bytes(views: int, table_rows: int, channels: int, points: int,
                       table_itemsize: int) -> float:
    """Bytes the fused interpolation of one tile must move, each once: the
    (V, P, C) table, the (V, N, 4) int32 tap indices and float32 weights,
    and the (N, C) float32 output. At V=4, P=768, C=1024, N=131072: 566.3 MB
    with an f32 table and 559.9 MB with a bf16 one (PERF.md, kernel table)."""
    return float(views * table_rows * channels * table_itemsize
                 + 2 * views * points * 4 * 4 + points * channels * 4)


def fused_interp_bound_s(views: int, table_rows: int, channels: int, points: int,
                         table_itemsize: int) -> float:
    """The least time one tile can take on the card: the larger of its bytes
    at the HBM rate and its FLOPs at the float32 rate (the kernel sums in
    f32 on the CUDA cores with either table)."""
    return max(fused_interp_bytes(views, table_rows, channels, points, table_itemsize)
               / PEAK_BYTES_PER_S,
               interp_flops(views, points, channels) / PEAK_FLOPS["float32"])


def query_flops(model: dict, rig: dict, points: int, return_channels: int) -> float:
    """One query request: the observation's DINOv2 and the interpolation of
    every returned channel at every point."""
    return (dinov2_flops(model, rig["views"], rig["patch_hw"])
            + interp_flops(rig["views"], points, return_channels))


"""The yardstick's arithmetic against hand counts."""

import pytest

from port_bench import costs

VITL = {"hidden_size": 1024, "num_layers": 24, "num_heads": 16, "mlp_ratio": 4,
        "patch_size": 14, "image_size": 518}


def test_dinov2_flops_match_a_hand_count_at_24x32_patches():
    N, D, L = 24 * 32 + 1, 1024, 24
    qkv, proj = 2 * N * D * 3 * D, 2 * N * D * D
    mlp = 2 * (2 * N * D * 4 * D)
    attn = 2 * (2 * N * N * D)                    # q k^T and p v, all heads together
    patch = 24 * 32 * 2 * (3 * 14 * 14) * D
    per_view = L * (qkv + proj + mlp + attn) + patch
    assert costs.dinov2_flops(VITL, 4, (24, 32)) == 4 * per_view
    assert costs.dinov2_flops(VITL, 4, (24, 32)) == pytest.approx(2.094e12, rel=1e-3)


def test_kernel_bytes_match_the_kernel_table():
    # PERF.md's kernel table: 566 MB with an f32 table, 559.9 MB with a bf16 one
    assert costs.fused_interp_bytes(4, 768, 1024, 131072, 4) / 1e6 == pytest.approx(566.2, abs=0.1)
    assert costs.fused_interp_bytes(4, 768, 1024, 131072, 2) / 1e6 == pytest.approx(559.9, abs=0.1)
    bound = costs.fused_interp_bound_s(4, 768, 1024, 131072, 4)
    assert bound == pytest.approx(0.169e-3, rel=0.01)   # bytes bound it, not FLOPs
    assert costs.interp_flops(4, 131072, 1024) / costs.PEAK_FLOPS["float32"] < bound


def test_request_flops():
    rig = {"views": 4, "patch_hw": [24, 32]}
    q = costs.query_flops(VITL, rig, 1 << 20, 1024 + 3)
    assert q == costs.dinov2_flops(VITL, 4, (24, 32)) + 2 * 4 * 4 * (1 << 20) * 1027

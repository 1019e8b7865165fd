"""Tests of the benchmark (``python -m pytest port_bench/tests`` from the
repository root). They run on the CPU at tiny sizes, with the kernels'
plain versions; those marked ``cuda`` need the card and skip elsewhere."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


def tiny_spec(workload: str):
    """The cell of ``workload`` at a size a CPU test holds: a 2-layer ViT of
    width 64 on a 48x64 rig, 8,192 points in tiles of 2,048."""
    from port_bench import harness

    spec = harness.Spec(workload)
    spec.config, spec.traffic = copy.deepcopy(spec.config), copy.deepcopy(spec.traffic)
    spec.config["model"].update(hidden_size=64, num_layers=2, num_heads=4, image_size=56)
    spec.config["rig"].update(height=48, width=64, patch_hw=[4, 6])
    tr = spec.traffic
    tr["rig"]["focal"] = 52.0
    tr.update(points=8192, tile=2048, check_block=4096, warmup_requests=1)
    return spec


@pytest.fixture
def counted_kernel(monkeypatch):
    """``fused_weighted_interp`` counting its calls on the CPU, where the
    plain version runs and no launch is counted."""
    from d3fields_tpu_torch.fields import kernels

    inner = kernels.fused_weighted_interp

    def counting(feats, idx, w, matmul_dtype="float32"):
        counting.launches += 1
        counting.launches_bf16 += matmul_dtype == "bfloat16"
        return inner(feats, idx, w, matmul_dtype)

    counting.launches = counting.launches_bf16 = 0
    monkeypatch.setattr(kernels, "fused_weighted_interp", counting)
    return counting

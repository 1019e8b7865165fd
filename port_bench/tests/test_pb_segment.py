"""The segmentation cell at a size a CPU test holds: the driver runs the
harness end to end, its readers answer or return None, the reference
loads nothing of JAX, the program or huggingface, and the cost model
agrees with hand counts."""

import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest

from port_bench import costs_segment, harness

CELL = "gdino-swint-samh-bf16.segment-4v"


def tiny_segment_spec():
    """The cell with ``tiny_test`` GroundingDINO (2 + 2 deformable layers)
    and SAM on a 48x64 rig."""
    from d3fields_tpu_torch.models.groundingdino import model as gd
    from d3fields_tpu_torch.models.sam import model as sm

    spec = harness.Spec(CELL)
    spec.config, spec.traffic = copy.deepcopy(spec.config), copy.deepcopy(spec.traffic)
    spec.limits = copy.deepcopy(spec.limits)
    g = dataclasses.asdict(gd.GroundingDinoConfig.tiny_test())
    g.update(short_side=64, max_side=96)
    spec.config.update(gdino=g, sam=dataclasses.asdict(sm.SamConfig.tiny_test()))
    spec.config["rig"].update(height=48, width=64)
    spec.traffic["rig"]["focal"] = 52.0
    spec.limits["deform_gather_launches"] = g["encoder_layers"] + g["decoder_layers"]
    # a loaded host may fit one request in a test's window
    spec.traffic["samples"] = spec.limits["samples"] = 1
    return spec


@pytest.fixture
def counted_gather(monkeypatch):
    """``deform_gather`` counting its calls on the CPU, where the plain
    version runs and no launch is counted."""
    from d3fields_tpu_torch.models.groundingdino import deform_gather as dg
    from d3fields_tpu_torch.models.groundingdino import model as gd

    inner = dg.deform_gather

    def counting(*args):
        counting.launches += 1
        return inner(*args)

    counting.launches = 0
    monkeypatch.setattr(dg, "deform_gather", counting)
    monkeypatch.setattr(gd, "deform_gather", counting)
    return counting


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_end_to_end(trace, counted_gather):
    spec = tiny_segment_spec()
    res = harness.run_cell(spec, 2 ** 31 + 23, 1.5, trace, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["checks"]["deform_gather_launches"]["value"] == 4
    metrics = spec.per_layer if trace else spec.end_to_end
    names = {m["name"] for m in metrics}
    assert set(res["metrics"]) <= names
    if trace:
        # the CPU profile holds no device op: the device's numbers have nothing to read
        assert {"gdino_ms.segment", "sam_encode_ms.segment", "sam_decode_ms.segment",
                "mfu.segment", "sam_boxes.segment"} <= set(res["metrics"])
        assert "deform_gather_roofline" not in res["metrics"]
        assert res["metrics"]["sam_boxes.segment"]["value"] >= 4
    else:
        assert set(res["metrics"]) == {"request_ms_p95", "setup_s"}
    from d3fields_tpu_torch.utils.profiling import tracer

    assert not tracer.on


def test_the_readers_answer_or_return_none():
    rec = {"profile": {"steps": 2, "ops": [("deform_gather_kernel<float>", 1e-3, None)] * 24},
           "gather_launches": [dict(B=1, S=100, Q=100, nh=8, hd=32, L=4, P=4, itemsize=4)] * 12,
           "spans": {}, "program_counters": {"seg_boxes": 30}, "traced_requests": 3}
    roof = harness.reader("deform_gather_roofline")(rec)
    bound = costs_segment.deform_gather_bound_s(rec["gather_launches"][0])
    assert roof == pytest.approx(100 * 12 * bound * 2 / 24e-3)
    assert harness.reader("sam_boxes.segment")(rec) == 10
    assert harness.reader("gdino_ms.segment")(rec) is None
    # the parent's program counts no seg_boxes; a launch missing from the profile
    assert harness.reader("sam_boxes.segment")({"program_counters": {}}) is None
    rec["profile"]["ops"] = rec["profile"]["ops"][:-1]
    assert harness.reader("deform_gather_roofline")(rec) is None


def test_the_reference_loads_nothing_of_jax_the_program_or_huggingface():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from port_bench.reference import gdino, sam, segment, swin, bert, msda\n"
            "from port_bench import weights_segment, costs_segment\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'd3fields_tpu', 'd3fields_tpu_torch', 'transformers'))\n"
            "print(bad)\n" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_deform_gather_bytes_match_a_hand_count():
    # the encoder's bf16 launch: value 4*17821*8*32*2, locations 4*17821*8*4*4*2*4,
    # weights 4*17821*8*4*4*4, output 4*17821*256*4 bytes
    hand = 36_497_408 + 72_994_816 + 36_497_408 + 72_994_816
    assert costs_segment.deform_gather_bytes(4, 17821, 17821, 8, 32, 4, 4, 2) == hand
    assert hand / 1e6 == pytest.approx(219.0, abs=0.05)


def test_sam_encoder_flops_match_a_hand_count():
    """SAM at D=32, 2 heads, MLP 128, an 8x8 grid, window 14 (the grid padded
    to 14x14, one window), layer 1 global."""
    s = {"hidden_size": 32, "num_layers": 2, "num_heads": 2, "mlp_dim": 128, "patch_size": 8,
         "image_size": 64, "window_size": 14, "global_attn_indexes": [1],
         "output_channels": 16}
    D, N, Np = 32, 64, 196
    patch = 2 * N * (3 * 8 * 8) * D
    windowed = (2 * Np * D * 4 * D + 4 * Np * Np * D + 2 * Np * 2 * 16 * 2 * 14
                + 2 * N * D * 128 * 2)
    glob = 2 * N * D * 4 * D + 4 * N * N * D + 2 * N * 2 * 16 * 2 * 8 + 2 * N * D * 128 * 2
    neck = 2 * N * D * 16 + 2 * N * 9 * 16 * 16
    assert costs_segment.sam_encoder_flops(s, 3) == 3 * (patch + windowed + glob + neck)


def test_request_flops_at_the_cell():
    """About 26 TFLOP a 4-view request, SAM's encoder most of it."""
    cfg = json.load(open(os.path.join(harness.ROOT, "port_bench/configs/"
                                      "gdino-swint-samh-bf16.json")))
    total = costs_segment.segment_flops(cfg, 4, boxes=40)
    sam = costs_segment.sam_encoder_flops(cfg["sam"], 4)
    assert 20e12 < total < 32e12 and 0.8 < sam / total < 0.95
    assert costs_segment.gdino_levels(cfg["gdino"], 800, 1067) == [
        (100, 134), (50, 67), (25, 34), (13, 17)]

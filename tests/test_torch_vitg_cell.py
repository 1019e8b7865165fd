"""The benchmark's two query cells of this round: ``vitg14reg-bf16.query-1m``
(DINOv2 ViT-g/14 with registers, ``drivers/query_vitg.py``) and
``vitl14-f32.query-32k`` (32,768 points an observation), on the CPU.

The ViT-g cell runs at a small size (width 64, 2 layers, 4 heads, the
SwiGLU 176 wide, 4 registers, 8x8 pretraining positions) on a 48x64 rig,
8,192 points in tiles of 2,048, its limits as they are.
"""

import ast
import copy
import json
import os
import subprocess
import sys

import pytest
import torch

from port_bench import calibrate_vitg, harness
from port_bench.drivers import query, query_vitg

CELLS = ("vitg14reg-bf16.query-1m", "vitl14-f32.query-32k")
SEED = 2 ** 33 + 19


def tiny_spec():
    spec = harness.Spec(CELLS[0])
    spec.config, spec.traffic = copy.deepcopy(spec.config), copy.deepcopy(spec.traffic)
    spec.config["model"].update(hidden_size=64, num_layers=2, num_heads=4, image_size=112,
                                ffn_hidden=176)
    spec.config["rig"].update(height=48, width=64, patch_hw=[4, 6])
    tr = spec.traffic
    tr["rig"]["focal"] = 52.0
    tr.update(points=8192, tile=2048, check_block=4096, warmup_requests=1, profile_steps=2)
    return spec


@pytest.mark.parametrize("name, cell, driver", [
    (CELLS[0], "vitg14reg-bf16", query_vitg.Cell), (CELLS[1], "vitl14-f32", query.Cell)])
def test_the_new_cells_resolve(name, cell, driver):
    """Each cell's configuration, traffic and limits load by name, its
    driver imports, and it reports the query cells' metrics (the two new
    per-layer metrics in the ViT-g cell alone)."""
    spec = harness.Spec(name)
    assert spec.config["name"] == cell and spec.chips == 1
    assert harness.driver(spec) is driver
    assert {m["name"] for m in spec.end_to_end} == {"query_pts_per_s", "request_ms_p95",
                                                   "setup_s"}
    layer = {m["name"] for m in spec.per_layer}
    assert {"dinov2_ms.query", "batch_eval_ms", "fused_interp_roofline", "mfu.query",
            "dinov2_attn_launches.query"} <= layer
    assert ({"dinov2_ffn_ms.query", "dinov2_tokens.query"} <= layer) == (cell != "vitl14-f32")
    if name == CELLS[1]:
        assert (spec.traffic["points"], spec.traffic["tile"]) == (32768, 32768)
        assert spec.limits == harness.Spec("vitl14-f32.query-1m").limits


@pytest.mark.parametrize("metric", ["dinov2_ffn_ms.query", "dinov2_tokens.query"])
def test_the_new_readers_read_nothing_where_nothing_was_recorded(metric):
    """A record without a profile, without the program's counters, or whose
    profile has no ``dinov2_ffn`` range (the parent's program, another
    driver) gives None, and no error."""
    read = harness.reader(metric)
    profile = {"steps": 3, "ops": [("sam_attention_bf16_kernel", 5e-5, "dinov2")]}
    for rec in ({}, {"profile": profile}, {"program_counters": {"dinov2_attn": 40}},
                {"program_counters": {}, "profile": None}):
        assert read(rec) is None


def test_the_new_readers_read_what_was_recorded():
    ops = [("nvjet_a", 2e-3, "dinov2_ffn"), ("nvjet_b", 1e-3, "dinov2_ffn"),
           ("sam_attention_bf16_kernel", 5e-5, "dinov2")]
    assert harness.reader("dinov2_ffn_ms.query")({"profile": {"steps": 3, "ops": ops}}) == \
        pytest.approx(1.0)
    counters = {"dinov2_forwards": 5, "dinov2_tokens": 5 * 3092}
    assert harness.reader("dinov2_tokens.query")({"program_counters": counters}) == 3092


def test_the_vitg_cell_runs_correct_at_a_small_size():
    """The ViT-g cell at the small size, traced, run by the harness in a
    process of its own (as ``port_bench/run.py`` runs it, so that its guard
    sees no module of JAX or the JAX package loaded), the kernel's calls
    counted as the card would count its launches: correct, every compared
    number within its limit, 4 x (1 + 4 + 24) tokens a transformer call."""
    code = (f"import sys, time, json; sys.path.insert(0, {harness.ROOT!r}); "
            f"sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})\n"
            "import torch; torch.set_num_threads(1)\n"
            "from d3fields_tpu_torch.fields import kernels\n"
            "inner = kernels.fused_weighted_interp\n"
            "def counting(feats, idx, w, matmul_dtype='float32'):\n"
            "    counting.launches += 1\n"
            "    counting.launches_bf16 += matmul_dtype == 'bfloat16'\n"
            "    return inner(feats, idx, w, matmul_dtype)\n"
            "counting.launches = counting.launches_bf16 = 0\n"
            "kernels.fused_weighted_interp = counting\n"
            "from test_torch_vitg_cell import tiny_spec, SEED\n"
            "from port_bench import harness\n"
            "res = harness.run_cell(tiny_spec(), SEED, 2.0, True, 'cpu', time.perf_counter())\n"
            "print(json.dumps(res))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res is not None, out.stderr[-3000:]
    assert res["correct"], res["checks"]
    assert res["checks"]["samples"]["value"] == 3
    assert res["metrics"]["dinov2_tokens.query"]["value"] == 4 * (1 + 4 + 24)


def test_the_control_fails_the_limits_at_a_small_size():
    """The reference one precision step down (fp8 e4m3 products, e4m3
    table and tap weights, TF32 f32 parts: the control of a bf16
    configuration) in the program's place fails the fused descriptors' and
    the validity's limits. Its descriptors lie 0.04-0.05 off here, under
    ``desc_rel``'s limit, which full-size readings set (PERF.md: the
    program 0.0251 at most over 22 seeds, the control 0.166 at least over
    6), where the program's lie 0 off on the CPU."""
    spec = tiny_spec()
    control = calibrate_vitg.query_control(spec, SEED, "fp8", torch.device("cpu"))
    failed = [k for k in ("desc_rel", "feat_rel", "dist_abs", "mask_abs", "valid_mismatch")
              if control[k] > spec.limits[k]]
    assert {"feat_rel", "valid_mismatch"} <= set(failed), control
    assert control["desc_rel"] > 0.01, control


def _imported(path: str):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("name, program_allowed", [
    ("reference/dinov2_vitg.py", False), ("weights_vitg.py", False), ("costs_vitg.py", False),
    ("drivers/query_vitg.py", True), ("calibrate_vitg.py", True),
    ("metrics/dinov2_ffn_ms.query.py", False), ("metrics/dinov2_tokens.query.py", False)])
def test_the_vitg_cells_modules_import_no_jax(name, program_allowed):
    """Nothing of the ViT-g cell imports JAX, Flax or the JAX package; the
    reference, the weights, the yardstick and the readers import nothing of
    the program either (only the driver runs the program)."""
    path = os.path.join(harness.HERE, name)
    names = set(_imported(path))
    assert not names & set(harness.FORBIDDEN), (name, names)
    if not program_allowed:
        assert "d3fields_tpu_torch" not in names, name
        assert "d3fields_tpu_torch" not in open(path).read().replace("``d3fields_tpu_torch``", "")


def test_the_vitg_request_counts_7_59_tflop():
    """costs_vitg: 4 views x 773 tokens through 40 layers at 61.4 MFLOP a
    token and layer, 7.59 TFLOP, with the patch embedding."""
    from port_bench import costs_vitg

    model = harness.Spec(CELLS[0]).config["model"]
    per_token = 2 * 1536 * (4 * 1536 + 3 * 4096) + 4 * 773 * 1536
    assert per_token == 61_372_416
    flops = costs_vitg.dinov2_flops(model, 4, (24, 32))
    assert flops == 40 * 4 * 773 * per_token + 4 * 768 * 2 * 3 * 14 * 14 * 1536
    assert 7.59e12 < flops < 7.60e12

"""The benchmark's plain XMem reference (``port_bench/reference/xmem.py``)
against the program's ``VideoMaskTracker``, and the video cell's check, on
the CPU at a small size.

The size is one where every part of the memory runs within a short video:
64x96 frames (a 4x6 key grid), 2 objects, value_dim 64, hidden_dim 16, a
memory frame every 2 frames, 3 working-memory frames at most and 2 after a
consolidation, 8 prototypes and 32 long-term elements, over 24 frames. The
working memory then consolidates at frames 4, 6, ..., 22 (10 times) and
the long-term memory evicts before each consolidation from frame 10 on (7
times). The weights are the benchmark's (``port_bench/weights_xmem.py``),
drawn from a seed.
"""

import ast
import copy
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from d3fields_tpu_torch.config import XMemConfig
from d3fields_tpu_torch.models.xmem import memory as M
from d3fields_tpu_torch.models.xmem.network import XMem
from d3fields_tpu_torch.seg.video_tracker import VideoMaskTracker
from d3fields_tpu_torch.utils.convert import audit_state_dict
from port_bench import calibrate_video, harness, weights_xmem
from port_bench.reference import xmem as R
from port_bench.videos import Video

SMALL = dict(value_dim=64, hidden_dim=16, max_mid_term_frames=3, min_mid_term_frames=2,
             num_prototypes=8, max_long_term_elements=32, mem_every=2, size=64)
H, W, OBJECTS, FRAMES = 64, 96, 2, 24
SEED = 2 ** 33 + 7
CELL = "xmem-r50-bf16.davis480p"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the Tier-1 run's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_config(dtype: str) -> XMemConfig:
    return XMemConfig(**SMALL, compute_dtype=dtype)


def xmem_dict(cfg: XMemConfig) -> dict:
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "compute_dtype"}


@pytest.fixture(scope="module")
def video():
    traffic = harness.Spec(CELL).traffic
    return Video(SEED, 0, H, W, OBJECTS, FRAMES, traffic["video"]).render_all()


@pytest.fixture(scope="module")
def weights():
    return weights_xmem.xmem_weights(xmem_dict(small_config("float32")), SEED, "cpu")


def run_program(cfg: XMemConfig, weights: dict, video):
    """Every frame's probabilities (O+1, H, W), memory readout and the
    memory elements its read attended, through ``VideoMaskTracker.process``."""
    frames, mask0 = video
    model = XMem(cfg, device="cpu")
    model.load_state_dict(audit_state_dict(model, weights, "xmem"), strict=True)
    tracker = VideoMaskTracker(model, cfg, 1, OBJECTS, (H, W), size=cfg.size, device="cpu")
    read = M.match_memory
    got, out = {}, []

    def keep(mem, *args, **kwargs):
        got["readout"] = read(mem, *args, **kwargs)
        return got["readout"]

    M.match_memory = keep
    try:
        for t in range(FRAMES):
            got.clear()
            elements = tracker.core.read_elements if t else 0
            index = tracker.process(frames[t][None], mask0[None] if t == 0 else None,
                                    return_index=True)
            out.append({"prob": tracker.last_prob[0], "index": index[0],
                        "readout": got.get("readout"), "read_elements": elements})
    finally:
        M.match_memory = read
    return out


def test_program_matches_reference_f32(weights, video):
    """Float32, TF32 off: every frame's probabilities within 1e-5 (they
    differ by rounding alone: the reference's three-product similarity,
    its explicit sum of the other masks, its one skip convolution per
    image; 2e-7 here), the labels the same wherever the reference's two
    likeliest objects lie more than twice that apart, the memory the same
    size at every read, and the reference's memory through the schedule's
    10 consolidations and 7 evictions."""
    cfg = small_config("float32")
    prog = run_program(cfg, weights, video)
    frames, mask0 = video
    ref = R.replay(weights, lambda t: frames[t], mask0, xmem_dict(cfg), OBJECTS, R.MODES["f32"],
                   range(FRAMES), "cpu")
    for t in range(FRAMES):
        torch.testing.assert_close(prog[t]["prob"], ref[t]["prob"], rtol=0, atol=1e-5)
        assert prog[t]["read_elements"] == ref[t]["read_elements"]
        top2 = ref[t]["prob"].topk(2, dim=0).values
        clear = ((top2[0] - top2[1]) > 2e-5).numpy()
        assert (prog[t]["index"] == ref[t]["prob"].argmax(0).numpy())[clear].all()
    assert (ref[FRAMES - 1]["consolidations"], ref[FRAMES - 1]["evictions"]) == (10, 7)


def test_program_matches_reference_bf16(weights, video):
    """bf16 networks, f32 memory, held to the reference's ``bf16`` mode:
    every frame's probabilities within 0.01 and each memory readout within
    the cell's ``readout_rel`` limit. The two differ in rounding from frame
    3 on, the first to read a memory frame whose masks were soft (frame 2):
    the reference sums the other masks explicitly, the program subtracts
    its own from their total, and the bf16 sums differ by an ulp; through
    the value encoder, the readout and the decoder that moves the
    probabilities by 1.4e-3-2.1e-3, a fifth of 0.01. The fp8 control moves
    them by 0.024-0.045."""
    cfg = small_config("bfloat16")
    prog = run_program(cfg, weights, video)
    frames, mask0 = video
    ref = R.replay(weights, lambda t: frames[t], mask0, xmem_dict(cfg), OBJECTS, R.MODES["bf16"],
                   range(FRAMES), "cpu")
    limit = harness.Spec(CELL).limits["readout_rel"]
    for t in range(FRAMES):
        torch.testing.assert_close(prog[t]["prob"], ref[t]["prob"], rtol=0, atol=0.01)
        assert prog[t]["read_elements"] == ref[t]["read_elements"]
        if t:
            a, b = prog[t]["readout"][0].double(), ref[t]["readout"].double()
            assert float((a - b).norm() / b.norm()) < limit, t


def small_spec():
    """The video cell at the small size, its limits as they are, with
    videos of 12 frames (consolidations at frames 4, 6, 8 and 10), so that
    a short window holds whole videos."""
    spec = harness.Spec(CELL)
    spec.config, spec.traffic = copy.deepcopy(spec.config), copy.deepcopy(spec.traffic)
    spec.config["xmem"].update(SMALL)
    spec.config["video"].update(height=H, width=W, objects=OBJECTS)
    spec.traffic.update(frames=12, profile_steps=2)
    return spec


def test_the_cells_check_passes_a_sound_run_and_fails_the_control():
    """The cell at the small size, run by the harness in a process of its
    own (as ``port_bench/run.py`` runs it, so that the harness's guard sees
    no module of JAX or the JAX package loaded): correct, with every
    compared number within its limit and every guard met. The reference
    one precision step down (fp8 products) in the program's place fails a
    limit."""
    code = (f"import sys, time, json; sys.path.insert(0, {harness.ROOT!r}); "
            f"sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})\n"
            "import torch; torch.set_num_threads(1)\n"
            "from test_torch_xmem_reference import small_spec, SEED\n"
            "from port_bench import harness\n"
            "res = harness.run_cell(small_spec(), SEED, 3.0, False, 'cpu', time.perf_counter())\n"
            "print(json.dumps(res))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res is not None, out.stderr[-3000:]
    assert res["correct"], res["checks"]
    assert res["checks"]["consolidations"]["value"] == 4
    assert res["checks"]["samples"]["value"] == 3
    spec = small_spec()
    control = calibrate_video.control(spec, SEED, torch.device("cpu"))
    failed = [k for k in ("prob_abs", "label_mismatch_share", "readout_rel", "read_elements")
              if control[k] > spec.limits[k]]
    assert "readout_rel" in failed, control


def _imported(path: str):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("name, program_allowed", [
    ("reference/xmem.py", False), ("weights_xmem.py", False), ("videos.py", False),
    ("costs_xmem.py", False), ("drivers/video.py", True), ("calibrate_video.py", True)])
def test_the_video_cells_modules_import_no_jax(name, program_allowed):
    """Nothing of the video cell imports JAX, Flax or the JAX package; the
    reference and the inputs' and yardstick's modules import nothing of
    the program either (only the driver runs the program)."""
    path = os.path.join(harness.HERE, name)
    names = set(_imported(path))
    assert not names & set(harness.FORBIDDEN), (name, names)
    if not program_allowed:
        assert "d3fields_tpu_torch" not in names, name
        assert "d3fields_tpu_torch" not in open(path).read().replace("``d3fields_tpu_torch``", "")

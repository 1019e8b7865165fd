"""The tracer's spans and counters of XMem video propagation
(``VideoMaskTracker.process``), on the CPU at a small size.

On, each frame's spans nest as ``xmem.process`` -> ``xmem.key``,
``xmem.read``, ``xmem.decode``, ``xmem.memorize`` (-> ``xmem.evict``,
``xmem.consolidate``); the counters ``xmem_frames``, ``xmem_mem_frames``,
``xmem_consolidations``, ``xmem_evictions`` count the frame schedule's
events and ``xmem_read_elements`` the memory elements the reads attend.
Off, nothing is recorded, and the answers are the same either way.
"""

import dataclasses

import numpy as np
import pytest
import torch

from d3fields_tpu_torch.config import XMemConfig
from d3fields_tpu_torch.models.xmem.network import XMem
from d3fields_tpu_torch.seg.video_tracker import VideoMaskTracker
from d3fields_tpu_torch.utils.convert import audit_state_dict
from d3fields_tpu_torch.utils.profiling import tracer
from port_bench import harness, weights_xmem
from port_bench.videos import Video

CFG = XMemConfig(value_dim=64, hidden_dim=16, max_mid_term_frames=3, min_mid_term_frames=2,
                 num_prototypes=8, max_long_term_elements=32, mem_every=2, size=64)
H, W, OBJECTS, FRAMES = 64, 96, 2, 24
PARENT = {"xmem.process": None, "xmem.key": "xmem.process", "xmem.read": "xmem.process",
          "xmem.decode": "xmem.process", "xmem.memorize": "xmem.process",
          "xmem.consolidate": "xmem.memorize", "xmem.evict": "xmem.memorize"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    xmem = {k: v for k, v in dataclasses.asdict(CFG).items() if k != "compute_dtype"}
    model = XMem(CFG, device="cpu")
    sd = weights_xmem.xmem_weights(xmem, 2 ** 34 + 5, "cpu")
    model.load_state_dict(audit_state_dict(model, sd, "xmem"), strict=True)
    video = Video(2 ** 34 + 5, 1, H, W, OBJECTS, FRAMES,
                  harness.Spec("xmem-r50-bf16.davis480p").traffic["video"]).render_all()
    return model, video


def schedule():
    """The frame schedule worked out from the configuration alone: memory
    frames, consolidations, evictions and the elements each read attends."""
    hw = (H // 16) * (W // 16)
    work = long = 0
    mem_frames = cons = evicts = elements = 0
    protos = min(CFG.num_prototypes, (CFG.max_mid_term_frames - CFG.min_mid_term_frames) * hw)
    for t in range(FRAMES):
        if t:
            elements += long + work
        if t % CFG.mem_every == 0:
            mem_frames += 1
            work += hw
            if work >= CFG.max_mid_term_frames * hw:
                if long >= CFG.max_long_term_elements - protos:
                    long = CFG.max_long_term_elements - protos
                    evicts += 1
                long += protos
                work = CFG.min_mid_term_frames * hw
                cons += 1
    return {"xmem_frames": FRAMES, "xmem_mem_frames": mem_frames, "xmem_consolidations": cons,
            "xmem_evictions": evicts, "xmem_read_elements": elements}


def run(setup):
    model, (frames, mask0) = setup
    tracker = VideoMaskTracker(model, CFG, 1, OBJECTS, (H, W), size=CFG.size, device="cpu")
    out = []
    for t in range(FRAMES):
        out.append(tracker.process(frames[t][None], mask0[None] if t == 0 else None,
                                   return_index=True))
        out.append(tracker.last_prob.clone())
    return out


@pytest.fixture
def traced():
    tracer.reset()
    tracer.enable()
    yield tracer
    tracer.disable()
    tracer.reset()


def test_spans_nest_and_counters_follow_the_schedule(setup, traced):
    run(setup)
    recs = traced.records()
    names = [r[0] for r in recs]
    assert sorted(set(names)) == sorted(PARENT)
    for name, t0, t1, parent, root, _ in recs:
        assert t1 is not None and t1 >= t0
        assert (recs[parent][0] if parent >= 0 else None) == PARENT[name], name
        assert recs[root][0] == "xmem.process"
    want = schedule()
    assert want["xmem_consolidations"] == 10 and want["xmem_evictions"] == 7
    counters = traced.summary()["counters"]
    assert {k: counters.get(k, 0) for k in want} == want
    count = {n: names.count(n) for n in PARENT}
    assert count == {"xmem.process": FRAMES, "xmem.key": FRAMES, "xmem.read": FRAMES - 1,
                     "xmem.decode": FRAMES - 1, "xmem.memorize": want["xmem_mem_frames"],
                     "xmem.consolidate": want["xmem_consolidations"],
                     "xmem.evict": want["xmem_evictions"]}


def test_the_tracer_changes_no_answer(setup):
    tracer.reset()
    off = run(setup)
    assert tracer.records() == []
    tracer.enable()
    try:
        on = run(setup)
    finally:
        tracer.disable()
        tracer.reset()
    for a, b in zip(off, on):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert torch.equal(a, b)

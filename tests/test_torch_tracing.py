"""The port's tracer (``d3fields_tpu_torch/utils/profiling.py``): spans and
counters of the query path and the tracking loop, on the CPU.

Off, a span reads no clock and records nothing; on, the query's spans nest
as update -> features, ingest and query -> tile -> distance, taps, kernel,
bilinear, the outputs do not change, and each span opens a ``d3f.<name>``
range in a recording ``torch.profiler`` trace.
"""

import json
import math
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from d3fields_tpu_torch.config import D3FieldsConfig, FusionConfig, TrackingConfig
from d3fields_tpu_torch.fields import fusion
from d3fields_tpu_torch.fields.state import state_from_obs
from d3fields_tpu_torch.track import rigid
from d3fields_tpu_torch.utils import profiling
from d3fields_tpu_torch.utils import synthetic as tsyn
from d3fields_tpu_torch.utils.profiling import SYNC_WARNING, Tracer, tracer

N, TILE, C = 1000, 300, 16
TILE_CHILDREN = ["fields.bilinear", "fields.distance", "fields.kernel", "fields.taps"]


@pytest.fixture(scope="module")
def scene():
    sc = tsyn.render_sphere_scene(num_views=4, H=48, W=64, feat_dim=C)
    sc["mask"] = np.concatenate([~sc["sphere_masks"].any(1)[..., None],
                                 np.moveaxis(sc["sphere_masks"], 1, -1)], -1).astype(np.float32)
    return sc


@pytest.fixture(scope="module")
def pts():
    return np.random.RandomState(0).uniform([-0.3, -0.4, 0.0], [0.6, 0.4, 0.4],
                                            (N, 3)).astype(np.float32)


class PatchBackend:
    """A feature backend: (V, h, w, C) descriptors on the patch grid."""

    def __call__(self, images, patch_hw=None):
        V = images.shape[0]
        g = torch.Generator().manual_seed(1)
        return torch.rand((V, *patch_hw, C), generator=g)


def observation(sc):
    return {k: sc[k] for k in ("color", "depth", "pose", "K", "mask")}


def query_fusion():
    return fusion.Fusion(config=D3FieldsConfig(fusion=FusionConfig(query_tile=TILE)),
                         feature_backend=PatchBackend(), device="cpu")


@pytest.fixture
def on():
    tracer.reset()
    tracer.enable()
    try:
        yield tracer
    finally:
        tracer.disable()
        tracer.reset()


def by_id(records):
    return {sid: r for sid, r in enumerate(records)}


@pytest.mark.parametrize("fused", [True, False])
def test_off_records_nothing_and_reads_no_clock(scene, pts, monkeypatch, fused):
    state = state_from_obs(scene, dino_feats=scene["dino_feats"], mask=scene["mask"],
                           device="cpu")
    calls = []
    real = time.perf_counter_ns
    monkeypatch.setattr(time, "perf_counter_ns", lambda: calls.append(1) or real())
    tracer.reset()
    assert not tracer.on
    out = fusion.batch_eval(state, pts, ("dino_feats", "mask"), tile=TILE, fused=fused)
    assert out["dino_feats"].shape == (N, C)
    assert calls == [] and tracer.records() == [] and tracer.summary()["spans"] == {}


def test_one_update_and_query_make_the_span_tree(scene, pts, on):
    fus = query_fusion()
    fus.update(observation(scene))
    fus.batch_eval(pts, ("dino_feats", "mask"))
    recs = by_id(on.records())
    names = [r[0] for r in recs.values()]
    tiles = [sid for sid, r in recs.items() if r[0] == "fields.tile"]
    assert len(tiles) == math.ceil(N / TILE) == 4
    assert names.count("fields.update") == names.count("fields.query") == 1
    update = names.index("fields.update")
    query = names.index("fields.query")
    for sid, r in recs.items():
        name, t0, t1, parent, root, _ = r
        assert t1 >= t0
        if name in ("fields.update", "fields.query"):
            assert parent == -1 and root == sid
        elif name.startswith("fields.update."):
            assert parent == update and root == update
        elif name == "fields.tile":
            assert parent == query and root == query
        else:
            assert recs[parent][0] == "fields.tile" and root == query, name
            assert recs[parent][2] >= t1 and recs[parent][1] <= t0
    assert {r[0] for r in recs.values() if r[3] == update} == {
        "fields.update.features", "fields.update.ingest"}
    for tile in tiles:
        assert sorted(r[0] for r in recs.values() if r[3] == tile) == TILE_CHILDREN
    summary = on.summary()["spans"]
    assert summary["fields.tile"]["count"] == 4
    assert sorted(summary["fields.tile"]["children"]) == TILE_CHILDREN


@pytest.mark.parametrize("fused", [True, False])
def test_outputs_are_bit_identical_with_the_tracer_on_and_off(scene, pts, fused):
    state = state_from_obs(scene, dino_feats=scene["dino_feats"], mask=scene["mask"],
                           device="cpu")
    names = ("dino_feats", "mask", "color_tensor")
    off = fusion.batch_eval(state, pts, names, tile=TILE, fused=fused)
    tracer.reset()
    tracer.enable()
    try:
        got = fusion.batch_eval(state, pts, names, tile=TILE, fused=fused)
    finally:
        tracer.disable()
    assert tracer.summary()["spans"]["fields.tile"]["count"] == 4
    tracer.reset()
    for k in off:
        assert torch.equal(off[k], got[k]), k


def test_self_time_is_the_duration_less_the_children(monkeypatch, on):
    ticks = iter([0, 10, 30, 40, 45, 100,   # outer (inner, inner)
                  200, 210, 250, 300])      # outer (inner)
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks) * 1_000_000)
    for kids in (2, 1):
        with on.span("outer"):
            for _ in range(kids):
                with on.span("inner"):
                    pass
    s = on.summary()["spans"]
    assert s["outer"]["count"] == 2 and s["inner"]["count"] == 3
    assert s["outer"]["total_ms"] == pytest.approx(200.0)
    assert s["outer"]["self_ms"] == pytest.approx((100 - 25) + (100 - 40))
    assert s["inner"]["self_ms"] == pytest.approx(s["inner"]["total_ms"]) == pytest.approx(65.0)
    kids = s["outer"]["children"]["inner"]
    assert kids["total_ms"] == pytest.approx(65.0)
    assert kids["median_ms"] == pytest.approx((25 + 40) / 2)
    assert s["inner"]["median_ms"] == pytest.approx(20.0)


def test_a_full_buffer_counts_the_spans_it_drops():
    tr = Tracer(capacity=3)
    tr.enable()
    try:
        for _ in range(2):
            with tr.span("a"):
                with tr.span("b"):
                    tr.count("hits", 2)
    finally:
        tr.disable()
    s = tr.summary()
    assert [r[0] for r in tr.records()] == ["a", "b", "a"]
    assert s["dropped"] == 1
    assert s["counters"] == {"hits": 4} and s["counters_by_span"] == {"b": {"hits": 4}}
    assert s["spans"]["a"]["count"] == 2 and s["spans"]["b"]["count"] == 1


def test_each_thread_keeps_its_own_stack(on):
    def work():
        with on.span("worker"):
            with on.span("inner"):
                pass

    with on.span("main"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    recs = by_id(on.records())
    worker = next(sid for sid, r in recs.items() if r[0] == "worker")
    inner = next(r for r in recs.values() if r[0] == "inner")
    assert recs[worker][3] == -1 and recs[worker][4] == worker
    assert inner[3] == worker and inner[4] == worker
    assert recs[worker][5] != next(r for r in recs.values() if r[0] == "main")[5]


def test_a_sync_warning_is_charged_to_the_innermost_span(recwarn):
    before = list(warnings.filters)
    tracer.reset()
    tracer.enable()
    try:
        with tracer.span("a"):
            with tracer.span("b"):
                warnings.warn(SYNC_WARNING, UserWarning)
                warnings.warn(SYNC_WARNING, UserWarning)
            warnings.warn(SYNC_WARNING, UserWarning)
        warnings.warn(SYNC_WARNING, UserWarning)  # outside the program's spans
        warnings.warn("another warning", UserWarning)
        s = tracer.summary()
    finally:
        tracer.disable()
        tracer.reset()
    assert s["counters"] == {"host_syncs": 3}
    assert s["counters_by_span"] == {"a": {"host_syncs": 1}, "b": {"host_syncs": 2}}
    assert [str(w.message) for w in recwarn] == ["another warning"]
    assert warnings.filters == before


def test_export_chrome_writes_nested_events(scene, pts, on, tmp_path):
    fus = query_fusion()
    fus.update(observation(scene))
    fus.batch_eval(pts, ("dino_feats", "mask"))
    path = tmp_path / "spans.json"
    on.export_chrome(str(path))
    trace = json.loads(path.read_text())
    events = {e["args"]["id"]: e for e in trace["traceEvents"]}
    assert len(events) == len(on.records()) and trace["otherData"]["dropped"] == 0
    for e in events.values():
        assert e["ph"] == "X" and e["dur"] >= 0
        p = events.get(e["args"]["parent"])
        if p is not None:
            assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3


def test_each_span_opens_a_profiler_range(scene, pts, on, tmp_path):
    fus = query_fusion()
    fus.update(observation(scene))
    on.reset()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(1).add_(1)  # the profile's first op sets it up, for ~1 ms
        fus.batch_eval(pts, ("dino_feats", "mask"))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = sorted((e["ts"], e["name"][4:], e["dur"])
                    for e in json.loads(path.read_text())["traceEvents"]
                    if e.get("ph") == "X" and e["name"].startswith("d3f."))
    recs = sorted(on.records(), key=lambda r: r[1])
    assert [r[1] for r in ranges] == [r[0] for r in recs]
    for (_, _, dur_us), r in zip(ranges, recs):
        assert abs(dur_us - (r[2] - r[1]) / 1e3) < 50


def test_rigid_tracking_records_one_step_span_per_iteration(scene, on):
    state = state_from_obs(scene, dino_feats=scene["dino_feats"], mask=scene["mask"],
                           device="cpu")
    kp = torch.as_tensor(np.random.RandomState(2).uniform(-0.1, 0.1, (2, 5, 3)),
                         dtype=torch.float32)
    src = torch.rand((10, C), generator=torch.Generator().manual_seed(3))
    lo, hi = rigid.boundary_vectors({"x_lower": -0.3, "x_upper": 0.6, "y_lower": -0.4,
                                     "y_upper": 0.4, "z_lower": 0.001, "z_upper": 0.4}, "cpu")
    out = rigid.rigid_tracking_steps(state, src, kp, lo, hi, TrackingConfig(iters=3))
    assert out["loss_history"].shape == (3, 4)
    recs = by_id(on.records())
    (top,) = [sid for sid, r in recs.items() if r[0] == "track.rigid"]
    steps = [sid for sid, r in recs.items() if r[0] == "track.step"]
    assert len(steps) == 3 and all(recs[s][3] == top for s in steps)
    for sid, r in recs.items():
        assert r[4] == top
        if r[0].startswith("fields."):
            assert recs[r[3]][0] == "track.step"


def test_traced_writes_the_trace_and_prints_the_summary(scene, pts, tmp_path, capsys):
    path = tmp_path / "spans.json"
    fus = query_fusion()
    with profiling.traced(str(path)):
        assert tracer.on
        fus.update(observation(scene))
        fus.batch_eval(pts, ("dino_feats",))
    assert not tracer.on
    printed = json.loads(capsys.readouterr().err)
    assert printed["spans"]["fields.tile"]["count"] == 4
    events = json.loads(path.read_text())["traceEvents"]
    assert sum(e["name"] == "fields.update" for e in events) == 1
    tracer.reset()
    with profiling.traced(None):
        assert not tracer.on


def test_vis_repr_trace_writes_the_spans_of_its_queries(tmp_path, capsys):
    from d3fields_tpu_torch.apps import vis_repr

    path = tmp_path / "spans.json"
    assert vis_repr.main(["--synthetic", "--step", "0.04", "--out", str(tmp_path / "out"),
                          "--trace", str(path)], device="cpu") == 0
    assert not tracer.on
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]]
    # one observation, then the grid query and the vertex query
    assert names.count("fields.update") == 1 and names.count("fields.query") == 2
    err = capsys.readouterr().err
    assert json.loads(err[err.index("{"):])["spans"]["fields.query"]["count"] == 2
    tracer.reset()

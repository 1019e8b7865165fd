"""The port's tracer (``d3fields_tpu_torch/utils/profiling.py``): spans and
counters of the query path and the tracking loop, on the CPU.

Off, a span reads no clock, makes no CUDA event and records nothing; on,
the query's spans nest as update -> features, ingest and query -> tile ->
distance, taps, kernel, bilinear, the outputs do not change, and each span
opens a ``d3f.<name>`` range in a recording ``torch.profiler`` trace.

The device timing of the spans is held here to a stand-in for CUDA (its
events, streams and capture state): two events a span on the stream it
began on, polled at span exits by ``query()`` alone (no synchronise, no
``elapsed_time``) and read by ``summary()`` after the traced work, none while a stream captures, none for a dropped
span, none kept across a reset, none in a process that has not set CUDA
up, and the chrome trace's device lane placed
on the host's clock through the anchor. On the card (marked ``cuda``,
skipped elsewhere), a span around ``torch.cuda._sleep`` reads the sleep on
the device and far less on the host. The benchmark's readers of the
spans' device counters read their mean, or nothing. This file imports no
JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_tracing.py`` runs it on the card.
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
from d3fields_tpu_torch.utils.profiling import (DEVICE_SPANS, DEVICE_US, HOST_SYNCS, SYNC_WARNING,
                                                Tracer, tracer)

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


def program_counters(summary):
    """The summary's counters less the spans' device time (which only a
    CUDA machine records)."""
    return {k: v for k, v in summary["counters"].items()
            if not k.endswith((DEVICE_US, DEVICE_SPANS))}


@pytest.mark.parametrize("fused", [True, False])
def test_off_records_nothing_and_reads_no_clock(scene, pts, monkeypatch, fused):
    state = state_from_obs(scene, dino_feats=scene["dino_feats"], mask=scene["mask"],
                           device="cpu")
    calls, events = [], []
    real = time.perf_counter_ns
    monkeypatch.setattr(time, "perf_counter_ns", lambda: calls.append(1) or real())
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: events.append(a) or FakeEvent())
    tracer.reset()
    assert not tracer.on
    out = fusion.batch_eval(state, pts, ("dino_feats", "mask"), tile=TILE, fused=fused)
    assert out["dino_feats"].shape == (N, C)
    assert calls == [] and tracer.records() == [] and tracer.summary()["spans"] == {}
    assert events == []


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
    assert program_counters(s) == {"hits": 4} and s["counters_by_span"] == {"b": {"hits": 4}}
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
    assert program_counters(s) == {"host_syncs": 3}
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
    events = {e["args"]["id"]: e for e in trace["traceEvents"] if e["cat"] == "d3f"}
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
    assert sum(e["name"] == "fields.update" for e in events if e["cat"] == "d3f") == 1
    tracer.reset()
    with profiling.traced(None):
        assert not tracer.on


def test_vis_repr_trace_writes_the_spans_of_its_queries(tmp_path, capsys):
    from d3fields_tpu_torch.apps import vis_repr

    path = tmp_path / "spans.json"
    assert vis_repr.main(["--synthetic", "--step", "0.04", "--out", str(tmp_path / "out"),
                          "--trace", str(path)], device="cpu") == 0
    assert not tracer.on
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e["cat"] == "d3f"]
    # one observation, then the grid query and the vertex query
    assert names.count("fields.update") == 1 and names.count("fields.query") == 2
    err = capsys.readouterr().err
    assert json.loads(err[err.index("{"):])["spans"]["fields.query"]["count"] == 2
    tracer.reset()


# ---------------------------------------------------------------------------
# Device timing, against a stand-in for CUDA
# ---------------------------------------------------------------------------

class FakeStream:
    def __init__(self, name: str):
        self.name, self.device = name, torch.device("cuda", 0)


class FakeEvent:
    """A timing event of :class:`FakeCuda`: ``record`` stamps the device's
    clock (ms), ``query`` says whether the device has passed the stamp."""

    cuda = None

    def __init__(self, enable_timing=False):
        self.timing, self.t, self.stream = enable_timing, None, None
        if self.cuda is not None:
            self.cuda.made.append(self)

    def record(self, stream=None):
        self.t, self.stream = self.cuda.clock, stream
        self.cuda.calls.append(("record", self, stream))

    def query(self):
        self.cuda.calls.append(("query", self))
        return self.t <= self.cuda.done

    def synchronize(self):
        self.cuda.calls.append(("event_sync", self))
        self.cuda.done = max(self.cuda.done, self.t)

    def elapsed_time(self, end):
        assert self.t is not None and end.t is not None
        self.cuda.calls.append(("elapsed_time", self, end))
        return end.t - self.t


class FakeCuda:
    """One device: a clock (ms) events stamp, the stamp it has finished
    up to, a capture flag, and a current stream for each thread."""

    def __init__(self):
        self.clock, self.done, self.capturing = 0.0, 0.0, False
        self.made, self.calls, self.streams = [], [], {}

    def current_stream(self, device=None):
        tid = threading.get_ident()
        return self.streams.setdefault(tid, FakeStream(f"stream {len(self.streams)}"))

    def synchronize(self, device=None):
        self.calls.append(("synchronize",))
        self.done = self.clock

    def records(self):
        return [(e, s) for op, *rest in self.calls if op == "record" for e, s in [rest]]


@pytest.fixture
def fake_cuda(monkeypatch):
    cuda = FakeCuda()
    monkeypatch.setattr(FakeEvent, "cuda", cuda)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", cuda.current_stream)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: cuda.capturing)
    monkeypatch.setattr(torch.cuda, "synchronize", cuda.synchronize)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    return cuda


@pytest.fixture
def timed(fake_cuda):
    """A tracer on, over the stand-in: its anchor stamped at device time 0."""
    tr = Tracer()
    tr.enable()
    try:
        yield tr, fake_cuda
    finally:
        tr.disable()


def spans_at(tr, cuda, plan, stack=None):
    """Open and close spans as ``plan`` says: ("enter", name, device ms) or
    ("exit", device ms), the device's clock set before each step; returns
    the spans left open, for a later call to close."""
    stack = [] if stack is None else stack
    for step in plan:
        cuda.clock = step[-1]
        if step[0] == "enter":
            stack.append(tr.span(step[1]))
            stack[-1].__enter__()
        else:
            stack.pop().__exit__(None, None, None)
    return stack


def test_on_each_span_records_two_events_on_its_stream(timed):
    tr, cuda = timed
    anchor = cuda.made[0]
    assert [c[0] for c in cuda.calls] == ["synchronize", "record", "synchronize"]
    spans_at(tr, cuda, [("enter", "a", 1.0), ("enter", "b", 2.0), ("exit", 5.0), ("exit", 7.0)])
    recs = cuda.records()[1:]
    assert len(recs) == 4 and len(cuda.made) == 5 and anchor not in [e for e, _ in recs]
    assert all(e.timing for e in cuda.made)
    (a0, s), (b0, _), (b1, _), (a1, _) = recs
    assert {st for _, st in recs} == {s} and s is cuda.current_stream()
    assert (a0.t, b0.t, b1.t, a1.t) == (1.0, 2.0, 5.0, 7.0)


def test_a_span_exit_queries_and_never_synchronises(timed):
    tr, cuda = timed
    calls = len(cuda.calls)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        spans_at(tr, cuda, [("enter", "a", 1.0), ("exit", 3.0), ("enter", "b", 4.0),
                            ("exit", 9.0)])
    ops = [c[0] for c in cuda.calls[calls:]]
    assert "synchronize" not in ops and "event_sync" not in ops
    assert ops.count("query") == 2 and ops.count("record") == 4
    assert len(tr._pending) == 2  # the device has passed neither end
    cuda.done = 3.0
    spans_at(tr, cuda, [("enter", "c", 10.0), ("exit", 11.0)])
    # the exit moved "a", the oldest, to the finished pairs and stopped at
    # "b"; no exit reads a time
    assert [p[1] for p in tr._pending] == ["b", "c"] and [p[1] for p in tr._done] == ["a"]
    assert "elapsed_time" not in [c[0] for c in cuda.calls[calls:]]
    assert not any(k.endswith(DEVICE_SPANS) for k in tr._counters)
    assert HOST_SYNCS not in tr._counters
    s = tr.summary()
    assert [s["counters"][f"{n}.device_spans"] for n in "abc"] == [1, 1, 1]
    assert s["counters"]["a.device_us"] == pytest.approx(2e3)
    assert not tr._pending and not tr._done


def test_summary_resolves_what_is_pending(timed):
    tr, cuda = timed
    spans_at(tr, cuda, [("enter", "a", 1.0), ("enter", "b", 2.0), ("exit", 3.0), ("exit", 6.0),
                        ("enter", "a", 10.0), ("enter", "b", 10.5), ("exit", 12.5),
                        ("exit", 13.0), ("enter", "a", 20.0), ("exit", 24.0)])
    s = tr.summary()
    assert not tr._pending
    c = s["counters"]
    assert c["a.device_spans"] == 3 and c["a.device_us"] == pytest.approx((5 + 3 + 4) * 1e3)
    assert c["b.device_spans"] == 2 and c["b.device_us"] == pytest.approx((1 + 2) * 1e3)
    assert s["spans"]["a"]["device_median_ms"] == pytest.approx(4.0)
    assert s["spans"]["a"]["device_p95_ms"] == pytest.approx(np.percentile([5, 3, 4], 95))
    assert s["spans"]["b"]["device_median_ms"] == pytest.approx(1.5)
    assert s["counters_by_span"] == {}
    assert HOST_SYNCS not in c
    # the resolved events go back to the pool: the next spans make none
    made = len(cuda.made)
    spans_at(tr, cuda, [("enter", "a", 30.0), ("exit", 31.0)])
    assert len(cuda.made) == made


def test_a_capturing_stream_gets_no_event(timed):
    tr, cuda = timed
    records = len(cuda.records())
    cuda.capturing = True
    spans_at(tr, cuda, [("enter", "captured", 1.0), ("exit", 2.0)])
    assert len(cuda.records()) == records
    # a capture that begins inside a span: its end is not recorded, nor polled
    cuda.capturing = False
    open_ = spans_at(tr, cuda, [("enter", "outer", 3.0)])
    cuda.capturing = True
    calls = len(cuda.calls)
    spans_at(tr, cuda, [("exit", 4.0)], open_)
    assert [c[0] for c in cuda.calls[calls:]] == []
    cuda.capturing = False
    s = tr.summary()
    assert s["spans"]["captured"]["count"] == s["spans"]["outer"]["count"] == 1
    assert not any(k.endswith(".device_spans") for k in s["counters"])
    assert "device_median_ms" not in s["spans"]["outer"]


def test_reset_drops_pending_pairs(timed):
    tr, cuda = timed
    open_ = spans_at(tr, cuda, [("enter", "before", 1.0), ("exit", 2.0),
                                ("enter", "open", 3.0)])
    cuda.done = 2.0
    open_ = spans_at(tr, cuda, [("enter", "finished", 2.5), ("exit", 2.6)], open_)
    assert [p[1] for p in tr._done] == ["before"] and len(tr._pending) == 1
    tr.reset()
    assert not tr._pending and not tr._done
    spans_at(tr, cuda, [("exit", 4.0), ("enter", "after", 5.0), ("exit", 6.0)], open_)
    s = tr.summary()
    assert set(s["spans"]) == {"after"}
    assert {k for k in s["counters"] if k.startswith("after.")} == {
        "after.device_us", "after.device_spans"}
    assert not any(k.startswith(("before.", "open.", "finished.")) for k in s["counters"])


def test_a_process_without_a_cuda_context_times_nothing(fake_cuda, monkeypatch):
    # CUDA present but never set up (a run on the CPU): no context is made,
    # no event recorded, no device counter kept
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: pytest.fail("current_device() sets CUDA up"))
    tr = Tracer()
    tr.enable()
    try:
        spans_at(tr, fake_cuda, [("enter", "a", 1.0), ("enter", "b", 2.0), ("exit", 3.0),
                                 ("exit", 4.0)])
    finally:
        tr.disable()
    s = tr.summary()
    assert fake_cuda.made == [] and fake_cuda.calls == []
    assert s["spans"]["a"]["count"] == s["spans"]["b"]["count"] == 1
    assert not any(k.endswith((DEVICE_US, DEVICE_SPANS)) for k in s["counters"])
    assert "device_median_ms" not in s["spans"]["a"]


def test_dropped_spans_are_not_timed(fake_cuda):
    tr = Tracer(capacity=2)
    tr.enable()
    try:
        spans_at(tr, fake_cuda, [("enter", "a", 1.0), ("exit", 2.0), ("enter", "b", 3.0),
                                 ("exit", 4.0), ("enter", "c", 5.0), ("exit", 6.0)])
    finally:
        tr.disable()
    s = tr.summary()
    assert s["dropped"] == 1 and len(fake_cuda.records()) == 1 + 4
    assert s["counters"]["a.device_spans"] == s["counters"]["b.device_spans"] == 1
    assert "c.device_spans" not in s["counters"]


def test_threads_keep_their_own_streams(timed):
    tr, cuda = timed

    def work():
        with tr.span("worker"):
            with tr.span("inner"):
                pass

    with tr.span("main"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    main = cuda.current_stream()
    by_stream = {}
    for e, st in cuda.records()[1:]:
        by_stream.setdefault(st, []).append(e)
    assert len(by_stream) == 2 and len(by_stream[main]) == 2
    (worker,) = [st for st in by_stream if st is not main]
    assert len(by_stream[worker]) == 4
    s = tr.summary()
    assert all(s["counters"][f"{n}.device_spans"] == 1 for n in ("main", "worker", "inner"))


def test_export_chrome_writes_the_device_lane_on_the_hosts_clock(fake_cuda, monkeypatch,
                                                                 tmp_path):
    # host ns read at: the anchor at enable, a and b's starts and ends, and
    # the second anchor, which finds the device's clock 1% slow
    host = iter([1000, 2000, 3000, 4000, 5000, 1_011_000])
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(host))
    tr = Tracer()
    tr.enable()
    try:
        # device ms 0 is the anchor, at host ns 1000
        spans_at(tr, fake_cuda, [("enter", "a", 0.002), ("enter", "b", 0.003),
                                 ("exit", 0.005), ("exit", 0.0065)])
    finally:
        tr.disable()
    fake_cuda.clock = 1.0  # the second anchor, at host ns 1,011,000
    path = tmp_path / "spans.json"
    tr.export_chrome(str(path))
    assert next(host, None) is None
    events = json.loads(path.read_text())["traceEvents"]
    host_ev = {e["name"]: e for e in events if e["cat"] == "d3f"}
    dev_ev = {e["name"]: e for e in events if e["cat"] == "d3f.device"}
    assert set(host_ev) == set(dev_ev) == {"a", "b"}
    tid = threading.get_ident()
    assert host_ev["a"]["tid"] == tid and dev_ev["a"]["tid"] == f"device {tid}"
    # host: a 2000-5000 ns, b 3000-4000; device, 1.01 host ns a device ns:
    # a 1000 + 2000 * 1.01 = 3020 for 4500 * 1.01, b 4030 for 2000 * 1.01
    t0 = 2000
    assert (host_ev["a"]["ts"], host_ev["a"]["dur"]) == ((2000 - t0) / 1e3, 3.0)
    assert (host_ev["b"]["ts"], host_ev["b"]["dur"]) == ((3000 - t0) / 1e3, 1.0)
    assert dev_ev["a"]["ts"] == pytest.approx((3020 - t0) / 1e3)
    assert dev_ev["a"]["dur"] == pytest.approx(4.545)
    assert dev_ev["b"]["ts"] == pytest.approx((4030 - t0) / 1e3)
    assert dev_ev["b"]["dur"] == pytest.approx(2.02)
    assert dev_ev["b"]["args"] == host_ev["b"]["args"]
    # the device times themselves stay on the device's clock
    assert tr.summary()["spans"]["a"]["device_median_ms"] == pytest.approx(0.0045)


@pytest.mark.parametrize("metric, span", [
    ("gdino_device_ms.segment", "seg.detect"),
    ("gdino_text_device_ms.segment", "seg.detect.text"),
    ("gdino_backbone_device_ms.segment", "seg.detect.backbone"),
    ("gdino_encoder_device_ms.segment", "seg.detect.encoder"),
    ("gdino_decoder_device_ms.segment", "seg.detect.decoder"),
    ("gdino_post_device_ms.segment", "seg.detect.post"),
    ("sam_encode_device_ms.segment", "seg.sam.encode"),
    ("sam_decode_device_ms.segment", "seg.sam.decode"),
    ("xmem_key_device_ms.video", "xmem.key"),
    ("xmem_read_device_ms.video", "xmem.read"),
    ("xmem_decode_device_ms.video", "xmem.decode"),
    ("xmem_memorize_device_ms.video", "xmem.memorize"),
    ("dinov2_device_ms.query", "fields.update.features"),
    ("batch_eval_device_ms.query", "fields.query"),
])
def test_the_device_time_readers_read_the_mean_or_nothing(metric, span):
    from port_bench import harness

    read = harness.reader(metric)
    counters = {span + ".device_us": 12_345.0, span + ".device_spans": 5, "seg_boxes": 3}
    assert read({"program_counters": counters}) == pytest.approx(12_345.0 / 5 / 1e3)
    for rec in ({}, {"program_counters": {}}, {"program_counters": {"seg_boxes": 3}},
                {"program_counters": {span + ".device_us": 0.0, span + ".device_spans": 0}},
                {"program_counters": {"other.device_us": 1.0, "other.device_spans": 1}}):
        assert read(rec) is None


@pytest.mark.cuda
def test_a_span_reads_a_device_sleep_the_host_does_not_wait_for():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the spans' device time comes from CUDA events")
    # calibrate the sleep's cycles to ms
    cycles = 10_000_000
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    per_ms = cycles / start.elapsed_time(end)
    n = int(50 * per_ms)  # a 50 ms sleep
    tr = Tracer()
    tr.enable()
    try:
        for _ in range(3):
            with tr.span("sleep"):
                torch.cuda._sleep(n)
    finally:
        tr.disable()
    s = tr.summary()
    sleep = s["spans"]["sleep"]
    assert sleep["device_median_ms"] == pytest.approx(50.0, rel=0.1)
    assert sleep["median_ms"] < 5.0
    assert s["counters"]["sleep.device_spans"] == 3
    assert s["counters"].get(HOST_SYNCS, 0) == 0

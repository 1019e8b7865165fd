"""The program's spans in a profile (``program_trace.read``), the per-layer
numbers read from them, and ``program_run``'s wrapping of the harness."""

import json
import time

import pytest

from port_bench import harness, program_run, program_trace

from conftest import tiny_spec


def x(name, ts, dur, cat="cpu_op", **kw):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, **kw}


def launch(ts, corr):
    return x("cudaLaunchKernel", ts, 1, "cuda_runtime", args={"correlation": corr})


def kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


# a window of 100 us: one query of two tiles, the first with a distance and a
# kernel span; device busy 20-30, 40-45, 70-80 and 97-99
EVENTS = [
    x("pb.window", 0, 100, "user_annotation"),
    x("pb.batch_eval", 4, 92, "user_annotation"),
    x("d3f.fields.query", 5, 90),
    x("d3f.fields.tile", 10, 40), x("d3f.fields.distance", 12, 8), x("d3f.fields.kernel", 30, 10),
    x("d3f.fields.tile", 55, 35),
    x("aten::add", 13, 2),
    launch(14, 1), launch(32, 2), launch(60, 3), launch(97, 4),
    kernel("k1", 20, 10, 1), kernel("fused", 40, 5, 2), kernel("k3", 70, 10, 3),
    kernel("k4", 97, 2, 4),
]


@pytest.fixture
def trace_path(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return str(path)


def test_read_puts_ops_and_idle_time_down_to_the_innermost_span(trace_path):
    tr = program_trace.read(trace_path)
    us = pytest.approx
    assert tr["busy_s"] == us(27e-6) and tr["idle_s"] == us(73e-6)
    assert tr["outside_idle_s"] == us(8e-6)   # 0-5, 95-97, 99-100
    s = tr["spans"]
    assert {k: s[k]["idle_s"] for k in s} == {
        "fields.query": us(15e-6), "fields.tile": us(32e-6),
        "fields.distance": us(8e-6), "fields.kernel": us(10e-6)}
    assert s["fields.tile"]["idle_incl_s"] == us(50e-6)
    assert s["fields.query"]["idle_incl_s"] == us(65e-6)
    assert (s["fields.distance"]["ops"], s["fields.kernel"]["ops"], s["fields.tile"]["ops"],
            s["fields.query"]["ops"]) == (1, 1, 1, 0)
    assert s["fields.kernel"]["busy_s"] == us(5e-6)
    assert sum(r["idle_s"] for r in s.values()) + tr["outside_idle_s"] == us(tr["idle_s"])


def test_read_trace_keeps_its_keys_and_readings_beside_program_ranges(trace_path, tmp_path):
    rec = harness.read_trace(trace_path)
    assert set(rec) == {"busy_s", "trace_window_s", "ops", "device_ops", "idle_gaps"}
    assert rec["busy_s"] == pytest.approx(27e-6)
    assert [o[2] for o in rec["ops"]] == ["batch_eval"] * 3 + [None]
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps({"traceEvents": [e for e in EVENTS
                                                if not e["name"].startswith("d3f.")]}))
    rec_bare = harness.read_trace(str(bare))
    assert rec_bare["ops"] == rec["ops"] and rec_bare["busy_s"] == rec["busy_s"]


def summary(tiles_ms, counters, requests=2):
    """A tracer summary of ``requests`` requests whose tiles took
    ``tiles_ms`` = [(distance, taps, bilinear), ...]."""
    def kid(xs):
        xs = sorted(xs)
        return {"total_ms": sum(xs), "median_ms": xs[len(xs) // 2]}

    return {"spans": {
        "fields.update": {"count": requests},
        "fields.update.ingest": {"count": requests, "median_ms": 2.5},
        "fields.tile": {"count": len(tiles_ms), "children": {
            "fields.distance": kid([t[0] for t in tiles_ms]),
            "fields.taps": kid([t[1] for t in tiles_ms]),
            "fields.bilinear": kid([t[2] for t in tiles_ms])}}},
        "counters": counters, "counters_by_span": {}, "dropped": 0}


def test_the_metrics_read_the_summary_and_the_trace(trace_path):
    rec = {"program": summary([(1.0, 4.0, 5.0), (2.0, 3.0, 6.0), (1.5, 3.5, 4.0)],
                              {"host_syncs": 14, "device_allocs": 0, "alloc_retries": 0}),
           "program_trace": program_trace.read(trace_path)}
    read = {name: fn(rec) for name, (fn, _) in program_trace.METRICS.items()}
    assert read == {"ingest_ms.query": 2.5, "host_syncs.query": 7.0, "device_allocs.query": 0.0,
                    "tile_distance_ms.query": 1.5, "tile_taps_ms.query": 3.5,
                    "tile_bilinear_ms.query": 5.0,
                    "tile_idle_share.query": pytest.approx(100 * 50 / 73)}
    # no program summary or trace (a harness that does not trace the program)
    assert all(fn({"program": None, "program_trace": None}) is None
               for fn, _ in program_trace.METRICS.values())
    # a window without syncs reads 0; one never read by the allocator, nothing
    bare = {"program": summary([(1.0, 1.0, 1.0)], {}), "program_trace": None}
    assert program_trace.METRICS["host_syncs.query"][0](bare) == 0
    assert program_trace.METRICS["device_allocs.query"][0](bare) is None


def test_a_tiny_run_reports_the_programs_numbers():
    with program_run.wrapped(True) as got:
        res = harness.run_cell(tiny_spec("vitl14-f32.query-1m"), 2 ** 31 + 11, 0.5, True, "cpu",
                               time.perf_counter())
    res = program_run.add_program(res, got)
    assert harness.window.__name__ == "window" and harness.read_trace.__name__ == "read_trace"
    for name in ("ingest_ms.query", "host_syncs.query", "tile_distance_ms.query",
                 "tile_taps_ms.query", "tile_bilinear_ms.query", "tile_idle_share.query"):
        assert name in res["program"], name
    by_span = res["breakdown"]["by_span"]
    assert by_span["fields.tile"]["count"] == got["program"]["spans"]["fields.tile"]["count"]
    assert {"fields.update", "fields.query", "fields.kernel", "outside"} <= set(by_span)
    idle = sum(r["idle_s"] for r in by_span.values())
    assert idle == pytest.approx(got["program_trace"]["idle_s"])
    assert "dinov2_ms.query" in res["metrics"]

"""The harness finds every cell's files by name, samples uniformly, reads a
profiler trace, and its readers compute what their docstrings say."""

import collections
import json
import os

import pytest

from port_bench import costs, harness

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    spec = harness.Spec(cell)
    assert spec.config["name"] == spec.cell["config"]
    assert harness.driver(spec).__name__ == "Cell"
    assert spec.end_to_end and spec.per_layer
    assert "setup_s" in [m["name"] for m in spec.end_to_end]
    for m in spec.end_to_end + spec.per_layer:
        assert callable(harness.reader(m["name"]))
    assert "samples" in spec.limits


def test_a_cell_not_in_the_benchmark_is_refused():
    with pytest.raises(KeyError):
        harness.Spec("vitl14-f32.no-such-traffic")


def test_every_metric_has_a_reader_and_every_file_is_named():
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(harness.HERE, "metrics"))
             if f.endswith(".py") and not f.startswith("_")}
    assert names == files
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        assert json.load(open(os.path.join(harness.ROOT, c["file"])))["reduced"] == c["reduced"]


def test_reservoir_keeps_a_uniform_sample():
    hits = collections.Counter()
    for seed in range(3000):
        r = harness.Reservoir(3, seed)
        kept = {}
        for i in range(12):
            slot = r.offer()
            if slot is not None:
                kept[slot] = i
        assert len(kept) == 3
        hits.update(kept.values())
    share = [hits[i] / 3000 for i in range(12)]
    assert max(share) - min(share) < 0.06 and abs(sum(share) - 3) < 1e-9


def test_read_trace_unions_busy_time_and_names_gaps(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "pb.window", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb.batch_eval", "ts": 10, "dur": 60,
         "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::index", "ts": 12, "dur": 5, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 13, "dur": 1,
         "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 80, "dur": 1,
         "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 20, "dur": 30, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 40, "dur": 20, "args": {"correlation": 8}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    rec = harness.read_trace(str(path))
    assert rec["busy_s"] == pytest.approx(40e-6)
    assert [o[2] for o in rec["ops"]] == ["batch_eval", None]
    assert rec["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    gaps = dict(rec["idle_gaps"])
    assert gaps["pb.batch_eval"] == pytest.approx(20e-6)   # 0-10 outside, 10-20 inside
    assert sum(gaps.values()) == pytest.approx(60e-6)


def test_readers_compute_their_metrics():
    rec = {"setup_s": 12.5, "window_s": 2.0, "steps": 8, "work": 8 * 2 ** 20,
           "latencies_s": [0.2] * 9 + [0.4], "flops_per_step": 2e12, "peak_flops": 67e12,
           "spans": {"dinov2": [0.06, 0.07, 0.08], "batch_eval": [0.1, 0.1]},
           "kernel_tile": {"views": 4, "rows": 768, "channels": 1024, "points": 131072,
                           "itemsize": 4},
           "profile": {"busy_s": 0.25, "window_s": 1.0, "steps": 2,
                       "ops": [("fused_interp_slice_kernel<float>", 0.5e-3, "batch_eval")] * 16
                       + [("gemm", 1e-3, "dinov2")]}}
    read = {m: harness.reader(m)(rec) for m in (
        "setup_s", "query_pts_per_s", "request_ms_p95", "dinov2_ms.query", "batch_eval_ops",
        "idle_share.query", "mfu.query", "fused_interp_roofline")}
    assert read["setup_s"] == 12.5
    assert read["query_pts_per_s"] == 4 * 2 ** 20
    assert 200 < read["request_ms_p95"] < 400
    assert read["dinov2_ms.query"] == pytest.approx(70.0)
    assert read["batch_eval_ops"] == 8
    # busy 0.125 s a profiled request of a 0.25 s mean request in the window
    assert read["idle_share.query"] == pytest.approx(50.0)
    assert read["mfu.query"] == pytest.approx(100 * 2e12 * 4 / 67e12)
    bound = costs.fused_interp_bound_s(4, 768, 1024, 131072, 4)
    assert read["fused_interp_roofline"] == pytest.approx(100 * bound / 0.5e-3)
    # nothing to read: the metric is left out, never 0
    assert harness.reader("fused_interp_roofline")({"kernel_tile": rec["kernel_tile"]}) is None
    assert harness.reader("batch_eval_ops")({"profile": None}) is None
    assert harness.reader("idle_share.query")({"steps": 8, "window_s": 2.0}) is None


def test_memory_peak_leaves_out_the_answers_held_for_the_check(monkeypatch):
    """Each step's peak counts the program's work; the sampled answers that
    the cell holds for the check while the step runs are taken off."""
    import torch

    alloc = {"now": 100, "peak": 100}

    def allocate(n):
        alloc["now"] += n
        alloc["peak"] = max(alloc["peak"], alloc["now"])

    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda: alloc.update(peak=alloc["now"]))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: alloc["peak"])

    class Cell:
        held = 0

        def held_bytes(self):
            return self.held

        def step(self, slot):
            allocate(50)      # the step's work, freed at its end but its answer
            allocate(-40)
            if slot is not None:
                self.held += 10
            else:
                allocate(-10)
            return 1.0

    mem = harness.MemoryPeak(True)
    mem.mark()
    assert mem.peak == 100
    cell = Cell()
    rec = harness.window(cell, 0.0, harness.Reservoir(3, 1), mem)
    rec2 = harness.window(cell, 0.0, harness.Reservoir(0, 1), mem)
    assert rec["steps"] == rec2["steps"] == 1 and cell.held == 10
    assert mem.peak == 150    # 100 before, 50 for the step; the held 10 taken off

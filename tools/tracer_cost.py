"""What ``d3fields_tpu_torch.utils.profiling.tracer`` costs on a CUDA card's
host, and how well its device intervals sit on the host's clock. Prints
one JSON object (ns per call; median and quartiles of a request in ms):

- a span off, on (with its two CUDA events and their poll) and on with the
  device timing left out; a read of the caching allocator; a caught
  synchronisation warning;
- a query request (``Fusion.update`` of a 4-view 240x320 observation with
  its 24x32x1024 descriptors, then 1,048,576 points through the fused
  query in 8 tiles, f32 and bf16), a segmentation request and a video
  frame of the benchmark's cells ``gdino-swint-samh-bf16.segment-4v`` and
  ``xmem-r50-bf16.davis480p`` (``port_bench``'s drivers, set up as a run
  sets them up), each with the tracer on and off, interleaved two and two;
  with the tracer on, the host synchronisations and the spans a request;
- the anchor: for each timed span of 3 segmentation requests under
  ``torch.profiler`` (after a profile that sets the profiler up), its
  device interval's start against the first kernel launched inside its
  ``d3f.<name>`` range, each range placing the span's host clock on the
  profiler's; once right after the tracer's ``enable`` and again after
  51 s of requests (the tracer's placement, which takes the drift out
  with a second anchor). Beside it, without the profiler: a second anchor
  made after the 51 s against where the first alone places it (the drift
  the placement takes out), and the spread of back-to-back anchors;
- one segmentation request written by ``export_chrome``: each span's
  host interval and device interval, in ms from the request's start.

    python tools/tracer_cost.py
"""

import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from d3fields_tpu_torch.config import D3FieldsConfig, FusionConfig  # noqa: E402
from d3fields_tpu_torch.fields.fusion import Fusion, batch_eval  # noqa: E402
from d3fields_tpu_torch.utils import profiling  # noqa: E402
from d3fields_tpu_torch.utils.profiling import DEVICE_SPANS, HOST_SYNCS, tracer  # noqa: E402

SEED = 2 ** 31 + 77
DRIFT_S = 51.0  # the benchmark's run_seconds


def per_call_ns(fn, n: int) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t0) / n


def best_ns(fn, n: int, on: bool, device_timing: bool = True) -> float:
    """The least of three timings of ``n`` calls, the tracer on (inside a
    span) or off; on without ``device_timing``, its spans record no event."""
    if not on:
        return min(per_call_ns(fn, n) for _ in range(3))
    tracer.enable()
    timed, tracer._timed = tracer._timed, device_timing
    try:
        with tracer.span("outer"):
            return min(per_call_ns(fn, n) for _ in range(3))
    finally:
        tracer._timed = timed
        tracer.disable()
        tracer.reset()


def span():
    with tracer.span("x"):
        pass


def quartiles(v) -> dict:
    return {"median_ms": statistics.median(v), "q": statistics.quantiles(v, n=4)}


def interleaved(request, n: int) -> dict:
    """``request()`` ``n`` times, the tracer on for the second and third of
    every four (enabled, with its anchor's synchronises, outside the timed
    part); each way's request times, and with the tracer on the host
    synchronisations, spans and device-timed spans a request."""
    times = {"off": [], "on": []}
    tracer.reset()
    for i in range(n):
        mode = "on" if i % 4 in (1, 2) else "off"
        if mode == "on":
            tracer.enable()
        t0 = time.perf_counter()
        request()
        times[mode].append((time.perf_counter() - t0) * 1e3)
        tracer.disable()
    s = tracer.summary()
    on = len(times["on"])
    out = {m: quartiles(v) for m, v in times.items()}
    out["host_syncs_per_request"] = s["counters"].get(HOST_SYNCS, 0) / on
    out["spans_per_request"] = len(tracer.records()) / on
    out["device_spans_per_request"] = sum(
        v for k, v in s["counters"].items() if k.endswith(DEVICE_SPANS)) / on
    out["device_median_ms"] = {k: v["device_median_ms"] for k, v in s["spans"].items()
                               if "device_median_ms" in v}
    out["host_median_ms"] = {k: v["median_ms"] for k, v in s["spans"].items()}
    tracer.reset()
    return out


def query_requests(dtype: str) -> dict:
    obs, pts = query_scene()
    fus = Fusion(config=D3FieldsConfig(fusion=FusionConfig(query_tile=131072)), device="cuda")

    def request():
        fus.update(obs)
        batch_eval(fus.state, pts, ("dino_feats", "mask"), tile=131072, fused=True,
                   matmul_dtype=dtype)
        torch.cuda.synchronize()

    for _ in range(3):
        request()
    return interleaved(request, 40)


def query_scene():
    from d3fields_tpu_torch.utils.synthetic import render_sphere_scene

    sc = render_sphere_scene(num_views=4, H=240, W=320, feat_dim=8)
    obs = {k: sc[k] for k in ("color", "depth", "pose", "K")}
    obs["mask"] = np.random.RandomState(0).rand(4, 240, 320, 3).astype(np.float32)
    obs["dino_feats"] = torch.rand((4, 24, 32, 1024),
                                   generator=torch.Generator().manual_seed(0)).numpy()
    pts = np.random.RandomState(1).uniform([-0.3, -0.4, 0.001], [0.6, 0.4, 0.4],
                                           (1 << 20, 3)).astype(np.float32)
    return obs, pts


def bench_cell(workload: str):
    """The program of a benchmark cell, set up as ``port_bench/run.py`` sets
    it up (weights from the seed, shapes warmed up), untraced."""
    from port_bench import harness

    spec = harness.Spec(workload)
    ctx = harness.Context(spec, SEED, torch.device("cuda"), harness.Probe(torch.cuda.synchronize))
    cell = harness.driver(spec)(ctx)
    cell.setup()
    torch.cuda.synchronize()
    return cell


def anchor_offsets(cell, requests: int) -> dict:
    """For each device-timed span of ``requests`` requests under the
    profiler: its device start (the tracer's, on the host's clock) less the
    start of the first kernel launched inside its ``d3f.<name>`` range, in
    microseconds on the profiler's clock; the range's start and the span's
    host start give the offset between the two host clocks. Negative: the
    event lies before the kernel, as it does on the stream. ``backlogged``:
    the spans whose device start lags their host start by over 100 us, so
    that the first kernel follows the start event at once on the stream."""
    from torch.profiler import ProfilerActivity, profile

    from port_bench.harness import DEVICE_CATS, RUNTIME_CATS

    n0 = len(tracer.records())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(requests):
            cell.step(None)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    recs = tracer.records()
    device = tracer.device_times()
    spans = sorted((r[1], sid) for sid, r in enumerate(recs) if sid >= n0)
    # a parent's range opens before its child's: on a tie, the longer first
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][4:]) for e in events
                     if e.get("cat") in ("cpu_op", "user_annotation")
                     and e["name"].startswith("d3f.")),
                    key=lambda r: (r[0], -r[1]))
    matched = [(r, s) for r, s in zip(ranges, spans) if r[2] == recs[s[1]][0]]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}
    kernel = {}
    for e in events:
        c = e.get("args", {}).get("correlation")
        if e.get("cat") in DEVICE_CATS and c is not None:
            kernel[c] = min(kernel.get(c, e["ts"]), e["ts"])
    launches = sorted((ts, c) for c, ts in launch.items() if c in kernel)
    launch_ts = np.asarray([ts for ts, _ in launches])
    diffs, backlogged = [], []
    for (r0, r1, _), (t0, sid) in matched:
        if sid not in device or device[sid][1] is None:
            continue
        lo, hi = np.searchsorted(launch_ts, r0), np.searchsorted(launch_ts, r1, side="right")
        if lo == hi:
            continue
        first = min(kernel[c] for _, c in launches[lo:hi])
        d0 = device[sid][1][0]
        diff = (d0 - t0) / 1e3 + r0 - first
        diffs.append(diff)
        if (d0 - t0) / 1e3 > 100:
            backlogged.append(diff)

    def stats(v):
        return {"n": len(v), "median_us": statistics.median(v) if v else None,
                "q_us": statistics.quantiles(v, n=4) if len(v) > 1 else None,
                "min_us": min(v, default=None), "max_us": max(v, default=None)}

    return {"spans": len(spans), "ranges": len(ranges), "matched": len(matched),
            "all": stats(diffs), "backlogged": stats(backlogged)}


def anchor_now():
    """An anchor as the tracer makes one: an event between two synchronises
    and the host clock read right after."""
    torch.cuda.synchronize()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    torch.cuda.synchronize()
    return ev, time.perf_counter_ns()


def placed_error_us(old, new) -> float:
    """Where the anchor ``old`` places the event of ``new`` on the host's
    clock, less where ``new`` read it (us)."""
    return (old[1] + old[0].elapsed_time(new[0]) * 1e6 - new[1]) / 1e3


def anchor_drift(cell) -> dict:
    """:func:`anchor_offsets` right after ``enable`` and after ``DRIFT_S``
    seconds of requests with the tracer on."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        cell.step(None)
    pairs = [anchor_now()]
    for _ in range(20):
        pairs.append(anchor_now())
    jitter = [placed_error_us(a, b) for a, b in zip(pairs, pairs[1:])]
    tracer.reset()
    tracer.enable()
    try:
        (anchor,) = tracer._anchors.values()
        first = anchor_offsets(cell, 3)
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < DRIFT_S:
            cell.step(None)
            n += 1
        elapsed = time.perf_counter() - t0
        last = anchor_offsets(cell, 3)
        direct = placed_error_us(anchor, anchor_now())
    finally:
        tracer.disable()
        tracer.reset()
    drift = {k: (last[k]["median_us"] - first[k]["median_us"]
                 if last[k]["median_us"] is not None and first[k]["median_us"] is not None
                 else None) for k in ("all", "backlogged")}
    return {"at_enable": first, "after": last, "seconds_between": elapsed,
            "requests_between": n, "drift_of_median_us": drift,
            "reanchor_after_us": direct, "back_to_back_anchor_us": {
                "median": statistics.median(jitter), "min": min(jitter), "max": max(jitter)}}


def chrome_lanes(cell) -> dict:
    """One request with the tracer on, as ``export_chrome`` writes it: for
    each span its host and its device interval ([start, duration] in ms
    from the first host event)."""
    tracer.reset()
    tracer.enable()
    try:
        cell.step(None)
    finally:
        tracer.disable()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spans.json")
        tracer.export_chrome(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    tracer.reset()
    t0 = min(e["ts"] for e in events if e["cat"] == "d3f")
    return {lane: {e["name"]: [(e["ts"] - t0) / 1e3, e["dur"] / 1e3]
                   for e in events if e["cat"] == cat}
            for lane, cat in (("host", "d3f"), ("device", "d3f.device"))}


def main() -> None:
    y = torch.ones(16, device="cuda")
    torch.cuda.synchronize()
    out = {"card": torch.cuda.get_device_name(0),
           "span_off_ns": best_ns(span, 200000, False),
           "span_on_ns": best_ns(span, 100000, True),
           "span_on_host_only_ns": best_ns(span, 100000, True, device_timing=False),
           "allocator_read_ns": best_ns(profiling._allocator_counts, 2000, False),
           "cpu_copy_off_ns": best_ns(y.cpu, 5000, False),
           "cpu_copy_on_ns": best_ns(y.cpu, 5000, True),
           "request": {dtype: query_requests(dtype) for dtype in ("float32", "bfloat16")}}
    print(json.dumps(out), flush=True)
    seg = bench_cell("gdino-swint-samh-bf16.segment-4v")
    out["segment"] = interleaved(lambda: seg.step(None), 40)
    print(json.dumps({"segment": out["segment"]}), flush=True)
    out["anchor"] = anchor_drift(seg)
    out["segment_chrome_ms"] = chrome_lanes(seg)
    seg.release()
    del seg
    video = bench_cell("xmem-r50-bf16.davis480p")
    out["video"] = interleaved(lambda: video.step(None), 160)
    video.release()
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

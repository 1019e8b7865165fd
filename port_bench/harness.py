"""The benchmark's machinery: find a cell by name, set it up, run its closed
loop for the window, trace it, check it, and print the result line.

Everything that belongs to one configuration, traffic mix or metric lives in
files of its own, found by the names in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<traffic>.json`` (which names its driver
module, ``drivers/<driver>.py``), ``limits/<cell>.json`` and
``metrics/<metric>.py``. A driver's ``Cell`` holds the program under test
and its inputs (``setup``, ``step``, ``held_bytes``, ``record``, ``release``,
``check``); this module owns the clocks, the window, the profile and the
result.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import importlib
import importlib.util
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "d3fields_tpu")
# device events of a torch.profiler chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def clock() -> float:
    return time.perf_counter()


# ---------------------------------------------------------------------------
# The cell, found by name
# ---------------------------------------------------------------------------

def load_json(path: str):
    with open(path) as f:
        return json.load(f)


class Spec:
    """One cell of ``BENCHMARK.json`` with its configuration, traffic and
    limits, and the names of the metrics it reports."""

    def __init__(self, workload: str, bench_path: Optional[str] = None):
        bench = load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(os.path.join(ROOT, configs[self.cell["config"]]["file"]))
        self.traffic = load_json(os.path.join(HERE, "traffic", self.cell["traffic"] + ".json"))
        self.limits = load_json(os.path.join(HERE, "limits", workload + ".json"))

        def mine(metrics):
            return [m for m in metrics if workload in m.get("workloads", [workload])]

        self.end_to_end = mine(bench["end_to_end"])
        self.per_layer = mine(bench["per_layer"])
        self.chips = int(self.cell["chips"])


def driver(spec: Spec):
    """The ``Cell`` class of the traffic's driver module."""
    return importlib.import_module(f"port_bench.drivers.{spec.traffic['driver']}").Cell


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """``metrics/<metric>.py``'s ``read(record)``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    mod_spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# Spans and samples
# ---------------------------------------------------------------------------

class Probe:
    """Host-clock spans around the program's layers, between synchronises
    (``spans`` set: the traced run's first part), and profiler ranges named
    ``pb.<layer>`` (``annotate``: its second part). Off, it costs nothing."""

    def __init__(self, sync: Callable[[], None]):
        self.sync = sync
        self.spans: Optional[Dict[str, List[float]]] = None
        self.annotate = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.spans is None and not self.annotate:
            yield
            return
        rf = None
        if self.annotate:
            import torch

            rf = torch.profiler.record_function("pb." + name)
            rf.__enter__()
        if self.spans is not None:
            self.sync()
            t0 = clock()
        try:
            yield
        finally:
            if self.spans is not None:
                self.sync()
                self.spans.setdefault(name, []).append(clock() - t0)
            if rf is not None:
                rf.__exit__(None, None, None)


class Reservoir:
    """A uniform sample of ``k`` of the window's steps, drawn from the seed
    as the steps come (the window's length is not known before it ends)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed % (1 << 64) * 7919 + 17)
        self.seen = 0

    def offer(self) -> Optional[int]:
        """The slot the current step's answer takes, or None to let it go."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

class Context:
    """What a driver's ``Cell`` is given."""

    def __init__(self, spec: Spec, seed: int, device, probe: Probe):
        self.spec, self.seed, self.device, self.probe = spec, seed, device, probe
        self.config, self.traffic, self.limits = spec.config, spec.traffic, spec.limits


class MemoryPeak:
    """The peak of the card's allocated bytes over the program's own work:
    each step's peak, less the sampled answers the cell holds for the
    check while the step runs (``cell.held_bytes()``), which a deployment
    would not hold. Off the card it reads 0."""

    def __init__(self, cuda: bool):
        self.cuda, self.peak = cuda, 0

    def mark(self) -> None:
        """Fold in the peak since the last mark (or since the process began)."""
        if self.cuda:
            import torch

            self.peak = max(self.peak, torch.cuda.max_memory_allocated())

    @contextlib.contextmanager
    def step(self, cell):
        if not self.cuda:
            yield
            return
        import torch

        held = cell.held_bytes()
        torch.cuda.reset_peak_memory_stats()
        try:
            yield
        finally:
            self.peak = max(self.peak, torch.cuda.max_memory_allocated() - held)


def window(cell, seconds: float, reservoir: Reservoir,
           memory: Optional[MemoryPeak] = None) -> dict:
    """The closed loop: steps back to back until ``seconds`` have passed; the
    window ends with the step that crosses it. Each step's time runs from
    its input handed in to its answer complete (the step ends in a
    synchronise or a copy to the host). The interpreter's garbage
    collections inside the window are timed too."""
    memory = memory or MemoryPeak(False)
    lat, work, collections_s = [], 0.0, []
    started = {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = clock()
        elif "t" in started:
            collections_s.append((info["generation"], clock() - started.pop("t")))

    gc.callbacks.append(on_gc)
    t0 = clock()
    try:
        while True:
            slot = reservoir.offer()
            with memory.step(cell):
                ts = clock()
                work += cell.step(slot)
                te = clock()
            lat.append(te - ts)
            if te - t0 >= seconds:
                break
    finally:
        gc.callbacks.remove(on_gc)
    return {"window_s": te - t0, "steps": len(lat), "latencies_s": lat, "work": work,
            "gc_s": collections_s}


def _host_segments(cpu: list):
    """Times at which the innermost traced host operation changes, and its
    name from then on (None: nothing traced), from nested (ts, end, name)
    events of one thread sorted by start."""
    starts, names, stack = [], [], []
    for ts, end, name in cpu:
        while stack and stack[-1][1] <= ts:
            done = stack.pop()
            starts.append(done[1])
            names.append(stack[-1][2] if stack else None)
        starts.append(ts)
        names.append(name)
        stack.append((ts, end, name))
    while stack:
        done = stack.pop()
        starts.append(done[1])
        names.append(stack[-1][2] if stack else None)
    order = np.argsort(np.asarray(starts), kind="stable")
    return np.asarray(starts)[order], [names[i] for i in order]


def read_trace(path: str) -> dict:
    """Device busy time, idle gaps by what the host was doing, device ops by
    name and by the ``pb.<layer>`` range that launched them, from a
    torch.profiler chrome trace of one ``pb.window`` range."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    win = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "pb.window"]
    if not win:
        raise RuntimeError("the trace holds no pb.window range")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    main_tid = win[0]["tid"]
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"][3:]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"].startswith("pb.")
                    and e["name"] != "pb.window")
    r_start = np.asarray([r[0] for r in ranges])
    # the union of device intervals inside the window, and the gaps between
    busy, gaps, cur_end = 0.0, [], w0
    ops = []
    for e in dev:
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        c = e.get("args", {}).get("correlation")
        span = None
        if c in launch_ts and len(ranges):
            k = int(np.searchsorted(r_start, launch_ts[c], side="right")) - 1
            if k >= 0 and ranges[k][1] >= launch_ts[c]:
                span = ranges[k][2]
        ops.append((e["name"], e["dur"] * 1e-6, span))
        if t <= s:
            continue
        if s > cur_end:
            gaps.append((cur_end, s))
        if t > cur_end:
            busy += t - max(s, cur_end)
            cur_end = t
    if w1 > cur_end:
        gaps.append((cur_end, w1))
    cpu = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") in ("cpu_op", "user_annotation", "python_function")
                 and e.get("tid") == main_tid and e["name"] != "pb.window")
    seg_t, seg_name = _host_segments(cpu)
    idle = collections.Counter()
    for a, b in gaps:
        k = int(np.searchsorted(seg_t, (a + b) / 2, side="right")) - 1
        name = seg_name[k] if k >= 0 else None
        idle[(name or "host outside traced ops")[:80]] += (b - a) * 1e-6
    by_name = collections.Counter()
    for name, dur, _ in ops:
        by_name[name[:80]] += dur
    return {"busy_s": busy * 1e-6, "trace_window_s": (w1 - w0) * 1e-6, "ops": ops,
            "device_ops": [[k, v] for k, v in by_name.most_common(10)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(10)]}


def profile(cell, steps: int, memory: Optional[MemoryPeak] = None) -> dict:
    """``steps`` further steps under torch.profiler (host and device), after
    the window; read from its chrome trace, written to and removed from a
    temporary directory."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    memory = memory or MemoryPeak(False)
    cell.probe.annotate = True
    tmp = tempfile.mkdtemp(prefix="port_bench_trace_")
    try:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("pb.window"):
                t0 = clock()
                for _ in range(steps):
                    with memory.step(cell):
                        cell.step(None)
                window_s = clock() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        rec = read_trace(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        cell.probe.annotate = False
    rec["window_s"] = window_s
    rec["steps"] = steps
    return rec


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Optional[dict]:
    """One run of a cell: set-up, the window, (the traced part), the check.
    Returns the result, or None (after saying why on stderr) when a module
    of JAX, Flax or the JAX package was loaded by the time the result is
    due."""
    import torch

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    probe = Probe(sync)
    ctx = Context(spec, seed, torch.device(device), probe)
    cell = driver(spec)(ctx)
    memory = MemoryPeak(cuda)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cell.setup()
    sync()
    memory.mark()
    rec = {"setup_s": clock() - t_start, "trace": trace}
    if trace:
        probe.spans = {}
    rec.update(window(cell, seconds, Reservoir(int(spec.traffic["samples"]), seed), memory))
    lat = np.asarray(rec["latencies_s"])
    phases = {"setup_s": rec["setup_s"], **getattr(cell, "setup_laps", {}),
              "window_s": rec["window_s"],
              "step_s": [float(np.percentile(lat, q)) for q in (0, 5, 50, 95, 100)],
              "gc_s": [sum(d for g, d in rec["gc_s"] if g == k) for k in range(3)],
              "gc_full": sum(g == 2 for g, _ in rec["gc_s"])}
    if trace:
        rec["spans"], probe.spans = probe.spans, None
        t0 = clock()
        rec["profile"] = profile(cell, int(spec.traffic["profile_steps"]), memory)
        phases["profile_s"] = clock() - t0
    rec.update(cell.record())
    phases["held_bytes"] = cell.held_bytes()
    cell.release()
    t0 = clock()
    checks = cell.check()
    phases["check_s"] = clock() - t0
    print("phases " + json.dumps(phases), file=sys.stderr)
    print("readings " + json.dumps(cell.last_readings), file=sys.stderr)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    bad = forbidden_loaded()
    if bad:
        print(f"port_bench: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return None
    device_row = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": spec.chips, "memory_peak_bytes": int(memory.peak)}
    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": rec["steps"],
              "failed": cell.failed, "metrics": metrics, "device": device_row}
    if trace:
        p = rec["profile"]
        device_row["busy_s"] = p["busy_s"]
        device_row["window_s"] = p["window_s"]
        result["breakdown"] = {"device_ops": p["device_ops"], "idle_gaps": p["idle_gaps"]}
    result["power_limit"] = power_limit() if cuda else "cpu"
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"], "kind": c["kind"]}
                        for k, c in checks.items()}
    return result


def check(value: float, limit: float, kind: str = "max") -> dict:
    """One compared number: ``value`` at most ``limit`` ('max') or at least
    ``limit`` ('min')."""
    ok = value <= limit if kind == "max" else value >= limit
    return {"value": float(value), "limit": float(limit), "kind": kind, "ok": bool(ok)}


def print_result(result: dict) -> None:
    """The checks on stderr as its last lines, then the result as the last
    line of stdout."""
    for name, c in result["checks"].items():
        op = "<=" if c["kind"] == "max" else ">="
        print(f"check {name} {c['value']!r} {op} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)

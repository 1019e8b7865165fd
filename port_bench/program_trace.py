"""The program's own spans in a profile, and the per-layer numbers they give.

``d3fields_tpu_torch.utils.profiling.tracer``, when on, opens a profiler
range ``d3f.<name>`` for each of its spans (``fields.update``,
``fields.query``, ``fields.tile`` and the tile's ``fields.distance``,
``fields.taps``, ``fields.kernel``, ``fields.bilinear``, ...). :func:`read`
puts each device op and each stretch of device idle time of a
``torch.profiler`` chrome trace of one ``pb.window`` range down to the
innermost such range open on the window's thread at that moment;
:data:`METRICS` reads the per-layer numbers from the tracer's summary of a
traced window (``rec["program"]``) and from :func:`read`'s result
(``rec["program_trace"]``); :func:`by_span` joins the two per span name.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np

from port_bench.harness import DEVICE_CATS, RUNTIME_CATS

PREFIX = "d3f."
TILE = "fields.tile"
# a request is one of these
REQUEST = "fields.update"


def _segments(ranges: List[Tuple[float, float, str]]):
    """Times at which the stack of open ranges changes, and the stack (names,
    outermost first) from then on, from nested (start, end, name) ranges of
    one thread."""
    starts, stacks, stack = [], [], []
    for ts, end, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][1] <= ts:
            done = stack.pop()
            starts.append(done[1])
            stacks.append(tuple(s[2] for s in stack))
        stack.append((ts, end, name))
        starts.append(ts)
        stacks.append(tuple(s[2] for s in stack))
    while stack:
        done = stack.pop()
        starts.append(done[1])
        stacks.append(tuple(s[2] for s in stack))
    order = np.argsort(np.asarray(starts, dtype=float), kind="stable")
    return np.asarray(starts, dtype=float)[order], [stacks[i] for i in order]


def read(path: str) -> dict:
    """For each program span name: ``ops``, the device ops launched while it
    was the innermost ``d3f.`` range open on the window's thread, ``busy_s``
    their device time, ``idle_s`` the device's idle time while it was the
    innermost such range, and ``idle_incl_s`` while it was open at any
    depth; besides, the window's ``idle_s`` and ``busy_s``, and
    ``outside_idle_s``, idle with no program span open."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    win = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "pb.window"]
    if not win:
        raise RuntimeError("the trace holds no pb.window range")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    tid = win[0]["tid"]
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):]) for e in events
              if e.get("tid") == tid and e["name"].startswith(PREFIX)
              and e.get("cat") in ("cpu_op", "user_annotation")]
    seg_t, seg_stack = _segments(ranges)

    def stack_at(t):
        k = int(np.searchsorted(seg_t, t, side="right")) - 1
        return seg_stack[k] if k >= 0 else ()

    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in RUNTIME_CATS and e.get("tid") == tid
                 and "correlation" in e.get("args", {})}
    spans: Dict[str, dict] = {}

    def row(name):
        return spans.setdefault(name, {"ops": 0, "busy_s": 0.0, "idle_s": 0.0,
                                       "idle_incl_s": 0.0})

    busy, gaps, cur_end = 0.0, [], w0
    for e in sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"]):
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t <= s:
            continue
        c = e.get("args", {}).get("correlation")
        stack = stack_at(launch_ts[c]) if c in launch_ts else ()
        if stack:
            r = row(stack[-1])
            r["ops"] += 1
            r["busy_s"] += (t - s) * 1e-6
        if s > cur_end:
            gaps.append((cur_end, s))
        if t > cur_end:
            busy += t - max(s, cur_end)
            cur_end = t
    if w1 > cur_end:
        gaps.append((cur_end, w1))
    outside = 0.0
    for a, b in gaps:
        k = int(np.searchsorted(seg_t, a, side="right")) - 1
        t = a
        while t < b:
            nxt = seg_t[k + 1] if k + 1 < len(seg_t) else np.inf
            stack = seg_stack[k] if k >= 0 else ()
            piece = (min(b, nxt) - t) * 1e-6
            if stack:
                row(stack[-1])["idle_s"] += piece
                for name in set(stack):
                    row(name)["idle_incl_s"] += piece
            else:
                outside += piece
            t = min(b, nxt)
            k += 1
    return {"spans": spans, "busy_s": busy * 1e-6, "idle_s": sum(b - a for a, b in gaps) * 1e-6,
            "outside_idle_s": outside}


def by_span(program: dict, trace: dict) -> dict:
    """Per span name: the host summary's count, median, total and self time
    (ms) beside the profile's device ops, busy and idle seconds; and
    ``outside``, the idle seconds with no program span open."""
    host = (program or {}).get("spans", {})
    dev = (trace or {}).get("spans", {})
    out = {}
    for name in sorted(set(host) | set(dev)):
        h, d = host.get(name, {}), dev.get(name, {})
        out[name] = {"count": h.get("count"), "median_ms": h.get("median_ms"),
                     "total_ms": h.get("total_ms"), "self_ms": h.get("self_ms"),
                     "ops": d.get("ops"), "busy_s": d.get("busy_s"), "idle_s": d.get("idle_s")}
    if trace:
        out["outside"] = {"idle_s": trace["outside_idle_s"]}
    return out


# -- the per-layer numbers ----------------------------------------------------

def _span(rec, name):
    return ((rec.get("program") or {}).get("spans") or {}).get(name)


def _per_request(rec, counter, default=None):
    """A counter's total over the traced window's requests; ``default``
    where the tracer never counted it."""
    prog, req = rec.get("program"), _span(rec, REQUEST)
    total = prog["counters"].get(counter, default) if prog and req else None
    return None if total is None else total / req["count"]


def _tile_child_ms(rec, child):
    tile = _span(rec, TILE)
    kid = tile["children"].get(child) if tile else None
    return kid["median_ms"] if kid else None


def ingest_ms(rec):
    """The median ``fields.update.ingest`` of the traced window (ms)."""
    s = _span(rec, "fields.update.ingest")
    return s["median_ms"] if s else None


def tile_idle_share(rec):
    """The device's idle time while a ``fields.tile`` span was open, over
    all its idle time in the profiled requests (%)."""
    tr = rec.get("program_trace")
    if not tr or TILE not in tr["spans"] or tr["idle_s"] <= 0:
        return None
    return 100.0 * tr["spans"][TILE]["idle_incl_s"] / tr["idle_s"]


# name: (reader of a record with "program" and "program_trace", unit)
METRICS = {
    "ingest_ms.query": (ingest_ms, "ms"),
    # a sync is counted where it happens; the allocator is read at every request
    "host_syncs.query": (lambda rec: _per_request(rec, "host_syncs", 0), "count"),
    "device_allocs.query": (lambda rec: _per_request(rec, "device_allocs"), "count"),
    "tile_distance_ms.query": (lambda rec: _tile_child_ms(rec, "fields.distance"), "ms"),
    "tile_taps_ms.query": (lambda rec: _tile_child_ms(rec, "fields.taps"), "ms"),
    "tile_bilinear_ms.query": (lambda rec: _tile_child_ms(rec, "fields.bilinear"), "ms"),
    "tile_idle_share.query": (tile_idle_share, "%"),
}

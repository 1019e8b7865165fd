"""Timing: the program's spans and counters, throughput, and waiting for the
device.

Counterpart of ``d3fields_tpu/utils/profiling.py``:

- :func:`sync` waits for the CUDA devices that hold the tensors of a
  nested structure (lists, tuples, dicts), so that a host clock read after
  it includes the device's work;
- :class:`Throughput` (FPS as XMem's eval counts it,
  ``total_frames / total_process_time``, ``XMem/eval.py:248-250``);
- :data:`tracer`, the program's one span system: named, nested host-clock
  spans and counters kept in memory, summarised by :meth:`Tracer.summary`
  and written by :meth:`Tracer.export_chrome`. Off (the default) a span
  checks one flag and does nothing else; no span ever synchronises. On,
  in a process that has set CUDA up, each span also times its stream's
  work on the device with a pair of CUDA events, placed on the host's clock
  through anchor events;
  while a ``torch.profiler`` records, each span also opens a
  ``record_function("d3f.<name>")`` range, so that the program's spans sit
  in the profiler's trace on the device's clock.

The JAX module's ``trace`` (``jax.profiler``) and ``xla_flops`` (XLA's
cost analysis) have no counterpart here: ``torch.profiler`` is used
directly, and no compiler reports a FLOP count for eager PyTorch.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
import warnings
from collections import defaultdict, deque
from typing import Optional

import numpy as np
import torch

# the text of the warning torch.cuda.set_sync_debug_mode("warn") raises
SYNC_WARNING = "called a synchronizing CUDA operation"
# the tracer's counters (besides those the program counts itself)
HOST_SYNCS = "host_syncs"
DEVICE_ALLOCS = "device_allocs"
ALLOC_RETRIES = "alloc_retries"
# the counters of a span's device time: ``<span name>`` + each
DEVICE_US, DEVICE_SPANS = ".device_us", ".device_spans"


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def sync(tree) -> None:
    """Wait for every CUDA device that holds a tensor of ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class Throughput:
    """XMem-eval FPS accounting (``XMem/eval.py:146,216,248-250``)."""

    def __init__(self):
        self.total_time = 0.0
        self.total_units = 0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, units: int = 1, result_tree=None):
        sync(result_tree)
        self.total_time += time.perf_counter() - self._t0
        self.total_units += units

    @property
    def per_second(self) -> float:
        return self.total_units / max(self.total_time, 1e-9)


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------

class _Off:
    """The span of a tracer that is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()

# a record: [name, start ns, end ns (None while open), parent id (-1 for a
# root), root id, thread id]; a span's id is its index in the buffer
_NAME, _T0, _T1, _PARENT, _ROOT, _TID = range(6)


def _allocator_counts():
    """The caching allocator's calls to cudaMalloc and its retries so far."""
    stats = torch.cuda.memory_stats_as_nested_dict()
    return stats.get("num_device_alloc", 0), stats.get("num_alloc_retries", 0)


class _Span:
    __slots__ = ("tracer", "name", "memory", "stack", "entry", "range", "alloc0", "timed")

    def __init__(self, tracer: "Tracer", name: str, memory: bool):
        self.tracer, self.name, self.memory = tracer, name, memory

    def __enter__(self):
        tr = self.tracer
        self.alloc0 = _allocator_counts() if self.memory and tr._cuda else None
        self.stack = tr._stack()
        parent = self.stack[-1] if self.stack else None  # (id, record)
        # record_function's path through the dispatcher costs tens of
        # microseconds a span under the profiler; this one a few
        self.range = (torch._C._profiler._RecordFunctionFast("d3f." + self.name)
                      if torch._C._autograd._profiler_enabled() else None)
        # the range opens right before the clock read, as it closes right
        # after the next one: none of the tracer's bookkeeping (a thread's
        # first span makes its stack) lies between them, so that the range's
        # duration and the span's agree
        if self.range is not None:
            self.range.__enter__()
        rec = [self.name, time.perf_counter_ns(), None,
               -1 if parent is None else parent[0], 0, threading.get_ident()]
        with tr._lock:
            sid = len(tr._records)
            if sid < tr.capacity:
                tr._records.append(rec)
            else:
                tr.dropped += 1
                sid = -1
        self.timed = tr._start_event() if sid >= 0 and tr._timed else None
        rec[_ROOT] = sid if parent is None else parent[1][_ROOT]
        self.entry = (sid, rec)
        self.stack.append(self.entry)
        return self

    def __exit__(self, *exc):
        tr, timed, end = self.tracer, self.timed, None
        if timed is not None:
            end = tr._end_event(timed)
        self.entry[1][_T1] = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        if self.alloc0 is not None:
            allocs, retries = _allocator_counts()
            tr.count(DEVICE_ALLOCS, allocs - self.alloc0[0])
            tr.count(ALLOC_RETRIES, retries - self.alloc0[1])
        self.stack.pop()
        if timed is not None:
            tr._pend(self.entry[0], self.name, timed, end)
        return False


class Tracer:
    """Named, nested host-clock spans and counters, kept in memory.

    ``with tracer.span("fields.tile"):`` records the span's name, its start
    and end (``time.perf_counter_ns``), its parent's id and its root's id
    (every span under one top-level span shares the root's id), each
    thread on a stack of its own. ``tracer.count(name, n)`` adds to a
    counter, charged also to the innermost span open on the calling thread.
    Spans go into a buffer of ``capacity`` records; once it is full, further
    spans are counted in ``dropped`` and not stored. Nothing is written
    until :meth:`export_chrome`.

    :meth:`enable` turns it on: then each span, while a ``torch.profiler``
    records, opens a ``record_function("d3f.<name>")`` range; with CUDA,
    every synchronising CUDA call made inside a span (pageable copies,
    ``.item()``, ``.cpu()``; ``torch.cuda.set_sync_debug_mode("warn")``'s
    warnings, caught and not shown) is counted as ``host_syncs``, and a span
    opened with ``memory=True`` reads the caching allocator at its entry and
    exit and counts the difference as ``device_allocs`` (cudaMalloc calls)
    and ``alloc_retries``. :meth:`disable` restores the earlier debug mode
    and warning filters. Off, :meth:`span` checks one flag and returns a
    shared object that does nothing.

    On, where CUDA was set up before :meth:`enable` (a process that only
    runs on the CPU makes no CUDA context here and times nothing), each
    stored span is also timed on the device: a timing event (from a pool
    that reading the times refills; until then each pair's events stay
    alive) recorded on the calling thread's current stream right after the
    span's start is read, and another on that stream at its exit; not while
    the stream captures a CUDA graph, where no event is recorded. The span's
    device time is the interval between the two: from the stream reaching
    the span to the end of the span's work, gaps included; on a stream the
    host has just drained (a synchronise right before the span) it holds the
    host's launch gaps too. The pairs wait in a queue; each timed span's
    exit moves the oldest whose end the device has passed onto a list of
    finished pairs (``Event.query``, which never waits) and reads no time,
    and :meth:`summary` and :meth:`export_chrome` wait for the rest and read
    every pair's ``elapsed_time``, after the traced work. A resolved span
    adds to the counters ``<name>.device_us`` (microseconds) and
    ``<name>.device_spans``. :meth:`enable` places the device's clock on the
    host's: between two synchronises it records an anchor event, and reads
    the host clock. :meth:`device_times` makes a second anchor so, and
    places a device event at the first anchor's read plus its
    ``elapsed_time`` to the event, scaled by the host's time between the two
    anchors over the device's: the two clocks drift apart by parts per
    million (a placement from the first anchor alone was 0.2-0.6 ms early
    after 51 s on an H100), and the scale takes the drift out.
    """

    def __init__(self, capacity: int = 1 << 20):
        self.capacity = capacity
        self.on = False
        self._cuda = False
        self._timed = False  # the spans timed on the device
        self._lock = threading.Lock()
        self._warnings = None
        self._sync_mode = None
        self._gen = 0  # the buffer's generation: reset() starts the next
        self._pool = {}  # device -> timing events free for reuse
        self._anchors = {}  # device -> (anchor event, host ns, device)
        self._pending = deque()  # timed spans the device may not have finished
        self._done = []  # and those it has finished, their times not read yet
        self.reset()

    # -- recording ----------------------------------------------------------
    def span(self, name: str, *, memory: bool = False):
        if not self.on:
            return _OFF
        return _Span(self, name, memory)

    def count(self, name: str, n: int = 1) -> None:
        if not self.on:
            return
        stack = self._stack()
        with self._lock:
            self._counters[name] += n
            if stack:
                self._by_span[stack[-1][1][_NAME]][name] += n

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _on_warning(self, message, category, filename, lineno, file=None, line=None):
        if issubclass(category, UserWarning) and SYNC_WARNING in str(message):
            if self._stack():
                self.count(HOST_SYNCS)
            return
        self._showwarning(message, category, filename, lineno, file, line)

    # -- device time ----------------------------------------------------------
    def _event(self, device):
        try:
            return self._pool[device].pop()
        except (KeyError, IndexError):
            return torch.cuda.Event(enable_timing=True)

    def _start_event(self):
        """A span's start on the device, recorded on the current stream:
        (event, stream, buffer generation, the device's anchor), or None
        while the stream captures a graph."""
        if torch.cuda.is_current_stream_capturing():
            return None
        # with no device given, current_stream() asks whether CUDA is
        # available, which costs ~5 us a call
        stream = torch.cuda.current_stream(torch.cuda.current_device())
        start = self._event(stream.device)
        start.record(stream)
        return start, stream, self._gen, self._anchors.get(stream.device)

    def _end_event(self, timed):
        """The span's end on its start's stream, or None where a capture
        began inside the span."""
        if torch.cuda.is_current_stream_capturing():
            return None
        end = self._event(timed[1].device)
        end.record(timed[1])
        return end

    def _pend(self, sid: int, name: str, timed, end) -> None:
        """Queue a timed span, then move the oldest queued spans the device
        has finished to the finished list; their times are read later, by
        :meth:`_flush` (two ``elapsed_time`` reads cost ~13 us a span on an
        H100's host). A span whose end was not recorded, or whose buffer a
        reset emptied, is dropped, and nothing is polled while a capture may
        be under way."""
        start, stream, gen, anchor = timed
        with self._lock:
            if end is None or gen != self._gen:
                self._pool.setdefault(stream.device, []).extend(
                    e for e in (start, end) if e is not None)
                return
            self._pending.append((sid, name, start, end, stream.device, anchor))
            while self._pending and self._pending[0][3].query():
                self._done.append(self._pending.popleft())

    def _resolve(self, item) -> None:
        """A finished pair's device time into the counters and the span's
        device interval on the host's clock (the lock held)."""
        sid, name, start, end, device, anchor = item
        ms = start.elapsed_time(end)
        self._counters[name + DEVICE_US] += ms * 1e3
        self._counters[name + DEVICE_SPANS] += 1
        after = None if anchor is None else anchor[0].elapsed_time(start)
        self._device[sid] = (ms, anchor, after)
        self._pool.setdefault(device, []).extend((start, end))

    def _flush(self) -> None:
        """Resolve every finished pair, then wait for each queued one and
        resolve it (the lock held)."""
        for item in self._done:
            self._resolve(item)
        self._done.clear()
        while self._pending:
            item = self._pending.popleft()
            item[3].synchronize()
            self._resolve(item)

    @staticmethod
    def _anchor(device) -> tuple:
        """``device``'s clock against the host's: an event the device
        reaches between two synchronises, and the host clock read right
        after the second."""
        torch.cuda.synchronize(device)
        anchor = torch.cuda.Event(enable_timing=True)
        anchor.record(torch.cuda.current_stream(device))
        torch.cuda.synchronize(device)
        return anchor, time.perf_counter_ns(), device

    # -- switching ------------------------------------------------------------
    def enable(self) -> None:
        if self.on:
            return
        self._cuda = torch.cuda.is_available()
        # is_available() makes no CUDA context; is_initialized() says one exists
        self._timed = self._cuda and torch.cuda.is_initialized()
        if self._timed:
            device = torch.device("cuda", torch.cuda.current_device())
            self._anchors = {device: self._anchor(device)}
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.filterwarnings("always", message=".*" + SYNC_WARNING, category=UserWarning)
        self._showwarning = warnings.showwarning
        warnings.showwarning = self._on_warning
        if self._cuda:
            self._sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        self.on = True

    def disable(self) -> None:
        if not self.on:
            return
        self.on = False
        if self._cuda:
            torch.cuda.set_sync_debug_mode(self._sync_mode)
        self._warnings.__exit__(None, None, None)
        self._warnings = None

    def reset(self) -> None:
        """Forget every span, counter and pending device time; spans open
        now are left out."""
        with self._lock:
            self._records = []
            self._counters = defaultdict(int)
            self._by_span = defaultdict(lambda: defaultdict(int))
            self._local = threading.local()
            self.dropped = 0
            self._gen += 1
            for _, _, start, end, device, _ in (*self._pending, *self._done):
                self._pool.setdefault(device, []).extend((start, end))
            self._pending.clear()
            self._done.clear()
            self._device = {}  # span id -> (device ms, its anchor, ms from the anchor)

    # -- reading --------------------------------------------------------------
    def records(self) -> list:
        """The stored spans: (name, start ns, end ns or None while open,
        parent id, root id, thread id), a span's id being its index here."""
        with self._lock:
            return [tuple(r) for r in self._records]

    def device_times(self) -> dict:
        """For each device-timed span's id: its device time (ms) and its
        device interval on the host's clock (start ns, end ns; None on a
        device without an anchor), placed between the span's anchor and one
        made now. Waits for the device's pending work."""
        with self._lock:
            self._flush()
            device = dict(self._device)
        now, scale, out = {}, {}, {}
        for sid, (ms, anchor, after) in device.items():
            if anchor is None:
                out[sid] = (ms, None)
                continue
            if anchor not in scale:
                dev = anchor[2]
                if dev not in now:
                    now[dev] = self._anchor(dev)
                dev_ms = anchor[0].elapsed_time(now[dev][0])
                # host ns a device ms, from the span's anchor to now
                scale[anchor] = (now[dev][1] - anchor[1]) / dev_ms if dev_ms > 0 else 1e6
            t0 = anchor[1] + after * scale[anchor]
            out[sid] = (ms, (round(t0), round(t0 + ms * scale[anchor])))
        return out

    def summary(self) -> dict:
        """For each span name: ``count``, ``median_ms``, ``p95_ms``,
        ``total_ms``, ``self_ms`` (the total less the time of child spans)
        and ``children``: for each child name, its ``total_ms`` and the
        ``median_ms`` over this name's spans of the child's summed time in
        each (0 where a span has none); where its spans were timed on the
        device, ``device_median_ms`` and ``device_p95_ms``. Besides:
        ``counters`` (totals, the device time's among them),
        ``counters_by_span`` (the totals charged to each innermost span
        name) and ``dropped``. Waits for the device's pending work."""
        with self._lock:
            self._flush()
            recs = [tuple(r) for r in self._records]
            counters = dict(self._counters)
            by_span = {k: dict(v) for k, v in self._by_span.items()}
            dropped = self.dropped
            device = dict(self._device)
        dur = [None if r[_T1] is None else (r[_T1] - r[_T0]) * 1e-6 for r in recs]
        child = defaultdict(lambda: defaultdict(float))  # parent id -> name -> ms
        for r, d in zip(recs, dur):
            if d is not None and r[_PARENT] >= 0:
                child[r[_PARENT]][r[_NAME]] += d
        spans = {}
        for sid, (r, d) in enumerate(zip(recs, dur)):
            if d is None:
                continue
            s = spans.setdefault(r[_NAME], {"ms": [], "self_ms": 0.0, "kids": [],
                                            "device_ms": []})
            s["ms"].append(d)
            s["self_ms"] += d - sum(child[sid].values())
            s["kids"].append(child[sid])
            if sid in device:
                s["device_ms"].append(device[sid][0])
        out = {}
        for name, s in spans.items():
            ms = np.asarray(s["ms"])
            names = sorted({k for kids in s["kids"] for k in kids})
            out[name] = {
                "count": len(ms), "median_ms": float(np.median(ms)),
                "p95_ms": float(np.percentile(ms, 95)), "total_ms": float(ms.sum()),
                "self_ms": s["self_ms"],
                "children": {k: {"total_ms": float(sum(kids.get(k, 0.0) for kids in s["kids"])),
                                 "median_ms": float(np.median([kids.get(k, 0.0)
                                                               for kids in s["kids"]]))}
                             for k in names}}
            if s["device_ms"]:
                out[name]["device_median_ms"] = float(np.median(s["device_ms"]))
                out[name]["device_p95_ms"] = float(np.percentile(s["device_ms"], 95))
        return {"spans": out, "counters": counters, "counters_by_span": by_span,
                "dropped": dropped}

    def export_chrome(self, path: str) -> None:
        """The stored spans as a chrome trace (``chrome://tracing``,
        Perfetto): one complete event each, in microseconds, with its id,
        parent and root in ``args``, and for each span timed on the device
        a second one, its device interval, on the lane ``device <thread
        id>``, both on the host's clock; the counters and the count of
        dropped spans under ``otherData``."""
        summary = self.summary()
        recs = self.records()
        device = {sid: at for sid, (_, at) in self.device_times().items() if at is not None}
        t0 = min([r[_T0] for r in recs] + [at[0] for at in device.values()], default=0)
        events = []
        for sid, r in enumerate(recs):
            if r[_T1] is None:
                continue
            args = {"id": sid, "parent": r[_PARENT], "root": r[_ROOT]}
            events.append({"ph": "X", "name": r[_NAME], "cat": "d3f", "pid": os.getpid(),
                           "tid": r[_TID], "ts": (r[_T0] - t0) / 1e3,
                           "dur": (r[_T1] - r[_T0]) / 1e3, "args": args})
            if sid in device:
                d0, d1 = device[sid]
                events.append({"ph": "X", "name": r[_NAME], "cat": "d3f.device",
                               "pid": os.getpid(), "tid": f"device {r[_TID]}",
                               "ts": (d0 - t0) / 1e3, "dur": (d1 - d0) / 1e3, "args": args})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "otherData": {"counters": summary["counters"],
                                     "counters_by_span": summary["counters_by_span"],
                                     "dropped": summary["dropped"]}}, f)


tracer = Tracer()


@contextlib.contextmanager
def traced(path: Optional[str]):
    """The apps' ``--trace PATH``: :data:`tracer` on (and emptied) inside;
    at exit its spans written to ``path`` as a chrome trace and its summary
    printed to stderr. Without a path, nothing."""
    if not path:
        yield
        return
    tracer.reset()
    tracer.enable()
    try:
        yield
    finally:
        tracer.disable()
        tracer.export_chrome(path)
        print(json.dumps(tracer.summary(), indent=1), file=sys.stderr)

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
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

# the text of the warning torch.cuda.set_sync_debug_mode("warn") raises
SYNC_WARNING = "called a synchronizing CUDA operation"
# the tracer's counters (besides those the program counts itself)
HOST_SYNCS = "host_syncs"
DEVICE_ALLOCS = "device_allocs"
ALLOC_RETRIES = "alloc_retries"


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
    __slots__ = ("tracer", "name", "memory", "stack", "entry", "range", "alloc0")

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
        rec[_ROOT] = sid if parent is None else parent[1][_ROOT]
        self.entry = (sid, rec)
        self.stack.append(self.entry)
        return self

    def __exit__(self, *exc):
        self.entry[1][_T1] = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        if self.alloc0 is not None:
            allocs, retries = _allocator_counts()
            self.tracer.count(DEVICE_ALLOCS, allocs - self.alloc0[0])
            self.tracer.count(ALLOC_RETRIES, retries - self.alloc0[1])
        self.stack.pop()
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
    """

    def __init__(self, capacity: int = 1 << 20):
        self.capacity = capacity
        self.on = False
        self._cuda = False
        self._lock = threading.Lock()
        self._warnings = None
        self._sync_mode = None
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

    # -- switching ------------------------------------------------------------
    def enable(self) -> None:
        if self.on:
            return
        self._cuda = torch.cuda.is_available()
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
        """Forget every span and counter; spans open now are left out."""
        with self._lock:
            self._records = []
            self._counters = defaultdict(int)
            self._by_span = defaultdict(lambda: defaultdict(int))
            self._local = threading.local()
            self.dropped = 0

    # -- reading --------------------------------------------------------------
    def records(self) -> list:
        """The stored spans: (name, start ns, end ns or None while open,
        parent id, root id, thread id), a span's id being its index here."""
        with self._lock:
            return [tuple(r) for r in self._records]

    def summary(self) -> dict:
        """For each span name: ``count``, ``median_ms``, ``p95_ms``,
        ``total_ms``, ``self_ms`` (the total less the time of child spans)
        and ``children``: for each child name, its ``total_ms`` and the
        ``median_ms`` over this name's spans of the child's summed time in
        each (0 where a span has none). Besides: ``counters`` (totals),
        ``counters_by_span`` (the totals charged to each innermost span
        name) and ``dropped``."""
        with self._lock:
            recs = [tuple(r) for r in self._records]
            counters = dict(self._counters)
            by_span = {k: dict(v) for k, v in self._by_span.items()}
            dropped = self.dropped
        dur = [None if r[_T1] is None else (r[_T1] - r[_T0]) * 1e-6 for r in recs]
        child = defaultdict(lambda: defaultdict(float))  # parent id -> name -> ms
        for r, d in zip(recs, dur):
            if d is not None and r[_PARENT] >= 0:
                child[r[_PARENT]][r[_NAME]] += d
        spans = {}
        for sid, (r, d) in enumerate(zip(recs, dur)):
            if d is None:
                continue
            s = spans.setdefault(r[_NAME], {"ms": [], "self_ms": 0.0, "kids": []})
            s["ms"].append(d)
            s["self_ms"] += d - sum(child[sid].values())
            s["kids"].append(child[sid])
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
        return {"spans": out, "counters": counters, "counters_by_span": by_span,
                "dropped": dropped}

    def export_chrome(self, path: str) -> None:
        """The stored spans as a chrome trace (``chrome://tracing``,
        Perfetto): one complete event each, in microseconds, with its id,
        parent and root in ``args``; the counters and the count of dropped
        spans under ``otherData``."""
        recs = self.records()
        t0 = min((r[_T0] for r in recs), default=0)
        events = [{"ph": "X", "name": r[_NAME], "cat": "d3f", "pid": os.getpid(),
                   "tid": r[_TID], "ts": (r[_T0] - t0) / 1e3, "dur": (r[_T1] - r[_T0]) / 1e3,
                   "args": {"id": sid, "parent": r[_PARENT], "root": r[_ROOT]}}
                  for sid, r in enumerate(recs) if r[_T1] is not None]
        summary = self.summary()
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

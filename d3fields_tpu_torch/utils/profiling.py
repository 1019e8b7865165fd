"""Timing: per-stage wall clocks, throughput, and the card's measured
matmul peak and launch floor.

Counterpart of ``d3fields_tpu/utils/profiling.py``:

- :func:`sync` waits for the CUDA devices that hold the tensors of a
  nested structure (lists, tuples, dicts), so that a host clock read after
  it includes the device's work;
- :class:`StageTimer` and :class:`Throughput` (FPS as XMem's eval counts it,
  ``total_frames / total_process_time``, ``XMem/eval.py:248-250``);
- :func:`measured_matmul_peak_tflops` and :func:`measured_dispatch_floor_ms`
  time a chain of matmuls and a trivial launch with CUDA events (on the
  CPU, with the host clock).

The JAX module's ``trace`` (``jax.profiler``) and ``xla_flops`` (XLA's
cost analysis) have no counterpart here: ``torch.profiler`` is used
directly, and no compiler reports a FLOP count for eager PyTorch.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from d3fields_tpu_torch.utils.device import resolve_device


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


class StageTimer:
    """Accumulates per-stage latencies; ``report()`` gives a table. A stage
    ends once the tensors put in its holder's ``"out"`` (or the
    ``result_tree``) are computed."""

    def __init__(self):
        self.times: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, result_tree=None):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            sync(holder.get("out", result_tree))
            self.times[name].append(time.perf_counter() - t0)

    def report(self) -> str:
        lines = [f"{'stage':<28}{'calls':>6}{'mean ms':>10}{'min ms':>10}{'total s':>10}"]
        for name, ts in self.times.items():
            a = np.asarray(ts)
            lines.append(f"{name:<28}{len(ts):>6}{a.mean() * 1e3:>10.1f}"
                         f"{a.min() * 1e3:>10.1f}{a.sum():>10.2f}")
        return "\n".join(lines)


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


def _best_ms(fn, repeats: int, dev: torch.device) -> float:
    """The least milliseconds of ``repeats`` calls of ``fn`` after one
    warm-up call: CUDA events on a GPU, the host clock elsewhere."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def measured_matmul_peak_tflops(dtype=torch.bfloat16, n: int = 8192, chain: int = 8,
                                repeats: int = 3, *, device=None) -> float:
    """Delivered dense-matmul rate of ``device``: the best TFLOP/s of a
    chain of ``chain`` dependent (n, n) @ (n, n) matmuls (2 chain n^3 FLOPs)
    over ``repeats``. The denominator of a utilisation statement: the peak
    the card delivers, not the data sheet's."""
    dev = resolve_device(device)
    x = torch.full((n, n), 1.0 / n, dtype=dtype, device=dev)

    def f():
        y = x
        for _ in range(chain):
            y = (y @ y) * (1.0 / n)  # the rescale keeps bf16 away from inf
        return y

    return 2.0 * chain * n ** 3 / (_best_ms(f, repeats, dev) * 1e-3) / 1e12


def measured_dispatch_floor_ms(reps: int = 10, *, device=None) -> float:
    """Milliseconds of one trivial launch (an add on 8 floats) and its wait,
    the least of ``reps``: the floor under every per-stage latency. A stage
    whose time is near k times this for k launches is bound by launches,
    not by work."""
    dev = resolve_device(device)
    x = torch.zeros(8, device=dev)
    return _best_ms(lambda: x + 1.0, reps, dev)

#!/usr/bin/env python3
"""A traced run of a cell with the program's own tracer on.

    python3 port_bench/program_run.py --workload <cell> --seed <n> --seconds <s> \\
        [--tracer-window 0|1]

runs ``port_bench/run.py ... --trace 1`` with
``d3fields_tpu_torch.utils.profiling.tracer`` on after set-up: through the
traced window (``--tracer-window 1``, the default; 0 leaves it off there,
to see what it costs) and through the profiled requests, whose ``d3f.``
ranges :func:`program_trace.read` reads before the trace is removed. The
result line is the harness's with two more keys: ``program``, the
per-layer numbers of :data:`program_trace.METRICS`, and
``breakdown.by_span``; ``program_counters`` holds the tracer's counters of
the window and of the profiled requests.

The harness itself never turns the tracer on, so this script wraps three
of its functions for the length of the run (:func:`wrapped`).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import harness, program_trace  # noqa: E402


@contextlib.contextmanager
def wrapped(tracer_window: bool = True):
    """``harness.window``, ``harness.profile`` and ``harness.read_trace``
    with the program's tracer on, for the length of the block; yields the
    dict that gathers ``program`` (the window's summary), ``profiled`` (the
    profiled requests' summary) and ``program_trace``."""
    from d3fields_tpu_torch.utils.profiling import tracer

    window, profile, read_trace = harness.window, harness.profile, harness.read_trace
    got = {"program": None, "profiled": None, "program_trace": None}

    def traced(key, fn, on, *args):
        tracer.reset()
        if on:
            tracer.enable()
        try:
            return fn(*args)
        finally:
            got[key] = tracer.summary() if tracer.on else None
            tracer.disable()
            tracer.reset()

    def read_both(path):
        got["program_trace"] = program_trace.read(path)
        return read_trace(path)

    harness.window = lambda *a: traced("program", window, tracer_window, *a)
    harness.profile = lambda *a: traced("profiled", profile, True, *a)
    harness.read_trace = read_both
    try:
        yield got
    finally:
        harness.window, harness.profile, harness.read_trace = window, profile, read_trace


def add_program(result: dict, got: dict) -> dict:
    """``result`` with the ``program`` metrics, ``breakdown.by_span`` and
    ``program_counters`` of what :func:`wrapped` gathered."""
    metrics = {}
    for name, (read, unit) in program_trace.METRICS.items():
        value = read(got)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": unit}
    result["program"] = metrics
    result.setdefault("breakdown", {})["by_span"] = program_trace.by_span(
        got["program"] or got["profiled"], got["program_trace"])
    result["program_counters"] = {k: (got[k] or {}).get("counters_by_span")
                                  for k in ("program", "profiled")}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--tracer-window", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    from port_bench import run

    run.cache_env(ROOT)
    run.T_START = T_START
    print_result = harness.print_result
    with wrapped(bool(args.tracer_window)) as got:
        harness.print_result = lambda result: print_result(add_program(result, got))
        try:
            return run.main(["--workload", args.workload, "--seed", str(args.seed),
                             "--seconds", str(args.seconds), "--trace", "1"])
        finally:
            harness.print_result = print_result


if __name__ == "__main__":
    sys.exit(main())

"""Helpers the metric readers share. A reader takes the run's record and
returns the metric's value, or None where the record holds nothing to read."""

from __future__ import annotations

import re
import statistics

import numpy as np


def median_ms(rec: dict, span: str):
    xs = rec.get("spans", {}).get(span)
    return statistics.median(xs) * 1e3 if xs else None


def ops_per(rec: dict, span: str, per: float):
    """Device ops launched inside the ``pb.<span>`` ranges of the profile,
    per ``per`` units (None where the profile holds no such range)."""
    prof = rec.get("profile")
    if not prof or per <= 0:
        return None
    n = sum(1 for _, _, s in prof["ops"] if s == span)
    return n / per if n else None


def idle_percent(rec: dict):
    """1 - the device's busy time per profiled step over the mean step of the
    run's window, which the profiler does not stretch (%)."""
    prof = rec.get("profile")
    if not prof or not prof["steps"] or not rec.get("steps") or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - (prof["busy_s"] / prof["steps"]) / (rec["window_s"] / rec["steps"]))


def mfu_percent(rec: dict):
    """FLOPs counted from shapes over the window's wall time, as a share of
    the published peak of the configuration's dtype."""
    if not rec.get("window_s"):
        return None
    return 100.0 * rec["flops_per_step"] * rec["steps"] / rec["window_s"] / rec["peak_flops"]


def kernel_durations(rec: dict, pattern: str):
    """Device times (s) of the profiled launches whose name matches ``pattern``."""
    prof = rec.get("profile")
    if not prof:
        return []
    rx = re.compile(pattern)
    return [d for name, d, _ in prof["ops"] if rx.search(name)]


def percentile(xs, q: float):
    return float(np.percentile(np.asarray(xs), q)) if xs else None

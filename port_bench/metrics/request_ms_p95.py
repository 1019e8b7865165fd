"""request_ms_p95: the 95th percentile of all the window's request times (ms),
each from the observation handed in to the answers complete on the device."""
from port_bench.metrics import _lib


def read(rec):
    p = _lib.percentile(rec.get("latencies_s"), 95)
    return None if p is None else p * 1e3

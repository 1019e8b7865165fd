"""idle_share.segment: 1 - the union of the device's busy intervals per
profiled request (profiled after the window) over the mean request of the
traced window (%)."""
from port_bench.metrics import _lib


def read(rec):
    return _lib.idle_percent(rec)

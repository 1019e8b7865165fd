"""idle_share.video: 1 - the union of the device's busy intervals per
profiled frame (profiled after the window) over the mean frame of the
traced window (%)."""
from port_bench.metrics import _lib


def read(rec):
    return _lib.idle_percent(rec)

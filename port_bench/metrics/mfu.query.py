"""mfu.query: model FLOPs counted from shapes (port_bench/costs.py) over the
traced window's wall time, as a share of the published peak of the
configuration's dtype (%)."""
from port_bench.metrics import _lib


def read(rec):
    return _lib.mfu_percent(rec)

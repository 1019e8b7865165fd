"""mfu.segment: model FLOPs counted from shapes (port_bench/costs_segment.py:
GroundingDINO and SAM's encoder over the views, SAM's decoder over each
request's boxes) over the traced window's wall time, as a share of the
published bf16 peak (%)."""
from port_bench.metrics import _lib


def read(rec):
    return _lib.mfu_percent(rec)

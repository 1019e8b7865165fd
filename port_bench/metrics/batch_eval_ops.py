"""batch_eval_ops: device ops launched inside the query of one request (count),
over the profiled requests."""
from port_bench.metrics import _lib


def read(rec):
    prof = rec.get("profile")
    return _lib.ops_per(rec, "batch_eval", prof["steps"]) if prof else None

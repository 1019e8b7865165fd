"""batch_eval_ms: the field query of a request (ms), host clock between
synchronises, median over the traced window."""
from port_bench.metrics import _lib


def read(rec):
    return _lib.median_ms(rec, "batch_eval")

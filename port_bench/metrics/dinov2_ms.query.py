"""dinov2_ms.query: the feature backend's call inside Fusion.update (ms), host
clock between synchronises, median over the traced window."""
from port_bench.metrics import _lib


def read(rec):
    return _lib.median_ms(rec, "dinov2")

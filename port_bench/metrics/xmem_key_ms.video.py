"""xmem_key_ms.video: the key encoder and its projections (``encode_key``)
of a frame (ms), host clock between synchronises, median over the traced
window's frames."""
from port_bench.metrics import _lib


def read(rec):
    return _lib.median_ms(rec, "xmem_key")

"""xmem_read_ms.video: the memory read of a frame (``match_memory``: the
similarity over [long-term, working] memory, the top-k softmax, the
readout, the usage counts; ms), host clock between synchronises, median
over the traced window's frames that read (all but the seed frames)."""
from port_bench.metrics import _lib


def read(rec):
    return _lib.median_ms(rec, "xmem_read")

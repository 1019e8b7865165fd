"""xmem_memorize_ms.video: a memory frame's value encoder over its objects
and ``add_memory`` (the write, and where due the eviction and the
consolidation; ms), host clock between synchronises, median over the
traced window's memory frames."""
from port_bench.metrics import _lib


def read(rec):
    return _lib.median_ms(rec, "xmem_memorize")

"""xmem_decode_ms.video: the decoder of a frame's objects (``segment``:
the fusion, the upsampling blocks, the logits and soft aggregation, the
hidden update on normal frames; ms), host clock between synchronises,
median over the traced window's frames that decode."""
from port_bench.metrics import _lib


def read(rec):
    return _lib.median_ms(rec, "xmem_decode")

"""sam_encode_ms.segment: SAM's image encoder over the rig (``set_images``,
ms), host clock between synchronises, median over the traced window."""
from port_bench.metrics import _lib


def read(rec):
    return _lib.median_ms(rec, "sam_encode")

"""mfu.video: model FLOPs counted from shapes (port_bench/costs_xmem.py:
the key encoder of each frame; the read and the decoder of its objects on
each frame but the seed; the value encoder of its objects on each memory
frame) over the traced window's wall time, as a share of the published
bf16 peak (%)."""
from port_bench.metrics import _lib


def read(rec):
    return _lib.mfu_percent(rec)

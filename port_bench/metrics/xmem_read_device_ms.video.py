"""xmem_read_device_ms.video: XMem's memory read of a frame, on the device
(ms): the mean device time of the program's ``xmem.read`` span, its CUDA-
event interval from the stream reaching the span to the end of its work,
``xmem.read.device_us`` over ``xmem.read.device_spans`` / 1000 over the
requests the tracer saw. None where the program has no such counters.

In a traced run nearly every span read lies between the synchronises that
``harness.Probe`` makes around the layers it wraps: the interval starts
on a drained card and holds the host's launch gaps, and tends to repeat
the layer's host-clock twin; see ``_device``."""
from port_bench.metrics import _device


def read(rec):
    return _device.mean_ms(rec, "xmem.read")

"""dinov2_device_ms.query: the feature backend's call inside Fusion.update
(DINOv2 over the 4 views: resize, normalisation, the transformer), on the
device (ms): the mean device time of the program's
``fields.update.features`` span, its CUDA-event interval from the stream
reaching the span to the end of its work,
``fields.update.features.device_us`` over
``fields.update.features.device_spans`` / 1000 over the requests the tracer
saw. None where the program has no such counters.

In a traced run nearly every span read lies between the synchronises that
``harness.Probe`` makes around the layers it wraps: the interval starts
on a drained card and holds the host's launch gaps, and tends to repeat
the layer's host-clock twin; see ``_device``."""
from port_bench.metrics import _device


def read(rec):
    return _device.mean_ms(rec, "fields.update.features")

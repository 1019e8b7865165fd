"""The device time of the program's spans: each span the tracer times on
the device adds its CUDA-event interval to the counter
``<span>.device_us`` and one to ``<span>.device_spans``
(``d3fields_tpu_torch/utils/profiling.py::Tracer``).

Which requests the counters come from. The segment, video and ViT-g
drivers keep the tracer on through the whole traced run: the window, in
which ``harness.Probe`` synchronises the card right before and right after
each layer it wraps (``gdino``, ``sam_encode``, ``sam_decode``; the four
``xmem_*``; ``dinov2``, ``batch_eval``), and the profile of 3 (video: 20)
requests after it, which runs without those synchronises. Nearly every span
read therefore comes from synchronised requests. A span that opens on a card
the Probe has just drained starts its interval at once, so the interval
holds the host's launch gaps as well as the device's work, and the mean
repeats the Probe's host-clock span of the same layer rather than the
device time of the program as it runs untraced (there a span's interval
opens when the backlogged stream reaches it). The metrics read the
unsynchronised program only once the harness counts just the profiled
requests (the tracer reset when the profile starts, or on only under
``Probe.annotate``)."""


def mean_ms(rec: dict, span: str):
    """The mean device time of ``span`` (ms), or None where the program's
    counters hold none (an untraced run, the CPU, a program without device
    timing)."""
    counters = rec.get("program_counters") or {}
    n, us = counters.get(span + ".device_spans"), counters.get(span + ".device_us")
    if not n or us is None:
        return None
    return us / n / 1e3

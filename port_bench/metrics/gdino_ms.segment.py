"""gdino_ms.segment: the detector's call inside a segmentation request (ms):
``predict_with_classes_batch``, GroundingDINO over the 4 views with its
host post-processing, host clock between synchronises, median over the
traced window."""
from port_bench.metrics import _lib


def read(rec):
    return _lib.median_ms(rec, "gdino")

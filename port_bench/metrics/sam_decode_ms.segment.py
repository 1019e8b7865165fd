"""sam_decode_ms.segment: SAM's mask decoder over every view's boxes
(``predict_boxes_views``) and the masks' trip to the host, to the end of
``segment_views`` (ms), host clock between synchronises, median over the
traced window."""
from port_bench.metrics import _lib


def read(rec):
    return _lib.median_ms(rec, "sam_decode")

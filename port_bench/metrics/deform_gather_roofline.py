"""deform_gather_roofline: the least time of a request's ``deform_gather``
launches (port_bench/costs_segment.py: each launch's value table,
sampling locations, weights and output moved once at the HBM rate), summed
over the profiled requests, over the summed device time of the profiled
launches of csrc/deform_gather.cu, both routes (%). None where the profile
holds no such launch, or not the request's count of them."""
from port_bench import costs_segment
from port_bench.metrics import _lib

PATTERN = r"deform_gather"


def read(rec):
    times = _lib.kernel_durations(rec, PATTERN)
    launches = rec.get("gather_launches")
    if not times or not launches or len(times) != len(launches) * rec["profile"]["steps"]:
        return None
    bound = sum(costs_segment.deform_gather_bound_s(x) for x in launches)
    return 100.0 * bound * rec["profile"]["steps"] / sum(times)

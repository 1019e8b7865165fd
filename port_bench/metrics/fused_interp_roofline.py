"""fused_interp_roofline: the least time a query tile's interpolation can take
(port_bench/costs.py: its table, taps and output moved once at the HBM
rate, or its FLOPs at the f32 rate, whichever is longer) over the median
device time of the profiled launches of csrc/fused_interp.cu (%)."""
import statistics

from port_bench import costs
from port_bench.metrics import _lib

# the kernels of csrc/fused_interp.cu: the shared-memory slice route and the direct gather
PATTERN = r"fused_interp_slice_kernel|fused_weighted_interp_kernel"


def read(rec):
    times = _lib.kernel_durations(rec, PATTERN)
    tile = rec.get("kernel_tile")
    if not times or not tile:
        return None
    bound = costs.fused_interp_bound_s(tile["views"], tile["rows"], tile["channels"],
                                       tile["points"], tile["itemsize"])
    return 100.0 * bound / statistics.median(times)

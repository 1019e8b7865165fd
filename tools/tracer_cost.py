"""What ``d3fields_tpu_torch.utils.profiling.tracer`` costs on a CUDA card's
host: a span off and on, a read of the caching allocator, a caught
synchronisation warning, and a request (``Fusion.update`` of a 4-view
240x320 observation with its 24x32x1024 descriptors, then 1,048,576
points through the fused query in 8 tiles, f32 and bf16) with the tracer
on and off, interleaved two and two over 40 requests. Prints one JSON
object (ns per call; median and quartiles of a request in ms).

    python tools/tracer_cost.py
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from d3fields_tpu_torch.config import D3FieldsConfig, FusionConfig  # noqa: E402
from d3fields_tpu_torch.fields.fusion import Fusion, batch_eval  # noqa: E402
from d3fields_tpu_torch.utils import profiling  # noqa: E402
from d3fields_tpu_torch.utils.profiling import tracer  # noqa: E402
from d3fields_tpu_torch.utils.synthetic import render_sphere_scene  # noqa: E402


def per_call_ns(fn, n: int) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t0) / n


def best_ns(fn, n: int, on: bool) -> float:
    """The least of three timings of ``n`` calls, the tracer on (inside a
    span) or off."""
    if not on:
        return min(per_call_ns(fn, n) for _ in range(3))
    tracer.enable()
    try:
        with tracer.span("outer"):
            return min(per_call_ns(fn, n) for _ in range(3))
    finally:
        tracer.disable()
        tracer.reset()


def span():
    with tracer.span("x"):
        pass


def requests(dtype: str) -> dict:
    sc = render_sphere_scene(num_views=4, H=240, W=320, feat_dim=8)
    obs = {k: sc[k] for k in ("color", "depth", "pose", "K")}
    obs["mask"] = np.random.RandomState(0).rand(4, 240, 320, 3).astype(np.float32)
    obs["dino_feats"] = torch.rand((4, 24, 32, 1024),
                                   generator=torch.Generator().manual_seed(0)).numpy()
    pts = np.random.RandomState(1).uniform([-0.3, -0.4, 0.001], [0.6, 0.4, 0.4],
                                           (1 << 20, 3)).astype(np.float32)
    fus = Fusion(config=D3FieldsConfig(fusion=FusionConfig(query_tile=131072)), device="cuda")

    def request():
        fus.update(obs)
        batch_eval(fus.state, pts, ("dino_feats", "mask"), tile=131072, fused=True,
                   matmul_dtype=dtype)
        torch.cuda.synchronize()

    for _ in range(3):
        request()
    times = {"off": [], "on": []}
    for i in range(40):
        mode = "on" if i % 4 in (1, 2) else "off"
        if mode == "on":
            tracer.reset()
            tracer.enable()
        t0 = time.perf_counter()
        request()
        times[mode].append((time.perf_counter() - t0) * 1e3)
        tracer.disable()
    out = {m: {"median_ms": statistics.median(v), "q": statistics.quantiles(v, n=4)}
           for m, v in times.items()}
    out["spans_per_request"] = len(tracer.records())
    tracer.reset()
    return out


def main() -> None:
    y = torch.ones(16, device="cuda")
    torch.cuda.synchronize()
    out = {"span_off_ns": best_ns(span, 200000, False),
           "span_on_ns": best_ns(span, 100000, True),
           "allocator_read_ns": best_ns(profiling._allocator_counts, 2000, False),
           "cpu_copy_off_ns": best_ns(y.cpu, 5000, False),
           "cpu_copy_on_ns": best_ns(y.cpu, 5000, True),
           "request": {dtype: requests(dtype) for dtype in ("float32", "bfloat16")}}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The readings that the video cell's correctness limits are set from.

    python3 port_bench/calibrate_video.py --seeds 1,2,... --control-seeds 3,4,5 \\
        [--workload xmem-r50-bf16.davis480p] [--seconds 4]

In one process, at the cell's own sizes: for each of ``--seeds`` a run of
the program (set-up, a short window, the check) and its compared numbers
against the reference, the lower readings; for each of ``--control-seeds``
the reference one precision step below the configuration's (fp8 for bf16)
in the program's place, on the seed's videos, at ``samples`` frames drawn
from the seed and at the first video's last frame, held to the reference
as the program is: the upper readings. One JSON line per reading, then a
summary: per number the largest lower and the smallest upper reading.
``port_bench/run.py`` never runs this.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from port_bench import calibrate, harness, weights_xmem  # noqa: E402
from port_bench.drivers import common  # noqa: E402
from port_bench.drivers import video as drv  # noqa: E402
from port_bench.reference import xmem as ref_xmem  # noqa: E402
from port_bench.reference.precision import CONTROL, MODES  # noqa: E402
from port_bench.rig import seed_rng  # noqa: E402


def control_frames(spec, seed: int):
    """(video, frame) pairs the control is compared at: ``samples`` frames
    drawn from the seed past each video's first, and the first video's last."""
    T, n = int(spec.traffic["frames"]), int(spec.traffic["videos"])
    rng = seed_rng(seed, 3)
    picks = [(int(rng.integers(n)), int(rng.integers(1, T)))
             for _ in range(spec.traffic["samples"])]
    return picks + [(0, T - 1)]


def control(spec, seed: int, device) -> dict:
    """The control in the program's place at :func:`control_frames`."""
    ctx = harness.Context(spec, seed, device, harness.Probe(lambda: None))
    cfg = spec.config
    videos = drv.render_videos(ctx)
    C = MODES[CONTROL[cfg["compute_dtype"]]]
    w = weights_xmem.xmem_weights(cfg["xmem"], seed, device)
    compared = []
    pairs = control_frames(spec, seed)
    for v in sorted({v for v, _ in pairs}):
        frames, mask0 = videos[v]
        stops = [t for u, t in pairs if u == v]
        out = ref_xmem.replay(w, lambda t: frames[t], mask0, cfg["xmem"], cfg["video"]["objects"],
                              C, stops, device)
        for t in stops:
            r = out[t]
            compared.append({"video": v, "t": t, "prob": r["prob"],
                             "index": r["prob"].argmax(0).to(torch.uint8).cpu().numpy(),
                             "readout": r["readout"], "read_elements": r["read_elements"]})
        common.free_device(device)
    del w
    worst = drv.reference_readings(cfg, seed, device, videos, compared,
                                   spec.limits["margins"], common.reference_mode(ctx))
    worst.pop("each")
    return {"kind": "control", "mode": C.name, "seed": seed, "frames": pairs, **worst}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="xmem-r50-bf16.davis480p")
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    spec = harness.Spec(args.workload)
    if device.type == "cuda":
        common.set_matmul_precision(spec.config)
    lower, upper = {}, {}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        r = calibrate.program_readings(spec, seed, args.seconds, device)
        common.free_device(device)
        calibrate.emit(r)
        for k, v in r.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool) and k != "seed":
                lower[k] = max(lower.get(k, v), v)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        r = control(spec, seed, device)
        common.free_device(device)
        calibrate.emit(r)
        for k, v in r.items():
            if isinstance(v, (int, float)) and k != "seed":
                upper[k] = min(upper.get(k, v), v)
    calibrate.emit({"kind": "summary", "workload": args.workload, "lower": lower,
                    "upper": upper, "power_limit": harness.power_limit()})
    return 0


if __name__ == "__main__":
    sys.exit(main())

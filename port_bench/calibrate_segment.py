#!/usr/bin/env python3
"""The readings that the segmentation cell's correctness limits are set from.

    python3 port_bench/calibrate_segment.py --seeds 1,2,... --control-seeds 3,4,5 \\
        [--workload gdino-swint-samh-bf16.segment-4v] [--seconds 3]

In one process, at the cell's own sizes: for each of ``--seeds`` a run of
the program (set-up, a short window, the check) and its compared numbers
against the reference, the lower readings; for each of ``--control-seeds``
the program's set-up (for the seed's box threshold), then the reference
one precision step below the configuration's (fp8 for bf16) in the
program's place, with its own choices, on the first ``samples`` requests
of the seed's sequence, held to the reference as the program is: the upper
readings. One JSON line per reading, then a summary: per number the
largest lower and the smallest upper reading. ``port_bench/run.py`` never
runs this.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from port_bench import calibrate, harness, weights_segment  # noqa: E402
from port_bench.drivers import common  # noqa: E402
from port_bench.drivers import segment as drv  # noqa: E402
from port_bench.reference import segment as ref_segment  # noqa: E402
from port_bench.reference.precision import CONTROL, MODES  # noqa: E402


def control(spec, seed: int, device) -> dict:
    """The control in the program's place on the seed's first requests."""
    probe = harness.Probe(torch.cuda.synchronize if device.type == "cuda" else lambda: None)
    cell = drv.Cell(harness.Context(spec, seed, device, probe))
    cell.setup()
    thr = cell.threshold
    cell.release()
    cfg, P = spec.config, common.reference_mode(cell.ctx)
    C = MODES[CONTROL[cfg["compute_dtype"]]]
    gw = weights_segment.gdino_weights(cfg["gdino"], seed, device)
    sw = weights_segment.sam_weights(cfg["sam"], seed, device)
    worst = {}
    with torch.no_grad():
        for k in range(int(spec.traffic["samples"])):
            images = cell.frames[cell.rig.position(k)]["color"]
            out = ref_segment.segment(gw, sw, images, cfg["queries"], thr, cfg["gdino"],
                                      cfg["sam"], C)
            scores = ref_segment.span_scores(out["det"]["logits"], out["det"]["spans"])[0]
            prog = {"found": out["found"], "scores": scores.cpu().numpy(),
                    "boxes": out["det"]["boxes"].double().cpu().numpy(), "emb": out["emb"],
                    "decoded": [(lg > 0, io) for lg, io in zip(out["logits"], out["iou"])],
                    "views": out["views"]}
            r = drv.readings(prog, images, out["det"]["select"], gw, sw, cfg, thr,
                             spec.limits["margins"], P)
            for key, v in r.items():
                worst[key] = max(worst.get(key, 0), v)
            common.free_device(device)
    return {"kind": "control", "mode": C.name, "seed": seed, "box_threshold": thr, **worst}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="gdino-swint-samh-bf16.segment-4v")
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
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
            if isinstance(v, (int, float)) and k not in ("seed", "box_threshold"):
                upper[k] = min(upper.get(k, v), v)
    calibrate.emit({"kind": "summary", "workload": args.workload, "lower": lower,
                    "upper": upper, "power_limit": harness.power_limit()})
    return 0


if __name__ == "__main__":
    sys.exit(main())

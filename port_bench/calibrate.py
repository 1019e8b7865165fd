#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 3,4,5 [--seconds 3] [--also-mode bf16]

(a cell of ``BENCHMARK.json``)

In one process, on the cell's own sizes: for each of ``--seeds`` a run of
the program (set-up, a short window at the cell's load, the check) and its
compared numbers against the reference, the lower readings; for each of
``--control-seeds`` the control, the reference computed one precision step
below the configuration's and put in the program's place, on the same
sampled inputs, the upper readings (``--also-mode`` names another mode to
read the same way, such as 'bf16' for a float32 configuration). One JSON
line per reading, then a summary: per number the largest lower and the
smallest upper reading. ``port_bench/run.py`` never runs this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from port_bench import harness, weights  # noqa: E402
from port_bench.drivers import common  # noqa: E402
from port_bench.reference import field  # noqa: E402
from port_bench.reference.precision import CONTROL, MODES  # noqa: E402


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def program_readings(spec, seed: int, seconds: float, device) -> dict:
    probe = harness.Probe(torch.cuda.synchronize if device.type == "cuda" else lambda: None)
    cell = harness.driver(spec)(harness.Context(spec, seed, device, probe))
    t0 = time.perf_counter()
    cell.setup()
    win = harness.window(cell, seconds, harness.Reservoir(int(spec.traffic["samples"]), seed))
    cell.release()
    checks = cell.check()
    return {"kind": "program", "seed": seed, "steps": win["steps"],
            "seconds": time.perf_counter() - t0, "correct": all(c["ok"] for c in checks.values()),
            **cell.last_readings}


def _inputs_cell(spec, seed: int, device):
    """A cell with the run's inputs (rig, frames, points) and no program."""
    cell = harness.driver(spec)(harness.Context(spec, seed, device, harness.Probe(lambda: None)))
    cell.rig = common.make_rig(cell.ctx)
    cell.frames = cell.rig.frame_pool()
    return cell


def query_control(spec, seed: int, mode: str, device) -> dict:
    """The control in the program's place on a run's sampled requests (the
    first ``samples`` requests of the seed's sequence)."""
    from port_bench.rig import query_points

    cell = _inputs_cell(spec, seed, device)
    tr, cfg = spec.traffic, spec.config
    cell.points = query_points(seed, tr["points"], tr["point_sets"], tr["box"])
    C, Pr = MODES[mode], common.reference_mode(cell.ctx)
    w = weights.dinov2_weights(cfg["model"], seed, device)
    worst = {}
    with torch.no_grad():
        for k in range(int(tr["samples"])):
            pos, pset = cell.rig.position(k), k % len(cell.points)
            frame = cell.frames[pos]
            desc_c = common.reference_descriptors(cell.ctx, w, frame, C)
            obs = common.obs_tensors(frame, device)
            pts = torch.as_tensor(cell.points[pset], device=device)
            out = {}
            for s in range(0, pts.shape[0], tr["check_block"]):
                blk = field.query(obs, desc_c, pts[s:s + tr["check_block"]], cfg["rig"]["mu"], C,
                                  tuple(tr["return_names"]))
                for name in ("dist", "valid_mask", *tr["return_names"]):
                    v = blk[name].float() if blk[name].is_floating_point() else blk[name]
                    out.setdefault(name, []).append(v)
            out = {k2: torch.cat(v) for k2, v in out.items()}
            desc_ref = common.reference_descriptors(cell.ctx, w, frame, Pr)
            r = cell.readings(desc_c.float(), out, pos, pset, desc_ref, Pr)
            for k2, v in r.items():
                worst[k2] = max(worst.get(k2, 0), v)
    return {"kind": "control", "mode": mode, "seed": seed, **worst}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--also-mode", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    spec = harness.Spec(args.workload)
    lower, upper = {}, {}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        r = program_readings(spec, seed, args.seconds, device)
        common.free_device(device)
        emit(r)
        for k, v in r.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool) and k not in ("seed",):
                lower[k] = max(lower.get(k, v), v)
    modes = [CONTROL[spec.config["compute_dtype"]]] + [m for m in args.also_mode.split(",") if m]
    for mode in modes:
        for seed in [int(s) for s in args.control_seeds.split(",") if s]:
            r = query_control(spec, seed, mode, device)
            common.free_device(device)
            emit(r)
            for k, v in r.items():
                if isinstance(v, (int, float)) and k != "seed":
                    upper.setdefault(mode, {})
                    upper[mode][k] = min(upper[mode].get(k, v), v)
    emit({"kind": "summary", "workload": args.workload, "lower": lower, "upper": upper,
          "power_limit": harness.power_limit()})
    return 0


if __name__ == "__main__":
    sys.exit(main())

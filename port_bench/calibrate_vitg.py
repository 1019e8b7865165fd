#!/usr/bin/env python3
"""The readings that the ViT-g/14-reg cell's correctness limits are set from.

    python3 port_bench/calibrate_vitg.py --workload vitg14reg-bf16.query-1m \\
        --seeds 1,2,... --control-seeds 3,4,5 [--seconds 3]

``calibrate.py``'s readings and control for this configuration's model:
``calibrate.py`` draws ViT-L's weights (``weights.py``) and runs
``reference/dinov2.py``, which hold no SwiGLU and no registers. Here the
control, the reference one precision step below the configuration's
(``CONTROL["bfloat16"]``: fp8 e4m3 products), runs
``reference/dinov2_vitg.py`` over ``weights_vitg.py``'s weights on the
same sampled inputs; the program's readings come from the cell's own
driver (``drivers/query_vitg.py``), as ``calibrate.py`` reads them. The
output is ``calibrate.py``'s. ``port_bench/run.py`` never runs this.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from port_bench import calibrate, weights_vitg  # noqa: E402
from port_bench.drivers import common  # noqa: E402
from port_bench.reference import field  # noqa: E402
from port_bench.reference.precision import MODES  # noqa: E402
from port_bench.rig import query_points  # noqa: E402


def query_control(spec, seed: int, mode: str, device) -> dict:
    """The control in the program's place on a run's sampled requests (the
    first ``samples`` requests of the seed's sequence)."""
    cell = calibrate._inputs_cell(spec, seed, device)
    tr, cfg = spec.traffic, spec.config
    cell.points = query_points(seed, tr["points"], tr["point_sets"], tr["box"])
    C, Pr = MODES[mode], common.reference_mode(cell.ctx)
    w = weights_vitg.vitg_weights(cfg["model"], seed, device)
    worst = {}
    with torch.no_grad():
        for k in range(int(tr["samples"])):
            pos, pset = cell.rig.position(k), k % len(cell.points)
            frame = cell.frames[pos]
            desc_c = cell.reference_descriptors(w, frame, C)
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
            desc_ref = cell.reference_descriptors(w, frame, Pr)
            r = cell.readings(desc_c.float(), out, pos, pset, desc_ref, Pr)
            for k2, v in r.items():
                worst[k2] = max(worst.get(k2, 0), v)
    return {"kind": "control", "mode": mode, "seed": seed, **worst}


def main(argv=None) -> int:
    calibrate.query_control = query_control  # calibrate.main's control, for this model
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())

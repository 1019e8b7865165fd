#!/usr/bin/env python3
"""Time the port's CUDA kernels of several checkouts against each other on
one card, with one timer.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 kernel_ab.py OLD . . OLD

Each argument is the root of a checkout of this repository, for example a
``git archive`` of the parent commit unpacked under ``build/``. For each
argument, in the order given, one process imports that checkout's
``d3fields_tpu_torch``, builds its kernels, holds its two kernel wrappers,
``fused_weighted_interp`` and ``deform_gather``, to their plain versions
and times them, on the same seeded inputs at the main path's shapes. The
inputs, the timer (``cuda_ms``) and the tolerance are this checkout's
``chip_smoke.py``'s, whatever the checkout under test: the wrappers'
signatures are the port's contract, so every checkout that has both
kernels takes part. Output: the card's name and power limit as nvidia-smi
gives them, then one JSON line per checkout and kernel shape.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke():
    """This checkout's chip_smoke.py, under a name of its own (the checkout
    under test may have one too)."""
    spec = importlib.util.spec_from_file_location(
        "kernel_ab_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_checkout(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import d3fields_tpu_torch
    from d3fields_tpu_torch import _build
    from d3fields_tpu_torch.fields import kernels
    from d3fields_tpu_torch.models.groundingdino import deform_gather as dg

    package = os.path.dirname(os.path.abspath(d3fields_tpu_torch.__file__))
    if os.path.dirname(package) != root:
        raise RuntimeError(f"imported {package}, not the package of {root}")
    smoke = _smoke()
    _build.build_all()
    dev = torch.device("cuda")
    cases = []
    V, hw, C, N, image_hw, xy_range = smoke.FUSED_SHAPES["main"]
    fused = smoke.kernel_inputs(dev, V, hw, C, N, image_hw, xy_range, seed=0)
    cases.append(("fused_weighted_interp", "main", kernels.fused_weighted_interp,
                  kernels.fused_weighted_interp_plain, fused))
    for seed, label in enumerate(smoke.GATHER_SHAPES):
        if label not in ("encoder", "decoder"):
            continue
        B, levels, nh, hd, P, Q, loc_range, nan_share = smoke.GATHER_SHAPES[label]
        value, loc, attn = smoke.gather_inputs(dev, B, levels, nh, hd, P, Q, loc_range,
                                               nan_share, seed=10 + seed)
        cases.append(("deform_gather", label, dg.deform_gather, dg.deform_gather_plain,
                      (value, levels, loc, attn)))
    for kernel, shape, fn, plain, args in cases:
        err, ok = smoke.compare(fn(*args), plain(*args))
        smoke.check(ok, f"{kernel} of {root} disagrees with its plain version at {shape}")
        smoke.emit({"phase": "kernel_ab", "checkout": root, "kernel": kernel, "shape": shape,
                    "ms": smoke.cuda_ms(lambda: fn(*args)), "max_abs_err": err})


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        time_checkout(os.path.abspath(argv[1]))
        return 0
    if not argv:
        print("usage: kernel_ab.py CHECKOUT [CHECKOUT ...]", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)
    for root in argv:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                       check=True, timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

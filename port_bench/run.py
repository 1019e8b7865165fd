#!/usr/bin/env python3
"""The benchmark of d3fields_tpu_torch: one run of one cell.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. It sets the cell up (weights and inputs from ``--seed``, every
shape of the cell warmed up), runs its closed loop for ``--seconds``
seconds, with ``--trace 1`` times the program's layers and profiles a few
more steps, holds sampled answers of the window to the plain reference
under ``port_bench/reference/``, and prints one JSON line:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each compared number
beside its limit, which are also the last lines of standard error.

It exits non-zero without a result where CUDA or the cards are missing, or
where a module of JAX, Flax or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed directory of the checkout."""
    cache = os.path.join(root, "build", "port_bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda"), ("D3F_NATIVE_CACHE", "native")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"  # transformers, if anything loads it, leaves JAX alone


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env(ROOT)
    sys.path.insert(0, ROOT)
    from port_bench import harness

    spec = harness.Spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"port_bench: {args.workload} needs {spec.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    if result is None:
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

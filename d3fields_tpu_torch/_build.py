"""The port's CUDA kernels: their sources, nvcc flags and build waves, and
the one path that launches them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is built and
loaded by :mod:`d3fields_tpu_torch.native_build` on first CUDA use into
``build/torch_kernels/lib<name>-<hash>.so`` of a writable checkout, else
into a per-user cache (``native_build.lib_dir``). Nothing is compiled or
loaded at import time: a machine without nvcc imports the package and runs
the kernels' plain versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import os
from typing import Callable, Dict, Iterable

import torch

from d3fields_tpu_torch import native_build

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
# the sources one load builds together, each wave one set of parallel
# nvcc: the field query's (its two kernels and DINOv2's attention), then
# segmentation's (the detector's gather and SAM's attention). A source
# builds with the first wave that names it, unless another wave built it
WAVES = (("fused_interp", "field_tile", "sam_attention"), ("deform_gather", "sam_attention"))
SOURCES = tuple(dict.fromkeys(name for wave in WAVES for name in wave))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# nvcc's messages of the last build of each source (native_build's log)
build_log = native_build.build_log


def _source(name: str) -> str:
    return os.path.join(CSRC, name + ".cu")


def lib_path(name: str) -> str:
    return native_build.library_path(_source(name), NVCC_FLAGS)


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source whose library is missing, one nvcc per
    source, all started together. Returns the seconds each build took."""
    return native_build.build([_source(n) for n in names], NVCC_FLAGS)


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` with ``declare`` applied
    once, built first if missing, with the other missing libraries of the
    first wave that names it (:data:`WAVES`)."""
    wave = next((w for w in WAVES if name in w), (name,))
    return native_build.load(_source(name), NVCC_FLAGS, declare, [_source(n) for n in wave])


def launch(name: str, device: torch.device, entry, *args) -> None:
    """One launch of kernel ``name``: its declared C entry ``entry`` called
    with ``args`` and the current stream of ``device``, under the device's
    guard. A nonzero return, a CUDA error code, raises RuntimeError. The
    wrappers count their own launches."""
    with torch.cuda.device(device):
        err = entry(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")

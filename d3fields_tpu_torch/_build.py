"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on first
CUDA use into ``build/torch_kernels/lib<name>-<hash>.so`` beside the
package, where ``<hash>`` covers the source and the flags, so an edited
source rebuilds and an unchanged one does not. Nothing is compiled or
loaded at import time: a machine without nvcc imports the package and runs
the kernels' plain versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "torch_kernels"
)
SOURCES = ("fused_interp", "deform_gather")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# nvcc's messages of the last build of each source (ptxas prints each
# kernel's registers, shared memory and spills there)
build_log: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of d3fields_tpu_torch are built "
            "on first use and need the CUDA toolkit (nvcc on PATH or CUDA_HOME)")
    return path


def lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source whose library is missing, one nvcc per
    source, all started together. Returns the seconds each build took."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = {}
    for name in names:
        lib = lib_path(name)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running[name] = (proc, tmp, lib, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, lib, t0) in running.items():
        out, err = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_log[name] = out + err
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{out}{err}")
            continue
        os.replace(tmp, lib)  # atomic: a reader never sees a half-written library
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    if name not in _libs:
        build_all((name,))
        _libs[name] = ctypes.CDLL(lib_path(name))
    return _libs[name]

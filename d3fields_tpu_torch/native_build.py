"""Build the port's native sources and load them with ctypes.

Counterpart of ``d3fields_tpu/native_build.py``, and the one mechanism for
both the host C++ sources (``<name>.cpp``: g++, :data:`GXX_FLAGS`) and the
CUDA kernels (``csrc/<name>.cu``: nvcc, ``_build.NVCC_FLAGS``). A source
compiles on first use into ``lib<name>-<hash>.so``, where ``<hash>``
covers the source and the flags: an edited source rebuilds, an unchanged
one does not, and the JAX package's libraries (written next to the
sources) are never touched. Host sources live in ``native/`` at the
repository root (shared with the JAX package: isosurface, point cloud) or
in the port's own ``d3fields_tpu_torch/native/`` (:data:`PORT_NATIVE_DIR`:
the PNG unfilter, the JPEG decoder, the affine warps). An installed wheel
carries the root's sources in ``d3fields_tpu_torch/_native_src/``
(``setup.py``'s build hook copies them there); :func:`find_source` looks
in the checkout first, then there.

The libraries go to ``build/native/`` (g++) or ``build/torch_kernels/``
(nvcc) of a writable checkout, else to a per-user cache (:func:`lib_dir`).
No expression is fused into a multiply-add unless the source asks for one
(``-ffp-contract=off``): the warps reproduce OpenCV's roundings. There is
no fallback: if the compiler fails, the error is raised.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Sequence

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
PORT_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
# an installed wheel's copy of NATIVE_DIR's sources (setup.py's build hook)
PKG_SRC_DIR = os.path.join(_PKG_DIR, "_native_src")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

# the compiler's messages of the last build of each source, by name (nvcc's
# ptxas prints each kernel's registers, shared memory and spills there)
build_log: Dict[str, str] = {}
_LOCK = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def lib_dir(kind: str, root: Optional[str] = None) -> str:
    """Where the compiled libraries of ``kind`` ('native' for g++, or
    'torch_kernels' for nvcc) go: ``<root>/build/<kind>`` when ``root`` is
    a checkout (it holds ``native/``) that this user may write, else
    ``<cache>/<kind>`` with the cache ``$D3F_NATIVE_CACHE`` or
    ``~/.cache/d3fields_tpu_torch`` (an installed wheel, a read-only
    tree). ``root`` defaults to the package's parent directory."""
    root = _REPO_ROOT if root is None else root
    if os.path.isdir(os.path.join(root, "native")) and os.access(root, os.W_OK):
        return os.path.join(root, "build", kind)
    cache = os.environ.get("D3F_NATIVE_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "d3fields_tpu_torch")
    return os.path.join(cache, kind)


def find_source(name: str, src_dir: Optional[str] = None) -> str:
    """The path of ``<name>.cpp`` in ``src_dir``; with no ``src_dir``, in the
    checkout's :data:`NATIVE_DIR`, then in the installed wheel's
    :data:`PKG_SRC_DIR`."""
    dirs = (NATIVE_DIR, PKG_SRC_DIR) if src_dir is None else (src_dir,)
    for d in dirs:
        path = os.path.join(d, name + ".cpp")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"{name}.cpp is in none of {list(dirs)}")


def library_path(src: str, flags: Sequence[str]) -> str:
    """The library the source file ``src`` compiles into with ``flags``."""
    name, suffix = os.path.splitext(os.path.basename(src))
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
    kind = "torch_kernels" if suffix == ".cu" else "native"
    return os.path.join(lib_dir(kind), f"lib{name}-{digest[:16]}.so")


def lib_path(name: str, src_dir: Optional[str] = None) -> str:
    return library_path(find_source(name, src_dir), GXX_FLAGS)


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of d3fields_tpu_torch are built "
            "on first use and need the CUDA toolkit (nvcc on PATH or CUDA_HOME)")
    return path


def build(srcs: Iterable[str], flags: Sequence[str]) -> Dict[str, float]:
    """Compile each source whose library is missing, one compiler per source
    (nvcc for ``.cu``, else g++), all started together, each into a
    temporary path renamed into place, so that a concurrent process never
    loads a half-written library. Returns the seconds each build took, by
    name."""
    running = {}
    for src in srcs:
        lib = library_path(src, flags)
        if os.path.exists(lib):
            continue
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        if src.endswith(".cu"):
            cmd = [_nvcc(), *flags, "-o", tmp, src]
            failure = f"nvcc failed for {os.path.relpath(src, _PKG_DIR)}"
        else:
            cmd, failure = ["g++", *flags, src, "-o", tmp], f"g++ failed for {src}"
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        name = os.path.splitext(os.path.basename(src))[0]
        running[name] = (proc, tmp, lib, failure, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, lib, failure, t0) in running.items():
        out, err = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_log[name] = out + err
        if proc.returncode != 0:
            failed.append(f"{failure}:\n{out}{err}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(src: str, flags: Sequence[str], declare: Callable[[ctypes.CDLL], None],
         wave: Iterable[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``src``, built first if missing (with the other
    missing libraries of ``wave``), and ``declare`` (the ``argtypes`` and
    ``restype`` of its entry points) applied once, when it is loaded."""
    with _LOCK:
        if src not in _libs:
            build(tuple(wave) or (src,), flags)
            handle = ctypes.CDLL(library_path(src, flags))
            declare(handle)
            _libs[src] = handle
        return _libs[src]


def load_native(name: str, declare: Callable[[ctypes.CDLL], None],
                src_dir: Optional[str] = None) -> ctypes.CDLL:
    """:func:`load` of the host source ``<name>.cpp`` (:func:`find_source`)."""
    return load(find_source(name, src_dir), GXX_FLAGS, declare)

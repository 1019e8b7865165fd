"""Build host C++ sources with g++ and load them with ctypes.

Counterpart of ``d3fields_tpu/native_build.py``. A source
``<src_dir>/<name>.cpp`` compiles on first use into
``build/native/lib<name>-<hash>.so`` beside the package, where ``<hash>``
covers the source and the flags: an edited source rebuilds, an unchanged
one does not, and the JAX package's libraries (written next to the
sources) are never touched. Sources live in ``native/`` at the repository
root (shared with the JAX package: isosurface, point cloud) or in the
port's own ``d3fields_tpu_torch/native/`` (:data:`PORT_NATIVE_DIR`: the
PNG unfilter, the JPEG decoder, the affine warps). No expression is
fused into a multiply-add unless the source asks for one
(``-ffp-contract=off``): the warps reproduce OpenCV's roundings. There
is no fallback: if g++ fails, the error is raised.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable, Dict

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
PORT_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

_LOCK = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def lib_path(name: str, src_dir: str = NATIVE_DIR) -> str:
    with open(os.path.join(src_dir, name + ".cpp"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def load_native(name: str, declare: Callable[[ctypes.CDLL], None],
                src_dir: str = NATIVE_DIR) -> ctypes.CDLL:
    """The loaded library of ``<src_dir>/<name>.cpp`` with ``declare``
    applied, built first if missing. The build writes to a temporary path
    and renames it, so a concurrent process never loads a half-written
    library."""
    src = os.path.join(src_dir, name + ".cpp")
    with _LOCK:
        if src not in _libs:
            lib = lib_path(name, src_dir)
            if not os.path.exists(lib):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{lib}.{os.getpid()}.tmp"
                r = subprocess.run(["g++", *GXX_FLAGS, src, "-o", tmp],
                                   capture_output=True, text=True)
                if r.returncode != 0:
                    raise RuntimeError(f"g++ failed for {os.path.relpath(src, _REPO_ROOT)}:\n"
                                       f"{r.stderr}")
                os.replace(tmp, lib)
            handle = ctypes.CDLL(lib)
            declare(handle)
            _libs[src] = handle
        return _libs[src]

"""Build host C++ sources with g++ and load them with ctypes.

Counterpart of ``d3fields_tpu/native_build.py``. A source ``<name>.cpp``
compiles on first use into ``lib<name>-<hash>.so``, where ``<hash>``
covers the source and the flags: an edited source rebuilds, an unchanged
one does not, and the JAX package's libraries (written next to the
sources) are never touched. Sources live in ``native/`` at the repository
root (shared with the JAX package: isosurface, point cloud) or in the
port's own ``d3fields_tpu_torch/native/`` (:data:`PORT_NATIVE_DIR`: the
PNG unfilter, the JPEG decoder, the affine warps). An installed wheel
carries the root's sources in ``d3fields_tpu_torch/_native_src/``
(``setup.py``'s build hook copies them there); :func:`find_source` looks
in the checkout first, then there.

The libraries go to ``build/native/`` of a writable checkout, else to a
per-user cache (:func:`lib_dir`): ``$D3F_NATIVE_CACHE`` or
``~/.cache/d3fields_tpu_torch``. No expression is fused into a
multiply-add unless the source asks for one (``-ffp-contract=off``): the
warps reproduce OpenCV's roundings. There is no fallback: if g++ fails,
the error is raised.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable, Dict, Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
PORT_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
# an installed wheel's copy of NATIVE_DIR's sources (setup.py's build hook)
PKG_SRC_DIR = os.path.join(_PKG_DIR, "_native_src")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

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


def lib_path(name: str, src_dir: Optional[str] = None) -> str:
    with open(find_source(name, src_dir), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return os.path.join(lib_dir("native"), f"lib{name}-{digest[:16]}.so")


def load_native(name: str, declare: Callable[[ctypes.CDLL], None],
                src_dir: Optional[str] = None) -> ctypes.CDLL:
    """The loaded library of ``<name>.cpp`` (found by :func:`find_source`)
    with ``declare`` applied, built first if missing. The build writes to
    a temporary path and renames it, so a concurrent process never loads a
    half-written library."""
    src = find_source(name, src_dir)
    with _LOCK:
        if src not in _libs:
            lib = lib_path(name, src_dir)
            if not os.path.exists(lib):
                os.makedirs(os.path.dirname(lib), exist_ok=True)
                tmp = f"{lib}.{os.getpid()}.tmp"
                r = subprocess.run(["g++", *GXX_FLAGS, src, "-o", tmp],
                                   capture_output=True, text=True)
                if r.returncode != 0:
                    raise RuntimeError(f"g++ failed for {src}:\n{r.stderr}")
                os.replace(tmp, lib)
            handle = ctypes.CDLL(lib)
            declare(handle)
            _libs[src] = handle
        return _libs[src]

"""Build the C++ host runtime in ``native/`` with g++ and load it with ctypes.

Counterpart of ``d3fields_tpu/native_build.py``. ``native/<name>.cpp`` (at
the repository root, shared with the JAX package) compiles on first use
into ``build/native/lib<name>-<hash>.so`` beside the package, where
``<hash>`` covers the source and the flags: an edited source rebuilds, an
unchanged one does not, and the JAX package's libraries (written next to
the sources) are never touched. There is no fallback: if g++ fails, the
error is raised.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable, Dict

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def lib_path(name: str) -> str:
    with open(os.path.join(NATIVE_DIR, name + ".cpp"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def load_native(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp`` with ``declare`` applied,
    built first if missing. The build writes to a temporary path and
    renames it, so a concurrent process never loads a half-written library."""
    with _LOCK:
        if name not in _libs:
            lib = lib_path(name)
            if not os.path.exists(lib):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{lib}.{os.getpid()}.tmp"
                src = os.path.join(NATIVE_DIR, name + ".cpp")
                r = subprocess.run(["g++", *GXX_FLAGS, src, "-o", tmp],
                                   capture_output=True, text=True)
                if r.returncode != 0:
                    raise RuntimeError(f"g++ failed for native/{name}.cpp:\n{r.stderr}")
                os.replace(tmp, lib)
            handle = ctypes.CDLL(lib)
            declare(handle)
            _libs[name] = handle
        return _libs[name]

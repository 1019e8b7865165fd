"""ctypes bridge to the native isosurface library (native/isosurface.cpp).

Counterpart of ``d3fields_tpu/mesh/_native.py``. The library is built with
g++ on first use by :mod:`d3fields_tpu_torch.native_build`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from d3fields_tpu_torch.native_build import load_native


def _declare(lib: ctypes.CDLL) -> None:
    lib.iso_marching_tetrahedra.restype = ctypes.c_int
    lib.iso_marching_tetrahedra.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.iso_free.restype = None
    lib.iso_free.argtypes = [ctypes.c_void_p]


def marching_tetrahedra(
    volume: np.ndarray, iso: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of a 3D scalar volume.

    Args:
      volume: (n0, n1, n2) float array.
      iso: iso value.

    Returns:
      vertices: (NV, 3) float32 in grid-index coordinates (d0, d1, d2).
      triangles: (NT, 3) int32 vertex indices.
    """
    lib = load_native("isosurface", _declare)
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    n0, n1, n2 = vol.shape
    verts_p = ctypes.POINTER(ctypes.c_float)()
    tris_p = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int()
    nt = ctypes.c_int()
    rc = lib.iso_marching_tetrahedra(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n0,
        n1,
        n2,
        float(iso),
        ctypes.byref(verts_p),
        ctypes.byref(tris_p),
        ctypes.byref(nv),
        ctypes.byref(nt),
    )
    if rc != 0:
        raise RuntimeError(f"isosurface extraction failed with code {rc}")
    try:
        if nv.value == 0:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
        verts = np.ctypeslib.as_array(verts_p, shape=(nv.value, 3)).copy()
        tris = np.ctypeslib.as_array(tris_p, shape=(nt.value, 3)).copy()
    finally:
        lib.iso_free(verts_p)
        lib.iso_free(tris_p)
    return verts, tris

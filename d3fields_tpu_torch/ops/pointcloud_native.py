"""ctypes bridge to the native point-cloud runtime (native/pointcloud.cpp).

Counterpart of ``d3fields_tpu/ops/pointcloud_native.py``: replaces the
reference's Open3D C++ calls (voxel downsample ``utils/draw_utils.py:314-323``,
statistical outlier removal ``vis_repr.py:79``) and runs the FPS host loop
(``utils/my_utils.py:478-497``) in C++. The library is built with g++ on
first use by :mod:`d3fields_tpu_torch.native_build`; there is no numpy
fallback.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from d3fields_tpu_torch.native_build import load_native


def _declare(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.pc_voxel_downsample.restype = ctypes.c_int64
    lib.pc_voxel_downsample.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_float, i64p,
    ]
    lib.pc_statistical_outliers.restype = ctypes.c_int64
    lib.pc_statistical_outliers.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_float, u8p,
    ]
    lib.pc_fps.restype = None
    lib.pc_fps.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i64p, f32p,
    ]


def _load() -> ctypes.CDLL:
    return load_native("pointcloud", _declare)


def _f32c(pts: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(pts, np.float32)


def voxel_downsample_indices(pts: np.ndarray, voxel: float) -> np.ndarray:
    """Indices of the first point per occupied voxel (input order)."""
    lib = _load()
    pts = _f32c(pts)
    out = np.empty(pts.shape[0], np.int64)
    kept = lib.pc_voxel_downsample(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pts.shape[0],
        ctypes.c_float(voxel),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out[:kept]


def statistical_outlier_mask(pts: np.ndarray, nb_neighbors: int = 5,
                             std_ratio: float = 0.2) -> np.ndarray:
    """Boolean keep-mask (Open3D remove_statistical_outlier semantics)."""
    lib = _load()
    pts = _f32c(pts)
    n = pts.shape[0]
    if n <= nb_neighbors:
        return np.ones(n, bool)
    mask = np.empty(n, np.uint8)
    lib.pc_statistical_outliers(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        nb_neighbors, ctypes.c_float(std_ratio),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return mask.astype(bool)


def fps_native(pts: np.ndarray, m: int, init_idx: int = -1
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(sampled points, their indices), with ``fps_np``'s semantics:
    ``init_idx=-1`` draws a random start, and a set smaller than ``m`` is
    padded as ``fps_np`` pads it."""
    lib = _load()
    pts = _f32c(pts)
    n = pts.shape[0]
    m_req = m
    m = min(m, n)
    if init_idx < 0:
        init_idx = int(np.random.randint(n))
    idx = np.empty(m, np.int64)
    dist = np.empty(n, np.float32)
    lib.pc_fps(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, m,
        init_idx, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dist.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return _pad_fps(pts, idx, m_req)


def _pad_fps(pts: np.ndarray, idx: np.ndarray, m_req: int):
    """fps_np always returns exactly particle_num points: once every point
    is selected the min-distance field is all zeros and argmax keeps
    returning index 0 (``utils/my_utils.py:478-497``); replicate that
    duplicate-padding so callers can stack fixed-size keypoint sets."""
    if idx.shape[0] < m_req:
        idx = np.concatenate([idx, np.zeros(m_req - idx.shape[0], np.int64)])
    return pts[idx], idx

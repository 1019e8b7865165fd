"""Artifact I/O.

Counterpart of ``d3fields_tpu/utils/io.py:62-97``: meshes as ASCII PLY and
pickles. ``load_frame`` (the reference's recorded-scene layout) is not
ported yet.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np


def save_ply(path: str, vertices: np.ndarray, triangles: np.ndarray,
             colors: Optional[np.ndarray] = None) -> None:
    """ASCII PLY with optional per-vertex uint8 colors."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(triangles)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(vertices):
            line = f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}"
            if has_color:
                c = colors[i]
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")
        for tri in triangles:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")


def save_pickle(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)

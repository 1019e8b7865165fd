"""Scene and artifact I/O.

Counterpart of ``d3fields_tpu/utils/io.py``. Loads the reference's
recorded-scene layout (``vis_repr.py:57-69``, ``vis_tracking.py:70-85``):

  data_path/
    camera_{i}/
      color/{t}.png          (BGR uint8)
      depth/{t}.png          (uint16 millimeters)
      camera_extrinsics.npy  (4x4 world->cam)
      camera_params.npy      (fx, fy, cx, cy)

through the PNG codec of :mod:`d3fields_tpu_torch.utils.png` (no OpenCV),
writes that layout (:func:`save_frame`), and writes meshes as ASCII PLY
and pickles.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from d3fields_tpu_torch.utils.png import imread_anydepth, imread_color, save_png


def load_frame(data_path: str, t: int, num_cam: int) -> dict:
    """One timestep -> reference obs dict {color (BGR), depth (m), pose, K}."""
    colors, depths, poses, Ks = [], [], [], []
    for i in range(num_cam):
        cam = os.path.join(data_path, f"camera_{i}")
        color_path = os.path.join(cam, "color", f"{t}.png")
        depth_path = os.path.join(cam, "depth", f"{t}.png")
        for path in (color_path, depth_path):
            if not os.path.isfile(path):
                raise FileNotFoundError(path)
        depth = imread_anydepth(depth_path).astype(np.float32) / 1000.0
        ext = np.load(os.path.join(cam, "camera_extrinsics.npy"))
        fx, fy, cx, cy = np.load(os.path.join(cam, "camera_params.npy"))[:4]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        colors.append(imread_color(color_path))
        depths.append(depth)
        poses.append(np.asarray(ext, np.float32)[:3])
        Ks.append(K)
    return {
        "color": np.stack(colors),
        "depth": np.stack(depths),
        "pose": np.stack(poses),
        "K": np.stack(Ks),
    }


def num_frames(data_path: str, cam: int = 0) -> int:
    d = os.path.join(data_path, f"camera_{cam}", "color")
    return len([f for f in os.listdir(d) if f.endswith(".png")])


def save_frame(data_path: str, t: int, obs: dict) -> None:
    """Write timestep ``t`` of an obs dict {color (V, H, W, 3) BGR uint8,
    depth (V, H, W) metres, pose (V, 3|4, 4), K (V, 3, 3)} in the layout
    :func:`load_frame` reads: depth rounded to uint16 millimetres, the 4x4
    extrinsics and (fx, fy, cx, cy) of each camera."""
    for i in range(obs["color"].shape[0]):
        cam = os.path.join(data_path, f"camera_{i}")
        for sub in ("color", "depth"):
            os.makedirs(os.path.join(cam, sub), exist_ok=True)
        save_png(os.path.join(cam, "color", f"{t}.png"), np.asarray(obs["color"][i], np.uint8))
        mm = np.clip(np.round(np.asarray(obs["depth"][i], np.float64) * 1000.0), 0, 65535)
        save_png(os.path.join(cam, "depth", f"{t}.png"), mm.astype(np.uint16))
        ext = np.eye(4, dtype=np.float32)
        ext[:3] = np.asarray(obs["pose"][i], np.float32)[:3]
        K = np.asarray(obs["K"][i], np.float32)
        np.save(os.path.join(cam, "camera_extrinsics.npy"), ext)
        np.save(os.path.join(cam, "camera_params.npy"),
                np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32))


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

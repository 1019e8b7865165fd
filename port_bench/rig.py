"""The benchmark's inputs: a drifting-sphere RGB-D rig and query points, in numpy.

A frozen copy of the port's synthetic rig (``utils/synthetic.py::
render_sphere_scene`` and ``apps/vis_tracking.py::synthetic_frame``), kept
here so that a change to the program cannot change the yardstick. Two
spheres over a ground plane, seen by a ring of inward-looking cameras that
aim at the spheres' base layout; the spheres drift by a fixed step a frame.
Two changes from the port's copy, both drawn from the seed:

- each sphere carries a colour texture fixed to its own surface (a sum of
  sinusoids of the sphere-local point), so that image descriptors move with
  the object, as real ones do on textured objects;
- the drift runs back and forth (a triangle wave over ``positions``
  frames), so that a pool of pre-rendered frames serves a window of any
  length with the same step between consecutive frames.

No descriptors are rendered: the cells run DINOv2 on the colour images.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

SPHERES = (((0.0, 0.0, 0.06), 0.12), ((0.18, 0.05, 0.05), 0.07))
HUES = ((60, 120, 220), (220, 120, 60))
GROUND_RGB = (90, 90, 90)
SKY_RGB = (40, 40, 40)


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use of ``seed`` (any whole number)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def rig_cameras(num_views: int, H: int, W: int, focal: float, look_at: np.ndarray):
    """(poses (V, 3, 4) world->camera, K (3, 3), camera centres (V, 3))."""
    K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]], np.float32)
    poses, centres = [], []
    for v in range(num_views):
        ang = 2 * np.pi * v / num_views
        cam = look_at + np.array([0.6 * np.cos(ang), 0.6 * np.sin(ang), 0.45])
        fwd = (look_at - cam) / np.linalg.norm(look_at - cam)
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])
        poses.append(np.concatenate([R, (-R @ cam)[:, None]], 1).astype(np.float32))
        centres.append(cam)
    return np.stack(poses), K, np.stack(centres)


class Rig:
    """The rig of one run: cameras, sphere textures and the drift, from the seed."""

    def __init__(self, seed: int, views: int, height: int, width: int, rig: dict):
        self.V, self.H, self.W = views, height, width
        self.focal = float(rig["focal"])
        self.drift = np.asarray(rig["drift_per_frame"], np.float64)  # (S, 3)
        self.positions = int(rig["positions"])
        self.centres = np.array([c for c, _ in SPHERES], np.float64)
        self.radii = np.array([r for _, r in SPHERES], np.float64)
        self.poses, self.K, self.cam_centres = rig_cameras(
            views, height, width, self.focal, self.centres.mean(0))
        rng = seed_rng(seed, 1)
        n = int(rig["texture_waves"])
        # per sphere: n directions with wavelengths in [lo, hi] metres, phases
        lo, hi = rig["texture_wavelength_m"]
        dirs = rng.standard_normal((len(SPHERES), n, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        self.wave = dirs * (2 * np.pi / rng.uniform(lo, hi, (len(SPHERES), n, 1)))
        self.phase = rng.uniform(0, 2 * np.pi, (len(SPHERES), n))
        self.start = int(rng.integers(0, 2 * (self.positions - 1)))

    def position(self, k: int) -> int:
        """The drift position of the k-th frame served: a triangle wave."""
        p = (self.start + k) % (2 * (self.positions - 1))
        return p if p < self.positions else 2 * (self.positions - 1) - p

    def render(self, position: int) -> Dict[str, np.ndarray]:
        """The observation at one drift position: 'color' (V, H, W, 3) uint8
        (BGR order is not modelled: the channels are as rendered), 'depth'
        (V, H, W) float32, 'pose' (V, 3, 4), 'K' (V, 3, 3) and 'mask' (V, H,
        W, 1 + S) float32 one-hot (background first)."""
        V, H, W = self.V, self.H, self.W
        centres = self.centres + self.drift * position
        cx, cy = W / 2.0, H / 2.0
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        dirs = np.stack([(xs - cx) / self.focal, (ys - cy) / self.focal, np.ones_like(xs)], -1)
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        S = len(self.radii)
        depth = np.zeros((V, H, W), np.float32)
        color = np.empty((V, H, W, 3), np.uint8)
        mask = np.zeros((V, H, W, 1 + S), np.float32)
        for v in range(V):
            R = self.poses[v][:, :3].astype(np.float64)
            cam = self.cam_centres[v]
            dw = dirs @ R
            best = np.full((H, W), np.inf)
            which = np.full((H, W), -1)
            for s in range(S):
                oc = cam - centres[s]
                b = 2 * (dw @ oc)
                disc = b * b - 4 * (oc @ oc - self.radii[s] ** 2)
                hit = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / 2, np.inf)
                hit = np.where(hit > 0, hit, np.inf)
                closer = hit < best
                best = np.where(closer, hit, best)
                which = np.where(closer, s, which)
            dz = dw[..., 2]
            plane = np.where(dz < -1e-6, -cam[2] / dz, np.inf)
            closer = plane < best
            best = np.where(closer, plane, best)
            which = np.where(closer, -1, which)
            hit = np.isfinite(best)
            depth[v] = np.where(hit, np.where(hit, best, 0.0) * (dw @ R[2]), 0.0)
            img = np.empty((H, W, 3), np.float64)
            img[:] = SKY_RGB
            img[hit & (which == -1)] = GROUND_RGB
            mask[v, ..., 0] = (which == -1).astype(np.float32)
            for s in range(S):
                sel = which == s
                local = cam + best[sel][:, None] * dw[sel] - centres[s]  # sphere-local point
                shade = 0.55 + 0.45 * np.mean(
                    np.sin(local @ self.wave[s].T + self.phase[s]), axis=-1)
                img[sel] = np.asarray(HUES[s % len(HUES)], np.float64) * shade[:, None]
                mask[v, ..., 1 + s] = sel.astype(np.float32)
            color[v] = np.clip(np.round(img), 0, 255).astype(np.uint8)
        return {"color": color, "depth": depth, "pose": self.poses.copy(),
                "K": np.tile(self.K[None], (V, 1, 1)), "mask": mask}

    def frame_pool(self) -> List[Dict[str, np.ndarray]]:
        """Every drift position rendered once."""
        return [self.render(p) for p in range(self.positions)]


def query_points(seed: int, count: int, sets: int, box) -> List[np.ndarray]:
    """``sets`` arrays of ``count`` float32 points uniform in ``box``
    ([[x, y, z] lower, [x, y, z] upper])."""
    rng = seed_rng(seed, 2)
    lo, hi = np.asarray(box[0], np.float32), np.asarray(box[1], np.float32)
    return [(lo + (hi - lo) * rng.random((count, 3), dtype=np.float32)).astype(np.float32)
            for _ in range(sets)]

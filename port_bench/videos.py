"""The video cell's inputs: synthetic multi-object videos, in numpy.

Frozen here beside the benchmark, as ``rig.py`` is, so that a change to the
program cannot change the yardstick. A video holds ``objects`` textured
ellipses over a textured background:

- the background is a sum of coloured sinusoidal gratings that pans
  steadily, as a camera's slow motion moves a scene;
- each object carries a texture fixed to its own surface (a sum of
  sinusoids of the ellipse's own coordinates, shaded towards its rim), so
  that its features move with it;
- each object drifts on a path of its own (a sinusoid across the frame on
  each axis) and turns slowly; the objects are drawn back to front, so
  that their paths cross and they pass in front of one another;
- at the first frame the objects stand apart, each whole in the frame.

The first frame's index mask (0 the background, ``i + 1`` the frontmost
object ``i``) seeds the video. Every number is drawn from the seed and the
video's number.
"""

from __future__ import annotations

import numpy as np

from port_bench.rig import seed_rng


class Video:
    """One video: ``frames`` RGB frames (H, W, 3) uint8 and the first
    frame's index mask, drawn from ``seed`` and ``number``."""

    def __init__(self, seed: int, number: int, height: int, width: int, objects: int,
                 frames: int, p: dict):
        self.H, self.W, self.O, self.T = height, width, objects, frames
        rng = seed_rng(seed, 16 + number)
        n, short = int(p["texture_waves"]), min(height, width)
        lo, hi = p["wavelength_frac"]
        # background gratings: wave vectors (n, 2) in radians per pixel, phases, colours
        ang = rng.uniform(0, np.pi, n)
        k = 2 * np.pi / (rng.uniform(lo, hi, n) * short)
        self.bg_k = np.stack([k * np.cos(ang), k * np.sin(ang)], 1)
        self.bg_phase = rng.uniform(0, 2 * np.pi, n)
        self.bg_colour = rng.uniform(-1, 1, (n, 3)) * 40.0 / n
        self.bg_base = rng.uniform(70, 150, 3)
        pan = rng.uniform(0, 2 * np.pi)
        self.pan = p["pan_px_per_frame"] * np.array([np.cos(pan), np.sin(pan)])
        # objects: sizes, frame-0 centres apart, paths, spin, textures, hues
        r_lo, r_hi = p["radius_frac"]
        self.axes = np.stack([rng.uniform(r_lo, r_hi, objects) * short,
                              rng.uniform(r_lo, r_hi, objects) * short * p["aspect"]], 1)
        slot = rng.permutation(objects)
        self.centre0 = np.stack([width * (slot + 0.5) / objects
                                 + rng.uniform(-0.05, 0.05, objects) * width,
                                 height * rng.uniform(0.35, 0.65, objects)], 1)
        self.amp = rng.uniform(0.1, 0.25, (objects, 2)) * np.array([width, height])
        self.amp *= rng.choice([-1.0, 1.0], (objects, 2))
        self.period = rng.uniform(*p["path_period_frames"], (objects, 2))
        self.angle0 = rng.uniform(0, np.pi, objects)
        self.spin = rng.uniform(-1, 1, objects) * p["spin_rad_per_frame"]
        ang = rng.uniform(0, 2 * np.pi, (objects, n))
        k = 2 * np.pi / (rng.uniform(lo, hi, (objects, n)) * short * 0.5)
        self.obj_k = np.stack([k * np.cos(ang), k * np.sin(ang)], -1)
        self.obj_phase = rng.uniform(0, 2 * np.pi, (objects, n))
        self.hue = rng.uniform(40, 255, (objects, 3))

    def _background(self, t: int) -> np.ndarray:
        """(H, W, 3) float32: the gratings sin(kx x + ky y + phase) of the
        panned coordinates, each a sum of two outer products, mixed into
        the colour channels as one matrix product per channel."""
        x = np.arange(self.W) + self.pan[0] * t
        y = np.arange(self.H) + self.pan[1] * t
        a = self.bg_k[:, :1] * x[None]                              # (n, W)
        b = self.bg_k[:, 1:] * y[None] + self.bg_phase[:, None]     # (n, H)
        rows = np.concatenate([np.sin(b), np.cos(b)]).T.astype(np.float32)        # (H, 2n)
        cols = np.concatenate([np.cos(a), np.sin(a)]).astype(np.float32)          # (2n, W)
        colour = np.concatenate([self.bg_colour, self.bg_colour]).astype(np.float32)
        img = rows @ (cols[:, :, None] * colour[:, None, :]).reshape(len(cols), -1)
        return img.reshape(self.H, self.W, 3) + self.bg_base.astype(np.float32)

    def centre(self, t: int) -> np.ndarray:
        return self.centre0 + self.amp * np.sin(2 * np.pi * t / self.period)

    def render(self, t: int):
        """Frame t: (RGB (H, W, 3) uint8, index mask (H, W) uint8)."""
        img = self._background(t)
        index = np.zeros((self.H, self.W), np.uint8)
        centres = self.centre(t)
        for i in range(self.O):
            cx, cy = centres[i]
            a, b = self.axes[i]
            r = max(a, b)
            x0, x1 = max(int(cx - r), 0), min(int(cx + r) + 2, self.W)
            y0, y1 = max(int(cy - r), 0), min(int(cy + r) + 2, self.H)
            if x0 >= x1 or y0 >= y1:
                continue
            dx = (np.arange(x0, x1) - cx).astype(np.float32)[None, :]
            dy = (np.arange(y0, y1) - cy).astype(np.float32)[:, None]
            th = self.angle0[i] + self.spin[i] * t
            c, s = np.float32(np.cos(th)), np.float32(np.sin(th))
            u, v = dx * c + dy * s, dy * c - dx * s
            rho = (u / np.float32(a)) ** 2 + (v / np.float32(b)) ** 2
            inside = rho <= 1.0
            u, v = u[inside], v[inside]
            k, phase = self.obj_k[i].astype(np.float32), self.obj_phase[i].astype(np.float32)
            waves = np.sin(u[:, None] * k[:, 0] + v[:, None] * k[:, 1] + phase)
            shade = (0.65 + 0.35 * waves.mean(-1)) * (1.0 - 0.35 * rho[inside])
            img[y0:y1, x0:x1][inside] = shade[:, None] * self.hue[i].astype(np.float32)
            index[y0:y1, x0:x1][inside] = i + 1
        return np.clip(np.round(img), 0, 255).astype(np.uint8), index

    def render_all(self):
        """(frames (T, H, W, 3) uint8, the first frame's index mask (H, W) uint8)."""
        frames = np.empty((self.T, self.H, self.W, 3), np.uint8)
        mask0 = None
        for t in range(self.T):
            frames[t], index = self.render(t)
            if t == 0:
                mask0 = index
        return frames, mask0

"""Synthetic calibrated multi-view RGB-D scenes (checkpoint-free demos).

A copy of ``d3fields_tpu/utils/synthetic.py`` (numpy). Analytic sphere
rendering over a ring of inward-looking cameras — the same fixture family
the test suite uses. Lets every app run end-to-end (field
fusion, consensus masks, meshes, tracking) with zero model downloads: DINOv2
features are random-but-deterministic, masks come from the analytic sphere
hits via :class:`PrecomputedMaskBackend`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def render_sphere_scene(
    num_views: int = 4,
    H: int = 240,
    W: int = 320,
    feat_dim: int = 1024,
    seed: int = 0,
    spheres: Optional[Sequence[Tuple[Sequence[float], float]]] = None,
    sphere_offsets: Optional[np.ndarray] = None,
    ground: bool = True,
    focal: float = 260.0,
) -> dict:
    """Returns a reference-style obs dict plus per-sphere hit masks.

    ``sphere_offsets`` (S, 3) translates each sphere (video frames for
    tracking demos).
    """
    rs = np.random.RandomState(seed)
    if spheres is None:
        spheres = [([0.0, 0.0, 0.06], 0.12), ([0.18, 0.05, 0.05], 0.07)]
    centers = np.array([c for c, _ in spheres], np.float64)
    radii = np.array([r for _, r in spheres], np.float64)
    # camera rig aims at the BASE sphere layout: offsets animate the
    # objects, not the cameras, so multi-frame videos keep a static rig
    # (the recorded-scene layout tracking demos emulate)
    look_at = centers.mean(axis=0)
    if sphere_offsets is not None:
        centers = centers + np.asarray(sphere_offsets, np.float64)

    cx, cy = W / 2.0, H / 2.0
    K = np.array([[focal, 0, cx], [0, focal, cy], [0, 0, 1]], np.float32)

    poses, depths, masks, colors = [], [], [], []
    for v in range(num_views):
        ang = 2 * np.pi * v / num_views
        cam_pos = look_at + np.array([0.6 * np.cos(ang), 0.6 * np.sin(ang), 0.45])
        fwd = look_at - cam_pos
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])
        t = -R @ cam_pos
        poses.append(np.concatenate([R, t[:, None]], 1).astype(np.float32))

        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        dirs = np.stack([(xs - cx) / focal, (ys - cy) / focal, np.ones_like(xs)], -1)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        dirs_w = dirs @ R
        s_best = np.full((H, W), np.inf)
        which = np.full((H, W), -1)
        for si, (c, r) in enumerate(zip(centers, radii)):
            oc = cam_pos - c
            b = 2 * (dirs_w @ oc)
            cc = oc @ oc - r ** 2
            disc = b ** 2 - 4 * cc
            s = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / 2, np.inf)
            s = np.where(s > 0, s, np.inf)
            closer = s < s_best
            s_best = np.where(closer, s, s_best)
            which = np.where(closer, si, which)
        if ground:
            dz = dirs_w[..., 2]
            s_pl = np.where(dz < -1e-6, -cam_pos[2] / dz, np.inf)
            closer = s_pl < s_best
            s_best = np.where(closer, s_pl, s_best)
            which = np.where(closer, -1, which)
        hit = np.isfinite(s_best)
        z = np.where(hit, s_best, 0.0) * (dirs_w @ R[2])
        depths.append(np.where(hit, z, 0.0).astype(np.float32))
        masks.append(np.stack([(which == si) & hit for si in range(len(spheres))]))
        # flat-shaded color render: per-sphere hue + gray ground
        img = np.full((H, W, 3), 40, np.uint8)
        img[which == -1] = (90, 90, 90)
        hues = [(60, 120, 220), (220, 120, 60), (60, 220, 120), (200, 200, 60)]
        for si in range(len(spheres)):
            img[which == si] = hues[si % len(hues)]
        colors.append(img)

    ph, pw = H // 10, W // 10
    feats = _geometric_features(
        np.stack(depths), np.stack(poses), K, centers, np.stack(masks),
        (ph, pw), feat_dim, rs,
    )
    return {
        "color": np.stack(colors),
        "depth": np.stack(depths),
        "pose": np.stack(poses),
        "K": np.tile(K[None], (num_views, 1, 1)),
        "dino_feats": feats,
        "sphere_masks": np.stack(masks),
    }


def _geometric_features(
    depths: np.ndarray, poses: np.ndarray, K: np.ndarray,
    centers: np.ndarray, sphere_masks: np.ndarray,
    patch_hw: Tuple[int, int], feat_dim: int, rs,
) -> np.ndarray:
    """Descriptors anchored to object-local geometry.

    Each patch token encodes the surface point's coordinates in its sphere's
    LOCAL frame (sinusoids of a random projection), so descriptors translate
    with the object — rigid tracking through the field genuinely converges,
    like real DINOv2 features on textured objects. Background patches encode
    world coordinates.
    """
    V, H, W = depths.shape
    ph, pw = patch_hw
    proj = rs.randn(3, feat_dim).astype(np.float32) * 25.0
    ys = (np.arange(ph) + 0.5) * H / ph
    xs = (np.arange(pw) + 0.5) * W / pw
    yi = np.clip(ys.astype(int), 0, H - 1)
    xi = np.clip(xs.astype(int), 0, W - 1)
    feats = np.zeros((V, ph, pw, feat_dim), np.float32)
    for v in range(V):
        d = depths[v][yi[:, None], xi[None, :]]
        which = np.full((ph, pw), -1)
        for si in range(sphere_masks.shape[1]):
            m = sphere_masks[v, si][yi[:, None], xi[None, :]]
            which = np.where(m, si, which)
        gx, gy = np.meshgrid(xs, ys)
        x = (gx - K[0, 2]) / K[0, 0] * d
        y = (gy - K[1, 2]) / K[1, 1] * d
        cam = np.stack([x, y, d], -1)
        R, t = poses[v][:, :3], poses[v][:, 3]
        world = (cam - t) @ R  # R^T (cam - t)
        local = world.copy()
        for si in range(centers.shape[0]):
            local[which == si] -= centers[si]
        feats[v] = np.sin(local @ proj)
        feats[v][d < 1e-6] = 0.0
    return feats


def sphere_mask_backend(scene: dict, labels: Sequence[str]):
    """PrecomputedMaskBackend serving the analytic per-view sphere masks."""
    from d3fields_tpu_torch.seg.backends import PrecomputedMaskBackend, with_background

    views = []
    for v in range(scene["sphere_masks"].shape[0]):
        m = scene["sphere_masks"][v]
        views.append(
            with_background(m, list(labels), np.full(m.shape[0], 0.9, np.float32))
        )
    return PrecomputedMaskBackend(views)

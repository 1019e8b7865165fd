"""Headless visualization: colours, keypoint markers, point-cloud
aggregation, the tracking video and paletted index masks.

Counterpart of ``d3fields_tpu/utils/visualization.py`` with no OpenCV,
matplotlib or Pillow:

- :func:`draw_keypoints` fills each disc as ``cv2.circle(img, c, r, color,
  -1)`` does (OpenCV's midpoint ``Circle`` with LINE_8), pixel for pixel,
  clipped at the image border;
- :class:`TrackVis` shrinks each view with :func:`resize_area_u8`, OpenCV's
  ``INTER_AREA`` tables in float32 and its integer path at integer scales
  (equal to ``cv2.resize`` at the shapes the tests hold);
- :class:`TrackVis` writes ``tracking.avi``, uncompressed 24-bit frames
  (:mod:`d3fields_tpu_torch.utils.avi`), where the JAX package writes an
  mp4v ``tracking.mp4`` with ``cv2.VideoWriter``: the port has no video
  encoder to call;
- :func:`save_index_mask_png` writes the paletted PNG through
  :mod:`d3fields_tpu_torch.utils.png`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from d3fields_tpu_torch.ops.pointcloud_native import statistical_outlier_mask
from d3fields_tpu_torch.track.keypoints import project_to_view
from d3fields_tpu_torch.utils.avi import AviWriter
from d3fields_tpu_torch.utils.png import save_png


def jet_colors(values: np.ndarray) -> np.ndarray:
    """values in [0,1] -> (N, 3) RGB in [0,1] (matplotlib 'jet')."""
    v = np.clip(np.asarray(values, np.float64), 0, 1)
    r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
    return np.stack([r, g, b], -1)


def instance_palette(n: int) -> np.ndarray:
    """(n, 3) uint8 distinct colours (jet-spread, the reference's
    ``vis_curr_mask`` / ``create_instance_mask_mesh`` convention)."""
    if n <= 1:
        return np.zeros((max(n, 1), 3), np.uint8)
    return (jet_colors(np.arange(n) / (n - 1)) * 255).astype(np.uint8)


def blend_instance_mask(color_bgr: np.ndarray, index_mask: np.ndarray,
                        alpha: float = 0.5) -> np.ndarray:
    """Jet-coloured instance overlay (``Fusion.vis_curr_mask``,
    ``fusion.py:1687-1697``): color (H, W, 3) BGR uint8, index_mask (H, W)."""
    palette = instance_palette(int(index_mask.max()) + 1)
    overlay = palette[index_mask.astype(np.int64)][..., ::-1]  # BGR
    out = (1 - alpha) * color_bgr.astype(np.float32) + alpha * overlay
    return out.astype(np.uint8)


def _fill_disc(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    """OpenCV's filled ``Circle`` (midpoint, LINE_8): for each octant step
    (dx, dy), rows cy +- dy span cx +- dx and rows cy +- dx span cx +- dy."""
    H, W = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for y, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy), (cy + dx, dy)):
            x0, x1 = max(cx - half, 0), min(cx + half, W - 1)
            if 0 <= y < H and x0 <= x1:
                img[y, x0:x1 + 1] = color
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def draw_keypoints(img_bgr: np.ndarray, uv: np.ndarray,
                   colors: Optional[np.ndarray] = None,
                   radius: int = 4) -> np.ndarray:
    """Filled discs at integer pixel coords (``utils/draw_utils.py:97``);
    keypoints off the image are skipped. ``colors`` (N, 3) RGB uint8."""
    out = np.array(img_bgr, copy=True)
    H, W = out.shape[:2]
    n = uv.shape[0]
    if colors is None:
        colors = (jet_colors(np.arange(n) / max(n - 1, 1)) * 255).astype(np.uint8)
    for i, (u, v) in enumerate(np.asarray(uv, np.int64)):
        if 0 <= u < W and 0 <= v < H:
            _fill_disc(out, int(u), int(v), radius, np.asarray(colors[i])[::-1])
    return out


def _area_taps(ssize: int, dsize: int) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's ``computeResizeAreaTab``: per output pixel, the source
    indices and float32 weights of the cells it covers, padded with
    zero weights -> (dsize, taps) int64, (dsize, taps) float32."""
    scale = ssize / dsize
    rows = []
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    k = max(len(t) for t in rows)
    idx = np.zeros((dsize, k), np.int64)
    w = np.zeros((dsize, k), np.float32)
    for d, taps in enumerate(rows):
        for j, (s, a) in enumerate(taps):
            idx[d, j], w[d, j] = s, a
    return idx, w


def resize_area_u8(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` of an
    (H, W, C) uint8 image to a smaller size: the area tables of OpenCV's
    generic path, each row's taps and then each column's summed in float32
    in OpenCV's order, rounded half to even. At integer scales, OpenCV's
    fast path: block sums in integers, 2x2 blocks rounded half up."""
    H, W = img.shape[:2]
    h, w = out_hw
    if h > H or w > W:
        raise ValueError(f"resize_area_u8 shrinks; {H}x{W} -> {h}x{w} is not a shrink")
    if H % h == 0 and W % w == 0:
        sy, sx = H // h, W // w
        total = img.reshape(h, sy, w, sx, *img.shape[2:]).astype(np.int64).sum((1, 3))
        if sy * sx == 4:
            return ((total + 2) >> 2).astype(np.uint8)
        return np.rint(total * np.float32(1.0 / (sy * sx))).astype(np.uint8)
    xi, xw = _area_taps(W, w)
    yi, yw = _area_taps(H, h)
    src = img.astype(np.float32)
    rows = np.zeros((H, w) + img.shape[2:], np.float32)
    for j in range(xi.shape[1]):
        wj = xw[:, j].reshape((1, w) + (1,) * (img.ndim - 2))
        rows += src[:, xi[:, j]] * wj
    out = np.zeros((h, w) + img.shape[2:], np.float32)
    for j in range(yi.shape[1]):
        out += rows[yi[:, j]] * yw[:, j].reshape((h,) + (1,) * (img.ndim - 1))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def aggregate_colored_pcd(
    colors_rgb: np.ndarray, depths: np.ndarray, Ks: np.ndarray,
    poses44: np.ndarray, boundaries=None, downsample_voxel: float = 0.0,
    masks: Optional[np.ndarray] = None, max_depth: float = 1.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Backproject all views -> (points (N, 3), colors (N, 3) float [0,1]).

    ``aggr_point_cloud_from_data`` (``utils/draw_utils.py:325-413``) without
    Open3D: per view, backproject -> boundary filter -> the per-voxel
    centroid of points and colours (o3d ``voxel_down_sample``) ->
    concatenate across views.
    """
    pts_all, col_all = [], []
    V = depths.shape[0]
    b = None
    if boundaries is not None:
        b = boundaries.as_dict() if hasattr(boundaries, "as_dict") else boundaries
    for v in range(V):
        d = depths[v]
        sel = (d > 0) & (d < max_depth)
        if masks is not None:
            sel &= masks[v].astype(bool)
        ys, xs = np.nonzero(sel)
        z = d[ys, xs]
        K = Ks[v]
        x = (xs - K[0, 2]) / K[0, 0] * z
        y = (ys - K[1, 2]) / K[1, 1] * z
        cam = np.stack([x, y, z], -1)
        c2w = np.linalg.inv(poses44[v])
        world = cam @ c2w[:3, :3].T + c2w[:3, 3]
        cols_v = colors_rgb[v][ys, xs].astype(np.float32) / 255.0
        if b is not None:
            keep = (
                (world[:, 0] > b["x_lower"]) & (world[:, 0] < b["x_upper"])
                & (world[:, 1] > b["y_lower"]) & (world[:, 1] < b["y_upper"])
                & (world[:, 2] > b["z_lower"]) & (world[:, 2] < b["z_upper"])
            )
            world, cols_v = world[keep], cols_v[keep]
        if downsample_voxel > 0 and world.shape[0]:
            world, cols_v = _voxel_mean(world, cols_v, downsample_voxel)
        pts_all.append(world)
        col_all.append(cols_v)
    return np.concatenate(pts_all, 0), np.concatenate(col_all, 0)


def _voxel_mean(pts: np.ndarray, cols: np.ndarray, voxel: float):
    """Per-voxel centroid of points and colours (o3d ``voxel_down_sample``)."""
    vox = np.floor(pts / voxel).astype(np.int64)
    key = vox - vox.min(axis=0)
    dims = key.max(axis=0) + 1
    flat = (key[:, 0] * dims[1] + key[:, 1]) * dims[2] + key[:, 2]
    uniq, inv = np.unique(flat, return_inverse=True)
    counts = np.bincount(inv, minlength=uniq.shape[0]).astype(np.float64)
    out_p = np.zeros((uniq.shape[0], 3))
    out_c = np.zeros((uniq.shape[0], cols.shape[1]))
    np.add.at(out_p, inv, pts)
    np.add.at(out_c, inv, cols)
    return (out_p / counts[:, None]).astype(pts.dtype), (
        out_c / counts[:, None]
    ).astype(cols.dtype)


def remove_statistical_outliers(pts: np.ndarray, nb_neighbors: int = 5,
                                std_ratio: float = 0.2) -> np.ndarray:
    """Indices kept by o3d ``remove_statistical_outlier`` (``vis_repr.py:79``):
    drop points whose mean k-NN distance exceeds mean + std_ratio * std
    (native C++, ``native/pointcloud.cpp``; no numpy fallback)."""
    return np.nonzero(statistical_outlier_mask(pts, nb_neighbors, std_ratio))[0]


class TrackVis:
    """Per-frame keypoint-reprojection mosaic -> ``tracking.avi`` (and,
    with ``save_frames``, ``<t>.png`` per frame). ``utils/track_vis.py:42-139``
    minus the Open3D window."""

    def __init__(self, poses34: np.ndarray, Ks: np.ndarray, output_dir: str,
                 fps: int = 10, imshow_ratio: float = 0.7,
                 save_frames: bool = False):
        self.poses = np.asarray(poses34)
        self.Ks = np.asarray(Ks)
        self.output_dir = output_dir
        self.ratio = imshow_ratio
        self.save_frames = save_frames
        self.t = 0
        self.vid = AviWriter(os.path.join(output_dir, "tracking.avi"), fps=fps)
        os.makedirs(output_dir, exist_ok=True)

    def visualize_match_pts(self, match_pts_list: List[np.ndarray],
                            colors_bgr: np.ndarray,
                            track_info: Dict[str, dict]) -> np.ndarray:
        V, H, W = colors_bgr.shape[:3]
        rh, rw = int(H * self.ratio), int(W * self.ratio)
        rows = (V + 1) // 2
        mosaic = np.zeros((rh * rows, rw * 2, 3), np.uint8)
        pt_colors = np.concatenate(
            [np.asarray(track_info[k]["src_pts_color"]) for k in track_info], axis=0)
        all_pts = np.concatenate(match_pts_list, axis=0)
        for v in range(V):
            uv = project_to_view(all_pts, self.poses[v], self.Ks[v])
            img = resize_area_u8(draw_keypoints(colors_bgr[v], uv, pt_colors), (rh, rw))
            mosaic[(v // 2) * rh:(v // 2 + 1) * rh, (v % 2) * rw:(v % 2 + 1) * rw] = img
        self.vid.write(mosaic)
        if self.save_frames:
            save_png(os.path.join(self.output_dir, f"{self.t:06d}.png"), mosaic)
        self.t += 1
        return mosaic

    def close(self):
        self.vid.close()


def davis_palette(n: int = 256) -> np.ndarray:
    """The DAVIS / PASCAL-VOC label colormap ((n, 3) uint8 RGB), by the VOC
    bit shuffle: equal to the reference's table (``XMem/util/palette.py``)."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def save_index_mask_png(path: str, index_mask: np.ndarray) -> None:
    """An index mask as an 8-bit paletted PNG with the DAVIS palette (what
    the reference eval writes for davis2017-evaluation)."""
    save_png(path, np.asarray(index_mask).astype(np.uint8), palette=davis_palette())

"""Headless visualization: colours, keypoint markers, point-cloud
aggregation, the tracking video and paletted index masks.

Counterpart of ``d3fields_tpu/utils/visualization.py`` with no OpenCV,
matplotlib or Pillow:

- :func:`draw_keypoints` fills each disc as ``cv2.circle(img, c, r, color,
  -1)`` does (OpenCV's midpoint ``Circle`` with LINE_8), pixel for pixel,
  clipped at the image border; :func:`draw_line` draws ``cv2.line`` at any
  thickness, pixel for pixel (the interactive tools' strokes);
- :class:`TrackVis` shrinks each view with :func:`resize_area_u8`, OpenCV's
  ``INTER_AREA`` tables in float32 and its integer path at integer scales,
  and its fixed-point linear path where it enlarges (equal to
  ``cv2.resize`` at the shapes the tests hold);
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

from d3fields_tpu_torch.models.resize import linear_resize_u8
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


XY_SHIFT = 16  # OpenCV's drawing fixed point
XY_ONE = 1 << XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C's integer division, truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(W: int, H: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` on a W x H rectangle at the origin: the
    segment's ends moved onto the rectangle's border along the segment, in
    int64 with truncated double quotients, or None when it misses."""
    right, bottom = W - 1, H - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return None if c1 | c2 else (x1, y1, x2, y2)


def _line8(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, value) -> None:
    """A one-pixel line: OpenCV's 8-connected ``LineIterator`` (clipped to
    the image, walked left to right)."""
    H, W = img.shape[:2]
    if not (0 <= x1 < W and 0 <= x2 < W and 0 <= y1 < H and 0 <= y2 < H):
        clipped = _clip_line(W, H, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, sy = x2 - x1, abs(y2 - y1), 1 if y2 >= y1 else -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = value
        if err < 0:  # a diagonal step
            err += 2 * (dx - dy)
            x, y = x + 1, y + sy
        else:
            err -= 2 * dy
            x, y = (x, y + sy) if vert else (x + 1, y)


def _line_fixed(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, value) -> None:
    """OpenCV's ``Line2``: a one-pixel line between 16.16 fixed-point ends,
    clipped to the image scaled by XY_ONE."""
    H, W = img.shape[:2]
    clipped = _clip_line(W << XY_SHIFT, H << XY_SHIFT, x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    major_x = abs(dx) > abs(dy)
    if (dx if major_x else dy) < 0:
        x1, y1, x2, y2, dx, dy = x2, y2, x1, y1, -dx, -dy
    half = XY_ONE >> 1
    k = np.arange(((x2 - x1) if major_x else (y2 - y1)) // XY_ONE + 1, dtype=np.int64)
    if major_x:
        xs = ((x1 + half) >> XY_SHIFT) + k
        ys = (y1 + half + k * _tdiv(dy << XY_SHIFT, abs(dx) | 1)) >> XY_SHIFT
    else:
        xs = (x1 + half + k * _tdiv(dx << XY_SHIFT, abs(dy) | 1)) >> XY_SHIFT
        ys = ((y1 + half) >> XY_SHIFT) + k
    xs = np.append(xs, (x2 + half) >> XY_SHIFT)
    ys = np.append(ys, (y2 + half) >> XY_SHIFT)
    keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[keep], xs[keep]] = value


def _fill_convex_poly(img: np.ndarray, v, value) -> None:
    """OpenCV's ``FillConvexPoly`` with LINE_8 and 16.16 fixed-point
    vertices ``v``: the outline's fixed-point lines, then the scanlines
    between the two edge walkers."""
    H, W = img.shape[:2]
    n, delta = len(v), XY_ONE >> 1
    (px, py), imin = v[-1], 0
    ymin = ymax = v[0][1]
    xmin = xmax = v[0][0]
    for i, (x, y) in enumerate(v):
        if y < ymin:
            ymin, imin = y, i
        ymax, xmax, xmin = max(ymax, y), max(xmax, x), min(xmin, x)
        _line_fixed(img, px, py, x, y, value)
        px, py = x, y
    xmin, xmax = (xmin + delta) >> XY_SHIFT, (xmax + delta) >> XY_SHIFT
    ymin, ymax = (ymin + delta) >> XY_SHIFT, (ymax + delta) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= W or ymin >= H:
        return
    ymax = min(ymax, H - 1)
    idx_, di_, x_, dx_, ye_ = [imin, imin], [1, n - 1], [-XY_ONE, -XY_ONE], [0, 0], [ymin, ymin]
    edges, y = n, ymin
    while True:
        for i in range(2):
            if y < ye_[i]:
                continue
            idx0, di = idx_[i], di_[i]
            idx = (idx0 + di) % n
            while True:  # for (; edges-- > 0; )
                edges -= 1
                if edges < 0:
                    break
                ty = (v[idx][1] + delta) >> XY_SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    ye_[i], x_[i], idx_[i] = ty, xs, idx
                    dx_[i] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                    break
                idx0, idx = idx, (idx + di) % n
        if edges < 0:
            break
        if y >= 0:
            xx1, xx2 = ((min(x_) + delta) >> XY_SHIFT, (max(x_) + delta) >> XY_SHIFT)
            if xx2 >= 0 and xx1 < W:
                img[y, max(xx1, 0):min(xx2, W - 1) + 1] = value
        x_[0] += dx_[0]
        x_[1] += dx_[1]
        y += 1
        if y > ymax:
            break


def draw_line(img: np.ndarray, p0, p1, value, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, p0, p1, value, thickness)`` (LINE_8, integer ends)
    in place, pixel for pixel as OpenCV 5.0 draws it: at thickness 1 the
    8-connected line; thicker, the segment clipped to the image grown by
    ``thickness`` on every side, then the 16.16 fixed-point quadrilateral
    around it and a filled disc of radius ``(thickness + 1) // 2`` at each
    end (round caps; a zero-length line is the disc alone)."""
    (x0, y0), (x1, y1) = (tuple(int(c) for c in p) for p in (p0, p1))
    if thickness <= 1:
        _line8(img, x0, y0, x1, y1, value)
        return img
    H, W = img.shape[:2]
    t = thickness
    clipped = _clip_line(W + 2 * t, H + 2 * t, x0 + t, y0 + t, x1 + t, y1 + t)
    if clipped is None:
        return img
    x0, y0, x1, y1 = ((c - t) << XY_SHIFT for c in clipped)
    dx, dy = (x0 - x1) / XY_ONE, (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    half_width = t << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half_width + (t & 1) * XY_ONE * 0.5) / np.sqrt(r)
        ox, oy = round(dy * r), round(dx * r)  # cvRound: half to even
        _fill_convex_poly(img, [(x0 + ox, y0 + oy), (x0 - ox, y0 - oy),
                                (x1 - ox, y1 - oy), (x1 + ox, y1 + oy)], value)
    radius = (half_width + (XY_ONE >> 1)) >> XY_SHIFT
    for cx, cy in ((x0, y0), (x1, y1)):
        _fill_disc(img, (cx + (XY_ONE >> 1)) >> XY_SHIFT, (cy + (XY_ONE >> 1)) >> XY_SHIFT,
                   radius, value)
    return img


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
    (H, W) or (H, W, C) uint8 image. A shrink along both axes takes the
    area tables of OpenCV's generic path, each row's taps and then each
    column's summed in float32 in OpenCV's order, rounded half to even; at
    integer scales, OpenCV's fast path: block sums in integers, 2x2 blocks
    rounded half up. A resize that enlarges along either axis is OpenCV's
    fixed-point linear resize with the area taps
    (``models/resize.py::linear_resize_u8(..., area=True)``)."""
    H, W = img.shape[:2]
    h, w = out_hw
    if h > H or w > W:
        return linear_resize_u8(img, out_hw, area=True)
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

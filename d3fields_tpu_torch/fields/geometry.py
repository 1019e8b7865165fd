"""L0 geometry primitives in PyTorch.

Counterpart of ``d3fields_tpu/fields/geometry.py``:

- ``project_points``       <- reference ``fusion.py:32-55`` (project_points_coords)
- ``sample_map_bilinear`` / ``sample_map_nearest`` / ``interpolate_maps``
  <- reference ``fusion.py:57-77`` (interpolate_feats), with exact
  ``F.grid_sample`` semantics (zeros padding, align_corners=True) written
  as masked gathers
- ``bilinear_taps`` / ``bilinear_corner_weights``: the 4-tap decomposition
  the fused interpolation kernel consumes
- ``create_grid``          <- reference ``fusion.py:79-88`` (create_init_grid)
- ``instance_to_onehot`` / ``onehot_to_instance`` <- reference ``fusion.py:90-116``
- ``VoxelHash``            <- reference ``fusion.py:118-180`` (_init_low_level_memory)
- ``backproject_depth`` and the host helpers ``depth_to_points_np``,
  ``camera_to_world_np``, ``aggregate_masked_points_np`` and
  ``voxel_downsample_np`` <- reference ``utils/my_utils.py:522-537``
  (depth2fgpcd) and ``utils/draw_utils.py:325-413`` (aggr_point_cloud_from_data)

Every function keeps the JAX package's layouts (channels last, views first)
so the two packages compare like with like.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------

def project_points(
    pts: Tensor,
    pose: Tensor,
    K: Tensor,
    *,
    eps: float = 1e-4,
    depth_fill: float = 1e-3,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Project world points into every calibrated view.

    Args:
      pts: (N, 3) world-frame points.
      pose: (V, 3, 4) world->camera extrinsics ``[R|t]``.
      K: (V, 3, 3) intrinsics.

    Returns:
      xy: (V, N, 2) pixel coordinates.
      valid: (V, N) bool, False where ``|z| < eps``.
      depth: (V, N) z-depth with invalid entries replaced by ``depth_fill``.

    ``K @ [R|t]`` is formed first and then applied to homogeneous points, as
    in the reference. Both products are written out as elementwise sums in
    a fixed pairwise order, ``(a0 + a1) + (a2 + a3)``: the order XLA's dot
    takes on the CPU. A different order moves the last bit of ``xy``, which
    can flip the nearest depth pixel and with it the distance.
    """
    KRt = (K[:, :, 0:1] * pose[:, 0:1, :] + K[:, :, 1:2] * pose[:, 1:2, :]) \
        + K[:, :, 2:3] * pose[:, 2:3, :]  # (V, 3, 4)
    A = KRt[:, None]  # (V, 1, 3, 4)
    p = pts[None, :, None, :]  # (1, N, 1, 3)
    cam = (A[..., 0] * p[..., 0] + A[..., 1] * p[..., 1]) \
        + (A[..., 2] * p[..., 2] + A[..., 3])  # (V, N, 3)
    z = cam[..., 2]
    invalid = torch.abs(z) < eps
    depth = torch.where(invalid, torch.full_like(z, depth_fill), z)
    xy = cam[..., :2] / depth[..., None]
    return xy, torch.logical_not(invalid), depth


# ---------------------------------------------------------------------------
# grid_sample-parity interpolation
# ---------------------------------------------------------------------------

def _gather_hw(img: Tensor, iy: Tensor, ix: Tensor) -> Tensor:
    """Gather ``img[(iy, ix)]`` for flat integer index arrays. img: (h, w, C)."""
    h, w = img.shape[0], img.shape[1]
    return img.reshape(h * w, -1)[iy * w + ix]  # (N, C)


def _unnormalize(coord: Tensor, in_size: int, out_size: int, align_corners: bool) -> Tensor:
    """Map image-space pixel coord (0..in_size-1) to map-space continuous index.

    Two steps, as in the reference: normalise to [-1, 1] at the pixel
    extremes, then grid_sample's unnormalisation over a map of ``out_size``
    pixels. Folding them into one ratio changes the rounding, and the
    ``floor`` of the result picks the taps.
    """
    gn = coord / (in_size - 1) * 2.0 - 1.0
    if align_corners:
        return (gn + 1.0) * 0.5 * (out_size - 1)
    return ((gn + 1.0) * out_size - 1.0) * 0.5


def bilinear_corner_weights(
    xy: Tensor,
    image_hw: Tuple[int, int],
    map_hw: Tuple[int, int],
    *,
    align_corners: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The shared zeros-padding grid_sample corner decomposition.

    Returns (x0i (N,), y0i (N,) int32 floor corner, w (N, 4) bilinear
    weights in tap order (0,0),(0,1),(1,0),(1,1) with out-of-bounds taps
    zeroed).
    """
    H, W = image_hw
    h, w = map_hw
    ix = _unnormalize(xy[:, 0], W, w, align_corners)
    iy = _unnormalize(xy[:, 1], H, h, align_corners)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    tx = ix - x0
    ty = iy - y0
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    wgts = []
    for dy, dx, wgt in (
        (0, 0, (1 - tx) * (1 - ty)),
        (0, 1, tx * (1 - ty)),
        (1, 0, (1 - tx) * ty),
        (1, 1, tx * ty),
    ):
        inb = (
            (x0i + dx >= 0) & (x0i + dx <= w - 1)
            & (y0i + dy >= 0) & (y0i + dy <= h - 1)
        )
        wgts.append(wgt * inb.to(wgt.dtype))
    return x0i, y0i, torch.stack(wgts, dim=-1)


def bilinear_taps(
    xy: Tensor,
    image_hw: Tuple[int, int],
    map_hw: Tuple[int, int],
    *,
    align_corners: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Decompose bilinear sampling into 4 flat tap indices + weights.

    Returns (idx, w): idx (..., 4) int32 flat indices into a (h*w,) map (taps
    clamped in-bounds), w (..., 4) weights with out-of-bounds taps zeroed —
    exactly the zeros-padding grid_sample contribution. ``xy`` is (N, 2) or
    (V, N, 2); the form the fused interpolation kernel consumes.
    """
    if xy.dim() == 3:
        pairs = [bilinear_taps(p, image_hw, map_hw, align_corners=align_corners)
                 for p in xy]
        return (torch.stack([i for i, _ in pairs]),
                torch.stack([w for _, w in pairs]))
    h, w = map_hw
    x0i, y0i, wgts = bilinear_corner_weights(xy, image_hw, map_hw,
                                             align_corners=align_corners)
    idxs = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xc = torch.clamp(x0i + dx, 0, w - 1)
        yc = torch.clamp(y0i + dy, 0, h - 1)
        idxs.append(yc * w + xc)
    return torch.stack(idxs, dim=-1).to(torch.int32), wgts


def sample_map_bilinear(
    img: Tensor,
    xy: Tensor,
    image_hw: Tuple[int, int],
    *,
    align_corners: bool = True,
) -> Tensor:
    """Bilinear sample of one (h, w, C) map at (N, 2) image-space points.

    Matches ``F.grid_sample(mode='bilinear', padding_mode='zeros')`` fed with
    the reference's (W-1)/(H-1) normalisation. Returns (N, C).
    """
    h, w = img.shape[0], img.shape[1]
    x0i, y0i, wgts = bilinear_corner_weights(xy, image_hw, (h, w),
                                             align_corners=align_corners)
    x0i = x0i.long()
    y0i = y0i.long()
    out = None
    for tap, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        xc = torch.clamp(x0i + dx, 0, w - 1)
        yc = torch.clamp(y0i + dy, 0, h - 1)
        contrib = _gather_hw(img, yc, xc) * wgts[:, tap:tap + 1]
        out = contrib if out is None else out + contrib
    return out


def sample_map_nearest(
    img: Tensor,
    xy: Tensor,
    image_hw: Tuple[int, int],
    *,
    align_corners: bool = True,
) -> Tensor:
    """Nearest-neighbour sample, zeros padding, grid_sample parity.

    PyTorch rounds the source index half to even (``std::nearbyint``), and
    ``torch.round`` does the same.
    """
    H, W = image_hw
    h, w = img.shape[0], img.shape[1]
    ix = torch.round(_unnormalize(xy[:, 0], W, w, align_corners)).long()
    iy = torch.round(_unnormalize(xy[:, 1], H, h, align_corners)).long()
    inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
    tap = _gather_hw(img, torch.clamp(iy, 0, h - 1), torch.clamp(ix, 0, w - 1))
    return tap * inb.to(img.dtype)[:, None]


def interpolate_maps(
    maps: Tensor,
    xy: Tensor,
    image_hw: Tuple[int, int],
    *,
    mode: str = "bilinear",
    align_corners: bool = True,
) -> Tensor:
    """Per-view interpolation: maps (V, h, w, C), xy (V, N, 2) -> (V, N, C)."""
    fn = sample_map_bilinear if mode == "bilinear" else sample_map_nearest
    return torch.stack([
        fn(m, p, image_hw, align_corners=align_corners) for m, p in zip(maps, xy)
    ])


# ---------------------------------------------------------------------------
# Grid factory
# ---------------------------------------------------------------------------

def create_grid(boundaries, step_size: float) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Regular voxel-centre grid (host-side numpy, 'ij' order, flattened to (N, 3)).

    ``boundaries`` is a :class:`d3fields_tpu_torch.config.Boundaries` or a
    dict with x/y/z_lower/upper keys.
    """
    if hasattr(boundaries, "as_dict"):
        boundaries = boundaries.as_dict()
    axes = []
    for a in ("x", "y", "z"):
        lo, hi = boundaries[f"{a}_lower"], boundaries[f"{a}_upper"]
        axes.append(np.arange(lo, hi, step_size, dtype=np.float32) + step_size / 2)
    xx, yy, zz = np.meshgrid(*axes, indexing="ij")
    coords = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    return coords, xx.shape


# ---------------------------------------------------------------------------
# Label codecs
# ---------------------------------------------------------------------------

def instance_to_onehot(instance, num_instances: Optional[int] = None):
    """Index mask -> boolean one-hot. Works on numpy arrays or tensors."""
    if num_instances is None:
        num_instances = int(instance.max()) + 1
    if isinstance(instance, np.ndarray):
        return np.eye(num_instances, dtype=bool)[instance.astype(np.int64)]
    return torch.nn.functional.one_hot(instance.long(), num_instances).bool()


def onehot_to_instance(onehot):
    """One-hot / probabilistic mask -> uint8 index mask (argmax, last axis)."""
    if isinstance(onehot, np.ndarray):
        return np.argmax(onehot, axis=-1).astype(np.uint8)
    return torch.argmax(onehot, dim=-1).to(torch.uint8)


# ---------------------------------------------------------------------------
# Voxel hashing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VoxelHash:
    """Bounded-workspace voxel <-> flat-index codec on numpy arrays.

    Reference: ``_init_low_level_memory`` closures (``fusion.py:118-180``).
    """

    lower: Tuple[float, float, float]
    voxel_size: float
    dims: Tuple[int, int, int]

    @staticmethod
    def from_boundaries(boundaries, voxel_size: float) -> "VoxelHash":
        if hasattr(boundaries, "as_dict"):
            boundaries = boundaries.as_dict()
        lower = np.array([boundaries["x_lower"], boundaries["y_lower"], boundaries["z_lower"]])
        upper = np.array([boundaries["x_upper"], boundaries["y_upper"], boundaries["z_upper"]])
        dims = ((upper - lower) / voxel_size).astype(np.int32)
        return VoxelHash(tuple(lower.tolist()), float(voxel_size), tuple(int(d) for d in dims))

    def pcd_to_voxel(self, pts: np.ndarray) -> np.ndarray:
        lower = np.asarray(self.lower, dtype=pts.dtype)
        return np.floor((pts - lower) / self.voxel_size).astype(np.int32)

    def voxel_to_pcd(self, vox: np.ndarray) -> np.ndarray:
        return vox * self.voxel_size + np.asarray(self.lower)

    def voxel_to_index(self, vox: np.ndarray) -> np.ndarray:
        d1, d2 = self.dims[1], self.dims[2]
        return vox[..., 0] * (d1 * d2) + vox[..., 1] * d2 + vox[..., 2]

    def index_to_voxel(self, idx: np.ndarray) -> np.ndarray:
        d1, d2 = self.dims[1], self.dims[2]
        z = idx % d2
        rem = idx // d2
        y = rem % d1
        x = rem // d1
        return np.stack([x, y, z], axis=-1).astype(np.int32)

    def pcd_to_index(self, pts: np.ndarray) -> np.ndarray:
        return self.voxel_to_index(self.pcd_to_voxel(pts))

    def index_to_pcd(self, idx: np.ndarray) -> np.ndarray:
        return self.voxel_to_pcd(self.index_to_voxel(idx))


# ---------------------------------------------------------------------------
# Depth back-projection
# ---------------------------------------------------------------------------

def backproject_depth(depth: Tensor, K: Tensor) -> Tensor:
    """Backproject a full (H, W) depth map to (H, W, 3) camera-frame points
    on its device (``depth2fgpcd``, ``utils/my_utils.py:522-537``, without
    the compaction; callers mask as needed)."""
    H, W = depth.shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xs = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :]
    ys = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    X = (xs - cx) * depth / fx
    Y = (ys - cy) * depth / fy
    return torch.stack([X, Y, depth], dim=-1)


def depth_to_points_np(depth: np.ndarray, mask: np.ndarray, cam_params) -> np.ndarray:
    """Host-side compacting backprojection (exact ``depth2fgpcd`` semantics:
    masks out non-positive depth, returns (N, 3) camera-frame points)."""
    fx, fy, cx, cy = cam_params
    mask = np.logical_and(mask, depth > 0)
    ys, xs = np.nonzero(mask)
    z = depth[ys, xs]
    return np.stack([(xs - cx) * z / fx, (ys - cy) * z / fy, z], axis=-1)


def camera_to_world_np(pts_cam: np.ndarray, pose_w2c: np.ndarray) -> np.ndarray:
    """Transform camera-frame points to world frame given a 4x4 world->cam pose."""
    c2w = np.linalg.inv(pose_w2c)
    pts_h = np.concatenate([pts_cam, np.ones((pts_cam.shape[0], 1))], axis=-1)
    return (c2w @ pts_h.T)[:3].T


def aggregate_masked_points_np(
    depths: np.ndarray,
    Ks: np.ndarray,
    poses: np.ndarray,
    masks: Optional[np.ndarray] = None,
    boundaries=None,
    max_depth: float = 1.5,
) -> np.ndarray:
    """Aggregate per-view masked backprojections into one world-frame cloud.

    Host-side rewrite of ``aggr_point_cloud_from_data``
    (``utils/draw_utils.py:325-413``) minus Open3D: when ``masks`` is None the
    reference's default validity ``(depth>0) & (depth<1.5)`` applies, otherwise
    ``mask & (depth>0)``; points outside ``boundaries`` are dropped.
    ``poses`` are (V, 4, 4) world->camera.
    """
    clouds = []
    for i in range(depths.shape[0]):
        K = Ks[i]
        cam_params = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
        if masks is None:
            m = (depths[i] > 0) & (depths[i] < max_depth)
        else:
            m = masks[i] & (depths[i] > 0)
        pts_w = camera_to_world_np(depth_to_points_np(depths[i], m, cam_params), poses[i])
        if boundaries is not None:
            b = boundaries.as_dict() if hasattr(boundaries, "as_dict") else boundaries
            keep = (
                (pts_w[:, 0] > b["x_lower"]) & (pts_w[:, 0] < b["x_upper"]) &
                (pts_w[:, 1] > b["y_lower"]) & (pts_w[:, 1] < b["y_upper"]) &
                (pts_w[:, 2] > b["z_lower"]) & (pts_w[:, 2] < b["z_upper"])
            )
            pts_w = pts_w[keep]
        clouds.append(pts_w)
    if not clouds:
        return np.zeros((0, 3))
    return np.concatenate(clouds, axis=0)


def voxel_downsample_np(pts: np.ndarray, voxel_size: float) -> np.ndarray:
    """Voxel-grid downsample: mean of the points in each occupied voxel
    (replaces Open3D's ``voxel_down_sample``, ``fusion.py:716-722``)."""
    if pts.shape[0] == 0:
        return pts
    vox = np.floor(pts / voxel_size).astype(np.int64)
    key = (vox - vox.min(axis=0)).astype(np.int64)
    dims = key.max(axis=0) + 1
    flat = (key[:, 0] * dims[1] + key[:, 1]) * dims[2] + key[:, 2]
    uniq, inv = np.unique(flat, return_inverse=True)
    sums = np.zeros((uniq.shape[0], 3))
    np.add.at(sums, inv, pts)
    counts = np.bincount(inv, minlength=uniq.shape[0]).astype(np.float64)
    return sums / counts[:, None]

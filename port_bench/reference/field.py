"""The D3Fields field query, as the reference's ``Fusion.eval`` computes it.

After ``fusion.py:305-394`` of the reference: world points projected into
each view through ``K @ [R|t]`` (a depth under 1e-4 is invalid and replaced
by 1e-3 before the divide), the depth map read at the nearest pixel and the
descriptor and mask maps bilinearly, both as ``F.grid_sample`` with zeros
padding and ``align_corners=True`` over the image's (W-1, H-1) extent, a
view valid where its depth is positive, the point in front and the signed
distance over ``-mu``, weighted by ``exp(min(mu - |d|, 0) / mu)``, the
distance clamped to ``±mu``; the sums over valid views divided by their
count plus 1e-6; a point no view sees gets distance 1e3 and zero features.

The bilinear reads are written as their four taps, so that a mode can round
the descriptor table and each tap's weight as the configuration states
(``port_bench/tests`` holds them to ``F.grid_sample``). Points whose answer
f32 arithmetic cannot settle are marked ``ambiguous``: where a view's
nearest depth pixel lies within ``NEAREST_MARGIN`` pixels of a rounding
boundary, or the depth test or the validity threshold lies within a hair of
its edge. On either side of such an edge an answer is right.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from port_bench.reference.precision import Precision

Tensor = torch.Tensor

INVALID_DIST = 1e3
DEPTH_EPS = 1e-4
DEPTH_FILL = 1e-3
COUNT_EPS = 1e-6
# f32 places a projected pixel within ~1e-4 px of its float64 position at
# 240x320 (port_bench/tests/test_pb_reference.py measures it); ten times that
NEAREST_MARGIN = 1e-3
DIST_MARGIN = 1e-5


def project(pts: Tensor, pose: Tensor, K: Tensor, P: Precision):
    """(V, N, 2) pixel coordinates, (V, N) z, (V, N) in-front flags."""
    KRt = P.r(K @ pose)                                   # (V, 3, 4)
    cam = P.r(torch.einsum("vij,nj->vni", KRt[:, :, :3], pts) + KRt[:, None, :, 3])
    z = cam[..., 2]
    front = z.abs() >= DEPTH_EPS
    zf = torch.where(front, z, torch.full_like(z, DEPTH_FILL))
    return P.r(cam[..., :2] / zf[..., None]), z, front, zf


def _normalise(coord: Tensor, size: int, P: Precision) -> Tensor:
    """A pixel coordinate normalised to [-1, 1] over the image's extent
    ``size`` - 1 (the reference's ``normalize_coords``)."""
    return P.r(P.r(coord / (size - 1)) * 2 - 1)


def _taps(ix: Tensor, iy: Tensor, h: int, w: int):
    """Four bilinear taps: flat indices (clamped) and weights (zero outside)."""
    x0, y0 = torch.floor(ix), torch.floor(iy)
    tx, ty = ix - x0, iy - y0
    x0, y0 = x0.long(), y0.long()
    idx, wts = [], []
    for dy, dx, wt in ((0, 0, (1 - tx) * (1 - ty)), (0, 1, tx * (1 - ty)),
                       (1, 0, (1 - tx) * ty), (1, 1, tx * ty)):
        xs, ys = x0 + dx, y0 + dy
        inb = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        idx.append(ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1))
        wts.append(wt * inb.to(wt.dtype))
    return torch.stack(idx, -1), torch.stack(wts, -1)


def _map_index(g: Tensor, size: int, P: Precision) -> Tensor:
    """grid_sample's source index (align_corners=True) on a map of ``size``."""
    return P.r(P.r(g + 1) * 0.5 * (size - 1))


def query(obs: Dict[str, Tensor], desc: Optional[Tensor], pts: Tensor, mu: float,
          P: Precision, names=("dino_feats", "mask"),
          nearest_shift: Optional[Tensor] = None,
          flip_valid: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """The field at (N, 3) points.

    ``obs``: 'depth' (V, H, W), 'pose' (V, 3, 4), 'K' (V, 3, 3), 'mask' (V,
    H, W, NI), all on one device; ``desc`` (V, ph, pw, C). Computed in
    ``P.field_dtype``. ``nearest_shift`` (V, N, 2) long moves each view's
    nearest depth pixel by that many pixels in x and y (the other side of
    an ambiguous rounding), and ``flip_valid`` (V, N) bool turns a view's
    validity over (the other side of the threshold). Returns 'dist',
    'valid_mask', each of ``names``, 'ambiguous' (N,) bool, and the edges
    behind it: 'nearest_near_edge' (V, N, 2) with 'nearest_side', the
    shift to the other side, and 'threshold_near_edge' (V, N).
    """
    dt = P.field_dtype
    depth = P.r(obs["depth"].to(dt))
    V, H, W = depth.shape
    xy, z, front, zf = project(P.r(pts.to(dt)), obs["pose"].to(dt), obs["K"].to(dt), P)
    gx, gy = _normalise(xy[..., 0], W, P), _normalise(xy[..., 1], H, P)
    # the depth map: nearest pixel (round half to even, as grid_sample does)
    fx, fy = _map_index(gx, W, P), _map_index(gy, H, P)
    nx, ny = torch.round(fx).long(), torch.round(fy).long()
    if nearest_shift is not None:
        nx, ny = nx + nearest_shift[..., 0], ny + nearest_shift[..., 1]
    inb = (nx >= 0) & (nx < W) & (ny >= 0) & (ny < H)
    flat = (ny.clamp(0, H - 1) * W + nx.clamp(0, W - 1))
    inter = torch.gather(depth.reshape(V, H * W), 1, flat) * inb.to(dt)
    d = P.r(inter - zf)
    valid = (inter > 0) & front & (d > -mu)
    if flip_valid is not None:
        valid = valid ^ flip_valid
    weight = P.r(torch.exp(P.r(torch.clamp(mu - d.abs(), max=0.0) / mu)))
    vf = valid.to(dt)
    count = vf.sum(0)
    none = count == 0
    dist = P.r((torch.clamp(d, -mu, mu) * vf).sum(0) / (count + COUNT_EPS))
    out = {"dist": torch.where(none, torch.full_like(dist, INVALID_DIST), dist),
           "valid_mask": ~none}
    vw = vf * weight
    for name in names:
        m = desc if name == "dino_feats" else obs[name]
        _, h, w, C = m.shape
        mx, my = _map_index(gx, w, P), _map_index(gy, h, P)
        idx, tw = _taps(mx, my, h, w)
        if name == "dino_feats":
            table = P.table_round(m.to(dt))
            tw = P.table_round(P.r(tw * vw[..., None]))
        else:
            table = P.r(m.to(dt))
            tw = P.r(tw * vw[..., None])
        acc = torch.zeros(pts.shape[0], C, dtype=dt, device=pts.device)
        for v in range(V):
            rows = table[v].reshape(h * w, C)
            for t in range(4):
                acc = P.r(acc + rows[idx[v, :, t]] * tw[v, :, t, None])
        val = P.r(acc / (count[:, None] + COUNT_EPS))
        out[name] = torch.where(none[:, None], torch.zeros_like(val), val)
    # edges f32 cannot settle: the nearest rounding, the depth test, the threshold
    near = torch.stack([(fx - torch.floor(fx) - 0.5).abs() < NEAREST_MARGIN,
                        (fy - torch.floor(fy) - 0.5).abs() < NEAREST_MARGIN], -1)
    threshold = (d + mu).abs() < DIST_MARGIN
    edge = near.any(-1) | threshold | ((z.abs() - DEPTH_EPS).abs() < DIST_MARGIN)
    out["ambiguous"] = edge.any(0)
    out["nearest_near_edge"] = near
    out["nearest_side"] = torch.stack([torch.sign(fx - torch.round(fx)),
                                       torch.sign(fy - torch.round(fy))], -1).long()
    out["threshold_near_edge"] = threshold
    return out

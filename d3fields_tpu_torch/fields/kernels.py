"""The fused field query and its hand-written CUDA kernel.

Counterpart of ``d3fields_tpu/fields/kernels.py:56-165, 259-369``:

- :func:`fused_weighted_interp` replaces the Pallas TPU kernel of the same
  name. On a CUDA tensor it launches ``csrc/fused_interp.cu`` (built with
  nvcc on first use) or raises; on a CPU tensor it runs the plain PyTorch
  version :func:`fused_weighted_interp_plain`, which is also the kernel's
  oracle on the card. The kernel has two routes, one launch either way:
  channel slices of the whole table staged in shared memory, or a direct
  gather from L2; :func:`slice_channels` picks one. ``matmul_dtype``
  'bfloat16' is the JAX kernel's bf16 route (its default on a TPU): the
  table and the tap weights rounded to bf16, the products summed in f32,
  through the kernel's bf16-table entry. The default here is 'float32',
  the JAX package's choice off a TPU.
- :func:`eval_field_fused` is ``fusion.eval_field`` with every patch-grid
  descriptor map fused through that kernel. On the card a tile is two
  launches: :func:`field_tile` (``csrc/field_tile.cu``) does the tile's
  point-wise work (projection, the nearest-depth tap, the visibility
  terms, the patch grid's taps with the normalisation folded in, the
  full-resolution maps) and writes the distance, the validity and the
  full-resolution answers in place; the descriptor kernel then writes its
  normalised rows in place. A query beyond the tile kernel's limits (a
  float64 state, more views, maps or grids than it takes, a gradient)
  raises there. On the CPU every tile runs the plain chain
  :func:`_eval_field_fused_plain`, plain torch around the descriptor
  kernel, which is also the tile kernel's oracle. The TPU tap layouts (packed 2x2-corner table, 128-lane
  row gathers, the one-hot matmul and its ``MAX_ONEHOT_PIXELS`` switch)
  are not carried over: the kernel takes a patch-grid map of any size.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from d3fields_tpu_torch import _build
from d3fields_tpu_torch.fields import geometry
from d3fields_tpu_torch.utils.profiling import tracer

Tensor = torch.Tensor


# dynamic shared memory one block of an H100 (sm_90) may opt in to
SMEM_PER_BLOCK = 232_448
# the shared-memory route's slice widths, in channels, widest first: 64-
# and 32-byte rows of an f32 table, and the same rows of a bf16 one
SLICE_CHANNELS = (16, 8)
SLICE_CHANNELS_BF16 = (32, 16)
MATMUL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the most views and full-resolution maps one tile kernel launch takes
# (csrc/field_tile.cu: kMaxViews, kMaxMaps)
TILE_MAX_VIEWS = 8
TILE_MAX_MAPS = 4


def _entry(symbol: str):
    fn = getattr(_build.load("fused_interp"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    return _entry("d3f_fused_weighted_interp")


def _kernel_bf16():
    return _entry("d3f_fused_weighted_interp_bf16")


def _tile_kernel():
    fn = _build.load("field_tile").d3f_field_tile
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int64] * 7
                   + [ctypes.c_double, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _matmul_dtype(matmul_dtype: str) -> torch.dtype:
    if matmul_dtype not in MATMUL_DTYPES:
        raise ValueError(
            f"matmul_dtype must be one of {sorted(MATMUL_DTYPES)}, got {matmul_dtype!r}")
    return MATMUL_DTYPES[matmul_dtype]


def slice_channels(V: int, P: int, C: int, table_dtype: torch.dtype = torch.float32) -> int:
    """The kernel's route for a (V, P, C) table of ``table_dtype`` (f32 or
    bf16): the channels per slice of the shared-memory route (f32: 16 or
    8, bf16: 32 or 16; the widest whose V*P rows fit in one block's shared
    memory, and no wider than C), or 0 for the direct gather, where a row
    is not a whole number of 16-byte chunks (C % 4 in f32, C % 8 in bf16)
    or not even the narrower slice fits. For f32 on an H100 that is the
    fastest route at each shape timed (PERF.md): 4-channel slices lost to
    the direct gather wherever they fit."""
    itemsize = torch.empty((), dtype=table_dtype).element_size()
    if C % (16 // itemsize):
        return 0
    for cs in SLICE_CHANNELS if itemsize == 4 else SLICE_CHANNELS_BF16:
        if cs <= C and V * P * cs * itemsize <= SMEM_PER_BLOCK:
            return cs
    return 0


def fused_weighted_interp_plain(feats: Tensor, idx: Tensor, w: Tensor,
                                matmul_dtype: str = "float32", *,
                                out: Optional[Tensor] = None) -> Tensor:
    """Plain PyTorch version: index, multiply, sum over taps and views.

    A tap whose index lies outside [0, P) contributes nothing, as in the
    TPU kernel (its one-hot compare matches no row). At ``matmul_dtype``
    'bfloat16' the table and the weights are rounded to bf16 first, and
    the products summed in f32. The sum is copied into ``out`` where one
    is given.
    """
    dt = _matmul_dtype(matmul_dtype)
    feats = feats.to(dt).float()
    w = w.to(dt).float()
    V, P, C = feats.shape
    inb = (idx >= 0) & (idx < P)
    safe = torch.where(inb, idx, torch.zeros_like(idx)).long()
    wz = w * inb.to(w.dtype)
    acc = torch.zeros((idx.shape[1], C), dtype=torch.float32, device=feats.device)
    for v in range(V):
        for t in range(4):
            acc = acc + feats[v][safe[v, :, t]] * wz[v, :, t, None]
    return acc if out is None else out.copy_(acc)


def fused_weighted_interp(feats: Tensor, idx: Tensor, w: Tensor,
                          matmul_dtype: str = "float32", *,
                          out: Optional[Tensor] = None) -> Tensor:
    """Multi-view weighted bilinear interpolation.

    Args:
      feats: (V, P, C) float32 or bfloat16 flattened per-view feature maps.
      idx: (V, N, 4) int32 flat tap indices (from ``geometry.bilinear_taps``).
      w: (V, N, 4) float32 tap weights, already multiplied by the
        per-(view, point) fusion weight.
      matmul_dtype: 'float32', or 'bfloat16' to round ``feats`` and ``w`` to
        bf16 and sum their products in f32 (the JAX kernel's bf16 route).
        An f32 ``feats`` is cast to it at each call (:func:`round_patch_maps`
        rounds a state's maps once instead); the kernel rounds ``w`` in
        registers.

      out: optional contiguous (N, C) float32 tensor on ``feats``' device
        (a view, such as a slice of a larger output) to write the sum
        into; returned. On the card it must be 16-byte aligned.

    Returns: (N, C) float32 — ``sum_v sum_tap w * feats[v, idx]``.

    CPU tensors take the plain version. CUDA tensors launch the kernel;
    ``fused_weighted_interp.launches`` counts each launch of either route
    and ``fused_weighted_interp.launches_bf16`` those of the bf16 route.
    """
    dt = _matmul_dtype(matmul_dtype)
    if feats.dim() != 3 or idx.dim() != 3 or w.dim() != 3:
        raise ValueError("feats must be (V, P, C), idx and w (V, N, 4)")
    V, P, C = feats.shape
    N = idx.shape[1]
    if tuple(idx.shape) != (V, N, 4) or tuple(w.shape) != (V, N, 4):
        raise ValueError(
            f"idx {tuple(idx.shape)} and w {tuple(w.shape)} must both be {(V, N, 4)}")
    if (feats.dtype not in MATMUL_DTYPES.values() or w.dtype != torch.float32
            or idx.dtype != torch.int32):
        raise TypeError(
            f"expected float32 or bfloat16 feats, float32 w and int32 idx, got "
            f"{feats.dtype}, {w.dtype}, {idx.dtype}")
    if not (feats.device == idx.device == w.device):
        raise ValueError("feats, idx and w must lie on one device")
    if out is not None:
        if out.dtype != torch.float32:
            raise TypeError(f"out must be float32, got {out.dtype}")
        if tuple(out.shape) != (N, C) or not out.is_contiguous() or out.device != feats.device:
            raise ValueError(f"out must be a contiguous {(N, C)} tensor on {feats.device}, got "
                             f"{tuple(out.shape)} on {out.device}")
    if feats.device.type == "cpu":
        return fused_weighted_interp_plain(feats, idx, w, matmul_dtype, out=out)
    if feats.device.type != "cuda":
        raise ValueError(f"no kernel for device {feats.device}")
    feats = feats.to(dt)
    if not (feats.is_contiguous() and idx.is_contiguous() and w.is_contiguous()):
        raise ValueError("the kernel takes contiguous feats, idx and w")
    if idx.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("the kernel reads idx and w 16 bytes at a time: they must be 16-byte aligned")
    if out is None:
        out = torch.empty((N, C), dtype=torch.float32, device=feats.device)
    elif out.data_ptr() % 16:
        raise ValueError("the kernel writes out 16 bytes at a time: it must be 16-byte aligned")
    if N == 0 or C == 0:
        return out
    # the shared-memory route copies the table 16 bytes at a time
    cs = slice_channels(V, P, C, dt) if feats.data_ptr() % 16 == 0 else 0
    bf16 = dt == torch.bfloat16
    with torch.cuda.device(feats.device):
        err = (_kernel_bf16() if bf16 else _kernel())(
            feats.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
            V, P, N, C, cs, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"fused_weighted_interp launch failed: CUDA error {err}")
    fused_weighted_interp.launches += 1
    if bf16:
        fused_weighted_interp.launches_bf16 += 1
    return out


fused_weighted_interp.launches = 0
fused_weighted_interp.launches_bf16 = 0


# FieldState attributes behind the fused query's return names
_STATE_ATTRS = {"dino_feats": "dino_feats", "mask": "mask", "color_tensor": "color"}


def round_patch_maps(state, return_names: Tuple[str, ...], matmul_dtype: str = "float32"):
    """``state`` with each patch-grid map among ``return_names`` (the maps
    :func:`eval_field_fused` hands the kernel) rounded to ``matmul_dtype``
    once, so that the kernel's launches over many tiles take the rounded
    table as it is; full-resolution maps, and every map at 'float32', stay
    as they are."""
    dt = _matmul_dtype(matmul_dtype)
    if dt == torch.float32:
        return state
    changes = {_STATE_ATTRS[name]: m.to(dt)
               for name, m in state.feature_maps(tuple(return_names)).items()
               if tuple(m.shape[1:3]) != state.image_hw and m.dtype != dt}
    return state.replace(**changes) if changes else state


def field_tile(state, pts: Tensor, out: Dict[str, Tensor], full_maps: Dict[str, Tensor],
               idx: Optional[Tensor] = None, tw: Optional[Tensor] = None,
               patch_hw: Tuple[int, int] = (0, 0)) -> None:
    """One launch of ``csrc/field_tile.cu`` over the (N, 3) points ``pts``:
    the point-wise work of a field-query tile, written in place.

    Writes ``out['dist']`` (N,) float32 and ``out['valid_mask']`` (N,)
    bool as ``fusion._fused_distance`` computes them, ``out[name]`` (N, C)
    for each full-resolution map of ``full_maps`` (name: (V, H, W, C)
    float32) as ``fusion._bilinear_views`` and ``fusion._normalise`` give
    it, and, where ``idx`` and ``tw`` ((V, N, 4) int32 and float32,
    16-byte aligned) are given, the taps of a ``patch_hw`` grid as
    ``geometry.bilinear_taps`` gives them, their weights times the view's
    fusion weight and ``1 / (denom + 1e-6)``: :func:`fused_weighted_interp`
    over them sums the normalised descriptor. ``state`` is a float32
    FieldState on the points' CUDA device, with at most
    :data:`TILE_MAX_VIEWS` views and :data:`TILE_MAX_MAPS` maps in
    ``full_maps``; every output is contiguous. ``field_tile.launches``
    counts the launches.
    """
    n = pts.shape[0]
    V = state.num_views
    H, W = state.image_hw
    names = tuple(full_maps)
    if V > TILE_MAX_VIEWS or len(names) > TILE_MAX_MAPS:
        raise ValueError(f"the tile kernel takes at most {TILE_MAX_VIEWS} views and "
                         f"{TILE_MAX_MAPS} full-resolution maps, got {V} and {len(names)}")
    if (idx is None) != (tw is None):
        raise ValueError("give both idx and tw, or neither")
    taps = () if idx is None else (idx, tw)
    want = [(pts, (n, 3), torch.float32), (out["dist"], (n,), torch.float32),
            (out["valid_mask"], (n,), torch.bool),
            *[(t, (V, n, 4), dt) for t, dt in zip(taps, (torch.int32, torch.float32))],
            *[(out[k], (n, full_maps[k].shape[-1]), torch.float32) for k in names]]
    for t, shape, dt in want:
        if tuple(t.shape) != shape or t.dtype != dt or not t.is_contiguous() \
                or t.device != pts.device:
            raise ValueError(f"the tile kernel takes a contiguous {shape} {dt} on {pts.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if any(t.data_ptr() % 16 for t in taps):
        raise ValueError("the tile kernel writes idx and tw 16 bytes at a time: they must be "
                         "16-byte aligned")
    if n == 0:
        return
    geom = [state.pose.contiguous(), state.K.contiguous(), state.depth.contiguous()]
    maps = [full_maps[k].contiguous() for k in names]
    maps_p = (ctypes.c_void_p * TILE_MAX_MAPS)(*[m.data_ptr() for m in maps])
    outs_p = (ctypes.c_void_p * TILE_MAX_MAPS)(*[out[k].data_ptr() for k in names])
    chans = (ctypes.c_int64 * TILE_MAX_MAPS)(*[m.shape[-1] for m in maps])
    taps_p = [t.data_ptr() for t in taps] or [None, None]
    with torch.cuda.device(pts.device):
        err = _tile_kernel()(
            pts.data_ptr(), *[g.data_ptr() for g in geom], out["dist"].data_ptr(),
            out["valid_mask"].data_ptr(), *taps_p,
            maps_p, outs_p, chans, len(names), V, H, W, *patch_hw, n, state.mu,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"field_tile launch failed: CUDA error {err}")
    field_tile.launches += 1


field_tile.launches = 0


def _tile_kernel_refusal(state, pts: Tensor, maps: Dict[str, Tensor]) -> Optional[str]:
    """Why :func:`field_tile` cannot take the tile, or None where it can:
    it takes a float32 state, points and full-resolution maps on the
    points' device, at most ``TILE_MAX_VIEWS`` views and ``TILE_MAX_MAPS``
    full-resolution maps, every other map on one patch grid, and nothing
    that asks for a gradient."""
    H, W = state.image_hw
    full = [m for m in maps.values() if tuple(m.shape[1:3]) == (H, W)]
    grids = {tuple(m.shape[1:3]) for m in maps.values()} - {(H, W)}
    tensors = [pts, state.depth, state.pose, state.K, *full]
    if any(t.device != pts.device for t in [*tensors, *maps.values()]):
        return "the state and the points lie on more than one device"
    if any(t.dtype != torch.float32 for t in tensors):
        return (f"it takes float32 points, geometry and full-resolution maps, got "
                f"{sorted({str(t.dtype) for t in tensors})}")
    if state.num_views > TILE_MAX_VIEWS:
        return f"it takes at most {TILE_MAX_VIEWS} views, got {state.num_views}"
    if len(full) > TILE_MAX_MAPS:
        return f"it takes at most {TILE_MAX_MAPS} full-resolution maps, got {len(full)}"
    if len(grids) > 1:
        return f"it takes one patch grid, got {sorted(grids)}"
    if torch.is_grad_enabled() and any(t.requires_grad for t in [*tensors, *maps.values()]):
        return "it has no backward: query under torch.no_grad, or differentiate fusion.eval_field"
    return None


def eval_field_fused(
    state,
    pts: Tensor,
    return_names: Tuple[str, ...] = ("dino_feats", "mask"),
    matmul_dtype: str = "float32",
    *,
    out: Optional[Dict[str, Tensor]] = None,
) -> Dict[str, Tensor]:
    """Drop-in fused replacement for ``fusion.eval_field``.

    Patch-grid descriptor maps (any map whose grid is not the image's) go
    through :func:`fused_weighted_interp` at ``matmul_dtype`` (the JAX
    function picks 'bfloat16' on a TPU and 'float32' elsewhere; here the
    caller picks, f32 by default); full-resolution maps and the distance
    terms are computed as in ``eval_field``: on the card by
    :func:`field_tile` (counted as ``query_tiles_fused`` by the tracer),
    which raises a ValueError naming the limit a query exceeds; on the CPU
    by the plain chain (``query_tiles_plain``).

    ``out``: tensors to write the answers into, 'dist' (N,), 'valid_mask'
    (N,) and each name's (N, C), contiguous (``batch_eval`` passes slices
    of its outputs); returned.
    """
    _matmul_dtype(matmul_dtype)
    names = tuple(return_names)
    maps = state.feature_maps(names)
    if pts.device.type == "cpu":
        tracer.count("query_tiles_plain")
        got = _eval_field_fused_plain(state, pts, names, matmul_dtype)
        if out is None:
            return got
        for k, v in got.items():
            out[k].copy_(v)
        return out
    if pts.device.type != "cuda":
        raise ValueError(f"no kernel for device {pts.device}")
    refusal = _tile_kernel_refusal(state, pts, maps)
    if refusal is not None:
        raise ValueError(f"the tile kernel does not take this query on {pts.device}: {refusal}")
    tracer.count("query_tiles_fused")
    n, dev = pts.shape[0], pts.device
    H, W = state.image_hw
    V = state.num_views
    if out is None:
        out = {"dist": torch.empty(n, dtype=torch.float32, device=dev),
               "valid_mask": torch.empty(n, dtype=torch.bool, device=dev),
               **{k: torch.empty((n, m.shape[-1]), dtype=torch.float32, device=dev)
                  for k, m in maps.items()}}
    full = {k: m for k, m in maps.items() if tuple(m.shape[1:3]) == (H, W)}
    patch = {k: m for k, m in maps.items() if k not in full}
    idx = tw = None
    patch_hw = (0, 0)
    if patch:
        idx = torch.empty((V, n, 4), dtype=torch.int32, device=dev)
        tw = torch.empty((V, n, 4), dtype=torch.float32, device=dev)
        patch_hw = tuple(next(iter(patch.values())).shape[1:3])
    with tracer.span("fields.prep"):
        field_tile(state, pts.contiguous(), out, full, idx, tw, patch_hw)
    for name, m in patch.items():
        _, h, w_, C = m.shape
        with tracer.span("fields.kernel"):
            fused_weighted_interp(m.reshape(V, h * w_, C).contiguous(), idx, tw, matmul_dtype,
                                  out=out[name])
    return out


def _eval_field_fused_plain(state, pts: Tensor, names: Tuple[str, ...],
                            matmul_dtype: str) -> Dict[str, Tensor]:
    """:func:`eval_field_fused` in plain torch around the descriptor kernel:
    the distance terms, the taps and the full-resolution maps as in
    ``eval_field``, each patch-grid map through
    :func:`fused_weighted_interp`, then normalised."""
    from d3fields_tpu_torch.fields import fusion  # fusion imports this module

    xy, outputs, vw, denom, all_invalid = fusion._fused_distance(state, pts)
    if not names:
        return outputs
    H, W = state.image_hw
    V = state.num_views
    maps = state.feature_maps(names)
    for name in names:
        m = maps[name]
        _, h, w_, C = m.shape
        if (h, w_) == (H, W):
            acc = fusion._bilinear_views(m, xy, vw, (H, W))
        else:
            with tracer.span("fields.taps"):
                idx, tw = geometry.bilinear_taps(xy, (H, W), (h, w_))
                tw = (tw * vw[..., None]).contiguous()
            with tracer.span("fields.kernel"):
                acc = fused_weighted_interp(m.reshape(V, h * w_, C).contiguous(), idx, tw,
                                            matmul_dtype)
        outputs[name] = fusion._normalise(acc, denom, all_invalid)
    return outputs

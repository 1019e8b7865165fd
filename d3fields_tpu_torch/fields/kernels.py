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
  descriptor map fused through that kernel. The nearest-depth visibility
  tap and the full-resolution mask/colour taps were XLA gathers in the JAX
  package, not Pallas; here they are plain torch indexing. The TPU tap
  layouts (packed 2x2-corner table, 128-lane row gathers, the one-hot
  matmul and its ``MAX_ONEHOT_PIXELS`` switch) are not carried over: the
  kernel takes a patch-grid map of any size.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from d3fields_tpu_torch import _build
from d3fields_tpu_torch.fields import geometry

Tensor = torch.Tensor


# dynamic shared memory one block of an H100 (sm_90) may opt in to
SMEM_PER_BLOCK = 232_448
# the shared-memory route's slice widths, in channels, widest first: 64-
# and 32-byte rows of an f32 table, and the same rows of a bf16 one
SLICE_CHANNELS = (16, 8)
SLICE_CHANNELS_BF16 = (32, 16)
MATMUL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _entry(symbol: str):
    fn = getattr(_build.load("fused_interp"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    return _entry("d3f_fused_weighted_interp")


def _kernel_bf16():
    return _entry("d3f_fused_weighted_interp_bf16")


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
                                matmul_dtype: str = "float32") -> Tensor:
    """Plain PyTorch version: index, multiply, sum over taps and views.

    A tap whose index lies outside [0, P) contributes nothing, as in the
    TPU kernel (its one-hot compare matches no row). At ``matmul_dtype``
    'bfloat16' the table and the weights are rounded to bf16 first, and
    the products summed in f32.
    """
    dt = _matmul_dtype(matmul_dtype)
    feats = feats.to(dt).float()
    w = w.to(dt).float()
    V, P, C = feats.shape
    inb = (idx >= 0) & (idx < P)
    safe = torch.where(inb, idx, torch.zeros_like(idx)).long()
    wz = w * inb.to(w.dtype)
    out = torch.zeros((idx.shape[1], C), dtype=torch.float32, device=feats.device)
    for v in range(V):
        for t in range(4):
            out = out + feats[v][safe[v, :, t]] * wz[v, :, t, None]
    return out


def fused_weighted_interp(feats: Tensor, idx: Tensor, w: Tensor,
                          matmul_dtype: str = "float32") -> Tensor:
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
    if feats.device.type == "cpu":
        return fused_weighted_interp_plain(feats, idx, w, matmul_dtype)
    if feats.device.type != "cuda":
        raise ValueError(f"no kernel for device {feats.device}")
    feats = feats.to(dt)
    if not (feats.is_contiguous() and idx.is_contiguous() and w.is_contiguous()):
        raise ValueError("the kernel takes contiguous feats, idx and w")
    if idx.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("the kernel reads idx and w 16 bytes at a time: they must be 16-byte aligned")
    out = torch.empty((N, C), dtype=torch.float32, device=feats.device)
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


def eval_field_fused(
    state,
    pts: Tensor,
    return_names: Tuple[str, ...] = ("dino_feats", "mask"),
    matmul_dtype: str = "float32",
) -> Dict[str, Tensor]:
    """Drop-in fused replacement for ``fusion.eval_field``.

    Patch-grid descriptor maps (any map whose grid is not the image's) go
    through :func:`fused_weighted_interp` at ``matmul_dtype`` (the JAX
    function picks 'bfloat16' on a TPU and 'float32' elsewhere; here the
    caller picks, f32 by default); full-resolution maps and the distance
    terms are computed as in ``eval_field``.
    """
    _matmul_dtype(matmul_dtype)
    from d3fields_tpu_torch.fields import fusion  # fusion imports this module

    xy, outputs, vw, denom, all_invalid = fusion._fused_distance(state, pts)
    names = tuple(return_names)
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
            idx, tw = geometry.bilinear_taps(xy, (H, W), (h, w_))
            acc = fused_weighted_interp(
                m.reshape(V, h * w_, C).contiguous(), idx, (tw * vw[..., None]).contiguous(),
                matmul_dtype)
        outputs[name] = fusion._normalise(acc, denom, all_invalid)
    return outputs

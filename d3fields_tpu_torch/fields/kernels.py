"""The fused field query and its hand-written CUDA kernel.

Counterpart of ``d3fields_tpu/fields/kernels.py:56-165, 259-369``:

- :func:`fused_weighted_interp` replaces the Pallas TPU kernel of the same
  name. On a CUDA tensor it launches ``csrc/fused_interp.cu`` (built with
  nvcc on first use) or raises; on a CPU tensor it runs the plain PyTorch
  version :func:`fused_weighted_interp_plain`, which is also the kernel's
  oracle on the card. The kernel has two routes, one launch either way:
  channel slices of the whole table staged in shared memory, or a direct
  gather from L2; :func:`slice_channels` picks one.
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
# the shared-memory route's slice widths, in channels, widest first
SLICE_CHANNELS = (16, 8)


def _kernel():
    fn = _build.load("fused_interp").d3f_fused_weighted_interp
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def slice_channels(V: int, P: int, C: int) -> int:
    """The kernel's route for a (V, P, C) table: the channels per slice of
    the shared-memory route (16 or 8: the widest whose V*P rows fit in
    one block's shared memory, and no wider than C), or 0 for the direct
    gather, where C % 4 != 0 or not even an 8-channel slice fits. On an
    H100 that is the fastest route at each shape timed (PERF.md): 4-channel
    slices lost to the direct gather wherever they fit."""
    if C % 4:
        return 0
    for cs in SLICE_CHANNELS:
        if cs <= C and V * P * cs * 4 <= SMEM_PER_BLOCK:
            return cs
    return 0


def fused_weighted_interp_plain(feats: Tensor, idx: Tensor, w: Tensor) -> Tensor:
    """Plain PyTorch version: index, multiply, sum over taps and views.

    A tap whose index lies outside [0, P) contributes nothing, as in the
    TPU kernel (its one-hot compare matches no row).
    """
    V, P, C = feats.shape
    inb = (idx >= 0) & (idx < P)
    safe = torch.where(inb, idx, torch.zeros_like(idx)).long()
    wz = w * inb.to(w.dtype)
    out = torch.zeros((idx.shape[1], C), dtype=torch.float32, device=feats.device)
    for v in range(V):
        for t in range(4):
            out = out + feats[v][safe[v, :, t]] * wz[v, :, t, None]
    return out


def fused_weighted_interp(feats: Tensor, idx: Tensor, w: Tensor) -> Tensor:
    """Multi-view weighted bilinear interpolation.

    Args:
      feats: (V, P, C) float32 flattened per-view feature maps.
      idx: (V, N, 4) int32 flat tap indices (from ``geometry.bilinear_taps``).
      w: (V, N, 4) float32 tap weights, already multiplied by the
        per-(view, point) fusion weight.

    Returns: (N, C) float32 — ``sum_v sum_tap w * feats[v, idx]``.

    CPU tensors take the plain version. CUDA tensors launch the kernel, and
    ``fused_weighted_interp.launches`` counts each launch.
    """
    if feats.dim() != 3 or idx.dim() != 3 or w.dim() != 3:
        raise ValueError("feats must be (V, P, C), idx and w (V, N, 4)")
    V, P, C = feats.shape
    N = idx.shape[1]
    if tuple(idx.shape) != (V, N, 4) or tuple(w.shape) != (V, N, 4):
        raise ValueError(
            f"idx {tuple(idx.shape)} and w {tuple(w.shape)} must both be {(V, N, 4)}")
    if feats.dtype != torch.float32 or w.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(
            f"expected float32 feats and w and int32 idx, got {feats.dtype}, "
            f"{w.dtype}, {idx.dtype}")
    if not (feats.device == idx.device == w.device):
        raise ValueError("feats, idx and w must lie on one device")
    if feats.device.type == "cpu":
        return fused_weighted_interp_plain(feats, idx, w)
    if feats.device.type != "cuda":
        raise ValueError(f"no kernel for device {feats.device}")
    if not (feats.is_contiguous() and idx.is_contiguous() and w.is_contiguous()):
        raise ValueError("the kernel takes contiguous feats, idx and w")
    if idx.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("the kernel reads idx and w 16 bytes at a time: they must be 16-byte aligned")
    out = torch.empty((N, C), dtype=torch.float32, device=feats.device)
    if N == 0 or C == 0:
        return out
    # the shared-memory route copies the table 16 bytes at a time
    cs = slice_channels(V, P, C) if feats.data_ptr() % 16 == 0 else 0
    with torch.cuda.device(feats.device):
        err = _kernel()(
            feats.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
            V, P, N, C, cs, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"fused_weighted_interp launch failed: CUDA error {err}")
    fused_weighted_interp.launches += 1
    return out


fused_weighted_interp.launches = 0


def eval_field_fused(
    state,
    pts: Tensor,
    return_names: Tuple[str, ...] = ("dino_feats", "mask"),
) -> Dict[str, Tensor]:
    """Drop-in fused replacement for ``fusion.eval_field``.

    Patch-grid descriptor maps (any map whose grid is not the image's) go
    through :func:`fused_weighted_interp`; full-resolution maps and the
    distance terms are computed as in ``eval_field``.
    """
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
                m.reshape(V, h * w_, C).contiguous(), idx, (tw * vw[..., None]).contiguous())
        outputs[name] = fusion._normalise(acc, denom, all_invalid)
    return outputs

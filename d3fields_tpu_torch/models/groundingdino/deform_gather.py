"""Multi-scale deformable-attention sampling and its hand-written CUDA kernel.

Counterpart of ``d3fields_tpu/models/groundingdino/gather_pallas.py::
deformable_gather_pallas`` and of the function it computes,
``model.py::deformable_attention_core``:

- :func:`deform_gather` replaces the Pallas TPU kernel. On a CUDA tensor it
  launches ``csrc/deform_gather.cu`` (built with nvcc on first use) or
  raises; on a CPU tensor it runs :func:`deform_gather_plain`, which is
  also the kernel's oracle on the card.
- The kernel reads ``value`` where it lies. The TPU kernel's level-stacked
  4-corner tables, its 8-query groups and lane-packed weights are not
  carried over, and neither are its limits (f32 tables of width
  4*hd == 128, ``query_tile % 8``, one view per call).
- The kernel's warps walk (batch, query, head) head-major: neighbouring
  warps hold neighbouring queries of one head, which is faster on the card
  than the heads of one query side by side (PERF.md).
- ``value`` may be bfloat16 (the encoder under the bf16 compute dtype,
  JAX ``model.py:373-397``): the kernel's bf16-table route reads bf16 rows
  and accumulates in f32, and the plain version widens the table to f32
  before it samples, so both sum in f32 as the TPU kernel does. ``loc``,
  ``attn`` and the output stay f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from d3fields_tpu_torch import _build

Tensor = torch.Tensor


def declare(lib: ctypes.CDLL) -> None:
    """The C entries of ``csrc/deform_gather.cu`` (``_build.load``); the
    bf16-table route takes its load width after the shapes."""
    for fn, ints in ((lib.d3f_deform_gather, 7), (lib.d3f_deform_gather_bf16, 8)):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


def bf16_width(hd: int) -> int:
    """The bf16 elements one lane of the bf16-table route loads at once:
    16 bytes where hd % 8 == 0, 8 where hd % 4 == 0, else one element."""
    return 8 if hd % 8 == 0 else 4 if hd % 4 == 0 else 1


@functools.lru_cache(maxsize=16)
def _level_table(shapes: Tuple[Tuple[int, int], ...], device: torch.device) -> Tensor:
    """The kernel's (L, 4) int32 rows of (h, w, level_start, 0) on
    ``device``, uploaded once per level layout: a copy from the host would
    wait for the card at every launch."""
    levels, start = [], 0
    for h, w in shapes:
        levels.append((h, w, start, 0))
        start += h * w
    return torch.tensor(levels, dtype=torch.int32, device=device)


def deform_gather_plain(value: Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                        loc: Tensor, attn: Tensor) -> Tensor:
    """Plain PyTorch version: per level, ``F.grid_sample`` (bilinear,
    ``align_corners=False``, zeros padding) of the (B*nh, hd, h, w) maps at
    the sample positions, weighted by ``attn`` and summed over points and
    levels.

    A NaN or infinite position makes its (b, q, head) row NaN on every
    device, as in the JAX package: ``attn + loc * 0`` is NaN there and
    ``attn`` elsewhere, since CUDA's grid_sample samples zeros at a NaN
    position where the CPU's gives NaN.

    A bf16 ``value`` is widened to f32 first (exactly), so the taps are
    weighted and summed in f32, as the TPU kernel sums bf16 tables.
    """
    value = value.float()
    B, S, nh, hd = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    attn = attn + (loc * 0.0).sum(-1)
    grids = 2.0 * loc - 1.0
    out = value.new_zeros((B * nh, hd, Q))
    start = 0
    for li, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w].permute(0, 2, 3, 1).reshape(B * nh, hd, h, w)
        g = grids[:, :, :, li].permute(0, 2, 1, 3, 4).reshape(B * nh, Q, P, 2)
        taps = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                             align_corners=False)  # (B*nh, hd, Q, P)
        a = attn[:, :, :, li].permute(0, 2, 1, 3).reshape(B * nh, 1, Q, P)
        out = out + (taps * a).sum(-1)
        start += h * w
    return out.reshape(B, nh, hd, Q).permute(0, 3, 1, 2).reshape(B, Q, nh * hd)


def deform_gather(value: Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                  loc: Tensor, attn: Tensor) -> Tensor:
    """Deformable-attention sampling.

    Args:
      value: (B, S, nh, hd) float32 or bfloat16; the levels' (h, w) maps
        flattened row-major and stacked along S in ``spatial_shapes`` order.
      spatial_shapes: the L levels' (h, w), with sum(h*w) == S.
      loc: (B, Q, nh, L, P, 2) float32 sample positions (x, y), [0, 1]
        spanning each map; positions outside sample zeros, and a NaN
        position makes its (b, q, head) row NaN.
      attn: (B, Q, nh, L, P) float32 attention weights.

    Returns: (B, Q, nh*hd) float32.

    CPU tensors take the plain version. CUDA tensors launch the kernel, its
    f32 route or, for a bf16 ``value``, its bf16-table route (which loads
    :func:`bf16_width` elements at once and raises when ``value`` is not
    aligned for that load); ``deform_gather.launches`` counts each launch,
    and ``deform_gather.launches_bf16`` those of the bf16-table route.
    """
    if value.dim() != 4 or loc.dim() != 6 or attn.dim() != 5:
        raise ValueError("value must be (B, S, nh, hd), loc (B, Q, nh, L, P, 2) and "
                         "attn (B, Q, nh, L, P)")
    B, S, nh, hd = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    shapes = [(int(h), int(w)) for h, w in spatial_shapes]
    if tuple(loc.shape) != (B, Q, nh, L, P, 2) or tuple(attn.shape) != (B, Q, nh, L, P):
        raise ValueError(f"loc {tuple(loc.shape)} and attn {tuple(attn.shape)} do not fit "
                         f"value {tuple(value.shape)}")
    if len(shapes) != L or sum(h * w for h, w in shapes) != S:
        raise ValueError(f"spatial_shapes {shapes} do not cover S={S} in L={L} levels")
    if not (value.dtype in (torch.float32, torch.bfloat16)
            and loc.dtype == attn.dtype == torch.float32):
        raise TypeError(f"expected a float32 or bfloat16 value and float32 loc and attn, "
                        f"got {value.dtype}, {loc.dtype}, {attn.dtype}")
    if not (value.device == loc.device == attn.device):
        raise ValueError("value, loc and attn must lie on one device")
    if value.device.type == "cpu":
        return deform_gather_plain(value, shapes, loc, attn)
    if value.device.type != "cuda":
        raise ValueError(f"no kernel for device {value.device}")
    if not (value.is_contiguous() and loc.is_contiguous() and attn.is_contiguous()):
        raise ValueError("the kernel takes contiguous value, loc and attn")
    if S >= 2 ** 31 or Q * nh >= 2 ** 31 or B >= 2 ** 16 or nh >= 2 ** 16:
        raise ValueError(f"the kernel indexes with int32 and a (Q, nh, B) grid: "
                         f"B={B}, S={S}, Q={Q}, nh={nh} are too large")
    out = torch.empty((B, Q, nh * hd), dtype=torch.float32, device=value.device)
    if out.numel() == 0:
        return out
    levels = _level_table(tuple(shapes), value.device)
    bf16 = value.dtype == torch.bfloat16
    if bf16:
        width = bf16_width(hd)
        if value.data_ptr() % (2 * width):
            raise ValueError(f"the bf16-table route loads {width} bf16 at once at hd={hd}: "
                             f"value must be {2 * width}-byte aligned, its address is "
                             f"{value.data_ptr():#x}")
    lib = _build.load("deform_gather", declare)
    entry, extra = (lib.d3f_deform_gather_bf16, (width,)) if bf16 else (lib.d3f_deform_gather, ())
    _build.launch("deform_gather", value.device, entry, value.data_ptr(), levels.data_ptr(),
                  loc.data_ptr(), attn.data_ptr(), out.data_ptr(), B, S, Q, nh, hd, L, P, *extra)
    deform_gather.launches += 1
    if bf16:
        deform_gather.launches_bf16 += 1
    return out


deform_gather.launches = 0
deform_gather.launches_bf16 = 0

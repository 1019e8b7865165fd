"""The vision transformers' attention and its hand-written CUDA kernel,
``csrc/sam_attention.cu``, which SAM and DINOv2 share.

Counterpart of ``d3fields_tpu/models/sam/model.py::_vision_attention``
with ``_rel_pos_bias``, and of the attention in
``d3fields_tpu/models/dinov2.py::_block`` (both XLA-fused on the TPU; no
Pallas kernel). Each entry is a layer's attention core, from the ``qkv``
projection's output (B, L, 3, nh, hd) to the output projection's input
(B, L, nh*hd):

- :func:`sam_attention`, every SAM vision layer: decomposed relative
  positions over an (h, w) grid or window.
- :func:`vit_attention`, every DINOv2 layer: no bias, any L (the patch
  grid and the CLS token).

On a CUDA tensor each launches the kernel (built with nvcc on first use)
or raises where its refusal function names a reason; on a CPU tensor it
runs its plain chain (:func:`sam_attention_plain`,
:func:`vit_attention_plain`), which is also the kernel's oracle on the
card. The kernel takes the route of the input's dtype: bfloat16 (tensor
cores, f32 logits and softmax, the probabilities rounded to bf16 as the
operands of ``p v``) or float32 (f32 FMA, no TF32). It reads q, k and v
where the projection wrote them and, for SAM, adds the bias from the two
small terms of :func:`bias_rows` in registers: no (B*nh, L, L) tensor
exists.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from d3fields_tpu_torch import _build
from d3fields_tpu_torch.utils.cuda_graph import host_effect
from d3fields_tpu_torch.utils.profiling import tracer

Tensor = torch.Tensor

KERNEL_HEAD_WIDTHS = (16, 64, 80)  # the widths csrc/sam_attention.cu instantiates with a bias
VIT_HEAD_WIDTHS = (64,)  # and without one: every DINOv2's
KERNEL_MAX_TABLE = 256  # h + w: a block's rows of both bias terms in shared memory
_ROUTES = {torch.bfloat16: "d3f_sam_attention_bf16", torch.float32: "d3f_sam_attention_f32"}
_VIT_ROUTES = {torch.bfloat16: "d3f_attention_bf16", torch.float32: "d3f_attention_f32"}


def declare(lib: ctypes.CDLL) -> None:
    """The C entries of ``csrc/sam_attention.cu`` (``_build.load``), one a
    route and a bias mode."""
    for symbol in _ROUTES.values():
        fn = getattr(lib, symbol)
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for symbol in _VIT_ROUTES.values():
        fn = getattr(lib, symbol)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int


def _row_refusal(qkv: Tensor) -> Optional[str]:
    """Why the kernel cannot read q, k and v of ``qkv`` as 16-byte rows, or
    None."""
    align = 16 // qkv.element_size()
    if qkv.stride(-1) != 1 or any(qkv.stride(d) % align for d in range(4)) or \
            qkv.data_ptr() % 16:
        return (f"the kernel reads 16-byte rows of q, k and v: qkv strides {qkv.stride()} and "
                f"address {qkv.data_ptr():#x} do not allow it")
    return None


def _offsets(n: int, device) -> Tensor:
    """idx[i, j] = i - j + n - 1: each query's row of a relative table."""
    ar = torch.arange(n, device=device)
    return ar[:, None] - ar[None] + n - 1


def rel_pos_bias(q_hw: Tuple[int, int], rel_h: Tensor, rel_w: Tensor, query: Tensor) -> Tensor:
    """Decomposed relative position bias (HF ``get_decomposed_rel_pos``
    with equal query and key sizes). query (B, h*w, hd) unscaled."""
    qh, qw = q_hw
    q = query.reshape(query.shape[0], qh, qw, -1)
    bias_h = torch.einsum("bhwc,hkc->bhwk", q, rel_h[_offsets(qh, query.device)])
    bias_w = torch.einsum("bhwc,wkc->bhwk", q, rel_w[_offsets(qw, query.device)])
    return (bias_h[..., :, None] + bias_w[..., None, :]).reshape(-1, qh * qw, qh * qw)


def padded(n: int) -> int:
    """A bias term count rounded up to 8: 16-byte aligned rows."""
    return -(-n // 8) * 8


def bias_rows(q: Tensor, rel_h: Tensor, rel_w: Tensor) -> Tensor:
    """The kernel's bias terms for q (B, L, nh, hd) unscaled: rows (nh, B,
    L, ph + pw), each query against every row of rel_h / scale (2h - 1
    rows, zero padded to ph = :func:`padded`) and then of rel_w / scale (to
    pw), in q's dtype, scale = hd ** -0.5: the bias in the units of q . k,
    which the kernel's sums start from. One batched GEMM over the heads that
    reads q where the qkv projection wrote it (no copy). The bias of query
    i at grid position (qh, qw) against key (kh, kw) is scale *
    (rows[..., i, qh - kh + h - 1] + rows[..., i, ph + qw - kw + w - 1]),
    the sum :func:`rel_pos_bias` builds."""
    B, L, nh, hd = q.shape
    ph, pw = padded(rel_h.shape[0]), padded(rel_w.shape[0])
    rel = torch.zeros((ph + pw, hd), device=q.device)
    rel[:rel_h.shape[0]] = rel_h
    rel[ph:ph + rel_w.shape[0]] = rel_w
    rel = (rel * hd ** 0.5).to(q.dtype)
    qt = q.reshape(B * L, nh, hd).transpose(0, 1)  # (nh, B*L, hd): a view
    return torch.bmm(qt, rel.t().expand(nh, hd, ph + pw)).view(nh, B, L, ph + pw)


def sam_attention_plain(qkv: Tensor, rel_h: Tensor, rel_w: Tensor,
                        hw: Tuple[int, int]) -> Tensor:
    """Plain PyTorch version: the (B*nh, L, L) logits of the scaled query,
    the relative-position bias added in place, the softmax in f32, the
    probabilities back in the trunk's dtype, then ``p v``. qkv (B, L, 3,
    nh, hd) -> (B, L, nh*hd)."""
    B, L, _, nh, hd = qkv.shape
    qkv = qkv.permute(2, 0, 3, 1, 4).reshape(3, B * nh, L, hd)
    q, k, v = qkv[0], qkv[1], qkv[2]
    logits = torch.matmul(q * (hd ** -0.5), k.transpose(-1, -2))
    # in place: a global layer's (B*nh, 4096, 4096) logits are 1 GB a view
    logits.add_(rel_pos_bias(hw, rel_h, rel_w, q))
    probs = torch.softmax(logits.float(), dim=-1).to(qkv.dtype)
    out = torch.matmul(probs, v).reshape(B, nh, L, hd).permute(0, 2, 1, 3)
    return out.reshape(B, L, nh * hd)


def kernel_refusal(qkv: Tensor, rel_h: Tensor, rel_w: Tensor,
                   hw: Tuple[int, int]) -> Optional[str]:
    """Why the kernel cannot take these inputs, or None: a head width it
    does not instantiate, a dtype other than float32 or bfloat16 (the
    tables' too), q, k and v rows not 16-byte aligned, tables too wide for
    shared memory, or indices beyond its int32 and grid limits."""
    B, L, _, nh, hd = qkv.shape
    h, w = hw
    if qkv.dtype not in _ROUTES or rel_h.dtype != qkv.dtype or rel_w.dtype != qkv.dtype:
        return (f"the kernel takes float32 or bfloat16 qkv and tables of its dtype, got "
                f"{qkv.dtype}, {rel_h.dtype}, {rel_w.dtype}")
    if hd not in KERNEL_HEAD_WIDTHS:
        return f"the kernel is built for head widths {KERNEL_HEAD_WIDTHS}, got {hd}"
    rows = _row_refusal(qkv)
    if rows is not None:
        return rows
    if h + w > KERNEL_MAX_TABLE:
        return f"h + w = {h + w} is beyond the kernel's {KERNEL_MAX_TABLE} table entries"
    if L * 3 >= 2 ** 22 or B >= 2 ** 16 or nh >= 2 ** 16:
        return f"L={L}, B={B}, nh={nh} are beyond the kernel's index and grid limits"
    return None


def sam_attention(qkv: Tensor, rel_h: Tensor, rel_w: Tensor, hw: Tuple[int, int]) -> Tensor:
    """``softmax(q k^T / sqrt(hd) + B) v`` of every (b, head), B the
    decomposed relative-position bias of the (h, w) grid.

    Args:
      qkv: (B, L, 3, nh, hd), L = h * w: the ``qkv`` projection's output,
        q, k and v of every head (a window's padded tokens included).
      rel_h, rel_w: (2h - 1, hd) and (2w - 1, hd) relative-position tables.
      hw: the grid (h, w) of a window or of the whole map.

    Returns: (B, L, nh*hd) in qkv's dtype, the heads side by side.

    CPU tensors take :func:`sam_attention_plain`. CUDA tensors launch the
    kernel, its bf16 or f32 route by qkv's dtype, or raise where
    :func:`kernel_refusal` says it cannot take them;
    ``sam_attention.launches`` counts each launch,
    ``sam_attention.launches_bf16`` those of the bf16 route, and the
    tracer's ``sam_attn`` counter each launch too.
    """
    B, L, three, nh, hd = qkv.shape
    h, w = hw
    if three != 3 or L != h * w:
        raise ValueError(f"qkv must be (B, h*w, 3, nh, hd) for hw={tuple(hw)}, "
                         f"got {tuple(qkv.shape)}")
    if tuple(rel_h.shape) != (2 * h - 1, hd) or tuple(rel_w.shape) != (2 * w - 1, hd):
        raise ValueError(f"rel_h {tuple(rel_h.shape)} and rel_w {tuple(rel_w.shape)} do not fit "
                         f"hw={tuple(hw)}, hd={hd}")
    if qkv.device.type == "cpu":
        return sam_attention_plain(qkv, rel_h, rel_w, hw)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    refusal = kernel_refusal(qkv, rel_h, rel_w, hw)
    if refusal is not None:
        raise ValueError(refusal)
    rows = bias_rows(qkv[:, :, 0], rel_h, rel_w)
    out = torch.empty((B, L, nh * hd), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    _build.launch("sam_attention", qkv.device,
                  getattr(_build.load("sam_attention", declare), _ROUTES[qkv.dtype]),
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), rows.data_ptr(), out.data_ptr(),
                  B, L, nh, h, w, hd, q.stride(0), q.stride(1), q.stride(2), hd ** -0.5)
    sam_attention.launches += 1
    if qkv.dtype == torch.bfloat16:
        sam_attention.launches_bf16 += 1
    tracer.count("sam_attn")
    return out


sam_attention.launches = 0
sam_attention.launches_bf16 = 0


def vit_attention_plain(qkv: Tensor) -> Tensor:
    """Plain PyTorch version: the (B*nh, L, L) logits in qkv's dtype, scaled
    in f32 (as the JAX package's product with a numpy scalar promotes), the
    softmax in f32, the probabilities back in qkv's dtype, then ``p v``.
    qkv (B, L, 3, nh, hd) -> (B, L, nh*hd)."""
    B, L, _, nh, hd = qkv.shape
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (B, nh, L, hd)
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * (1.0 / np.sqrt(hd))
    probs = torch.softmax(logits, dim=-1).to(qkv.dtype)
    return torch.matmul(probs, v).transpose(1, 2).reshape(B, L, nh * hd)


def vit_attention_refusal(qkv: Tensor) -> Optional[str]:
    """Why the kernel's bias-free mode cannot take ``qkv``, or None: a dtype
    other than float32 or bfloat16, a head width it does not instantiate,
    q, k and v rows not 16-byte aligned, a sequence, batch or head count
    beyond its index and grid limits, or a tensor that requires grad (the
    kernel has no backward)."""
    B, L, _, nh, hd = qkv.shape
    if qkv.dtype not in _VIT_ROUTES:
        return f"the kernel takes float32 or bfloat16 qkv, got {qkv.dtype}"
    if hd not in VIT_HEAD_WIDTHS:
        return f"the kernel's bias-free mode is built for head widths {VIT_HEAD_WIDTHS}, got {hd}"
    rows = _row_refusal(qkv)
    if rows is not None:
        return rows
    if L >= 2 ** 30 or B >= 2 ** 16 or nh >= 2 ** 16:
        return f"L={L}, B={B}, nh={nh} are beyond the kernel's index and grid limits"
    if qkv.requires_grad:
        return "qkv requires grad: the kernel has no backward"
    return None


def vit_attention(qkv: Tensor) -> Tensor:
    """``softmax(q k^T / sqrt(hd)) v`` of every (b, head): a plain ViT
    layer's attention core, DINOv2's.

    Args:
      qkv: (B, L, 3, nh, hd): the ``qkv`` projection's output, q, k and v
        of every head, for any L (a patch grid and its CLS token).

    Returns: (B, L, nh*hd) in qkv's dtype, the heads side by side.

    CPU tensors take :func:`vit_attention_plain`. CUDA tensors launch the
    kernel's bias-free mode, its bf16 or f32 route by qkv's dtype, or raise
    where :func:`vit_attention_refusal` says it cannot take them;
    ``vit_attention.launches`` counts each launch,
    ``vit_attention.launches_bf16`` those of the bf16 route, and the
    tracer's ``dinov2_attn`` counter each launch too (:func:`_count_vit`;
    a launch inside a graphed call is counted at each replay).
    """
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (B, L, 3, nh, hd), got {tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return vit_attention_plain(qkv)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    refusal = vit_attention_refusal(qkv)
    if refusal is not None:
        raise ValueError(refusal)
    B, L, _, nh, hd = qkv.shape
    out = torch.empty((B, L, nh * hd), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    _build.launch("sam_attention", qkv.device,
                  getattr(_build.load("sam_attention", declare), _VIT_ROUTES[qkv.dtype]),
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, L, nh, hd, q.stride(0), q.stride(1), q.stride(2), hd ** -0.5)
    host_effect(_count_vit, qkv.dtype == torch.bfloat16)
    return out


def _count_vit(bf16: bool) -> None:
    """One launch of :func:`vit_attention`'s kernel, counted."""
    vit_attention.launches += 1
    if bf16:
        vit_attention.launches_bf16 += 1
    tracer.count("dinov2_attn")


vit_attention.launches = 0
vit_attention.launches_bf16 = 0

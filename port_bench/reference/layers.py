"""The operations the segmentation references share, in plain PyTorch, under
a precision mode (``precision.py``).

A mode names the dtype of a network's trunk (``P.vit_dtype``: bf16 in the
``bf16`` and ``fp8`` modes) and how matrix products take their operands
(``P.operand``) and store float32 results (``P.r``). What lies outside a
trunk runs in float32, or float64 in the ``f64`` mode (:func:`outer`).
Inside a trunk, as the program's compute-dtype semantics state: products
sum in f32 and round to the trunk's dtype; layer and group norms take
their statistics and affine in f32 and round once; attention logits are
scaled, biased and soft-maxed in f32 (:func:`softmax`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.precision import Precision

Tensor = torch.Tensor


def outer(P: Precision) -> torch.dtype:
    """The dtype of everything outside a trunk."""
    return torch.float64 if P.vit_dtype == torch.float64 else torch.float32


def acc(x: Tensor) -> torch.dtype:
    """The dtype statistics and softmaxes of ``x`` are taken in."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def cast(w: dict, prefix: str, dtype: torch.dtype) -> dict:
    """The floating leaves of ``w`` under ``prefix``, prefix removed, in ``dtype``."""
    n = len(prefix)
    return {k[n:]: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in w.items() if k.startswith(prefix)}


def linear(x: Tensor, w: dict, name: str, P: Precision, bias: bool = True) -> Tensor:
    b = w.get(name + ".bias") if bias else None
    return P.r(F.linear(P.operand(x), P.operand(w[name + ".weight"]), b))


def matmul(a: Tensor, b: Tensor, P: Precision) -> Tensor:
    return P.r(torch.matmul(P.operand(a), P.operand(b)))


def layer_norm(x: Tensor, w: dict, name: str, eps: float, P: Precision) -> Tensor:
    """Statistics and affine in f32 (f64), rounded once to ``x``'s dtype."""
    a = acc(x)
    y = F.layer_norm(x.to(a), (x.shape[-1],), w[name + ".weight"].to(a), w[name + ".bias"].to(a),
                     eps=eps)
    return P.r(y).to(x.dtype)


def group_norm(x: Tensor, w: dict, name: str, groups: int, eps: float, P: Precision) -> Tensor:
    """GroupNorm of an NCHW map, statistics and affine in f32 (f64)."""
    a = acc(x)
    y = F.group_norm(x.to(a), groups, w[name + ".weight"].to(a), w[name + ".bias"].to(a), eps=eps)
    return P.r(y).to(x.dtype)


def softmax(logits: Tensor, P: Precision, dtype: torch.dtype) -> Tensor:
    """Soft-max of logits already in f32 (f64), returned in ``dtype``."""
    return P.r(torch.softmax(logits, dim=-1)).to(dtype)


def gelu(x: Tensor, P: Precision) -> Tensor:
    return P.r(F.gelu(x, approximate="none"))

"""Precision modes of the reference, and the lower-precision controls.

A mode says in which dtype the ViT runs and how its matrix products take
their operands, in which dtype the field's arithmetic runs, and how the
descriptor table and its tap weights are rounded:

- ``f64``: the reference of a configuration stated in float32 (TF32 off):
  everything in float64, so that the program's float32 is held to the
  exact answer.
- ``bf16``: the reference of a configuration stated in bfloat16 (the JAX
  package's compute dtype): the ViT's weights and activations in bf16, its
  layer norms' statistics and its softmax in f32, matrix products summed in
  f32; the field in float64 with the descriptor table and the tap weights
  rounded to bf16.
- ``tf32``: the control of a float32 configuration, one step down: matrix
  products in TF32 and every other float32 result rounded to TF32's 10-bit
  mantissa.
- ``fp8``: the control of a bfloat16 configuration, one step down: each
  matrix product's operands quantised to float8 e4m3 (one scale per
  tensor), the table and the tap weights in e4m3, the float32 parts rounded
  to TF32.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

Tensor = torch.Tensor

E4M3_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    vit_dtype: torch.dtype
    gemm: str            # 'plain', 'tf32' or 'fp8'
    field_dtype: torch.dtype
    round_tf32: bool     # round each float32 result to TF32
    table: str           # 'exact', 'bf16' or 'fp8'

    def r(self, x: Tensor) -> Tensor:
        """``x`` as this mode stores a float32 result."""
        return round_tf32(x) if self.round_tf32 and x.dtype == torch.float32 else x

    def table_round(self, x: Tensor) -> Tensor:
        if self.table == "bf16":
            return x.to(torch.bfloat16).to(x.dtype)
        if self.table == "fp8":
            return fp8(x)
        return self.r(x)

    @contextlib.contextmanager
    def matmul_mode(self):
        """TF32 on for this mode's products where it asks for it, off otherwise."""
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.gemm == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    def operand(self, x: Tensor) -> Tensor:
        """A matrix product's operand as this mode feeds it."""
        return fp8(x) if self.gemm == "fp8" else x


MODES = {
    "f64": Precision("f64", torch.float64, "plain", torch.float64, False, "exact"),
    "bf16": Precision("bf16", torch.bfloat16, "plain", torch.float64, False, "bf16"),
    "tf32": Precision("tf32", torch.float32, "tf32", torch.float32, True, "exact"),
    "fp8": Precision("fp8", torch.bfloat16, "fp8", torch.float32, True, "fp8"),
}

# a configuration's compute dtype -> (its reference, its control)
REFERENCE = {"float32": "f64", "bfloat16": "bf16"}
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def round_tf32(x: Tensor) -> Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (10-bit mantissa,
    ties to even), kept as float32; gradients pass straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0x0FFF
    r = ((bits + bias) & ~0x1FFF).view(torch.float32).reshape(x.shape)
    return x + (r - x).detach() if x.requires_grad else r


def fp8(x: Tensor) -> Tensor:
    """``x`` quantised to float8 e4m3 with one scale for the tensor (its
    largest magnitude maps to 448), returned in ``x``'s dtype."""
    amax = x.detach().abs().max().float().clamp(min=1e-30)
    scale = (amax / E4M3_MAX).to(x.dtype)
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

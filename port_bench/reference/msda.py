"""Multi-scale deformable attention's sampling, in plain PyTorch.

Deformable DETR's ``multi_scale_deformable_attn_pytorch``
(fundamentalvision/Deformable-DETR, ``models/ops/functions/
ms_deform_attn_func.py``), which GroundingDINO and huggingface both carry:
the value table split into its levels, each level's (B*heads, hd, h, w)
map sampled with ``grid_sample`` (bilinear, zero padding, align_corners
False) at 2*loc - 1, the samples weighted by the attention weights and
summed over levels and points. The table is widened to the weights'
dtype first, so a bf16 table is summed in f32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def sample(value: Tensor, shapes: Sequence[Tuple[int, int]], loc: Tensor,
           weights: Tensor) -> Tensor:
    """value (B, S, heads, hd); loc (B, Q, heads, L, P, 2) in [0, 1] of each
    map (x, y); weights (B, Q, heads, L, P) -> (B, Q, heads*hd)."""
    B, S, nh, hd = value.shape
    _, Q, _, L, Pn, _ = loc.shape
    value = value.to(weights.dtype)
    levels = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * loc - 1
    taps = []
    for li, (h, w) in enumerate(shapes):
        v = levels[li].flatten(2).transpose(1, 2).reshape(B * nh, hd, h, w)
        g = grids[:, :, :, li].transpose(1, 2).flatten(0, 1)  # (B*nh, Q, P, 2)
        taps.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                  align_corners=False))
    a = weights.transpose(1, 2).reshape(B * nh, 1, Q, L * Pn)
    out = (torch.stack(taps, dim=-2).flatten(-2) * a).sum(-1).view(B, nh * hd, Q)
    return out.transpose(1, 2).contiguous()

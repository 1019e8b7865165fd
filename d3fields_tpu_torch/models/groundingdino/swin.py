"""Swin Transformer backbone in PyTorch (GroundingDINO's vision trunk).

Counterpart of ``d3fields_tpu/models/groundingdino/swin.py``. Parameter
names are huggingface ``SwinBackbone``'s (``model.backbone.conv_encoder.
model.*`` inside a GroundingDINO state dict), so its weights load as they
are. Semantics are HF Swin's backbone mode (``always_partition=True``), as
in the JAX package:

- the input is padded bottom-right to a multiple of the patch size, and
  every block's map to a multiple of the window;
- shifted windows roll the map and mask attention across the rolled
  regions (-100 between regions, HF ``get_attn_mask``);
- patch merging pads an odd height or width by one;
- each output stage is layer-normed and returned as an NHWC map.

800×1067 is a multiple of neither 4 nor 7, so all three paddings run on
the detector's real input.

The trunk runs in the dtype of its weights (bf16 under the detector's
bf16 compute dtype, JAX ``model.py:742-790``): the LayerNorms take their
statistics and their affine in f32 and round once, and the window
attention's logits are scaled, biased and soft-maxed in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from d3fields_tpu_torch.models.common import linear, named

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    patch_size: int = 4
    out_stages: Tuple[int, ...] = (1, 2, 3)  # 0-based: stage2, stage3, stage4

    @staticmethod
    def tiny() -> "SwinConfig":
        return SwinConfig()

    @staticmethod
    def base() -> "SwinConfig":
        """Swin-B/384-w12, the trunk of groundingdino_swinb_cogcoor (HF
        grounding-dino-base), the second checkpoint the reference downloads."""
        return SwinConfig(embed_dim=128, depths=(2, 2, 18, 2),
                          num_heads=(4, 8, 16, 32), window_size=12)

    def stage_dim(self, i: int) -> int:
        return self.embed_dim * (2 ** i)


def _relative_position_index(window: int) -> Tensor:
    """(T, T) index into the (2w-1)^2 bias table, T = w*w (HF's buffer)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    return torch.as_tensor((rel[0] + window - 1) * (2 * window - 1) + (rel[1] + window - 1))


def _shift_mask(Hp: int, Wp: int, window: int, shift: int) -> np.ndarray:
    """Region mask for shifted windows (HF ``get_attn_mask``): (nw, T, T)
    additive, -100 across region boundaries."""
    img = np.zeros((Hp, Wp), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws_ in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws_] = cnt
            cnt += 1
    win = img.reshape(Hp // window, window, Wp // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class _WindowSelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, device):
        super().__init__()
        self.num_heads = num_heads
        self.query = linear(dim, dim, device)
        self.key = linear(dim, dim, device)
        self.value = linear(dim, dim, device)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, num_heads, device=device))
        self.register_buffer("relative_position_index",
                             _relative_position_index(window).to(device))

    def forward(self, x: Tensor, mask) -> Tensor:
        """x (B, nw, T, C) windows; mask (nw, T, T) additive or None."""
        B, nw, T, C = x.shape
        nh = self.num_heads
        hd = C // nh

        def heads(t: Tensor) -> Tensor:
            return t.reshape(B, nw, T, nh, hd).permute(0, 1, 3, 2, 4)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        # scaled in f32, as the JAX package's division by a numpy scalar promotes
        logits = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd)
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        logits = logits + bias.reshape(T, T, nh).permute(2, 0, 1)[None, None]
        if mask is not None:
            logits = logits + mask[None, :, None]
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        return torch.matmul(probs, v).permute(0, 1, 3, 2, 4).reshape(B, nw, T, C)


class _SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, mlp_ratio: float, device):
        super().__init__()
        self.window = window
        hidden = int(dim * mlp_ratio)
        self.layernorm_before = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.attention = named(self=_WindowSelfAttention(dim, num_heads, window, device),
                               output=named(dense=linear(dim, dim, device)))
        self.layernorm_after = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.intermediate = named(dense=linear(dim, hidden, device))
        self.output = named(dense=linear(hidden, dim, device))

    def forward(self, x: Tensor, hw: Tuple[int, int], shift: int, mask) -> Tensor:
        """x (B, H*W, C); mask from :func:`_shift_mask` when ``shift``."""
        H, W = hw
        B, _, C = x.shape
        ws = self.window
        h = self.layernorm_before(x).reshape(B, H, W, C)
        ph, pw = (-H) % ws, (-W) % ws
        h = F.pad(h, (0, 0, 0, pw, 0, ph))
        Hp, Wp = H + ph, W + pw
        if shift:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        h = h.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        h = self.attention.self(h.reshape(B, -1, ws * ws, C), mask)
        h = self.attention.output.dense(h)
        h = h.reshape(B, Hp // ws, Wp // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        h = h.reshape(B, Hp, Wp, C)
        if shift:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = x + h[:, :H, :W].reshape(B, H * W, C)
        h = F.gelu(self.intermediate.dense(self.layernorm_after(x)), approximate="none")
        return x + self.output.dense(h)


class _PatchMerging(nn.Module):
    def __init__(self, dim: int, device):
        super().__init__()
        self.reduction = linear(4 * dim, 2 * dim, device, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5, device=device)

    def forward(self, x: Tensor, hw: Tuple[int, int]):
        H, W = hw
        B, _, C = x.shape
        h = F.pad(x.reshape(B, H, W, C), (0, 0, 0, W % 2, 0, H % 2))
        h = torch.cat([h[:, 0::2, 0::2], h[:, 1::2, 0::2], h[:, 0::2, 1::2], h[:, 1::2, 1::2]],
                      dim=-1)
        nh, nw = (H + 1) // 2, (W + 1) // 2
        return self.reduction(self.norm(h.reshape(B, nh * nw, 4 * C))), (nh, nw)


class Swin(nn.Module):
    """Swin backbone with huggingface ``SwinBackbone`` parameter names."""

    def __init__(self, cfg: SwinConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, P = cfg.embed_dim, cfg.patch_size
        self.embeddings = named(
            patch_embeddings=named(projection=nn.utils.skip_init(
                nn.Conv2d, 3, D, P, stride=P, device=device)),
            norm=nn.LayerNorm(D, eps=1e-5, device=device))
        layers = []
        for si, depth in enumerate(cfg.depths):
            dim = cfg.stage_dim(si)
            blocks = nn.ModuleList([
                _SwinBlock(dim, cfg.num_heads[si], cfg.window_size, cfg.mlp_ratio, device)
                for _ in range(depth)])
            down = _PatchMerging(dim, device) if si < len(cfg.depths) - 1 else None
            layers.append(named(blocks=blocks, downsample=down) if down is not None
                          else named(blocks=blocks))
        self.encoder = named(layers=nn.ModuleList(layers))
        self.hidden_states_norms = nn.ModuleDict({
            f"stage{si + 1}": nn.LayerNorm(cfg.stage_dim(si), eps=1e-5, device=device)
            for si in cfg.out_stages})
        self._masks: Dict[Tuple, Tensor] = {}

    def _mask(self, Hp: int, Wp: int, shift: int, device) -> Tensor:
        key = (Hp, Wp, shift, device)
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(
                _shift_mask(Hp, Wp, self.cfg.window_size, shift), device=device)
        return self._masks[key]

    def forward(self, pixels: Tensor) -> List[Tensor]:
        """pixels (B, H, W, 3) -> the NHWC feature maps of ``out_stages``."""
        cfg = self.cfg
        P, D, ws = cfg.patch_size, cfg.embed_dim, cfg.window_size
        B, H, W, _ = pixels.shape
        proj = self.embeddings.patch_embeddings.projection
        pixels = F.pad(pixels.to(proj.weight.dtype), (0, 0, 0, (-W) % P, 0, (-H) % P))
        gh, gw = pixels.shape[1] // P, pixels.shape[2] // P
        # patch embedding as a matrix product over (c, py, px), the conv weight's order
        x = pixels.reshape(B, gh, P, gw, P, 3).permute(0, 1, 3, 5, 2, 4)
        x = F.linear(x.reshape(B, gh * gw, 3 * P * P), proj.weight.reshape(D, 3 * P * P),
                     proj.bias)
        x = self.embeddings.norm(x)
        hw = (gh, gw)
        outs = []
        for si, layer in enumerate(self.encoder.layers):
            for bi, blk in enumerate(layer.blocks):
                shift = 0 if bi % 2 == 0 else ws // 2
                mask = None
                if shift:
                    mask = self._mask(hw[0] + (-hw[0]) % ws, hw[1] + (-hw[1]) % ws, shift,
                                      x.device)
                x = blk(x, hw, shift, mask)
            if si in cfg.out_stages:
                normed = self.hidden_states_norms[f"stage{si + 1}"](x)
                outs.append(normed.reshape(B, hw[0], hw[1], cfg.stage_dim(si)))
            if hasattr(layer, "downsample"):
                x, hw = layer.downsample(x, hw)
        return outs

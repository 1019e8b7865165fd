"""DINOv2 vision transformer in PyTorch.

Counterpart of ``d3fields_tpu/models/dinov2.py``. The reference loads
DINOv2 ViT-L/14 from torch hub and takes ``x_norm_patchtokens`` as the
per-view descriptor map (``fusion.py:593-629``).

- :class:`Dinov2` keeps torch hub's parameter names and layouts, so a hub
  state dict loads as it is (:func:`convert_hub_state_dict` only checks and
  drops ``mask_token``); :func:`convert_hf_state_dict` re-keys a
  huggingface ``Dinov2Model`` state dict, and :func:`load_jax_params`
  carries the JAX package's stacked parameter dict across.
- Patch embedding is an unfold times the (D, 3·P·P) view of the conv
  weight, so it is a matrix product that TF32 settings for convolutions do
  not touch. LayerNorm (eps 1e-6) and the attention softmax run in f32,
  GELU is exact, attention is plain ``matmul`` + ``softmax``.
- :class:`Dinov2Backbone` resizes with the bit-exact Pillow resampler
  ('pil', default) or antialiased bilinear ('device'), both on the device,
  normalises,
  runs the transformer and returns the patch tokens on the (ph, pw) grid,
  with positional embeddings interpolated per grid and cached.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from d3fields_tpu_torch.models.common import imagenet_stats, linear
from d3fields_tpu_torch.models.resize import (
    bilinear_resize, cubic_resize_np, pil_bilinear_resize_u8,
)
from d3fields_tpu_torch.utils.convert import np_view
from d3fields_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Dinov2Config:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    patch_size: int = 14
    layerscale_init: float = 1.0
    image_size: int = 518  # pretraining grid: (518/14)^2 = 37^2 positions

    @staticmethod
    def vit_large() -> "Dinov2Config":
        return Dinov2Config()

    @staticmethod
    def vit_base() -> "Dinov2Config":
        return Dinov2Config(hidden_size=768, num_layers=12, num_heads=12)

    @staticmethod
    def vit_small() -> "Dinov2Config":
        return Dinov2Config(hidden_size=384, num_layers=12, num_heads=6)

    @staticmethod
    def tiny_test() -> "Dinov2Config":
        """Small config for unit tests."""
        return Dinov2Config(hidden_size=64, num_layers=3, num_heads=4, image_size=56)

    @property
    def pos_grid(self) -> int:
        return self.image_size // self.patch_size


# ---------------------------------------------------------------------------
# Modules (torch-hub parameter names)
# ---------------------------------------------------------------------------

class _LayerScale(nn.Module):
    def __init__(self, dim: int, device):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim, device=device))


class _Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, device):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = linear(dim, 3 * dim, device)
        self.proj = linear(dim, dim, device)

    def forward(self, x: Tensor) -> Tensor:
        B, N, D = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, nh, D // nh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, nh, N, dh)
        logits = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / np.sqrt(D // nh))
        probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, N, D)
        return self.proj(out)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device):
        super().__init__()
        self.fc1 = linear(dim, hidden, device)
        self.fc2 = linear(hidden, dim, device)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class _Block(nn.Module):
    def __init__(self, cfg: Dinov2Config, device):
        super().__init__()
        D = cfg.hidden_size
        self.norm1 = nn.LayerNorm(D, eps=1e-6, device=device)
        self.attn = _Attention(D, cfg.num_heads, device)
        self.ls1 = _LayerScale(D, device)
        self.norm2 = nn.LayerNorm(D, eps=1e-6, device=device)
        self.mlp = _Mlp(D, cfg.mlp_ratio * D, device)
        self.ls2 = _LayerScale(D, device)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.ls1.gamma * self.attn(self.norm1(x))
        return x + self.ls2.gamma * self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: Dinov2Config, device):
        super().__init__()
        # conv-shaped (D, 3, P, P) so hub checkpoints load unchanged;
        # applied as a matrix product in Dinov2.forward_tokens
        self.proj = nn.utils.skip_init(
            nn.Conv2d, 3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size,
            device=device)


class Dinov2(nn.Module):
    """DINOv2 ViT with torch-hub parameter names. Construct with random
    weights through :func:`init_params` or load a converted state dict."""

    def __init__(self, cfg: Dinov2Config, device=None):
        super().__init__()
        dev = resolve_device(device)
        D, G = cfg.hidden_size, cfg.pos_grid
        self.cfg = cfg
        self.cls_token = nn.Parameter(torch.empty(1, 1, D, device=dev))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + G * G, D, device=dev))
        self.patch_embed = _PatchEmbed(cfg, dev)
        self.blocks = nn.ModuleList([_Block(cfg, dev) for _ in range(cfg.num_layers)])
        self.norm = nn.LayerNorm(D, eps=1e-6, device=dev)

    def forward_tokens(self, pixels: Tensor, pos_embed: Tensor) -> Tensor:
        """Run the transformer.

        Args:
          pixels: (B, H, W, 3) normalised images, H/W multiples of the patch size.
          pos_embed: (1 + gh*gw, D) interpolated positional table.

        Returns: (B, 1 + gh*gw, D) final-layernorm tokens (cls first) —
        torch hub's ``x_norm_*`` outputs.
        """
        B, H, W, _ = pixels.shape
        P = self.cfg.patch_size
        D = self.cfg.hidden_size
        gh, gw = H // P, W // P
        x = pixels.reshape(B, gh, P, gw, P, 3).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(B, gh * gw, 3 * P * P)  # (c, py, px): the conv weight's order
        proj = self.patch_embed.proj
        x = F.linear(x, proj.weight.reshape(D, 3 * P * P), proj.bias)
        x = torch.cat([self.cls_token.expand(B, 1, D), x], dim=1) + pos_embed[None]
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


def init_params(cfg: Dinov2Config, generator: Optional[torch.Generator] = None,
                *, device=None) -> Dinov2:
    """A :class:`Dinov2` with random weights drawn as the JAX package's
    ``init_params`` draws them (N(0, 0.02²) matrices and tables, zero
    biases, unit norms, ``layerscale_init`` scales), from ``generator`` (on
    ``device``; a generator seeded with 0 when None). The numbers differ
    from JAX's; carry JAX's own with :func:`load_jax_params`."""
    dev = resolve_device(device)
    model = Dinov2(cfg, device=dev)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in ("cls_token", "pos_embed") or (leaf == "weight" and p.dim() > 1):
                p.normal_(0.0, 0.02, generator=gen)
            elif leaf == "gamma":
                p.fill_(cfg.layerscale_init)
            elif leaf == "weight":  # layer norms
                p.fill_(1.0)
            else:
                p.zero_()
    return model


# ---------------------------------------------------------------------------
# Backbone wrapper (pos-embed cache + preprocessing)
# ---------------------------------------------------------------------------

class Dinov2Backbone:
    """Feature backend: (K, H, W, 3) uint8 images -> (K, ph, pw, D) tokens.

    Matches ``Fusion.extract_dinov2_features`` (``fusion.py:593-629``):
    resize to (ph*14, pw*14), ImageNet-normalise, forward, reshape patch
    tokens to the (ph, pw) grid.
    """

    def __init__(self, model: Dinov2, *, pos_interpolate: str = "hub",
                 resize_mode: str = "pil", device=None):
        """``pos_interpolate``: 'hub' reproduces torch-hub DINOv2's
        scale-factor interpolation with interpolate_offset=0.1 (what the
        reference loads, ``fusion.py:223``); 'hf' is huggingface
        Dinov2Model's exact-size grid.

        ``resize_mode``: 'pil' (default) resizes uint8 images on the device
        with the bit-exact Pillow bilinear resampler the reference's
        ``T.Resize`` uses; 'device' resizes float images on the device with
        :func:`bilinear_resize` (close to PIL, not bit-identical).

        ``device`` defaults to CUDA; the model is moved there.
        """
        if resize_mode not in ("pil", "device"):
            raise ValueError(f"resize_mode must be 'pil' or 'device', got {resize_mode!r}")
        if pos_interpolate not in ("hub", "hf"):
            raise ValueError(f"pos_interpolate must be 'hub' or 'hf', got {pos_interpolate!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.pos_interpolate = pos_interpolate
        self.resize_mode = resize_mode
        self._pos_cache: Dict[Tuple[int, int], Tensor] = {}

    def interpolated_pos_embed(self, gh: int, gw: int) -> Tensor:
        """(1 + gh*gw, D) positional table for a (gh, gw) patch grid."""
        key = (gh, gw)
        if key not in self._pos_cache:
            pe = self.model.pos_embed.detach()[0].cpu().numpy()
            G = int(np.sqrt(pe.shape[0] - 1))
            if (gh, gw) == (G, G):
                out = pe
            else:
                cls_pe, patch_pe = pe[:1], pe[1:].reshape(G, G, -1)
                scale_hw = None  # 'hf': exact-size grid
                if self.pos_interpolate == "hub":
                    # torch hub interpolates with explicit scale factors
                    # (g + 0.1)/G (interpolate_offset=0.1), a different
                    # sampling grid than the plain size ratio
                    scale_hw = ((gh + 0.1) / G, (gw + 0.1) / G)
                patch_pe = cubic_resize_np(patch_pe, (gh, gw), scale_hw=scale_hw)
                out = np.concatenate([cls_pe, patch_pe.reshape(gh * gw, -1)], axis=0)
            self._pos_cache[key] = torch.as_tensor(out).to(self.device)
        return self._pos_cache[key]

    def __call__(self, images, patch_hw: Optional[Tuple[int, int]] = None) -> Tensor:
        K, H, W, _ = images.shape
        P = self.cfg.patch_size
        if patch_hw is None:
            patch_hw = (H // 10, W // 10)
        ph, pw = patch_hw
        pos = self.interpolated_pos_embed(ph, pw)
        if isinstance(images, np.ndarray):
            images = np.ascontiguousarray(images)
        images = torch.as_tensor(images).to(self.device)
        if self.resize_mode == "pil" and images.dtype == torch.uint8:
            images = pil_bilinear_resize_u8(images, (ph * P, pw * P))
        with torch.no_grad():
            return _extract_patch_features(self.model, images, pos, (ph * P, pw * P))


def _extract_patch_features(model: Dinov2, images_u8: Tensor, pos_embed: Tensor,
                            resize_hw: Tuple[int, int]) -> Tensor:
    """uint8 (K, H, W, 3) -> (K, ph, pw, D) patch tokens."""
    pixels = images_u8.to(torch.float32) / 255.0
    if tuple(pixels.shape[1:3]) != tuple(resize_hw):  # pre-resized (pil mode): skip
        pixels = bilinear_resize(pixels, resize_hw)
    mean, std = imagenet_stats(pixels.device)
    tokens = model.forward_tokens((pixels - mean) / std, pos_embed)
    P = model.cfg.patch_size
    ph, pw = resize_hw[0] // P, resize_hw[1] // P
    return tokens[:, 1:].reshape(images_u8.shape[0], ph, pw, -1)


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------

_BLOCK_KEYS = (
    "norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
    "attn.proj.weight", "attn.proj.bias", "ls1.gamma", "norm2.weight",
    "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
    "mlp.fc2.bias", "ls2.gamma",
)


def convert_hub_state_dict(sd, cfg: Dinov2Config) -> Dict[str, Tensor]:
    """A facebookresearch/dinov2 torch-hub state dict (the checkpoints the
    reference downloads, ``fusion.py:223``) as a :class:`Dinov2` state dict:
    the same names and layouts, without the unused ``mask_token``."""
    sd = np_view(sd)
    keys = ["cls_token", "pos_embed", "patch_embed.proj.weight",
            "patch_embed.proj.bias", "norm.weight", "norm.bias"]
    keys += [f"blocks.{i}.{k}" for i in range(cfg.num_layers) for k in _BLOCK_KEYS]
    return {k: torch.from_numpy(np.array(sd[k], np.float32)) for k in keys}


def convert_hf_state_dict(sd, cfg: Dinov2Config) -> Dict[str, Tensor]:
    """A huggingface ``Dinov2Model`` state dict as a :class:`Dinov2` state
    dict (query/key/value fused into hub's ``qkv``)."""
    sd = np_view(sd)
    hub = {
        "cls_token": sd["embeddings.cls_token"],
        "pos_embed": sd["embeddings.position_embeddings"],
        "patch_embed.proj.weight": sd["embeddings.patch_embeddings.projection.weight"],
        "patch_embed.proj.bias": sd["embeddings.patch_embeddings.projection.bias"],
        "norm.weight": sd["layernorm.weight"],
        "norm.bias": sd["layernorm.bias"],
    }
    for i in range(cfg.num_layers):
        pre, blk = f"encoder.layer.{i}", f"blocks.{i}"
        att = f"{pre}.attention.attention"
        hub[f"{blk}.attn.qkv.weight"] = np.concatenate(
            [sd[f"{att}.{n}.weight"] for n in ("query", "key", "value")], axis=0)
        hub[f"{blk}.attn.qkv.bias"] = np.concatenate(
            [sd[f"{att}.{n}.bias"] for n in ("query", "key", "value")], axis=0)
        for ours, theirs in (
            ("norm1", "norm1"), ("norm2", "norm2"), ("mlp.fc1", "mlp.fc1"),
            ("mlp.fc2", "mlp.fc2"), ("attn.proj", "attention.output.dense"),
        ):
            hub[f"{blk}.{ours}.weight"] = sd[f"{pre}.{theirs}.weight"]
            hub[f"{blk}.{ours}.bias"] = sd[f"{pre}.{theirs}.bias"]
        hub[f"{blk}.ls1.gamma"] = sd[f"{pre}.layer_scale1.lambda1"]
        hub[f"{blk}.ls2.gamma"] = sd[f"{pre}.layer_scale2.lambda1"]
    return convert_hub_state_dict(hub, cfg)


def load_jax_params(model: Dinov2, params: Dict[str, np.ndarray]) -> Dinov2:
    """Copy the JAX package's DINOv2 parameter dict (the stacked ``(L, ...)``
    leaves of ``d3fields_tpu.models.dinov2.init_params``, as numpy arrays)
    into ``model``, in place. Returns ``model``."""
    cfg = model.cfg
    P, D = cfg.patch_size, cfg.hidden_size
    p = {k: np.asarray(v, np.float32) for k, v in params.items()}
    sd = {
        "cls_token": p["cls_token"].reshape(1, 1, D),
        "pos_embed": p["pos_embed"][None],
        # (py, px, c) rows of patch_w -> the conv weight (D, c, py, px)
        "patch_embed.proj.weight": p["patch_w"].reshape(P, P, 3, D).transpose(3, 2, 0, 1),
        "patch_embed.proj.bias": p["patch_b"],
        "norm.weight": p["norm_w"],
        "norm.bias": p["norm_b"],
    }
    per_layer = {
        "norm1.weight": ("ln1_w", False), "norm1.bias": ("ln1_b", False),
        "attn.qkv.weight": ("qkv_w", True), "attn.qkv.bias": ("qkv_b", False),
        "attn.proj.weight": ("proj_w", True), "attn.proj.bias": ("proj_b", False),
        "ls1.gamma": ("ls1", False),
        "norm2.weight": ("ln2_w", False), "norm2.bias": ("ln2_b", False),
        "mlp.fc1.weight": ("fc1_w", True), "mlp.fc1.bias": ("fc1_b", False),
        "mlp.fc2.weight": ("fc2_w", True), "mlp.fc2.bias": ("fc2_b", False),
        "ls2.gamma": ("ls2", False),
    }
    for i in range(cfg.num_layers):
        for ours, (theirs, transpose) in per_layer.items():
            leaf = p[theirs][i]
            sd[f"blocks.{i}.{ours}"] = leaf.T if transpose else leaf  # (in, out) -> (out, in)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    return model

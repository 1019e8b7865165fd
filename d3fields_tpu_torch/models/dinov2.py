"""DINOv2 vision transformer in PyTorch.

Counterpart of ``d3fields_tpu/models/dinov2.py``. The reference loads
DINOv2 ViT-L/14 from torch hub and takes ``x_norm_patchtokens`` as the
per-view descriptor map (``fusion.py:593-629``). Beyond the JAX package,
:class:`Dinov2Config` also describes torch hub's giant models
(``dinov2_vitg14``, ``dinov2_vitg14_reg``): the fused SwiGLU feed-forward
(``SwiGLUFFNFused``: ``w12`` then ``w3``), register tokens (inserted after
the positional add, between the class token and the patches, and dropped
from the descriptors), and the positional table interpolated bicubically
with antialiasing at the exact grid size (``interpolate_offset`` 0).

- :class:`Dinov2` keeps torch hub's parameter names and layouts, so a hub
  state dict loads as it is (:func:`convert_hub_state_dict` only checks and
  drops ``mask_token``); :func:`convert_hf_state_dict` re-keys a
  huggingface ``Dinov2Model`` state dict, and :func:`load_jax_params`
  carries the JAX package's stacked parameter dict across.
- Patch embedding is an unfold times the (D, 3·P·P) view of the conv
  weight, so it is a matrix product that TF32 settings for convolutions do
  not touch. GELU is exact. Each layer's attention core is
  :func:`attention.vit_attention`: on the card one launch of
  ``csrc/sam_attention.cu``'s bias-free mode, which keeps the logits in
  f32 and never writes them; on the CPU the plain ``matmul`` + ``softmax``
  chain.
- The transformer runs in the dtype of its weights, float32 or bfloat16
  (the JAX package's ``compute_dtype``, ``dinov2.py:125-176``): a bf16
  model takes bf16 pixels, positions and tokens; its LayerNorms take their
  statistics and apply the affine in f32 and round once (torch's layer
  norm of a bf16 tensor); the attention logits are scaled and soft-maxed
  in f32 (the plain chain rounds them to bf16 first, the kernel does not)
  and the probabilities rounded to bf16; the final tokens come back as
  f32.
- On the card, with autograd off, :meth:`Dinov2.forward_tokens` replays a
  CUDA graph of :meth:`Dinov2.forward_tokens_eager`, one captured at the
  first call of each input signature (``utils/cuda_graph.py``): the host
  issues one launch where the eager ViT-L issues ~300. Its tokens are the
  eager call's, bit for bit.
- With :data:`tracer` on, ``dinov2.forward`` spans the transformer (the
  graphed call); the counters ``dinov2_forwards`` (transformer calls) and
  ``dinov2_tokens`` (tokens entering the blocks, ``B * (1 + R + gh*gw)``)
  are counted from host integers, the attention's launches at each replay
  too; the graph's captures and replays as ``dinov2_graph_captures`` and
  ``dinov2_graph_replays``.
- :class:`Dinov2Backbone` resizes with the bit-exact Pillow resampler
  ('pil', default) or antialiased bilinear ('device'), both on the device,
  normalises,
  runs the transformer and returns the patch tokens on the (ph, pw) grid,
  with positional embeddings interpolated per grid and cached. Its
  ``compute_dtype='bfloat16'`` rounds the weights once, at construction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from d3fields_tpu_torch.models.attention import vit_attention
from d3fields_tpu_torch.models.common import cast_copy, imagenet_stats, linear, torch_dtype
from d3fields_tpu_torch.models.resize import (
    bilinear_resize, cubic_resize_np, pil_bilinear_resize_u8,
)
from d3fields_tpu_torch.parallel.mesh import ViewShards
from d3fields_tpu_torch.utils.convert import np_view
from d3fields_tpu_torch.utils.cuda_graph import GraphCache
from d3fields_tpu_torch.utils.device import resolve_device
from d3fields_tpu_torch.utils.profiling import tracer

Tensor = torch.Tensor
FFN_KINDS = ("mlp", "swiglu")


@dataclasses.dataclass(frozen=True)
class Dinov2Config:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    patch_size: int = 14
    layerscale_init: float = 1.0
    image_size: int = 518  # pretraining grid: (518/14)^2 = 37^2 positions
    ffn: str = "mlp"  # 'mlp': GELU fc1/fc2; 'swiglu': torch hub's SwiGLUFFNFused, w12/w3
    num_register_tokens: int = 0
    # torch hub's interpolate_pos_encoding: offset 0 interpolates to the
    # exact grid size, otherwise by the scale factors (g + offset) / G
    interpolate_antialias: bool = False
    interpolate_offset: float = 0.1

    def __post_init__(self):
        if self.ffn not in FFN_KINDS:
            raise ValueError(f"ffn must be one of {FFN_KINDS}, got {self.ffn!r}")

    @staticmethod
    def vit_large() -> "Dinov2Config":
        return Dinov2Config()

    @staticmethod
    def vit_giant2() -> "Dinov2Config":
        """torch hub's ``dinov2_vitg14``."""
        return Dinov2Config(hidden_size=1536, num_layers=40, num_heads=24, ffn="swiglu")

    @staticmethod
    def vit_giant2_reg() -> "Dinov2Config":
        """torch hub's ``dinov2_vitg14_reg``: 4 registers, the positional
        table antialiased at the exact grid size."""
        return dataclasses.replace(Dinov2Config.vit_giant2(), num_register_tokens=4,
                                   interpolate_antialias=True, interpolate_offset=0.0)

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

    @property
    def ffn_hidden(self) -> int:
        """The feed-forward's hidden width: ``mlp_ratio * D``, which
        ``SwiGLUFFNFused`` takes to two thirds, rounded up to a multiple of 8
        (4096 at D = 1536)."""
        hidden = self.mlp_ratio * self.hidden_size
        return (int(hidden * 2 / 3) + 7) // 8 * 8 if self.ffn == "swiglu" else hidden


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
        return self.proj(vit_attention(self.qkv(x).reshape(B, N, 3, nh, D // nh)))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device):
        super().__init__()
        self.fc1 = linear(dim, hidden, device)
        self.fc2 = linear(hidden, dim, device)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class _SwiGLUFFN(nn.Module):
    """torch hub's ``SwiGLUFFNFused``: ``w3(silu(x1) * x2)`` with ``x1, x2``
    the two halves of ``w12(x)``; in bf16 each op rounds to bf16."""

    def __init__(self, dim: int, hidden: int, device):
        super().__init__()
        self.w12 = linear(dim, 2 * hidden, device)
        self.w3 = linear(hidden, dim, device)

    def forward(self, x: Tensor) -> Tensor:
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class _Block(nn.Module):
    def __init__(self, cfg: Dinov2Config, device):
        super().__init__()
        D = cfg.hidden_size
        self.norm1 = nn.LayerNorm(D, eps=1e-6, device=device)
        self.attn = _Attention(D, cfg.num_heads, device)
        self.ls1 = _LayerScale(D, device)
        self.norm2 = nn.LayerNorm(D, eps=1e-6, device=device)
        ffn = _SwiGLUFFN if cfg.ffn == "swiglu" else _Mlp
        self.mlp = ffn(D, cfg.ffn_hidden, device)
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
        R = cfg.num_register_tokens
        self.register_tokens = nn.Parameter(torch.empty(1, R, D, device=dev)) if R else None
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + G * G, D, device=dev))
        self.patch_embed = _PatchEmbed(cfg, dev)
        self.blocks = nn.ModuleList([_Block(cfg, dev) for _ in range(cfg.num_layers)])
        self.norm = nn.LayerNorm(D, eps=1e-6, device=dev)
        self._graphs = GraphCache("dinov2_graph")

    def forward_tokens(self, pixels: Tensor, pos_embed: Tensor) -> Tensor:
        """:meth:`forward_tokens_eager`'s tokens. On CUDA inputs with
        autograd off, a replay of a CUDA graph of it, one captured at the
        first call of each signature (the inputs' shapes, strides and
        dtypes); elsewhere the eager call itself."""
        B, H, W, _ = pixels.shape
        P = self.cfg.patch_size
        tracer.count("dinov2_forwards")
        tracer.count("dinov2_tokens",
                     B * (1 + self.cfg.num_register_tokens + (H // P) * (W // P)))
        with tracer.span("dinov2.forward"):
            return self._graphs(self.forward_tokens_eager, pixels, pos_embed, weights=(self,))

    def forward_tokens_eager(self, pixels: Tensor, pos_embed: Tensor) -> Tensor:
        """Run the transformer.

        Args:
          pixels: (B, H, W, 3) normalised images, H/W multiples of the patch size.
          pos_embed: (1 + gh*gw, D) interpolated positional table.

        Returns: (B, 1 + R + gh*gw, D) final-layernorm tokens (cls, then the
        R register tokens, then the patches) — torch hub's ``x_norm_*``
        outputs, in f32 whatever the weights' dtype.
        """
        B, H, W, _ = pixels.shape
        P = self.cfg.patch_size
        D = self.cfg.hidden_size
        dt = self.cls_token.dtype
        gh, gw = H // P, W // P
        x = pixels.reshape(B, gh, P, gw, P, 3).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(B, gh * gw, 3 * P * P).to(dt)  # (c, py, px): the conv weight's order
        proj = self.patch_embed.proj
        x = F.linear(x, proj.weight.reshape(D, 3 * P * P), proj.bias)
        x = torch.cat([self.cls_token.expand(B, 1, D), x], dim=1) + pos_embed[None].to(dt)
        if self.register_tokens is not None:  # no position: inserted after the add
            x = torch.cat([x[:, :1], self.register_tokens.expand(B, -1, -1), x[:, 1:]], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x).float()


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
            if name in ("cls_token", "register_tokens", "pos_embed") or \
                    (leaf == "weight" and p.dim() > 1):
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

    def __init__(self, model: Dinov2, *, compute_dtype: str = "float32",
                 pos_interpolate: str = "hub", resize_mode: str = "pil", device=None):
        """``pos_interpolate``: 'hub' reproduces torch-hub DINOv2's
        interpolation as the model's config states it: the scale factors of
        interpolate_offset=0.1 without antialiasing (what the reference
        loads, ``fusion.py:223``; the JAX package's table to the bit), or
        ``F.interpolate`` in float64 with the config's offset and antialias
        (the register models: the exact grid size, antialiased); 'hf' is
        huggingface Dinov2Model's exact-size grid.

        ``resize_mode``: 'pil' (default) resizes uint8 images on the device
        with the bit-exact Pillow bilinear resampler the reference's
        ``T.Resize`` uses; 'device' resizes float images on the device with
        :func:`bilinear_resize` (close to PIL, not bit-identical).

        ``compute_dtype`` 'bfloat16' runs the transformer on a copy of the
        model's weights rounded to bf16 once, here (``model`` keeps its own);
        the positional table stays f32 until it is interpolated.

        ``device`` defaults to CUDA; the model is moved there.
        """
        if resize_mode not in ("pil", "device"):
            raise ValueError(f"resize_mode must be 'pil' or 'device', got {resize_mode!r}")
        if pos_interpolate not in ("hub", "hf"):
            raise ValueError(f"pos_interpolate must be 'hub' or 'hf', got {pos_interpolate!r}")
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        # the transformer in the compute dtype; its pos_embed stays f32
        self.model = cast_copy(model.to(self.device).eval(), torch_dtype(compute_dtype),
                               ("cls_token", "register_tokens", "patch_embed.", "blocks.",
                                "norm."))
        self.cfg = model.cfg
        self.pos_interpolate = pos_interpolate
        self.resize_mode = resize_mode
        self._views = ViewShards.on(self.device, self.model)
        self.device = self._views.first
        # each positional table used, on every device of the shards
        self._pos_cache: Dict[Tuple[int, int], Dict[torch.device, Tensor]] = {}

    def shard_views(self, mesh) -> "Dinov2Backbone":
        """Split the view axis of each call over ``mesh`` (JAX
        ``dinov2.py:217-232``): the transformer is replicated on each device
        of the mesh, each device runs its views with no collective, and the
        tokens come back in view order on the mesh's first device, which
        becomes this backbone's device. The mesh size must divide the view
        count of a call. Each device keeps its own copy of every positional
        table it has used."""
        self._views = ViewShards(mesh, self.model)
        self.device = mesh.first
        self.model = self._views.replicas[self.device]
        self._pos_cache = {}
        return self

    def interpolated_pos_embed(self, gh: int, gw: int) -> Tensor:
        """(1 + gh*gw, D) positional table for a (gh, gw) patch grid."""
        return self._pos_tables(gh, gw)[self.device]

    def _pos_tables(self, gh: int, gw: int) -> Dict[torch.device, Tensor]:
        """The table of :meth:`interpolated_pos_embed` on each device."""
        key = (gh, gw)
        if key not in self._pos_cache:
            pe = self.model.pos_embed.detach()[0].cpu().numpy()
            G = int(np.sqrt(pe.shape[0] - 1))
            if (gh, gw) == (G, G):
                out = pe
            else:
                cls_pe, patch_pe = pe[:1], pe[1:].reshape(G, G, -1)
                cfg = self.cfg
                if self.pos_interpolate == "hub" and (
                        cfg.interpolate_antialias or cfg.interpolate_offset != 0.1):
                    patch_pe = _hub_interpolate(patch_pe, (gh, gw), cfg.interpolate_offset,
                                                cfg.interpolate_antialias)
                else:
                    scale_hw = None  # 'hf': exact-size grid
                    if self.pos_interpolate == "hub":
                        # torch hub interpolates with explicit scale factors
                        # (g + 0.1)/G (interpolate_offset=0.1), a different
                        # sampling grid than the plain size ratio
                        scale_hw = ((gh + 0.1) / G, (gw + 0.1) / G)
                    patch_pe = cubic_resize_np(patch_pe, (gh, gw), scale_hw=scale_hw)
                out = np.concatenate([cls_pe, patch_pe.reshape(gh * gw, -1)], axis=0)
            table = torch.as_tensor(out)
            self._pos_cache[key] = {d: table.to(d) for d in self._views.replicas}
        return self._pos_cache[key]

    def __call__(self, images, patch_hw: Optional[Tuple[int, int]] = None) -> Tensor:
        K, H, W, _ = images.shape
        if patch_hw is None:
            patch_hw = (H // 10, W // 10)
        ph, pw = patch_hw
        pos = self._pos_tables(ph, pw)
        return self._views.map(
            lambda model, dev, imgs: self._extract(model, imgs, pos[dev], ph, pw), images)

    def _extract(self, model: Dinov2, images: Tensor, pos: Tensor, ph: int, pw: int) -> Tensor:
        P = self.cfg.patch_size
        if self.resize_mode == "pil" and images.dtype == torch.uint8:
            images = pil_bilinear_resize_u8(images, (ph * P, pw * P))
        with torch.no_grad():
            return _extract_patch_features(model, images, pos, (ph * P, pw * P))


def _hub_interpolate(grid: np.ndarray, out_hw: Tuple[int, int], offset: float,
                     antialias: bool) -> np.ndarray:
    """torch hub's ``interpolate_pos_encoding`` of a (G, G, D) table to
    ``out_hw``, bicubic in float64: by the scale factors (g + offset) / G,
    or at the exact size where ``offset`` is 0; antialiased where asked."""
    G = grid.shape[0]
    x = torch.from_numpy(grid).double().permute(2, 0, 1)[None]
    size = {"scale_factor": ((out_hw[0] + offset) / G, (out_hw[1] + offset) / G)} if offset \
        else {"size": tuple(out_hw)}
    x = F.interpolate(x, mode="bicubic", antialias=antialias, align_corners=False, **size)
    assert tuple(x.shape[-2:]) == tuple(out_hw), (x.shape, out_hw, offset)
    return x[0].permute(1, 2, 0).numpy().astype(grid.dtype)


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
    first = 1 + model.cfg.num_register_tokens  # the class token and the registers
    return tokens[:, first:].reshape(images_u8.shape[0], ph, pw, -1)


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------

_BLOCK_KEYS = (
    "norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
    "attn.proj.weight", "attn.proj.bias", "ls1.gamma", "norm2.weight",
    "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
    "mlp.fc2.bias", "ls2.gamma",
)


def _block_keys(cfg: Dinov2Config) -> Tuple[str, ...]:
    if cfg.ffn == "mlp":
        return _BLOCK_KEYS
    return tuple(k.replace("mlp.fc1", "mlp.w12").replace("mlp.fc2", "mlp.w3") for k in _BLOCK_KEYS)


def convert_hub_state_dict(sd, cfg: Dinov2Config) -> Dict[str, Tensor]:
    """A facebookresearch/dinov2 torch-hub state dict (the checkpoints the
    reference downloads, ``fusion.py:223``) as a :class:`Dinov2` state dict:
    the same names and layouts (``register_tokens`` and the SwiGLU's
    ``mlp.w12`` / ``mlp.w3`` where ``cfg`` has them), without the unused
    ``mask_token``."""
    sd = np_view(sd)
    keys = ["cls_token", "pos_embed", "patch_embed.proj.weight",
            "patch_embed.proj.bias", "norm.weight", "norm.bias"]
    keys += ["register_tokens"] * bool(cfg.num_register_tokens)
    keys += [f"blocks.{i}.{k}" for i in range(cfg.num_layers) for k in _block_keys(cfg)]
    return {k: torch.from_numpy(np.array(sd[k], np.float32)) for k in keys}


# the presets a hub state dict is matched against, by name (looked up at
# each call)
_PRESETS = ("vit_small", "vit_base", "vit_large", "vit_giant2", "vit_giant2_reg")


def config_for_state_dict(sd) -> Dinov2Config:
    """The preset of a torch-hub state dict (``dinov2_vit{s,b,l,g}14`` and
    ``dinov2_vitg14_reg``), read from its keys and widths: the width of
    ``pos_embed`` and its grid, the count of ``blocks.*``, whether
    ``mlp.w12`` (SwiGLU) and ``register_tokens`` are there and how many
    registers. The head count is the preset's: a state dict does not hold
    it. The checkpoint loaders (``apps/_backends.py``) call it."""
    if "pos_embed" not in sd:
        raise ValueError("cannot sniff the DINOv2 variant: no 'pos_embed' in the state dict "
                         "— pass an explicit cfg")
    shape = tuple(np.shape(sd["pos_embed"]))
    blocks = {int(k.split(".")[1]) for k in sd if k.startswith("blocks.")}
    found = dict(hidden_size=shape[-1], num_layers=len(blocks),
                 pos_grid=int(round((shape[1] - 1) ** 0.5)),
                 ffn="swiglu" if "blocks.0.mlp.w12.weight" in sd else "mlp",
                 num_register_tokens=int(np.shape(sd["register_tokens"])[1])
                 if "register_tokens" in sd else 0)
    for name in _PRESETS:
        cfg = getattr(Dinov2Config, name)()
        if all(getattr(cfg, k) == v for k, v in found.items()):
            return cfg
    raise ValueError(f"no DINOv2 preset ({', '.join(_PRESETS)}) has {found} — pass an "
                     "explicit cfg")


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
    into ``model``, in place. Returns ``model``. The JAX package has neither
    the SwiGLU feed-forward nor register tokens: a config with either
    raises ``ValueError``."""
    cfg = model.cfg
    if cfg.ffn != "mlp" or cfg.num_register_tokens:
        raise ValueError("the JAX package's DINOv2 has the GELU MLP and no register tokens; "
                         f"cannot load its parameters into ffn={cfg.ffn!r} with "
                         f"{cfg.num_register_tokens} registers")
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

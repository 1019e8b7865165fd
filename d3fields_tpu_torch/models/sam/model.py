"""Segment Anything (SAM) in PyTorch: the box-prompted path.

Counterpart of ``d3fields_tpu/models/sam/model.py``. :class:`Sam` keeps the
parameter names of huggingface ``SamModel``, so its state dict loads with
``load_state_dict(strict=True)``; :func:`load_jax_params` carries the JAX
package's parameter pytree across and :func:`init_params` draws random
weights as the JAX package's ``random_params_direct`` does.

- :meth:`Sam.encode` is the ViT image encoder: patch embedding, absolute
  positions, windowed and global attention with decomposed relative
  positions, and the two-convolution neck with channel layer norms.
- :meth:`Sam.decode_boxes` embeds box prompts and runs the two-way mask
  decoder for every box of every view in one batch.
- Layouts are NHWC, as in the JAX package. Patch embedding and the
  decoder's 2x2 transposed convolutions are matrix products.

Point and mask prompts (``embed_points``, ``embed_mask_dense``,
``sam_decode_points``) are not ported yet; their parameters
(``prompt_encoder.point_embed.{0,1}``, ``not_a_point_embed``,
``mask_embed``) load with the rest and are unused.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from d3fields_tpu_torch.models.common import embedding, linear, named
from d3fields_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SamConfig:
    # vision encoder
    hidden_size: int = 1280            # ViT-H
    num_layers: int = 32
    num_heads: int = 16
    mlp_dim: int = 5120
    patch_size: int = 16
    image_size: int = 1024
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    output_channels: int = 256
    # prompt encoder / decoder
    prompt_hidden: int = 256
    decoder_heads: int = 8
    decoder_layers: int = 2
    decoder_mlp_dim: int = 2048
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden: int = 256
    mask_input_channels: int = 16

    @staticmethod
    def vit_huge() -> "SamConfig":
        return SamConfig()

    @staticmethod
    def tiny_test() -> "SamConfig":
        return SamConfig(
            hidden_size=32, num_layers=2, num_heads=2, mlp_dim=128,
            patch_size=8, image_size=64, window_size=14,
            global_attn_indexes=(1,), output_channels=16, prompt_hidden=16,
            decoder_heads=2, decoder_mlp_dim=64, iou_head_hidden=16,
        )

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


# ---------------------------------------------------------------------------
# vision encoder
# ---------------------------------------------------------------------------

def _rel_pos_bias(q_hw: Tuple[int, int], rel_h: Tensor, rel_w: Tensor, query: Tensor) -> Tensor:
    """Decomposed relative position bias (HF ``get_decomposed_rel_pos``
    with equal query and key sizes). query (B, h*w, hd) unscaled."""
    qh, qw = q_hw
    dev = query.device
    idx_h = torch.arange(qh, device=dev)[:, None] - torch.arange(qh, device=dev)[None] + qh - 1
    idx_w = torch.arange(qw, device=dev)[:, None] - torch.arange(qw, device=dev)[None] + qw - 1
    q = query.reshape(query.shape[0], qh, qw, -1)
    bias_h = torch.einsum("bhwc,hkc->bhwk", q, rel_h[idx_h])
    bias_w = torch.einsum("bhwc,wkc->bhwk", q, rel_w[idx_w])
    return (bias_h[..., :, None] + bias_w[..., None, :]).reshape(-1, qh * qw, qh * qw)


class _VisionAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, rel_size: int, device):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = linear(dim, 3 * dim, device)
        self.proj = linear(dim, dim, device)
        self.rel_pos_h = nn.Parameter(torch.empty(2 * rel_size - 1, hd, device=device))
        self.rel_pos_w = nn.Parameter(torch.empty(2 * rel_size - 1, hd, device=device))

    def forward(self, x: Tensor) -> Tensor:
        """x (B, h, w, C): one window or the whole map per batch entry."""
        B, h, w, C = x.shape
        nh = self.num_heads
        hd = C // nh
        qkv = self.qkv(x.reshape(B, h * w, C)).reshape(B, h * w, 3, nh, hd)
        qkv = qkv.permute(2, 0, 3, 1, 4).reshape(3, B * nh, h * w, hd)
        q, k, v = qkv[0], qkv[1], qkv[2]
        logits = torch.matmul(q * (hd ** -0.5), k.transpose(-1, -2))
        # in place: a global layer's (B*nh, 4096, 4096) logits are 1 GB a view
        logits.add_(_rel_pos_bias((h, w), self.rel_pos_h, self.rel_pos_w, q))
        probs = torch.softmax(logits, dim=-1)
        out = torch.matmul(probs, v).reshape(B, nh, h, w, hd).permute(0, 2, 3, 1, 4)
        return self.proj(out.reshape(B, h, w, C))


def _window_partition(x: Tensor, ws: int):
    B, H, W, C = x.shape
    ph, pw = (-H) % ws, (-W) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def _window_unpartition(win: Tensor, ws: int, padded_hw, orig_hw) -> Tensor:
    Hp, Wp = padded_hw
    H, W = orig_hw
    B = win.shape[0] // ((Hp // ws) * (Wp // ws))
    x = win.reshape(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


class _VisionLayer(nn.Module):
    def __init__(self, cfg: SamConfig, window: int, device):
        super().__init__()
        D = cfg.hidden_size
        self.window = window
        self.layer_norm1 = nn.LayerNorm(D, eps=1e-6, device=device)
        self.attn = _VisionAttention(D, cfg.num_heads, window or cfg.grid, device)
        self.layer_norm2 = nn.LayerNorm(D, eps=1e-6, device=device)
        self.mlp = named(lin1=linear(D, cfg.mlp_dim, device), lin2=linear(cfg.mlp_dim, D, device))

    def forward(self, x: Tensor) -> Tensor:
        h = self.layer_norm1(x)
        if self.window:
            win, padded = _window_partition(h, self.window)
            h = _window_unpartition(self.attn(win), self.window, padded, x.shape[1:3])
        else:
            h = self.attn(h)
        x = x + h
        h = F.gelu(self.mlp.lin1(self.layer_norm2(x)), approximate="none")
        return x + self.mlp.lin2(h)


class _PositionalEmbedding(nn.Module):
    """Random-Fourier positional encoding (HF ``SamPositionalEmbedding``)."""

    def __init__(self, num_pos_feats: int, device):
        super().__init__()
        self.register_buffer("positional_embedding", torch.empty(2, num_pos_feats, device=device))

    def forward(self, coords01: Tensor) -> Tensor:
        """[0, 1] coordinates (..., 2) -> (..., 2*num_pos_feats)."""
        c = torch.matmul(2.0 * coords01 - 1.0, self.positional_embedding)
        c = 2.0 * np.pi * c
        return torch.cat([c.sin(), c.cos()], dim=-1)


class _Attention(nn.Module):
    """``SamAttention``: project to the internal width, multi-head, project out."""

    def __init__(self, dim: int, internal: int, num_heads: int, device):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = linear(dim, internal, device)
        self.k_proj = linear(dim, internal, device)
        self.v_proj = linear(dim, internal, device)
        self.out_proj = linear(internal, dim, device)

    def forward(self, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        qi, ki, vi = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        B, Tq, Ci = qi.shape
        nh = self.num_heads
        hd = Ci // nh

        def heads(t: Tensor) -> Tensor:
            return t.reshape(B, t.shape[1], nh, hd).transpose(1, 2)

        logits = torch.matmul(heads(qi), heads(ki).transpose(-1, -2)) * (hd ** -0.5)
        probs = torch.softmax(logits, dim=-1)
        out = torch.matmul(probs, heads(vi)).transpose(1, 2).reshape(B, Tq, Ci)
        return self.out_proj(out)


class _FeedForward(nn.Module):
    """``SamFeedForward``: ReLU MLP of ``depth`` layers."""

    def __init__(self, d_in: int, hidden: int, d_out: int, depth: int, device):
        super().__init__()
        self.proj_in = linear(d_in, hidden, device)
        self.layers = nn.ModuleList([linear(hidden, hidden, device) for _ in range(depth - 2)])
        self.proj_out = linear(hidden, d_out, device)

    def forward(self, x: Tensor) -> Tensor:
        h = F.relu(self.proj_in(x))
        for layer in self.layers:
            h = F.relu(layer(h))
        return self.proj_out(h)


class _TwoWayLayer(nn.Module):
    def __init__(self, C: int, cfg: SamConfig, device):
        super().__init__()
        nh = cfg.decoder_heads
        self.self_attn = _Attention(C, C, nh, device)
        self.cross_attn_token_to_image = _Attention(C, C // 2, nh, device)
        self.cross_attn_image_to_token = _Attention(C, C // 2, nh, device)
        self.mlp = named(lin1=linear(C, cfg.decoder_mlp_dim, device),
                         lin2=linear(cfg.decoder_mlp_dim, C, device))
        for j in range(1, 5):
            self.add_module(f"layer_norm{j}", nn.LayerNorm(C, eps=1e-5, device=device))

    def forward(self, queries, keys, tokens, image_pe, first: bool):
        if first:
            # skip_first_layer_pe: the self-attention output replaces the
            # queries, with no residual (HF SamTwoWayAttentionBlock)
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + tokens
            queries = queries + self.self_attn(q, q, queries)
        queries = self.layer_norm1(queries)
        q, k = queries + tokens, keys + image_pe
        queries = self.layer_norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        h = self.mlp.lin2(F.relu(self.mlp.lin1(queries)))
        queries = self.layer_norm3(queries + h)
        q, k = queries + tokens, keys + image_pe
        keys = self.layer_norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


def _conv_transpose_2x(x: Tensor, weight: Tensor, bias: Tensor) -> Tensor:
    """ConvTranspose2d(kernel 2, stride 2) of an NHWC map as one matrix
    product: the 2x2 output cells of each input pixel do not overlap.
    weight is torch's (C_in, C_out, 2, 2)."""
    N, h, w, Cin = x.shape
    Cout = weight.shape[1]
    y = torch.matmul(x, weight.reshape(Cin, Cout * 4)).reshape(N, h, w, Cout, 2, 2)
    return y.permute(0, 1, 4, 2, 5, 3).reshape(N, 2 * h, 2 * w, Cout) + bias


class Sam(nn.Module):
    """SAM with the parameter names of huggingface ``SamModel``."""

    def __init__(self, cfg: SamConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        D, P, G = cfg.hidden_size, cfg.patch_size, cfg.grid
        Cout, C, mc = cfg.output_channels, cfg.prompt_hidden, cfg.mask_input_channels
        nm = cfg.num_multimask_outputs + 1
        conv = lambda *a, **k: nn.utils.skip_init(nn.Conv2d, *a, device=dev, **k)  # noqa: E731
        ln = lambda n, eps=1e-6: nn.LayerNorm(n, eps=eps, device=dev)  # noqa: E731

        pe = _PositionalEmbedding(C // 2, dev)
        self.shared_image_embedding = pe
        vision = named(
            patch_embed=named(projection=conv(3, D, P, stride=P)),
            layers=nn.ModuleList([
                _VisionLayer(cfg, 0 if i in cfg.global_attn_indexes else cfg.window_size, dev)
                for i in range(cfg.num_layers)]),
            neck=named(conv1=conv(D, Cout, 1, bias=False), layer_norm1=ln(Cout),
                       conv2=conv(Cout, Cout, 3, padding=1, bias=False), layer_norm2=ln(Cout)))
        vision.pos_embed = nn.Parameter(torch.empty(1, G, G, D, device=dev))
        self.vision_encoder = vision
        self.prompt_encoder = named(
            shared_embedding=pe,
            mask_embed=named(conv1=conv(1, mc // 4, 2, stride=2),
                             conv2=conv(mc // 4, mc, 2, stride=2),
                             conv3=conv(mc, C, 1),
                             layer_norm1=ln(mc // 4), layer_norm2=ln(mc)),
            no_mask_embed=embedding(1, C, dev),
            point_embed=nn.ModuleList([embedding(1, C, dev) for _ in range(4)]),
            not_a_point_embed=embedding(1, C, dev))
        transformer = named(
            layers=nn.ModuleList([_TwoWayLayer(C, cfg, dev) for _ in range(cfg.decoder_layers)]),
            final_attn_token_to_image=_Attention(C, C // 2, cfg.decoder_heads, dev),
            layer_norm_final_attn=ln(C, 1e-5))
        self.mask_decoder = named(
            iou_token=embedding(1, C, dev),
            mask_tokens=embedding(nm, C, dev),
            transformer=transformer,
            upscale_conv1=nn.utils.skip_init(nn.ConvTranspose2d, C, C // 4, 2, stride=2,
                                             device=dev),
            upscale_conv2=nn.utils.skip_init(nn.ConvTranspose2d, C // 4, C // 8, 2, stride=2,
                                             device=dev),
            upscale_layer_norm=ln(C // 4),
            output_hypernetworks_mlps=nn.ModuleList(
                [_FeedForward(C, C, C // 8, 3, dev) for _ in range(nm)]),
            iou_prediction_head=_FeedForward(C, cfg.iou_head_hidden, nm, cfg.iou_head_depth,
                                             dev))

    # ---- image encoder -------------------------------------------------

    def encode(self, pixels: Tensor) -> Tensor:
        """pixels (B, S, S, 3) preprocessed -> image embeddings (B, h, w, C)."""
        cfg, ve = self.cfg, self.vision_encoder
        P, D = cfg.patch_size, cfg.hidden_size
        B, H, W, _ = pixels.shape
        gh, gw = H // P, W // P
        # patch embedding as a matrix product over (c, py, px), the conv weight's order
        x = pixels.reshape(B, gh, P, gw, P, 3).permute(0, 1, 3, 5, 2, 4)
        proj = ve.patch_embed.projection
        x = F.linear(x.reshape(B, gh, gw, 3 * P * P), proj.weight.reshape(D, 3 * P * P),
                     proj.bias)
        x = x + ve.pos_embed
        for layer in ve.layers:
            x = layer(x)
        neck = ve.neck
        x = neck.layer_norm1(F.linear(x, neck.conv1.weight[:, :, 0, 0]))
        x = F.conv2d(x.permute(0, 3, 1, 2), neck.conv2.weight, padding=1).permute(0, 2, 3, 1)
        return neck.layer_norm2(x)

    # ---- prompts and mask decoder --------------------------------------

    def image_wide_positional_embedding(self) -> Tensor:
        """Dense grid positional encoding (h, w, C)."""
        size = self.cfg.grid
        dev = self.shared_image_embedding.positional_embedding.device
        t = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) / size
        grid = torch.stack([t[None, :].expand(size, size), t[:, None].expand(size, size)], -1)
        return self.shared_image_embedding(grid)

    def embed_boxes(self, boxes: Tensor) -> Tensor:
        """boxes (N, 4) xyxy in model-input pixels -> sparse embeddings
        (N, 2, C): pixel-centre shift, corner Fourier encoding, plus the
        learned top-left / bottom-right embeddings."""
        corners = (boxes.reshape(-1, 2, 2) + 0.5) / self.cfg.image_size
        emb = self.prompt_encoder.shared_embedding(corners)
        pt = self.prompt_encoder.point_embed
        return torch.stack([emb[:, 0] + pt[2].weight[0], emb[:, 1] + pt[3].weight[0]], dim=1)

    def mask_decoder_forward(self, image_emb: Tensor, image_pe: Tensor, sparse: Tensor,
                             dense: Tensor, multimask_output: bool = True):
        """image_emb (N, h, w, C), one per prompt; sparse (N, T, C); dense
        (h, w, C). Returns (masks (N, M, 4h, 4w), iou (N, M))."""
        md, cfg = self.mask_decoder, self.cfg
        N, h, w, C = image_emb.shape
        nm = cfg.num_multimask_outputs + 1
        out_tokens = torch.cat([md.iou_token.weight, md.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens[None].expand(N, -1, -1), sparse], dim=1)
        keys = (image_emb + dense).reshape(N, h * w, C)
        pe = image_pe.reshape(1, h * w, C).expand(N, -1, -1)

        tr = md.transformer
        queries = tokens
        for i, layer in enumerate(tr.layers):
            queries, keys = layer(queries, keys, tokens, pe, first=i == 0)
        q, k = queries + tokens, keys + pe
        queries = tr.layer_norm_final_attn(queries + tr.final_attn_token_to_image(q, k, keys))
        iou_tok, mask_toks = queries[:, 0], queries[:, 1:1 + nm]

        up = _conv_transpose_2x(keys.reshape(N, h, w, C), md.upscale_conv1.weight,
                                md.upscale_conv1.bias)
        up = F.gelu(md.upscale_layer_norm(up), approximate="none")
        up = _conv_transpose_2x(up, md.upscale_conv2.weight, md.upscale_conv2.bias)
        up = F.gelu(up, approximate="none")  # (N, 4h, 4w, C/8)
        hyper = torch.stack([mlp(mask_toks[:, i])
                             for i, mlp in enumerate(md.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("nmc,nhwc->nmhw", hyper, up)
        iou = md.iou_prediction_head(iou_tok)
        if multimask_output:
            return masks[:, 1:], iou[:, 1:]
        return masks[:, :1], iou[:, :1]

    def decode_boxes(self, image_embs: Tensor, boxes: Tensor, multimask_output: bool = True):
        """image_embs (N, h, w, C), the embedding each box is decoded
        against; boxes (N, 4) xyxy in model-input pixels -> (low_res_masks
        (N, M, 4h, 4w), iou (N, M)). Every box in one batch."""
        size = self.cfg.grid
        dense = self.prompt_encoder.no_mask_embed.weight[0].expand(size, size, -1)
        return self.mask_decoder_forward(image_embs, self.image_wide_positional_embedding(),
                                         self.embed_boxes(boxes), dense, multimask_output)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def init_params(cfg: SamConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> Sam:
    """A :class:`Sam` with random weights of the JAX package's
    ``random_params_direct`` (``sam/model.py:657``): every weight matrix,
    table, token and embedding N(0, 0.02²), biases zero, layer norms one
    and zero. Drawn from ``generator`` on ``device`` (a generator seeded
    with 0 when None); the numbers differ from JAX's."""
    dev = resolve_device(device)
    model = Sam(cfg, device=dev)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    norms = {id(m.weight) for m in model.modules() if isinstance(m, nn.LayerNorm)}
    with torch.no_grad():
        for t in list(model.parameters()) + [model.shared_image_embedding.positional_embedding]:
            if id(t) in norms:
                t.fill_(1.0)
            elif t.dim() == 1:  # biases, layer-norm shifts
                t.zero_()
            else:
                t.normal_(0.0, 0.02, generator=gen)
    return model


def load_jax_params(model: Sam, params: Dict) -> Sam:
    """Copy the JAX package's SAM parameter pytree (as built by
    ``d3fields_tpu.models.sam.model.convert_hf_state_dict``, leaves as numpy
    arrays) into ``model``, in place: the inverse of that converter.
    Returns ``model``."""
    cfg = model.cfg
    a = lambda x: np.asarray(x, np.float32)  # noqa: E731
    sd: Dict[str, np.ndarray] = {}

    def lin(name: str, w, b=None):
        sd[name + ".weight"] = a(w).T
        if b is not None:
            sd[name + ".bias"] = a(b)

    def norm(name: str, w, b):
        sd[name + ".weight"], sd[name + ".bias"] = a(w), a(b)

    def hwio(w):  # HWIO -> torch OIHW
        return a(w).transpose(3, 2, 0, 1)

    P = cfg.patch_size
    v = params["vision"]
    sd["vision_encoder.patch_embed.projection.weight"] = \
        a(v["patch_w"]).reshape(P, P, 3, -1).transpose(3, 2, 0, 1)
    sd["vision_encoder.patch_embed.projection.bias"] = a(v["patch_b"])
    sd["vision_encoder.pos_embed"] = a(v["pos_embed"])[None]
    for i, lp in enumerate(v["layers"]):
        pre = f"vision_encoder.layers.{i}"
        norm(pre + ".layer_norm1", lp["ln1_w"], lp["ln1_b"])
        lin(pre + ".attn.qkv", lp["qkv_w"], lp["qkv_b"])
        lin(pre + ".attn.proj", lp["proj_w"], lp["proj_b"])
        sd[pre + ".attn.rel_pos_h"] = a(lp["rel_pos_h"])
        sd[pre + ".attn.rel_pos_w"] = a(lp["rel_pos_w"])
        norm(pre + ".layer_norm2", lp["ln2_w"], lp["ln2_b"])
        lin(pre + ".mlp.lin1", lp["fc1_w"], lp["fc1_b"])
        lin(pre + ".mlp.lin2", lp["fc2_w"], lp["fc2_b"])
    nk = v["neck"]
    sd["vision_encoder.neck.conv1.weight"] = a(nk["conv1_w"]).T[:, :, None, None]
    norm("vision_encoder.neck.layer_norm1", nk["ln1_w"], nk["ln1_b"])
    sd["vision_encoder.neck.conv2.weight"] = hwio(nk["conv2_w"])
    norm("vision_encoder.neck.layer_norm2", nk["ln2_w"], nk["ln2_b"])

    p = params["prompt"]
    sd["shared_image_embedding.positional_embedding"] = a(p["pe_table"])
    sd["prompt_encoder.shared_embedding.positional_embedding"] = a(p["pe_table"])
    for i in range(4):
        sd[f"prompt_encoder.point_embed.{i}.weight"] = a(p["point_embed"])[i][None]
    sd["prompt_encoder.not_a_point_embed.weight"] = a(p["not_a_point"])[None]
    sd["prompt_encoder.no_mask_embed.weight"] = a(p["no_mask"])[None]
    me = p["mask_embed"]
    for j in (1, 2, 3):
        sd[f"prompt_encoder.mask_embed.conv{j}.weight"] = hwio(me[f"c{j}_w"])
        sd[f"prompt_encoder.mask_embed.conv{j}.bias"] = a(me[f"c{j}_b"])
    for j in (1, 2):
        norm(f"prompt_encoder.mask_embed.layer_norm{j}", me[f"ln{j}_w"], me[f"ln{j}_b"])

    def attn(name: str, q):
        for n in ("q", "k", "v"):
            lin(f"{name}.{n}_proj", q[n + "_w"], q[n + "_b"])
        lin(name + ".out_proj", q["out_w"], q["out_b"])

    def feed_forward(name: str, f):
        lin(name + ".proj_in", f["in_w"], f["in_b"])
        for j, (w, b) in enumerate(f["mid"]):
            lin(f"{name}.layers.{j}", w, b)
        lin(name + ".proj_out", f["out_w"], f["out_b"])

    d = params["decoder"]
    sd["mask_decoder.iou_token.weight"] = a(d["iou_token"])[None]
    sd["mask_decoder.mask_tokens.weight"] = a(d["mask_tokens"])
    tr = d["transformer"]
    for i, lp in enumerate(tr["layers"]):
        pre = f"mask_decoder.transformer.layers.{i}"
        attn(pre + ".self_attn", lp["self_attn"])
        attn(pre + ".cross_attn_token_to_image", lp["t2i"])
        attn(pre + ".cross_attn_image_to_token", lp["i2t"])
        lin(pre + ".mlp.lin1", lp["mlp"]["lin1_w"], lp["mlp"]["lin1_b"])
        lin(pre + ".mlp.lin2", lp["mlp"]["lin2_w"], lp["mlp"]["lin2_b"])
        for j in range(1, 5):
            norm(f"{pre}.layer_norm{j}", lp[f"ln{j}_w"], lp[f"ln{j}_b"])
    attn("mask_decoder.transformer.final_attn_token_to_image", tr["final_attn"])
    norm("mask_decoder.transformer.layer_norm_final_attn", tr["final_ln_w"], tr["final_ln_b"])
    # JAX keeps the transposed convolutions as spatially flipped HWIO kernels
    for j in (1, 2):
        w = a(d[f"up{j}_w"])[::-1, ::-1]
        sd[f"mask_decoder.upscale_conv{j}.weight"] = w.transpose(2, 3, 0, 1)
        sd[f"mask_decoder.upscale_conv{j}.bias"] = a(d[f"up{j}_b"])
    norm("mask_decoder.upscale_layer_norm", d["up_ln_w"], d["up_ln_b"])
    for i, f in enumerate(d["hyper"]):
        feed_forward(f"mask_decoder.output_hypernetworks_mlps.{i}", f)
    feed_forward("mask_decoder.iou_prediction_head", d["iou_head"])
    model.load_state_dict(
        {k: torch.from_numpy(np.array(x, np.float32, order="C")) for k, x in sd.items()},
        strict=True)
    return model

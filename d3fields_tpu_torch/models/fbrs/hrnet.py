"""HRNet-W + OCR, the f-BRS click model's backbone, in PyTorch (NCHW).

Counterpart of ``d3fields_tpu/models/fbrs/hrnet.py`` (the reference's
``XMem/inference/interact/fbrs/model/modeling/hrnet_ocr.py:158-383``,
``ocr.py:7-141``, ``resnetv1b.py:6-91``). :class:`HighResolutionNet` keeps
the reference's module paths (``stage2.0.branches.0.0.conv1``,
``ocr_distri_head.object_context_block.f_pixel.1.0``, ...), so its state
dict is the reference's and loads with ``load_state_dict(strict=True)``;
:func:`load_jax_params` carries the JAX package's parameter dict across.

Batch norm always uses the running statistics (``models/xmem/blocks.py::
batch_norm``), dropout is an inference no-op, and the cross-branch and
final upsampling is ``F.interpolate(..., align_corners=True)``, which the
JAX package's ``resize_bilinear_ac`` reproduces.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from d3fields_tpu_torch.models.xmem.blocks import batch_norm, conv
from d3fields_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class HrnetConfig:
    """``hrnet_ocr.py:159-163``; ``small`` halves the block counts (HRNet-18s)."""

    width: int = 18
    ocr_width: int = 64
    small: bool = True
    num_classes: int = 1

    @property
    def num_blocks(self) -> int:
        return 2 if self.small else 4

    @property
    def stage_modules(self) -> Tuple[int, int, int]:
        # (stage2, stage3, stage4) module counts, hrnet_ocr.py:186-208
        return (1, 3 if self.small else 4, 2 if self.small else 3)

    @property
    def stage_channels(self) -> Tuple[List[int], ...]:
        w = self.width
        return ([w, 2 * w], [w, 2 * w, 4 * w], [w, 2 * w, 4 * w, 8 * w])

    @property
    def feats_channels(self) -> int:
        return 15 * self.width  # the concat of [w, 2w, 4w, 8w]

    @property
    def ocr_mid(self) -> int:
        return 2 * self.ocr_width


def resize_ac(x: Tensor, size) -> Tensor:
    """Bilinear resize of (B, C, h, w) with ``align_corners=True``."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


def _bn(c: int, device) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, device=device)


def _conv_bn(cin: int, cout: int, k: int, device, stride: int = 1, relu: bool = False):
    """Sequential(conv, bn[, relu]): the reference's ``.0`` / ``.1`` keys."""
    layers = [conv(cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=False, device=device),
              _bn(cout, device)]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu else []))


def _cbr(seq: nn.Sequential, x: Tensor, relu: bool = True) -> Tensor:
    x = batch_norm(seq[0](x), seq[1])
    return F.relu(x) if relu else x


class BasicBlock(nn.Module):
    """``resnetv1b.py:6-40`` without downsampling (HRNet branches keep
    their width)."""

    def __init__(self, c: int, device):
        super().__init__()
        self.conv1 = conv(c, c, 3, padding=1, bias=False, device=device)
        self.bn1 = _bn(c, device)
        self.conv2 = conv(c, c, 3, padding=1, bias=False, device=device)
        self.bn2 = _bn(c, device)

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(batch_norm(self.conv1(x), self.bn1))
        return F.relu(batch_norm(self.conv2(y), self.bn2) + x)


class Bottleneck(nn.Module):
    """``resnetv1b.py:43-91`` (expansion 4, stride 1)."""

    def __init__(self, cin: int, planes: int, device):
        super().__init__()
        self.conv1 = conv(cin, planes, 1, bias=False, device=device)
        self.bn1 = _bn(planes, device)
        self.conv2 = conv(planes, planes, 3, padding=1, bias=False, device=device)
        self.bn2 = _bn(planes, device)
        self.conv3 = conv(planes, 4 * planes, 1, bias=False, device=device)
        self.bn3 = _bn(4 * planes, device)
        self.downsample = _conv_bn(cin, 4 * planes, 1, device) if cin != 4 * planes else None

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(batch_norm(self.conv1(x), self.bn1))
        y = F.relu(batch_norm(self.conv2(y), self.bn2))
        y = batch_norm(self.conv3(y), self.bn3)
        r = x if self.downsample is None else _cbr(self.downsample, x, relu=False)
        return F.relu(y + r)


class HighResolutionModule(nn.Module):
    """Per-branch basic blocks, then every branch fused into every other
    (``hrnet_ocr.py:13-155``): a 1x1 conv and an upsample from a lower
    resolution, stride-2 3x3 convs from a higher one."""

    def __init__(self, chans: List[int], num_blocks: int, device):
        super().__init__()
        self.branches = nn.ModuleList([
            nn.Sequential(*[BasicBlock(c, device) for _ in range(num_blocks)]) for c in chans])
        fuse = []
        for i, ci in enumerate(chans):
            row = []
            for j, cj in enumerate(chans):
                if j > i:
                    row.append(_conv_bn(cj, ci, 1, device))
                elif j < i:
                    row.append(nn.Sequential(*[
                        _conv_bn(cj, ci if k == i - j - 1 else cj, 3, device, stride=2,
                                 relu=k != i - j - 1) for k in range(i - j)]))
                else:
                    row.append(None)
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs: List[Tensor]) -> List[Tensor]:
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        out = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, f in enumerate(row):
                if j == i:
                    t = xs[j]
                elif j > i:
                    t = resize_ac(_cbr(f, xs[j], relu=False), xs[i].shape[-2:])
                else:
                    t = xs[j]
                    for k, step in enumerate(f):
                        t = _cbr(step, t, relu=k != len(f) - 1)
                y = t if y is None else y + t
            out.append(F.relu(y))
        return out


def _bn_relu_pair(cin: int, cout: int, device) -> nn.Sequential:
    """``ocr.py``'s Sequential(conv 1x1, Sequential(bn, relu))."""
    return nn.Sequential(conv(cin, cout, 1, bias=False, device=device),
                         nn.Sequential(_bn(cout, device), nn.ReLU()))


def _pair(seq: nn.Sequential, x: Tensor) -> Tensor:
    return F.relu(batch_norm(seq[0](x), seq[1][0]))


def _double(seq: nn.Sequential, x: Tensor) -> Tensor:
    y = _pair(seq, x)
    return F.relu(batch_norm(seq[2](y), seq[3][0]))


class HighResolutionNet(nn.Module):
    """HRNet-OCR (``hrnet_ocr.py:158-383``): image (B, 3, H, W) -> (out,
    aux) logits at 1/4 resolution."""

    def __init__(self, cfg: HrnetConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        nb = cfg.num_blocks
        self.conv1 = conv(3, 64, 3, stride=2, padding=1, bias=False, device=dev)
        self.bn1 = _bn(64, dev)
        self.conv2 = conv(64, 64, 3, stride=2, padding=1, bias=False, device=dev)
        self.bn2 = _bn(64, dev)
        self.layer1 = nn.Sequential(*[Bottleneck(64 if i == 0 else 256, 64, dev)
                                      for i in range(nb)])
        pre = [256]
        for t, (cur, mods) in enumerate(zip(cfg.stage_channels, cfg.stage_modules), start=1):
            trans = []
            for i, c in enumerate(cur):
                if i < len(pre):
                    trans.append(_conv_bn(pre[i], c, 3, dev, relu=True) if pre[i] != c else None)
                else:  # a new branch: one stride-2 conv from the lowest resolution
                    trans.append(nn.Sequential(_conv_bn(pre[-1], c, 3, dev, stride=2, relu=True)))
            self.add_module(f"transition{t}", nn.ModuleList(trans))
            self.add_module(f"stage{t + 1}", nn.Sequential(
                *[HighResolutionModule(cur, nb, dev) for _ in range(mods)]))
            pre = cur

        fc, mid, key = cfg.feats_channels, cfg.ocr_mid, cfg.ocr_width
        self.conv3x3_ocr = nn.Sequential(conv(fc, mid, 3, padding=1, device=dev), _bn(mid, dev),
                                         nn.ReLU())
        ocb = nn.Module()
        for name in ("f_pixel", "f_object"):
            seq = _bn_relu_pair(mid, key, dev)
            seq.append(conv(key, key, 1, bias=False, device=dev))
            seq.append(nn.Sequential(_bn(key, dev), nn.ReLU()))
            ocb.add_module(name, seq)
        ocb.f_down = _bn_relu_pair(mid, key, dev)
        ocb.f_up = _bn_relu_pair(key, mid, dev)
        self.ocr_distri_head = nn.Module()
        self.ocr_distri_head.object_context_block = ocb
        self.ocr_distri_head.conv_bn_dropout = _bn_relu_pair(2 * mid, mid, dev)
        self.cls_head = conv(mid, cfg.num_classes, 1, device=dev)
        self.aux_head = nn.Sequential(conv(fc, fc, 1, device=dev), _bn(fc, dev), nn.ReLU(),
                                      conv(fc, cfg.num_classes, 1, device=dev))

    def compute_feats(self, x: Tensor) -> Tensor:
        """(B, 3, H, W) -> the concatenated multi-resolution features
        (B, 15 * width, H/4, W/4) (``compute_hrnet_feats``)."""
        x = F.relu(batch_norm(self.conv1(x), self.bn1))
        x = F.relu(batch_norm(self.conv2(x), self.bn2))
        ys = [self.layer1(x)]
        for t in range(1, 4):
            xs = []
            for i, trans in enumerate(getattr(self, f"transition{t}")):
                src = ys[i] if i < len(ys) else ys[-1]
                if trans is None:
                    xs.append(src)
                elif isinstance(trans[0], nn.Conv2d):  # same level, new width
                    xs.append(_cbr(trans, src))
                else:  # new, downsampled branch
                    xs.append(_cbr(trans[0], src))
            for module in getattr(self, f"stage{t + 1}"):
                xs = module(xs)
            ys = xs
        size = ys[0].shape[-2:]
        return torch.cat([ys[0]] + [resize_ac(y, size) for y in ys[1:]], dim=1)

    def ocr_head(self, feats: Tensor) -> Tuple[Tensor, Tensor]:
        """OCR refinement of the backbone features -> (out, aux) logits at
        their resolution (``hrnet_ocr.py:322-332``, ``ocr.py``)."""
        a = self.aux_head
        aux = a[3](F.relu(batch_norm(a[0](feats), a[1])))
        f = F.relu(batch_norm(self.conv3x3_ocr[0](feats), self.conv3x3_ocr[1]))
        B, C, h, w = f.shape
        K = aux.shape[1]
        # SpatialGather (ocr.py:7-27): class-probability-weighted feature means
        probs = torch.softmax(aux.reshape(B, K, h * w), dim=2)
        context = torch.bmm(probs, f.reshape(B, C, h * w).transpose(1, 2))  # (B, K, C)
        context = context.transpose(1, 2)[..., None]                        # (B, C, K, 1)
        # ObjectAttentionBlock2D (ocr.py:64-141)
        ocb = self.ocr_distri_head.object_context_block
        key_c = self.cfg.ocr_width
        query = _double(ocb.f_pixel, f).reshape(B, key_c, h * w).transpose(1, 2)
        key = _double(ocb.f_object, context).reshape(B, key_c, K)
        value = _pair(ocb.f_down, context).reshape(B, key_c, K).transpose(1, 2)
        attn = torch.softmax(torch.bmm(query, key) * (key_c ** -0.5), dim=-1)
        ctx = torch.bmm(attn, value).transpose(1, 2).reshape(B, key_c, h, w)
        ctx = _pair(ocb.f_up, ctx)
        y = _pair(self.ocr_distri_head.conv_bn_dropout, torch.cat([ctx, f], dim=1))
        return self.cls_head(y), aux

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        return self.ocr_head(self.compute_feats(x))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def jax_state_dict(params: Dict) -> Dict[str, np.ndarray]:
    """The JAX package's parameter dict (module path -> {"w", "b"} for a
    conv with HWIO weights, {"scale", "bias", "mean", "var"} for a batch
    norm) as a torch state dict without the step counters."""
    sd = {}
    for name, p in params.items():
        if "w" in p:
            sd[f"{name}.weight"] = np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)
            if "b" in p:
                sd[f"{name}.bias"] = np.asarray(p["b"], np.float32)
        else:
            for k, j in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                         ("running_var", "var")):
                sd[f"{name}.{k}"] = np.asarray(p[j], np.float32)
    return sd


def load_state(model: nn.Module, sd: Dict[str, np.ndarray]) -> nn.Module:
    """``model.load_state_dict(sd, strict=True)`` with the batch-norm step
    counters, which neither package reads, taken from ``model``."""
    full = {k: v for k, v in model.state_dict().items() if k.endswith("num_batches_tracked")}
    full.update({k: torch.from_numpy(np.array(v, np.float32, order="C")) for k, v in sd.items()})
    model.load_state_dict(full, strict=True)
    return model


def load_jax_params(model: HighResolutionNet, params: Dict) -> HighResolutionNet:
    """Copy the JAX package's HRNet parameters (``hrnet.init_params`` or
    ``convert_torch_state_dict``, leaves as arrays) into ``model``, in
    place. Returns ``model``."""
    return load_state(model, jax_state_dict(params))


def init_params(cfg: HrnetConfig, generator: Optional[torch.Generator] = None, *,
                scale: float = 0.1, device=None) -> HighResolutionNet:
    """A :class:`HighResolutionNet` with the JAX ``init_params``'
    distributions: conv weights N(0, scale²), biases 0, batch norms the
    identity. Drawn from ``generator`` (seeded with 0 when None)."""
    dev = resolve_device(device)
    model = HighResolutionNet(cfg, device=dev)
    return random_init(model, generator, scale, dev)


def random_init(model: nn.Module, generator, scale: float, dev) -> nn.Module:
    """Conv weights N(0, scale²) from ``generator`` (seeded with 0 when
    None), conv biases 0, batch norms the identity: the JAX packages'
    ``init_params`` of HRNet, f-BRS and S2M. Returns ``model`` in eval mode."""
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, scale, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model.eval()

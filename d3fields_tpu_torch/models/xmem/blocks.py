"""XMem network blocks in PyTorch (NCHW).

Counterpart of ``d3fields_tpu/models/xmem/blocks.py``, as modules that keep
the reference's parameter names (``XMem/model/modules.py``,
``group_modules.py``, ``cbam.py``, ``resnet.py``), so that a reference
state dict loads as it is:

- convolutions are ``F.conv2d`` in NCHW with OIHW weights;
- batch norm is inference-mode with running statistics, whatever the
  module's train/eval mode (the reference always runs frozen checkpoints);
  training makes the statistics trainable leaves (:func:`batch_norm`);
- the object ("group") axis is folded into the batch axis before convs:
  every group block takes (B*O, C, H, W);
- the GRU updaters keep the reference's gate order, new value before the
  forget gate (``modules.py:64-76``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def conv(cin: int, cout: int, k: int, *, stride: int = 1, padding: int = 0,
         bias: bool = True, device=None) -> nn.Conv2d:
    """A Conv2d without PyTorch's default initialisation (``init_params``
    or a checkpoint sets every weight); on the CPU when ``device`` is None."""
    return nn.utils.skip_init(nn.Conv2d, cin, cout, k, stride=stride, padding=padding,
                              bias=bias, device=device or "cpu")


def batch_norm(x: Tensor, bn: nn.BatchNorm2d) -> Tensor:
    """Inference-mode batch norm with the module's running statistics.

    Training (``trainer.py``) makes the statistics trainable leaves, as the
    JAX package's parameter tree holds them; then the norm is its
    arithmetic, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, which
    carries their gradients (``F.batch_norm`` gives none)."""
    if bn.running_mean.requires_grad or bn.running_var.requires_grad:
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        return (x - bn.running_mean.view(shape)) * inv.view(shape) + bn.bias.view(shape)
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                        training=False, eps=bn.eps)


def conv_bn(x: Tensor, c: nn.Conv2d, bn: nn.BatchNorm2d, relu: bool = True) -> Tensor:
    x = batch_norm(c(x), bn)
    return F.relu(x) if relu else x


def max_pool_3x3_s2(x: Tensor) -> Tensor:
    """torch MaxPool2d(kernel_size=3, stride=2, padding=1)."""
    return F.max_pool2d(x, 3, 2, 1)


def avg_pool(x: Tensor, k: int) -> Tensor:
    """k x k average pool, stride k (== F.interpolate(mode='area', 1/k))."""
    return F.avg_pool2d(x, k)


def upsample_2x(x: Tensor) -> Tensor:
    """Bilinear x2 with half-pixel centres (align_corners=False)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def upsample_4x_logits(x: Tensor) -> Tensor:
    """Bilinear x4, align_corners=False (the decoder's last logit upsample,
    reference ``modules.py:247``)."""
    H, W = x.shape[-2:]
    return F.interpolate(x, size=(4 * H, 4 * W), mode="bilinear", align_corners=False)


def gru_update(g: Tensor, h: Tensor, transform: nn.Conv2d) -> Tensor:
    """The reference's nonstandard GRU (``modules.py:64-76``):
    new_h = f*h*(1-u) + u*tanh(v) with [f, u, v] = conv3x3([g, h])."""
    ch = h.shape[1]
    values = transform(torch.cat([g, h], dim=1))
    forget = torch.sigmoid(values[:, :ch])
    update = torch.sigmoid(values[:, ch:2 * ch])
    new_value = torch.tanh(values[:, 2 * ch:])
    return forget * h * (1.0 - update) + update * new_value


def clip(x: Tensor, lo: float, hi: float) -> Tensor:
    """``jnp.clip``: the values of ``torch.clamp``, and its gradient, which
    at a value equal to a bound is half the incoming one (``torch.clamp``
    passes all of it). Near 1, sigmoid probabilities land on the bound
    ``1 - 1e-7`` exactly, where the log-odds amplify the difference.
    Without autograd it is ``torch.clamp``."""
    y = x.clamp(lo, hi)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return y
    tie = (x == lo) | (x == hi)
    return torch.where(tie, 0.5 * x + 0.5 * x.detach(), y)  # the value x, half the gradient


def soft_aggregate(prob: Tensor, dim: int) -> Tensor:
    """Soft aggregation from STM (``aggregate.py:6-19``): prepend the
    implicit background prod(1-p) and renormalise through logits, in f32."""
    prob = prob.float()
    bg = torch.prod(1.0 - prob, dim=dim, keepdim=True)
    new_prob = clip(torch.cat([bg, prob], dim=dim), 1e-7, 1.0 - 1e-7)
    logits = torch.log(new_prob / (1.0 - new_prob))
    return torch.softmax(logits, dim=dim)


def pad_divide_by(x: Tensor, d: int, hw_dims: Tuple[int, int] = (-2, -1)):
    """Symmetric zero pad of the two ``hw_dims`` up to multiples of ``d``
    (``util/tensor_util.py``). Returns (padded, (lh, uh, lw, uw))."""
    hd, wd = (a % x.dim() for a in hw_dims)
    H, W = x.shape[hd], x.shape[wd]
    new_h, new_w = -(-H // d) * d, -(-W // d) * d
    lh, uh = (new_h - H) // 2, (new_h - H + 1) // 2
    lw, uw = (new_w - W) // 2, (new_w - W + 1) // 2
    pads = [0] * (2 * x.dim())  # F.pad lists the last dim first
    pads[2 * (x.dim() - 1 - hd)], pads[2 * (x.dim() - 1 - hd) + 1] = lh, uh
    pads[2 * (x.dim() - 1 - wd)], pads[2 * (x.dim() - 1 - wd) + 1] = lw, uw
    return F.pad(x, pads), (lh, uh, lw, uw)


def unpad(x: Tensor, pad_spec, hw_dims: Tuple[int, int] = (-2, -1)) -> Tensor:
    lh, uh, lw, uw = pad_spec
    hd, wd = (a % x.dim() for a in hw_dims)
    x = x.narrow(hd, lh, x.shape[hd] - lh - uh)
    return x.narrow(wd, lw, x.shape[wd] - lw - uw)


# ---------------------------------------------------------------------------
# residual trunks (torchvision-style, reference XMem/model/resnet.py)
# ---------------------------------------------------------------------------

def _downsample(cin: int, cout: int, stride: int, device) -> nn.Sequential:
    return nn.Sequential(conv(cin, cout, 1, stride=stride, bias=False, device=device),
                         nn.BatchNorm2d(cout, device=device))


class BasicBlock(nn.Module):
    """ResNet-18 BasicBlock."""

    def __init__(self, cin: int, cout: int, stride: int, device=None):
        super().__init__()
        self.conv1 = conv(cin, cout, 3, stride=stride, padding=1, bias=False, device=device)
        self.bn1 = nn.BatchNorm2d(cout, device=device)
        self.conv2 = conv(cout, cout, 3, padding=1, bias=False, device=device)
        self.bn2 = nn.BatchNorm2d(cout, device=device)
        self.downsample = (_downsample(cin, cout, stride, device)
                           if stride != 1 or cin != cout else None)

    def forward(self, x: Tensor) -> Tensor:
        out = conv_bn(x, self.conv1, self.bn1)
        out = conv_bn(out, self.conv2, self.bn2, relu=False)
        identity = x if self.downsample is None else conv_bn(
            x, self.downsample[0], self.downsample[1], relu=False)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """ResNet-50 Bottleneck (stride on the 3x3, torchvision v1.5)."""

    def __init__(self, cin: int, cmid: int, cout: int, stride: int, device=None):
        super().__init__()
        self.conv1 = conv(cin, cmid, 1, bias=False, device=device)
        self.bn1 = nn.BatchNorm2d(cmid, device=device)
        self.conv2 = conv(cmid, cmid, 3, stride=stride, padding=1, bias=False, device=device)
        self.bn2 = nn.BatchNorm2d(cmid, device=device)
        self.conv3 = conv(cmid, cout, 1, bias=False, device=device)
        self.bn3 = nn.BatchNorm2d(cout, device=device)
        self.downsample = (_downsample(cin, cout, stride, device)
                           if stride != 1 or cin != cout else None)

    def forward(self, x: Tensor) -> Tensor:
        out = conv_bn(x, self.conv1, self.bn1)
        out = conv_bn(out, self.conv2, self.bn2)
        out = conv_bn(out, self.conv3, self.bn3, relu=False)
        identity = x if self.downsample is None else conv_bn(
            x, self.downsample[0], self.downsample[1], relu=False)
        return F.relu(out + identity)


def res_layer(kind: str, cin: int, cmid: int, cout: int, blocks: int, stride: int,
              device=None) -> nn.Sequential:
    out = []
    for i in range(blocks):
        ci, s = (cin, stride) if i == 0 else (cout, 1)
        out.append(Bottleneck(ci, cmid, cout, s, device) if kind == "bottleneck"
                   else BasicBlock(ci, cout, s, device))
    return nn.Sequential(*out)


class KeyEncoder(nn.Module):
    """ResNet-50 trunk -> (f16 1024ch, f8 512ch, f4 256ch)
    (``modules.py:153-175``; its first layer is named ``res2``)."""

    def __init__(self, device=None):
        super().__init__()
        self.conv1 = conv(3, 64, 7, stride=2, padding=3, bias=False, device=device)
        self.bn1 = nn.BatchNorm2d(64, device=device)
        self.res2 = res_layer("bottleneck", 64, 64, 256, 3, 1, device)
        self.layer2 = res_layer("bottleneck", 256, 128, 512, 4, 2, device)
        self.layer3 = res_layer("bottleneck", 512, 256, 1024, 6, 2, device)

    def forward(self, x: Tensor):
        x = max_pool_3x3_s2(conv_bn(x, self.conv1, self.bn1))
        f4 = self.res2(x)
        f8 = self.layer2(f4)
        f16 = self.layer3(f8)
        return f16, f8, f4


# ---------------------------------------------------------------------------
# XMem-specific blocks; inputs are (B*O, C, H, W) with per-image features
# broadcast over the objects by the caller
# ---------------------------------------------------------------------------

class GroupResBlock(nn.Module):
    """Two 3x3 convs on relu-activated input plus a (projected) skip
    (``group_modules.py:37-55``)."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.conv1 = conv(cin, cout, 3, padding=1, device=device)
        self.conv2 = conv(cout, cout, 3, padding=1, device=device)
        self.downsample = conv(cin, cout, 3, padding=1, device=device) if cin != cout else None

    def forward(self, g: Tensor) -> Tensor:
        out = self.conv2(F.relu(self.conv1(F.relu(g))))
        return out + (g if self.downsample is None else self.downsample(g))


class _ChannelGate(nn.Module):
    def __init__(self, c: int, reduction: int, device=None):
        super().__init__()
        self.mlp = nn.Sequential(
            nn.Flatten(),
            nn.utils.skip_init(nn.Linear, c, c // reduction, device=device or "cpu"),
            nn.ReLU(),
            nn.utils.skip_init(nn.Linear, c // reduction, c, device=device or "cpu"),
        )


class _BasicConv(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.conv = conv(2, 1, 7, padding=3, device=device)


class _SpatialGate(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.spatial = _BasicConv(device)


class CBAM(nn.Module):
    """Channel and spatial attention (``cbam.py:20-95``)."""

    def __init__(self, c: int, reduction: int = 16, device=None):
        super().__init__()
        self.ChannelGate = _ChannelGate(c, reduction, device)
        self.SpatialGate = _SpatialGate(device)

    def forward(self, x: Tensor) -> Tensor:
        mlp = self.ChannelGate.mlp
        scale = torch.sigmoid(mlp(x.mean(dim=(2, 3))) + mlp(x.amax(dim=(2, 3))))
        x = x * scale[:, :, None, None]
        pooled = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.SpatialGate.spatial.conv(pooled))


class FeatureFusionBlock(nn.Module):
    """concat -> resblock -> CBAM residual -> resblock (``modules.py:22-41``)."""

    def __init__(self, x_dim: int, g_dim: int, mid: int, out: int, device=None):
        super().__init__()
        self.block1 = GroupResBlock(x_dim + g_dim, mid, device)
        self.attention = CBAM(mid, device=device)
        self.block2 = GroupResBlock(mid, out, device)

    def forward(self, x: Tensor, g: Tensor) -> Tensor:
        g = self.block1(torch.cat([x, g], dim=1))
        return self.block2(g + self.attention(g))


class HiddenReinforcer(nn.Module):
    """The value encoder's GRU (``modules.py:82-99``)."""

    def __init__(self, g_dim: int, hidden_dim: int, device=None):
        super().__init__()
        self.transform = conv(g_dim + hidden_dim, hidden_dim * 3, 3, padding=1, device=device)

    def forward(self, g: Tensor, h: Tensor) -> Tensor:
        return gru_update(g, h, self.transform)


class HiddenUpdater(nn.Module):
    """The decoder's multi-scale GRU (``modules.py:45-79``)."""

    def __init__(self, hidden_dim: int, device=None):
        super().__init__()
        self.g16_conv = conv(512, 256, 1, device=device)
        self.g8_conv = conv(256, 256, 1, device=device)
        self.g4_conv = conv(257, 256, 1, device=device)
        self.transform = conv(256 + hidden_dim, hidden_dim * 3, 3, padding=1, device=device)

    def forward(self, g16: Tensor, g8: Tensor, g4: Tensor, h: Tensor) -> Tensor:
        g = (self.g16_conv(g16) + self.g8_conv(avg_pool(g8, 2))
             + self.g4_conv(avg_pool(g4, 4)))
        return gru_update(g, h, self.transform)


class UpsampleBlock(nn.Module):
    """conv skip + x2-upsampled g, then a group res block
    (``modules.py:178-190``)."""

    def __init__(self, skip_dim: int, up_dim: int, out_dim: int, device=None):
        super().__init__()
        self.skip_conv = conv(skip_dim, up_dim, 3, padding=1, device=device)
        self.out_conv = GroupResBlock(up_dim, out_dim, device)

    def forward(self, skip_f: Tensor, up_g: Tensor) -> Tensor:
        return self.out_conv(self.skip_conv(skip_f) + upsample_2x(up_g))


class KeyProjection(nn.Module):
    """Key conv, shrinkage d^2+1 and sigmoid selection (``modules.py:194-211``)."""

    def __init__(self, key_dim: int, device=None):
        super().__init__()
        self.key_proj = conv(1024, key_dim, 3, padding=1, device=device)
        self.d_proj = conv(1024, 1, 3, padding=1, device=device)
        self.e_proj = conv(1024, key_dim, 3, padding=1, device=device)

    def forward(self, f16: Tensor, need_s: bool = True, need_e: bool = True):
        key = self.key_proj(f16)
        shrinkage = torch.square(self.d_proj(f16)) + 1.0 if need_s else None
        selection = torch.sigmoid(self.e_proj(f16)) if need_e else None
        return key, shrinkage, selection


class ValueEncoder(nn.Module):
    """ResNet-18 trunk over [image, own mask, other masks], then the fuser
    and the hidden reinforcer (``modules.py:102-150``)."""

    def __init__(self, value_dim: int, hidden_dim: int, device=None):
        super().__init__()
        self.conv1 = conv(5, 64, 7, stride=2, padding=3, bias=False, device=device)
        self.bn1 = nn.BatchNorm2d(64, device=device)
        self.layer1 = res_layer("basic", 64, 64, 64, 2, 1, device)
        self.layer2 = res_layer("basic", 64, 128, 128, 2, 2, device)
        self.layer3 = res_layer("basic", 128, 256, 256, 2, 2, device)
        self.fuser = FeatureFusionBlock(1024, 256, value_dim, value_dim, device)
        self.hidden_reinforce = HiddenReinforcer(value_dim, hidden_dim, device)

    def trunk(self, x: Tensor) -> Tensor:
        """(N, 5, H, W) -> (N, 256, H/16, W/16). The reference applies relu
        after the max pool; the two commute."""
        x = max_pool_3x3_s2(conv_bn(x, self.conv1, self.bn1))
        return self.layer3(self.layer2(self.layer1(x)))


class Decoder(nn.Module):
    """Fuser, hidden updater and two upsample blocks to x4 logits
    (``modules.py:214-250``)."""

    def __init__(self, value_dim: int, hidden_dim: int, device=None):
        super().__init__()
        self.fuser = FeatureFusionBlock(1024, value_dim + hidden_dim, 512, 512, device)
        self.hidden_update = HiddenUpdater(hidden_dim, device)
        self.up_16_8 = UpsampleBlock(512, 512, 256, device)
        self.up_8_4 = UpsampleBlock(256, 256, 256, device)
        self.pred = conv(256, 1, 3, padding=1, device=device)


def fold(x: Tensor) -> Tensor:
    """(B, O, ...) -> (B*O, ...)."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def broadcast_objects(x: Tensor, num_objects: int) -> Tensor:
    """Per-image (B, C, H, W) -> (B*O, C, H, W), each image repeated for
    its objects."""
    return fold(x[:, None].expand((x.shape[0], num_objects) + tuple(x.shape[1:])))


def unfold(x: Tensor, batch: int) -> Tensor:
    """(B*O, ...) -> (B, O, ...)."""
    return x.reshape((batch, x.shape[0] // batch) + tuple(x.shape[1:]))

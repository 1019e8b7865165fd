"""Scribble-to-Mask (S2M): DeepLabV3+ over a 6-channel ResNet-50, in PyTorch.

Counterpart of ``d3fields_tpu/models/s2m/model.py`` (the reference GUI's
scribble backend, ``XMem/inference/interact/s2m/s2m_network.py:7-56`` ->
``deeplabv3plus_resnet50`` with ``s2m_resnet.py``'s 6-channel conv1 and
``_deeplab.py``'s DeepLabHeadV3Plus and ASPP). Output stride 16: layer4
trades its stride for dilation 2, and the ASPP rates are 6, 12 and 18. The
input is (B, 6, H, W): RGB, the previous mask, the positive and negative
scribble maps (``s2m_controller.py:22-38``); the output is one logit map
at the input resolution (bilinear, ``align_corners=False``).

:class:`S2M` keeps the reference's parameter names (``backbone.layer1.0.
conv1``, ``classifier.aspp.convs.4.1``, ...), so its state dict loads with
``load_state_dict(strict=True)``; :func:`load_jax_params` carries the JAX
package's parameter dict across.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from d3fields_tpu_torch.models.fbrs.hrnet import jax_state_dict, load_state, random_init
from d3fields_tpu_torch.models.xmem.blocks import batch_norm, conv, max_pool_3x3_s2
from d3fields_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor

# ResNet-50 stages: (name, blocks, planes, stride, dilation of the later blocks);
# output stride 16 (s2m_network.py:9-14: replace_stride_with_dilation=[F, F, T])
_STAGES = (("layer1", 3, 64, 1, 1), ("layer2", 4, 128, 2, 1), ("layer3", 6, 256, 2, 1),
           ("layer4", 3, 512, 1, 2))
_ASPP_RATES = (6, 12, 18)


@dataclasses.dataclass(frozen=True)
class S2mConfig:
    num_classes: int = 1


def _cb(cin: int, cout: int, k: int, device, **kw) -> nn.Sequential:
    """Sequential(conv without bias, bn): the reference's ``.0`` / ``.1`` keys."""
    return nn.Sequential(nn.utils.skip_init(nn.Conv2d, cin, cout, k, bias=False, device=device,
                                            **kw),
                         nn.BatchNorm2d(cout, device=device))


class Bottleneck(nn.Module):
    """torchvision's ResNet bottleneck (expansion 4): the first block of a
    stage takes its stride and the previous dilation, the later blocks the
    stage's dilation."""

    def __init__(self, cin: int, planes: int, stride: int, dilation: int, device):
        super().__init__()
        self.conv1 = conv(cin, planes, 1, bias=False, device=device)
        self.bn1 = nn.BatchNorm2d(planes, device=device)
        self.conv2 = _cb(planes, planes, 3, device, stride=stride, padding=dilation,
                         dilation=dilation)[0]
        self.bn2 = nn.BatchNorm2d(planes, device=device)
        self.conv3 = conv(planes, 4 * planes, 1, bias=False, device=device)
        self.bn3 = nn.BatchNorm2d(4 * planes, device=device)
        self.downsample = (_cb(cin, 4 * planes, 1, device, stride=stride)
                           if stride != 1 or cin != 4 * planes else None)

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(batch_norm(self.conv1(x), self.bn1))
        y = F.relu(batch_norm(self.conv2(y), self.bn2))
        y = batch_norm(self.conv3(y), self.bn3)
        r = x if self.downsample is None else batch_norm(self.downsample[0](x),
                                                         self.downsample[1])
        return F.relu(y + r)


class S2M(nn.Module):
    """DeepLabV3+ ResNet-50 with a 6-channel stem."""

    def __init__(self, cfg: S2mConfig = S2mConfig(), device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        bb = nn.Module()
        bb.conv1 = conv(6, 64, 7, stride=2, padding=3, bias=False, device=dev)
        bb.bn1 = nn.BatchNorm2d(64, device=dev)
        cin = 64
        for name, blocks, planes, stride, dil in _STAGES:
            bb.add_module(name, nn.Sequential(*[
                Bottleneck(cin if b == 0 else 4 * planes, planes, stride if b == 0 else 1,
                           1 if (b == 0 and dil > 1) else dil, dev) for b in range(blocks)]))
            cin = 4 * planes
        self.backbone = bb
        aspp = nn.Module()
        aspp.convs = nn.ModuleList(
            [_cb(2048, 256, 1, dev)]
            + [_cb(2048, 256, 3, dev, padding=r, dilation=r) for r in _ASPP_RATES]
            + [nn.Sequential(nn.AdaptiveAvgPool2d(1), *_cb(2048, 256, 1, dev))])
        aspp.project = _cb(5 * 256, 256, 1, dev)
        head = nn.Module()
        head.project = _cb(256, 48, 1, dev)
        head.aspp = aspp
        head.classifier = nn.Sequential(*_cb(304, 256, 3, dev, padding=1), nn.ReLU(),
                                        conv(256, cfg.num_classes, 1, device=dev))
        self.classifier = head

    def forward(self, x: Tensor) -> Tensor:
        """(B, 6, H, W), H and W multiples of 16 (the controller pads) ->
        (B, num_classes, H, W) logits."""
        if x.shape[-2] % 16 or x.shape[-1] % 16:
            raise ValueError("S2M input must be padded to multiples of 16")
        bb, head = self.backbone, self.classifier
        y = max_pool_3x3_s2(F.relu(batch_norm(bb.conv1(x), bb.bn1)))
        low = y = bb.layer1(y)
        y = bb.layer4(bb.layer3(bb.layer2(y)))
        low = F.relu(batch_norm(head.project[0](low), head.project[1]))
        convs = head.aspp.convs
        branches = [F.relu(batch_norm(c[0](y), c[1])) for c in convs[:4]]
        pooled = F.relu(batch_norm(convs[4][1](y.mean(dim=(2, 3), keepdim=True)), convs[4][2]))
        branches.append(pooled.expand(-1, -1, *y.shape[-2:]))
        proj = head.aspp.project
        y = F.relu(batch_norm(proj[0](torch.cat(branches, dim=1)), proj[1]))  # dropout: no-op
        y = F.interpolate(y, size=low.shape[-2:], mode="bilinear", align_corners=False)
        cls = head.classifier
        y = F.relu(batch_norm(cls[0](torch.cat([low, y], dim=1)), cls[1]))
        y = cls[3](y)
        return F.interpolate(y, size=x.shape[-2:], mode="bilinear", align_corners=False)


def init_params(cfg: S2mConfig = S2mConfig(), generator: Optional[torch.Generator] = None, *,
                scale: float = 0.1, device=None) -> S2M:
    """An :class:`S2M` with the JAX ``init_params``' distributions (conv
    weights N(0, scale²), biases 0, identity batch norms), drawn from
    ``generator`` (seeded with 0 when None)."""
    dev = resolve_device(device)
    return random_init(S2M(cfg, device=dev), generator, scale, dev)


def load_jax_params(model: S2M, params: Dict) -> S2M:
    """Copy the JAX package's S2M parameters (``init_params`` or
    ``convert_torch_state_dict``) into ``model``, in place. Returns
    ``model``."""
    return load_state(model, jax_state_dict(params))

"""The f-BRS click model, click distance maps + HRNet-OCR, in PyTorch.

Counterpart of ``d3fields_tpu/models/fbrs/model.py`` (the reference's
``DistMapsHRNetModel``, ``XMem/inference/interact/fbrs/model/
is_hrnet_model.py:24-67``, and ``DistMaps``, ``model/ops.py:39-85``):
clicks become two tanh-of-distance maps (positive, negative), a 1x1
``rgb_conv`` fuses them with the image, and HRNet-OCR predicts one instance
logit map, upsampled to the input size with ``align_corners=True``.

Images are NCHW. Clicks follow the reference layout: (B, 2N, 2) rows of
(y, x), the first N positive and the last N negative, rows of -1 unused.
:class:`FbrsModel` keeps the reference's parameter names
(``feature_extractor.*``, ``rgb_conv.{0,2,3}``), so an ``fbrs.pth`` state
dict loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from d3fields_tpu_torch.models.fbrs import hrnet
from d3fields_tpu_torch.models.xmem.blocks import batch_norm, conv
from d3fields_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FbrsConfig:
    backbone: hrnet.HrnetConfig = dataclasses.field(default_factory=hrnet.HrnetConfig)
    norm_radius: float = 260.0  # fbrs_controller.py:9 (the max_size=800 regime)

    @classmethod
    def tiny_test(cls) -> "FbrsConfig":
        return cls(backbone=hrnet.HrnetConfig(width=4, ocr_width=8, small=True),
                   norm_radius=20.0)


def dist_maps(points: Tensor, hw: Tuple[int, int], norm_radius: float) -> Tensor:
    """(B, 2N, 2) click rows -> (B, 2, H, W) features
    (``DistMaps.get_coord_features``, model/ops.py:46-80): per pixel the
    least normalised squared distance over each polarity's valid clicks,
    then ``tanh(2 sqrt(d))``; a row whose larger coordinate is negative is
    unused."""
    H, W = hw
    B, N2, _ = points.shape
    pts = points.reshape(B, 2, N2 // 2, 2)
    invalid = pts.amax(dim=-1) < 0                                     # (B, 2, n)
    ys = torch.arange(H, dtype=torch.float32, device=points.device)[:, None, None]
    xs = torch.arange(W, dtype=torch.float32, device=points.device)[None, :, None]
    py = pts[..., 0][:, :, None, None, :]                              # (B, 2, 1, 1, n)
    px = pts[..., 1][:, :, None, None, :]
    d2 = ((ys - py) ** 2 + (xs - px) ** 2) / (norm_radius * norm_radius)
    d2 = torch.where(invalid[:, :, None, None, :], torch.full_like(d2, 1e6), d2)
    return torch.tanh(2.0 * torch.sqrt(d2.amin(dim=-1)))


class FbrsModel(nn.Module):
    """``DistMapsHRNetModel`` with the reference's parameter names."""

    def __init__(self, cfg: FbrsConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.rgb_conv = nn.Sequential(conv(5, 8, 1, device=dev), nn.LeakyReLU(0.2),
                                      nn.BatchNorm2d(8, device=dev), conv(8, 3, 1, device=dev))
        self.feature_extractor = hrnet.HighResolutionNet(cfg.backbone, device=dev)

    def fuse_clicks(self, image: Tensor, points: Tensor) -> Tensor:
        """The 1x1 conv + LeakyReLU(0.2) + BN + 1x1 conv that fuses the
        image with the click maps (is_hrnet_model.py:31-36)."""
        coord = dist_maps(points, image.shape[-2:], self.cfg.norm_radius)
        r = self.rgb_conv
        x = F.leaky_relu(r[0](torch.cat([image, coord], dim=1)), 0.2)
        return r[3](batch_norm(x, r[2]))

    def forward(self, image: Tensor, points: Tensor) -> Tensor:
        """(B, 3, H, W) image + clicks -> (B, 1, H, W) instance logits
        (``DistMapsHRNetModel.forward``)."""
        out, _ = self.feature_extractor(self.fuse_clicks(image, points))
        return hrnet.resize_ac(out, image.shape[-2:])

    def backbone_feats(self, image: Tensor, points: Tensor) -> Tensor:
        """The head input of f-BRS insertion 'A': the concatenated HRNet
        features before the OCR head (``brs.py:216-231``)."""
        return self.feature_extractor.compute_feats(self.fuse_clicks(image, points))

    def head_from_feats(self, feats: Tensor, out_hw: Tuple[int, int]) -> Tensor:
        """The OCR head on (scale/bias-modulated) backbone features ->
        logits (B, 1, H, W) at ``out_hw`` (``brs.py:176-196``)."""
        out, _ = self.feature_extractor.ocr_head(feats)
        return hrnet.resize_ac(out, out_hw)


def init_params(cfg: FbrsConfig, generator: Optional[torch.Generator] = None, *,
                device=None) -> FbrsModel:
    """An :class:`FbrsModel` with the JAX ``init_params``' distributions
    (conv weights N(0, 0.1²), biases 0, identity batch norms), drawn from
    ``generator`` (seeded with 0 when None)."""
    dev = resolve_device(device)
    return hrnet.random_init(FbrsModel(cfg, device=dev), generator, 0.1, dev)


def detect_config(sd: Mapping, norm_radius: float = 260.0) -> FbrsConfig:
    """Width, OCR width and ``small`` of a reference ``fbrs.pth`` state
    dict, by the reference's sniffing rules (``inference/utils.py:40-53``)."""
    n_fe = len([k for k in sd if k.startswith("feature_extractor.")])
    ocr = [v for k, v in sd.items() if "object_context_block.f_down.1.0.bias" in k]
    width = [v for k, v in sd.items() if "stage2.0.branches.0.0.conv1.weight" in k]
    if len(ocr) != 1 or len(width) != 1:
        raise ValueError("not an fbrs HRNet checkpoint (missing sniff keys)")
    return FbrsConfig(
        backbone=hrnet.HrnetConfig(width=int(np.shape(width[0])[0]),
                                   ocr_width=int(np.shape(ocr[0])[0]), small=n_fe < 1800),
        norm_radius=norm_radius)


def load_jax_params(model: FbrsModel, params: Dict) -> FbrsModel:
    """Copy the JAX package's f-BRS parameters (``model.init_params`` or
    ``convert_torch_state_dict``: HWIO convs, ``scale/bias/mean/var``
    batch norms) into ``model``, in place. Returns ``model``."""
    return hrnet.load_state(model, hrnet.jax_state_dict(params))

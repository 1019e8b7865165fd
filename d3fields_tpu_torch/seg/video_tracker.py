"""Video mask propagation: the d3fields <-> XMem bridge.

Counterpart of ``d3fields_tpu/seg/video_tracker.py`` (the reference's
``Fusion.xmem_process``, ``fusion.py:631-684``): per-view images are
ImageNet-normalised, min-side-resized to ``size`` (bilinear; nearest for
masks), padded to /16 and stepped through the XMem core for all views at
once; the per-object probabilities are resized back to full resolution
before the argmax.

Two resizes, as in the JAX package: the encoder input is resized without
antialiasing (torchvision's tensor ``Resize``), and the probabilities are
resized back with antialiasing (``jax.image.resize``), which matters at the
d3fields shape, where XMem runs at 480x640 for 240x320 frames and the way
back is a downscale.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from d3fields_tpu_torch.config import XMemConfig
from d3fields_tpu_torch.models.common import imagenet_stats
from d3fields_tpu_torch.models.resize import bilinear_resize, bilinear_resize_exact
from d3fields_tpu_torch.models.xmem.blocks import pad_divide_by, unpad
from d3fields_tpu_torch.models.xmem.core import XMemCore
from d3fields_tpu_torch.utils.profiling import tracer

Tensor = torch.Tensor


def _resize_min_side(hw: Tuple[int, int], size: int) -> Tuple[int, int]:
    """torchvision's min-side Resize shape rule (reference ``fusion.py:276``):
    short side = size, long side = int(size * long / short), truncated."""
    H, W = hw
    if size < 0:
        return H, W
    if H <= W:
        return size, int(size * W / H)
    return int(size * H / W), size


def prep_frames(images: Tensor, resized_hw: Tuple[int, int], pad_spec) -> Tensor:
    """(V, H, W, 3) RGB frames on the device -> ImageNet-normalised,
    min-side-resized, /16-padded (V, ph, pw, 3): the one XMem input
    pipeline, shared by :class:`VideoMaskTracker` and the fused serving step.

    Integer frames are 0..255; float frames must already be in [0, 1]."""
    imgs = images.to(torch.float32)
    if not images.is_floating_point():
        imgs = imgs / 255.0
    mean, std = imagenet_stats(imgs.device)
    imgs = (imgs - mean) / std
    if tuple(imgs.shape[1:3]) != tuple(resized_hw):
        imgs = bilinear_resize_exact(imgs, tuple(resized_hw))
    if any(pad_spec):
        lh, uh, lw, uw = pad_spec
        imgs = F.pad(imgs, (0, 0, lw, uw, lh, uh))
    return imgs


def upsample_probs(prob: Tensor, pad_spec, out_hw: Tuple[int, int]) -> Tensor:
    """(V, O+1, ph, pw) padded-grid probabilities -> (V, O+1, H, W) at the
    original resolution: unpad, then the antialiased bilinear resize."""
    prob_u = unpad(prob, pad_spec)
    if tuple(prob_u.shape[2:]) == tuple(out_hw):
        return prob_u
    return bilinear_resize(prob_u.permute(0, 2, 3, 1), tuple(out_hw)).permute(0, 3, 1, 2)


class VideoMaskTracker:
    """Propagates instance masks through a multi-camera video.

    ``process(rgb, mask)`` takes (V, H, W, 3) uint8 RGB and, on the first
    call, (V, H, W) uint8 index masks (0 = background); it returns (V, H, W,
    O+1) float one-hot masks. MaskMapper's label remapping is the identity
    here: d3fields seeds with consensus masks labelled 0..N.
    """

    def __init__(self, model, cfg: XMemConfig, num_views: int, num_objects: int,
                 image_hw: Tuple[int, int], size: int = 480, multi_group: bool = False, *,
                 device=None):
        """``model`` is an ``XMem`` module. ``multi_group=True`` lets masks
        on later frames seed objects entering mid-video. ``device``
        defaults to CUDA and raises when no GPU is visible."""
        self.cfg = cfg
        self.image_hw = tuple(image_hw)
        self.num_objects = num_objects  # without the background
        rh, rw = _resize_min_side(self.image_hw, size)
        self.resized_hw = (rh, rw)
        ph, pw = -(-rh // 16) * 16, -(-rw // 16) * 16
        lh, lw = (ph - rh) // 2, (pw - rw) // 2
        self.pad_spec = (lh, ph - rh - lh, lw, pw - rw - lw)
        self.core = XMemCore(model, cfg, num_views, num_objects, (ph, pw),
                             multi_group=multi_group, device=device)
        self.device = self.core.device
        self.first_mask_loaded = False
        self.last_prob = None  # (V, O+1, H, W) soft probabilities of the last step

    def clear_memory(self):
        self.core.clear_memory()
        self.first_mask_loaded = False
        self.last_prob = None

    def _prep_images(self, rgb) -> Tensor:
        if isinstance(rgb, np.ndarray):
            rgb = torch.from_numpy(np.ascontiguousarray(rgb))
        return prep_frames(rgb.to(self.device), self.resized_hw, self.pad_spec)

    def _prep_masks(self, mask: np.ndarray) -> Tensor:
        """(V, H, W) index mask -> (V, O, ph, pw) one-hot on the resized,
        padded grid. torchvision's NEAREST is ``F.interpolate(mode='nearest')``:
        src = floor(dst * in / out)."""
        V, H, W = mask.shape
        rh, rw = self.resized_hw
        yi = np.clip(np.arange(rh) * H // rh, 0, H - 1)
        xi = np.clip(np.arange(rw) * W // rw, 0, W - 1)
        small = mask[:, yi[:, None], xi[None, :]]
        onehot = np.stack([small == i + 1 for i in range(self.num_objects)], axis=1)
        out = torch.from_numpy(onehot.astype(np.float32)).to(self.device)
        return pad_divide_by(out, 16)[0]

    def process(self, rgb, mask: Optional[np.ndarray] = None,
                return_index: bool = False) -> np.ndarray:
        """One video step for all views; returns (V, H, W, O+1) one-hot
        (channel 0 = background), or with ``return_index`` the (V, H, W)
        uint8 argmax index mask. The tracer's span ``xmem.process`` holds
        the whole step, the copy to the host included."""
        with tracer.span("xmem.process"):
            return self._process(rgb, mask, return_index)

    def _process(self, rgb, mask, return_index: bool) -> np.ndarray:
        imgs = self._prep_images(rgb)
        if mask is not None and not self.first_mask_loaded:
            prob = self.core.step(imgs, self._prep_masks(np.asarray(mask)))
            self.first_mask_loaded = True
        elif mask is None:
            if not self.first_mask_loaded:
                raise ValueError("No mask provided for the first frame")
            prob = self.core.step(imgs)
        elif self.core.multi_group:
            # mid-video entry: the new mask's nonzero channels seed objects
            prob = self.core.step(imgs, self._prep_masks(np.asarray(mask)))
        else:
            raise NotImplementedError(
                "re-seeding with new masks mid-video needs multi_group=True (the "
                "d3fields pipeline seeds on frame 0 only; reference "
                "fusion.py:1240-1241 raises too)")
        up = upsample_probs(prob, self.pad_spec, self.image_hw)
        self.last_prob = up
        idx = torch.argmax(up, dim=1).to(torch.uint8).cpu().numpy()
        if return_index:
            return idx
        return np.stack([idx == i for i in range(up.shape[1])], axis=-1).astype(np.float32)

"""The Scribble-to-Mask controller: the reference GUI's scribble interaction.

Counterpart of ``d3fields_tpu/models/s2m/controller.py`` (the reference's
``S2MController``, ``XMem/inference/interact/s2m_controller.py``): given
the image, the previous index mask and a scribble map (object ids, 0 a
background scribble, ``ignore_class`` untouched), per-object mask
probabilities. Every object goes through one batched forward, where the
reference loops objects one forward each.
"""

from __future__ import annotations

import numpy as np
import torch

from d3fields_tpu_torch.models.s2m.model import S2M
from d3fields_tpu_torch.models.xmem.blocks import pad_divide_by, unpad
from d3fields_tpu_torch.utils.device import resolve_device


class S2MController:
    def __init__(self, model: S2M, num_objects: int, ignore_class: int = 255, *, device=None):
        """``model`` moves to ``device`` (CUDA unless the caller names another)."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.num_objects = num_objects
        self.ignore_class = ignore_class

    @torch.no_grad()
    def interact(self, image: np.ndarray, prev_mask: np.ndarray,
                 scr_mask: np.ndarray) -> np.ndarray:
        """image (H, W, 3) float; prev_mask (H, W) indices; scr_mask (H, W)
        object ids, 0 background, ``ignore_class`` untouched -> (K, H, W)
        per-object probabilities (``s2m_controller.py:22-38``)."""
        dev = self.device
        K = self.num_objects
        ks = torch.arange(1, K + 1, device=dev)[:, None, None]
        scr = torch.as_tensor(np.asarray(scr_mask), device=dev)[None].long()
        prev = torch.as_tensor(np.asarray(prev_mask), device=dev)[None].long()
        p_srb = (scr == ks).float()
        n_srb = ((scr != ks) & (scr != self.ignore_class)).float()
        img = torch.as_tensor(np.asarray(image, np.float32), device=dev).permute(2, 0, 1)
        x = torch.cat([img[None].expand(K, -1, -1, -1), (prev == ks).float()[:, None],
                       p_srb[:, None], n_srb[:, None]], dim=1)          # (K, 6, H, W)
        x, pads = pad_divide_by(x, 16)
        prob = unpad(torch.sigmoid(self.model(x)), pads)
        return prob[:, 0].cpu().numpy()

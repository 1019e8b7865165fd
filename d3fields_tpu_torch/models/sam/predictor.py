"""SAM predictor: preprocessing, box prediction and mask postprocessing.

Counterpart of ``d3fields_tpu/models/sam/predictor.py``, the original
SamPredictor contract the reference uses (``utils/grounded_sam.py:
392-431``): resize the longest side to the model size, normalise, pad
bottom-right; decode every box with multimask output; upscale the masks,
strip the padding, resize to the original image and threshold at 0. All of
it runs on the device; the masks come back as bool tensors.

:meth:`SamPredictor.set_images` encodes a whole rig in one batch and
:meth:`SamPredictor.predict_boxes_views` decodes every view's boxes in one
batch, each box against its own view's embedding.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from d3fields_tpu_torch.models.resize import bilinear_resize, bilinear_resize_exact
from d3fields_tpu_torch.models.sam.model import Sam
from d3fields_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


class SamPredictor:
    """Box-prompted segmentation: ``set_images(rgb_uint8 (V, H, W, 3))``
    then ``predict_boxes_views(boxes per view)``, or ``set_image`` and
    ``predict_boxes`` for one image."""

    def __init__(self, model: Sam, device=None):
        """``model`` is moved to ``device`` (CUDA unless the caller names
        another)."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self._image_embs = None
        self._orig_hw: Tuple[int, int] = (0, 0)
        self._resized_hw: Tuple[int, int] = (0, 0)

    def _target_hw(self, H: int, W: int) -> Tuple[int, int]:
        s = self.cfg.image_size / max(H, W)
        return int(H * s + 0.5), int(W * s + 0.5)

    def prep(self, rgbs: np.ndarray) -> Tensor:
        """uint8 (V, H, W, 3) -> normalised, bottom-right padded (V, S, S, 3)."""
        S = self.cfg.image_size
        rh, rw = self._target_hw(*rgbs.shape[1:3])
        img = bilinear_resize(torch.as_tensor(np.asarray(rgbs), device=self.device).float(),
                              (rh, rw))
        mean = torch.as_tensor(PIXEL_MEAN, dtype=torch.float32, device=self.device)
        std = torch.as_tensor(PIXEL_STD, dtype=torch.float32, device=self.device)
        return torch.nn.functional.pad((img - mean) / std, (0, 0, 0, S - rw, 0, S - rh))

    def set_images(self, rgbs: np.ndarray) -> "SamPredictor":
        """Encode a rig (V, H, W, 3) of views that share (H, W) in one batch."""
        H, W = rgbs.shape[1:3]
        self._orig_hw = (H, W)
        self._resized_hw = self._target_hw(H, W)
        with torch.no_grad():
            self._image_embs = self.model.encode(self.prep(rgbs))
        return self

    def set_image(self, rgb: np.ndarray) -> "SamPredictor":
        """Encode one (H, W, 3) image; repeated predict calls reuse it."""
        return self.set_images(np.asarray(rgb)[None])

    def predict_boxes_views(self, boxes_per_view: Sequence) -> List[Tuple[Tensor, Tensor]]:
        """Decode every view's boxes in one batch after :meth:`set_images`,
        with multimask output. ``boxes_per_view``: V arrays (N_v, 4) xyxy in
        original-image pixels (N_v may differ per view, and may be 0).
        Returns V pairs of (masks bool (N_v, M, H, W), iou (N_v, M)) on the
        device, M = ``cfg.num_multimask_outputs``."""
        if self._image_embs is None:
            raise RuntimeError("call set_images first")
        V = self._image_embs.shape[0]
        if len(boxes_per_view) != V:
            raise ValueError(f"{len(boxes_per_view)} box lists for {V} encoded views")
        H, W = self._orig_hw
        rh, rw = self._resized_hw
        boxes = [np.asarray(b, np.float32).reshape(-1, 4) for b in boxes_per_view]
        counts = [b.shape[0] for b in boxes]
        M = self.cfg.num_multimask_outputs
        if sum(counts) == 0:
            empty = (torch.zeros((0, M, H, W), dtype=torch.bool, device=self.device),
                     torch.zeros((0, M), device=self.device))
            return [empty] * V
        scale = np.asarray([rw / W, rh / H, rw / W, rh / H], np.float32)
        flat = torch.as_tensor(np.concatenate(boxes) * scale, device=self.device)
        view = torch.as_tensor(np.repeat(np.arange(V), counts), device=self.device)
        with torch.no_grad():
            low_res, iou = self.model.decode_boxes(self._image_embs[view], flat)
            masks = self._postprocess(low_res) > 0.0
        return list(zip(masks.split(counts), iou.split(counts)))

    def predict_boxes(self, boxes_xyxy: np.ndarray):
        """Boxes in original-image pixels of the image of :meth:`set_image`
        -> (masks bool (N, M, H, W), iou (N, M)) on the device."""
        if self._image_embs is None or self._image_embs.shape[0] != 1:
            raise RuntimeError("call set_image first")
        return self.predict_boxes_views([boxes_xyxy])[0]

    def _postprocess(self, low_res: Tensor) -> Tensor:
        """(N, M, s, s) mask logits -> (N, M, H, W): upscale to the model
        size, strip the bottom-right padding, resize to the original image,
        with F.interpolate's un-antialiased bilinear as the original SAM."""
        S = self.cfg.image_size
        rh, rw = self._resized_hw
        x = bilinear_resize_exact(low_res.permute(0, 2, 3, 1), (S, S))[:, :rh, :rw]
        return bilinear_resize_exact(x, self._orig_hw).permute(0, 3, 1, 2)

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
:meth:`SamPredictor.predict_points` decodes click prompts (upstream
``predict(point_coords=..., point_labels=..., mask_input=...)``). Unlike
the JAX predictor it pads neither the click count nor the prompt count to a
bucket: pad clicks join the decoder's token attention and move its output.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from d3fields_tpu_torch.models.resize import bilinear_resize, bilinear_resize_exact
from d3fields_tpu_torch.models.common import host_to_device, torch_dtype
from d3fields_tpu_torch.models.sam.model import Sam, trunk_copy
from d3fields_tpu_torch.parallel.mesh import ViewShards
from d3fields_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


@functools.lru_cache(maxsize=8)
def _pixel_stats(device: torch.device) -> Tuple[Tensor, Tensor]:
    """(mean, std) on ``device``, copied there once (as ``imagenet_stats``)."""
    return (torch.as_tensor(PIXEL_MEAN, dtype=torch.float32, device=device),
            torch.as_tensor(PIXEL_STD, dtype=torch.float32, device=device))


class SamPredictor:
    """Box-prompted segmentation: ``set_images(rgb_uint8 (V, H, W, 3))``
    then ``predict_boxes_views(boxes per view)``, or ``set_image`` and
    ``predict_boxes`` for one image."""

    def __init__(self, model: Sam, device=None, compute_dtype: str = "float32"):
        """``model`` is moved to ``device`` (CUDA unless the caller names
        another). ``compute_dtype='bfloat16'`` runs the ViT trunk in bf16 on
        a copy of its weights rounded once, here; the neck, the prompt
        encoder and the mask decoder keep f32 values and weights (JAX
        ``predictor.py:103-116``; its lifted matmul-precision pin on the
        decoder is a TPU setting with no counterpart here)."""
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.model = trunk_copy(model.to(self.device).eval(), torch_dtype(compute_dtype))
        self.cfg = model.cfg
        # the encoded views' embeddings: one tensor per device of the shards
        self._image_embs: Optional[List[Tensor]] = None
        self._orig_hw: Tuple[int, int] = (0, 0)
        self._resized_hw: Tuple[int, int] = (0, 0)
        self._views = ViewShards.on(self.device, self.model)
        self.device = self._views.first

    def shard_views(self, mesh) -> "SamPredictor":
        """Split the view axis of :meth:`set_images` and
        :meth:`predict_boxes_views` over ``mesh`` (JAX
        ``predictor.py:124-145``): the model is replicated on each device of
        the mesh, each device encodes its views and keeps their embeddings,
        and decodes their boxes with no collective; the masks come back in
        view order on the mesh's first device, which becomes this
        predictor's device. The mesh size must divide the view count.
        :meth:`set_image` (one image) runs on the first device."""
        self._views = ViewShards(mesh, self.model)
        self.device = mesh.first
        self.model = self._views.replicas[self.device]
        self._image_embs = None
        return self

    def _target_hw(self, H: int, W: int) -> Tuple[int, int]:
        s = self.cfg.image_size / max(H, W)
        return int(H * s + 0.5), int(W * s + 0.5)

    def prep(self, rgbs) -> Tensor:
        """uint8 (V, H, W, 3) -> normalised, bottom-right padded (V, S, S, 3),
        on the device of ``rgbs`` if it is a tensor, else on this
        predictor's."""
        S = self.cfg.image_size
        rh, rw = self._target_hw(*rgbs.shape[1:3])
        img = rgbs if torch.is_tensor(rgbs) else torch.as_tensor(np.asarray(rgbs),
                                                                  device=self.device)
        img = bilinear_resize(img.float(), (rh, rw))
        mean, std = _pixel_stats(img.device)
        return torch.nn.functional.pad((img - mean) / std, (0, 0, 0, S - rw, 0, S - rh))

    def set_images(self, rgbs: np.ndarray) -> "SamPredictor":
        """Encode a rig (V, H, W, 3) of views that share (H, W) in one batch
        (one batch per device under :meth:`shard_views`)."""
        return self._encode(self._views.split(rgbs))

    def set_image(self, rgb: np.ndarray) -> "SamPredictor":
        """Encode one (H, W, 3) image, on the first device; repeated predict
        calls reuse it."""
        return self._encode([np.asarray(rgb)[None]])

    def _encode(self, groups: Sequence) -> "SamPredictor":
        """Encode each group of views on its own device (a host array's on
        the first), where its embeddings stay for its own decode."""
        H, W = groups[0].shape[1:3]
        self._orig_hw = (H, W)
        self._resized_hw = self._target_hw(H, W)
        embs = []
        with torch.no_grad():
            for g in groups:
                x = self.prep(g)
                embs.append(self._views.replicas[x.device].encode(x))
        self._image_embs = embs
        return self

    def image_embeddings(self) -> Tensor:
        """The encoded views' embeddings (V, ...), in view order on this
        predictor's device."""
        if self._image_embs is None:
            raise RuntimeError("call set_images or set_image first")
        return self._views.gather(self._image_embs)

    def _single_embedding(self) -> Tensor:
        if self._image_embs is None or sum(e.shape[0] for e in self._image_embs) != 1:
            raise RuntimeError("call set_image first")
        return self._image_embs[0]

    def predict_boxes_views(self, boxes_per_view: Sequence) -> List[Tuple[Tensor, Tensor]]:
        """Decode every view's boxes in one batch after :meth:`set_images`,
        with multimask output. ``boxes_per_view``: V arrays (N_v, 4) xyxy in
        original-image pixels (N_v may differ per view, and may be 0).
        Returns V pairs of (masks bool (N_v, M, H, W), iou (N_v, M)) on the
        device, M = ``cfg.num_multimask_outputs``."""
        if self._image_embs is None:
            raise RuntimeError("call set_images first")
        V = sum(e.shape[0] for e in self._image_embs)
        if len(boxes_per_view) != V:
            raise ValueError(f"{len(boxes_per_view)} box lists for {V} encoded views")
        boxes = [np.asarray(b, np.float32).reshape(-1, 4) for b in boxes_per_view]
        counts = [b.shape[0] for b in boxes]
        parts, start = [], 0
        for e in self._image_embs:
            parts.append(self._decode_views(self._views.replicas[e.device], e,
                                            boxes[start:start + e.shape[0]]))
            start += e.shape[0]
        masks, iou = self._views.gather(parts)
        return list(zip(masks.split(counts), iou.split(counts)))

    def _decode_views(self, model: Sam, embs: Tensor, boxes: List[np.ndarray]):
        """Every box of these views against its own view's embedding, on
        the embeddings' device: (masks (N, M, H, W), iou (N, M))."""
        H, W = self._orig_hw
        rh, rw = self._resized_hw
        dev = embs.device
        counts = [b.shape[0] for b in boxes]
        if sum(counts) == 0:
            M = self.cfg.num_multimask_outputs
            return (torch.zeros((0, M, H, W), dtype=torch.bool, device=dev),
                    torch.zeros((0, M), device=dev))
        scale = np.asarray([rw / W, rh / H, rw / W, rh / H], np.float32)
        flat = host_to_device(np.concatenate(boxes) * scale, dev)
        view = host_to_device(np.repeat(np.arange(len(boxes)), counts), dev)
        with torch.no_grad():
            low_res, iou = model.decode_boxes(embs[view], flat)
            return self._postprocess(low_res) > 0.0, iou

    def predict_boxes(self, boxes_xyxy: np.ndarray):
        """Boxes in original-image pixels of the image of :meth:`set_image`
        -> (masks bool (N, M, H, W), iou (N, M)) on the device."""
        self._single_embedding()
        return self.predict_boxes_views([boxes_xyxy])[0]

    def predict_points(self, points_xy, labels, multimask_output: bool = True,
                       mask_input=None):
        """Click prompts on the image of :meth:`set_image`: points (N, P, 2)
        xy in original-image pixels, labels (N, P) in {1 foreground, 0
        background, -1 not a point} -> (masks bool (N, M, H, W), iou (N, M),
        low_res (N, M, s, s) logits) on the device. ``mask_input`` (N, s, s),
        exactly one low-res logit map per prompt (a previous call's third
        return), refines the masks."""
        emb = self._single_embedding()
        H, W = self._orig_hw
        rh, rw = self._resized_hw
        pts = np.array(points_xy, np.float32)
        if pts.ndim == 2:
            pts = pts[None]
        lbl = np.asarray(labels, np.int64).reshape(pts.shape[:2])
        n = pts.shape[0]
        pts[..., 0] *= rw / W
        pts[..., 1] *= rh / H
        mi = None
        if mask_input is not None:
            mi = torch.as_tensor(mask_input, dtype=torch.float32, device=self.device)
            if mi.dim() == 2:
                mi = mi[None]
            if mi.shape[0] != n:
                raise ValueError(f"mask_input has {mi.shape[0]} rows for {n} prompts — pass "
                                 "exactly one low-res logit map per prompt")
        embs = emb.expand(n, -1, -1, -1)
        with torch.no_grad():
            low_res, iou = self.model.decode_points(
                embs, torch.as_tensor(pts, device=self.device),
                torch.as_tensor(lbl, device=self.device), multimask_output, mask_input=mi)
            masks = self._postprocess(low_res) > 0.0
        return masks, iou, low_res

    def _postprocess(self, low_res: Tensor) -> Tensor:
        """(N, M, s, s) mask logits -> (N, M, H, W): upscale to the model
        size, strip the bottom-right padding, resize to the original image,
        with F.interpolate's un-antialiased bilinear as the original SAM."""
        S = self.cfg.image_size
        rh, rw = self._resized_hw
        x = bilinear_resize_exact(low_res.permute(0, 2, 3, 1), (S, S))[:, :rh, :rw]
        return bilinear_resize_exact(x, self._orig_hw).permute(0, 3, 1, 2)

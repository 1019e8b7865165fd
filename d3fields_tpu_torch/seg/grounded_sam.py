"""GroundedSAMBackend: open-text instance masks from GroundingDINO + SAM.

Counterpart of ``d3fields_tpu/seg/grounded_sam.py``, the rebuild of the
reference's ``grounded_instance_sam_new_ver`` (``utils/grounded_sam.py:
404-442``): detect boxes for the query texts, segment every box with SAM
(multimask, keep the mask with the best predicted IoU), prepend the
background mask = complement of the union. :meth:`segment_views` runs the
whole rig in one GroundingDINO forward, one SAM encode and one SAM decode.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from d3fields_tpu_torch.models.groundingdino.detector import Detections, GroundingDinoDetector
from d3fields_tpu_torch.models.sam.predictor import SamPredictor
from d3fields_tpu_torch.seg.backends import with_background
from d3fields_tpu_torch.seg.instances import ViewMasks
from d3fields_tpu_torch.utils.profiling import tracer
from d3fields_tpu_torch.utils.profiling import tracer

TEXT_THRESHOLD = 0.25  # reference utils/grounded_sam.py:414


def _view_masks(det: Detections, masks_mm: torch.Tensor, iou: torch.Tensor,
                queries: Sequence[str]) -> ViewMasks:
    best = iou.argmax(dim=1)
    masks = masks_mm[torch.arange(masks_mm.shape[0], device=best.device), best]
    labels = [queries[int(c)] for c in det.class_id]
    return with_background(masks.cpu().numpy(), labels, det.confidence)


def _background_only(H: int, W: int) -> ViewMasks:
    return with_background(np.zeros((0, H, W), bool), [], np.zeros((0,), np.float32))


class GroundedSAMBackend:
    def __init__(self, detector: GroundingDinoDetector, sam: SamPredictor):
        self.detector = detector
        self.sam = sam

    def segment(self, image: np.ndarray, queries: Sequence[str],
                thresholds: Sequence[float]) -> ViewMasks:
        """image (H, W, 3) RGB uint8 -> ViewMasks with background first.
        ``thresholds[0]`` is the box threshold (the reference uses only the
        first, ``utils/grounded_sam.py:423``)."""
        return self.segment_views(np.asarray(image)[None], queries, thresholds)[0]

    def segment_views(self, images: np.ndarray, queries: Sequence[str],
                      thresholds: Sequence[float]) -> List[ViewMasks]:
        """images (V, H, W, 3) RGB uint8 -> one ViewMasks per view: one
        GroundingDINO forward over all views, one SAM encode of the rig and
        one SAM decode of every view's boxes. Traced as ``seg.segment_views``,
        with ``seg.detect``, ``seg.sam.encode``, ``seg.sam.decode`` and
        ``seg.masks`` (the masks to the host, the background) inside."""
        with tracer.span("seg.segment_views", memory=True):
            dets = self.detector.predict_with_classes_batch(
                images, list(queries), box_threshold=float(thresholds[0]),
                text_threshold=TEXT_THRESHOLD)
            H, W = images.shape[1:3]
            if all(det.xyxy.shape[0] == 0 for det in dets):
                return [_background_only(H, W) for _ in dets]
            per_view = self.sam.set_images(images).predict_boxes_views([d.xyxy for d in dets])
            with tracer.span("seg.masks"):
                return [_view_masks(det, m, i, queries) if det.xyxy.shape[0]
                        else _background_only(H, W) for det, (m, i) in zip(dets, per_view)]

"""Open-text detection wrapper: the ``predict_with_classes`` contract.

Counterpart of ``d3fields_tpu/models/groundingdino/detector.py``. Classes
are joined into one caption ("[CLS] a . b . [SEP]"), every view is resized
(shortest side 800, longest at most 1333) and ImageNet-normalised, all
views run through ONE GroundingDINO forward, and detections are
thresholded on the max sigmoid token logit. A class owns the caption's
token span between '.' separators.

The reduction of the (V, Q, max_text_len) logits to per-query scores and
per-class span maxima runs on the device; the thresholding, box conversion
and duplicate removal that follow run on the host in numpy, as in the JAX
package. Tokenisation is pluggable: any callable str -> list[int].
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from d3fields_tpu_torch.models.common import imagenet_stats, torch_dtype
from d3fields_tpu_torch.models.groundingdino.model import GroundingDino, gated_copy
from d3fields_tpu_torch.models.resize import bilinear_resize
from d3fields_tpu_torch.parallel.mesh import ViewShards
from d3fields_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor
CLS_ID, SEP_ID, DOT_ID = 101, 102, 1012


@dataclasses.dataclass
class Detections:
    """Detections of one image (the supervision.Detections subset the
    reference uses, ``utils/grounded_sam.py:433-442``)."""

    xyxy: np.ndarray          # (N, 4) absolute pixel coords
    confidence: np.ndarray    # (N,)
    class_id: np.ndarray      # (N,) indices into the query class list


def tokenize_classes(
    classes: Sequence[str], tokenize: Callable[[str], List[int]]
) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Build '[CLS] c1 . c2 . ... [SEP]' ids + per-class token spans."""
    ids = [CLS_ID]
    spans = []
    for c in classes:
        toks = tokenize(c)
        spans.append((len(ids), len(ids) + len(toks)))
        ids.extend(toks)
        ids.append(DOT_ID)
    ids.append(SEP_ID)
    return np.asarray([ids], np.int64), spans


class GroundingDinoDetector:
    def __init__(self, model: GroundingDino, tokenize: Callable[[str], List[int]],
                 short_side: int = 800, max_side: int = 1333, device=None,
                 compute_dtype: str = "float32"):
        """``model`` is moved to ``device`` (CUDA unless the caller names
        another). ``compute_dtype='bfloat16'`` runs the gated trunk (Swin,
        the input projections and the 6 encoder layers) in bf16 on a copy
        of its weights rounded once, here; BERT, query selection, the
        decoder and the heads stay f32 (JAX ``detector.py:87, 108-113``)."""
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.model = gated_copy(model.to(self.device).eval(), torch_dtype(compute_dtype))
        self.cfg = model.cfg
        self.tokenize = tokenize
        self.short_side = short_side
        self.max_side = max_side
        self._views = ViewShards.on(self.device, self.model)
        self.device = self._views.first

    def shard_views(self, mesh) -> "GroundingDinoDetector":
        """Split the view axis of each batched forward over ``mesh`` (JAX
        ``detector.py:130-145``): the model is replicated on each device of
        the mesh, and each device runs the forward of its own views, its
        encoder and decoder gathers launching ``deform_gather`` (either
        route) on those views alone: the port's counterpart of the JAX
        ``shard_map`` forward, with no collective. The outputs come back in
        view order on the mesh's first device, which becomes this
        detector's device. The mesh size must divide the view count."""
        self._views = ViewShards(mesh, self.model)
        self.device = mesh.first
        self.model = self._views.replicas[self.device]
        return self

    def resized_hw(self, H: int, W: int) -> Tuple[int, int]:
        scale = self.short_side / min(H, W)
        if max(H, W) * scale > self.max_side:
            scale = self.max_side / max(H, W)
        return round(H * scale), round(W * scale)

    def prep(self, images) -> Tensor:
        """uint8 (V, H, W, 3) -> normalised (V, rh, rw, 3), on the device of
        ``images`` if it is a tensor, else on this detector's."""
        imgs = images if torch.is_tensor(images) else torch.as_tensor(np.asarray(images),
                                                                      device=self.device)
        imgs = bilinear_resize(imgs.float() / 255.0, self.resized_hw(*imgs.shape[1:3]))
        mean, std = imagenet_stats(imgs.device)
        return (imgs - mean) / std

    def predict_with_classes(
        self, image: np.ndarray, classes: Sequence[str],
        box_threshold: float, text_threshold: float = 0.25,
    ) -> Detections:
        """image: (H, W, 3) RGB uint8."""
        return self.predict_with_classes_batch(
            np.asarray(image)[None], classes, box_threshold, text_threshold)[0]

    def predict_with_classes_batch(
        self, images: np.ndarray, classes: Sequence[str],
        box_threshold: float, text_threshold: float = 0.25,
    ) -> List[Detections]:
        """All V views in ONE forward. images (V, H, W, 3) RGB uint8."""
        input_ids, spans = tokenize_classes(classes, self.tokenize)
        V, H, W = images.shape[:3]
        logits, boxes = self.forward_views(images, input_ids)
        with torch.no_grad():
            span_mask = torch.as_tensor(_span_mask(spans, self.cfg.max_text_len),
                                        device=self.device)
            reduced = _reduce_detection_outputs(logits, span_mask, text_threshold)
        scores, span_thr, span_fb = (t.cpu().numpy() for t in reduced)
        boxes = boxes.cpu().numpy()
        return [_postprocess_view_reduced(scores[v], span_thr[v], span_fb[v], boxes[v],
                                          box_threshold, (H, W)) for v in range(V)]

    def forward_views(self, images, input_ids: np.ndarray) -> Tuple[Tensor, Tensor]:
        """uint8 images (V, H, W, 3) and one caption's ids (1, L) -> the
        forward's (logits (V, Q, max_text_len), boxes (V, Q, 4)) on this
        detector's device; one forward per device under
        :meth:`shard_views`."""
        def forward(model, _, imgs):
            return model(self.prep(imgs), np.repeat(input_ids, imgs.shape[0], axis=0))

        with torch.no_grad():
            return self._views.map(forward, images)


def _span_mask(spans, L: int) -> np.ndarray:
    """(C, L) bool membership mask for the class token spans. A class whose
    tokenization is empty (span width 0) gets an all-false row and can
    never be assigned."""
    m = np.zeros((len(spans), L), bool)
    for c, (s, e) in enumerate(spans):
        m[c, s:e] = True
    return m


def _reduce_detection_outputs(logits: Tensor, span_mask: Tensor, text_threshold: float):
    """What the post-processing needs, reduced on the device: per-query max
    score (V, Q), and per-(query, class-span) maxima of the probabilities
    above ``text_threshold`` and of all of them (V, Q, C)."""
    probs = torch.sigmoid(logits)                          # (V, Q, L)
    scores = probs.amax(-1)
    p = probs[:, :, None, :]                               # (V, Q, 1, L)
    m = span_mask[None, None]                              # (1, 1, C, L)
    span_fb = torch.where(m, p, 0.0).amax(-1)
    thr = torch.where(p > text_threshold, p, 0.0)
    span_thr = torch.where(m, thr, 0.0).amax(-1)
    return scores, span_thr, span_fb


def _postprocess_view_reduced(scores, span_thr, span_fb, boxes, box_threshold, hw):
    """Host tail of the detection post-processing, from the reduced arrays:
    threshold on the max sigmoid token logit, assign the class by the
    strongest span among tokens above ``text_threshold`` (the reference's
    phrase extraction, ``utils/grounded_sam.py:414``), convert to absolute
    xyxy, drop near-duplicates."""
    H, W = hw
    keep = scores > box_threshold
    if not keep.any():
        return Detections(
            xyxy=np.zeros((0, 4), np.float32),
            confidence=np.zeros((0,), np.float32),
            class_id=np.zeros((0,), np.int64),
        )
    kb = boxes[keep]
    span_scores = span_thr[keep]
    # boxes whose every span token fell below text_threshold fall back to
    # the unthresholded response (the reference would emit an empty phrase)
    span_scores = np.where(span_scores.max(axis=1, keepdims=True) > 0, span_scores,
                           span_fb[keep])
    cx, cy, bw, bh = kb.T
    xyxy = np.stack([(cx - bw / 2) * W, (cy - bh / 2) * H,
                     (cx + bw / 2) * W, (cy + bh / 2) * H], axis=1).astype(np.float32)
    return dedup_boxes(Detections(
        xyxy=xyxy, confidence=scores[keep].astype(np.float32),
        class_id=span_scores.argmax(axis=1).astype(np.int64),
    ))


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy -> (N, M) IoU."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area_a = np.clip(a[:, 2:] - a[:, :2], 0, None).prod(-1)
    area_b = np.clip(b[:, 2:] - b[:, :2], 0, None).prod(-1)
    return inter / (area_a[:, None] + area_b[None] - inter + 1e-9)


def dedup_boxes(det: Detections, iou_threshold: float = 0.9) -> Detections:
    """Drop near-duplicate detections, keeping the higher confidence
    (reference duplicate-box removal, ``utils/grounded_sam.py:500-517``)."""
    n = det.xyxy.shape[0]
    if n <= 1:
        return det
    order = np.argsort(-det.confidence)
    iou = box_iou(det.xyxy, det.xyxy)
    keep = np.ones(n, bool)
    for rank, i in enumerate(order):
        if not keep[i]:
            continue
        for j in order[rank + 1:]:
            if keep[j] and iou[i, j] > iou_threshold:
                keep[j] = False
    return Detections(xyxy=det.xyxy[keep], confidence=det.confidence[keep],
                      class_id=det.class_id[keep])

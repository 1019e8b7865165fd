"""Open-text instance masks from GroundingDINO + SAM, in plain PyTorch and numpy.

D3Fields' ``grounded_instance_sam_new_ver`` (``utils/grounded_sam.py:
404-442``), as the program's ``GroundedSAMBackend.segment_views`` states
it for a rig of views:

- detection (``gdino.py``) of the caption of every query, then, per view:
  a query's score is its best token's sigmoid; the queries above the box
  threshold are kept; a query's class is the query whose caption span
  holds its strongest token among those above the text threshold (0.25),
  or among all the span's tokens where none is above it (the published
  code would give an empty phrase there); boxes cxcywh in [0, 1] become
  xyxy pixels; of two boxes at IoU above 0.9 the less confident goes
  (``utils/grounded_sam.py:500-517``);
- SAM (``sam.py``) on every view, every kept box decoded against its own
  view with multimask output, the mask of the best predicted IoU kept;
- per view the background mask, the complement of the union, first.

:func:`segment` runs it whole with its own choices (the control of the
benchmark's comparison runs it one precision step down); the benchmark's
check takes the stages one by one with the program's choices.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from port_bench.reference import gdino, sam
from port_bench.reference.precision import Precision

Tensor = torch.Tensor
TEXT_THRESHOLD = 0.25
DEDUP_IOU = 0.9


@dataclasses.dataclass
class Found:
    """One view's detections: xyxy pixels, confidence, class, and the
    index of the decoder query each came from."""

    xyxy: np.ndarray
    confidence: np.ndarray
    class_id: np.ndarray
    query: np.ndarray


@dataclasses.dataclass
class Masks:
    """One view's masks, background first (the ViewMasks contract)."""

    masks: np.ndarray
    labels: List[str]
    confidences: np.ndarray


def span_scores(logits: Tensor, spans, text_threshold: float = TEXT_THRESHOLD):
    """(V, Q) query scores, and (V, Q, classes) each class span's strongest
    token: among those above ``text_threshold``, or among all where none is."""
    probs = torch.sigmoid(logits.double())
    scores = probs.amax(-1)
    thr = torch.where(probs > text_threshold, probs, 0.0)
    strong = torch.stack([thr[..., a:b].amax(-1) if b > a else torch.zeros_like(scores)
                          for a, b in spans], -1)
    weak = torch.stack([probs[..., a:b].amax(-1) if b > a else torch.zeros_like(scores)
                        for a, b in spans], -1)
    per_class = torch.where(strong.amax(-1, keepdim=True) > 0, strong, weak)
    return scores, per_class


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: np.clip(x[:, 2:] - x[:, :2], 0, None).prod(-1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None] - inter + 1e-9)


def xyxy(boxes: np.ndarray, hw) -> np.ndarray:
    H, W = hw
    cx, cy, bw, bh = np.asarray(boxes, np.float64).T
    return np.stack([(cx - bw / 2) * W, (cy - bh / 2) * H, (cx + bw / 2) * W,
                     (cy + bh / 2) * H], 1)


def dedup_keep(boxes: np.ndarray, conf: np.ndarray) -> np.ndarray:
    """Which boxes stay: in descending confidence, a box goes when a kept
    one overlaps it at IoU above 0.9."""
    keep = np.ones(len(conf), bool)
    iou = box_iou(boxes, boxes)
    order = np.argsort(-conf, kind="stable")
    for r, i in enumerate(order):
        if keep[i]:
            later = order[r + 1:]
            keep[later] &= ~(iou[i, later] > DEDUP_IOU)
    return keep


def detections(logits: Tensor, boxes: Tensor, spans, box_threshold: float, hw) -> List[Found]:
    """Per view, the detections of the decoder's outputs."""
    scores, per_class = (t.cpu().numpy() for t in span_scores(logits, spans))
    boxes = boxes.double().cpu().numpy()
    out = []
    for v in range(scores.shape[0]):
        q = np.flatnonzero(scores[v] > box_threshold)
        b = xyxy(boxes[v, q], hw)
        keep = dedup_keep(b, scores[v, q])
        q = q[keep]
        out.append(Found(xyxy=b[keep], confidence=scores[v, q],
                         class_id=per_class[v, q].argmax(-1), query=q))
    return out


def with_background(masks: np.ndarray, labels, confs) -> Masks:
    hw = masks.shape[1:]
    bg = ~masks.any(0) if len(masks) else np.ones(hw, bool)
    return Masks(masks=np.concatenate([bg[None], masks]), labels=["background"] + list(labels),
                 confidences=np.concatenate([[1.0], confs]))


def segment(gw: dict, sw: dict, images_u8: np.ndarray, classes: Sequence[str],
            box_threshold: float, g: dict, s: dict, P: Precision) -> dict:
    """The whole request with the reference's own choices: ``det`` (the
    detector's outputs), ``found``, ``emb``, per view ``logits`` (N, 3, H,
    W) and ``iou`` (N, 3), ``views`` (:class:`Masks`)."""
    hw = images_u8.shape[1:3]
    det = gdino.detect(gw, images_u8, classes, g, P)
    found = detections(det["logits"], det["boxes"], det["spans"], box_threshold, hw)
    emb = sam.embed(sw, images_u8, s, P)
    counts = [len(f.query) for f in found]
    if sum(counts):
        logits, iou = sam.segment_boxes(sw, emb, [f.xyxy for f in found], hw, s, P)
    else:
        logits = torch.zeros((0, 3, *hw), device=emb.device)
        iou = torch.zeros((0, 3), device=emb.device)
    views, logit_v, iou_v = [], logits.split(counts), iou.split(counts)
    for f, lg, io in zip(found, logit_v, iou_v):
        best = io.argmax(1)
        chosen = (lg[torch.arange(len(best)), best] > 0).cpu().numpy()
        views.append(with_background(chosen, [classes[int(c)] for c in f.class_id],
                                     f.confidence))
    return {"det": det, "found": found, "emb": emb, "logits": list(logit_v),
            "iou": list(iou_v), "views": views}

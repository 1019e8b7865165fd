"""The readings behind the limits of chip_smoke.py's ``bf16`` holds, sound
and with a planted dtype fault, on the GPU.

Each hold of the ``bf16`` phase compares a bf16 run with the f32 run of the
same weights at full width. This script takes the same readings on the same
inputs, first as the port computes them and then with one of these faults
patched in (and taken out again after):

- ``layer_norm_bf16_stats``: every LayerNorm of a bf16 input takes its mean
  and variance in bf16 and normalises in bf16, where the JAX package (and
  the port) compute the statistics in f32;
- ``xmem_similarity_bf16``: XMem's memory similarity is computed from bf16
  keys, shrinkage, queries and selection in bf16, where the JAX package
  reads the memory in f32.

XMem's holds are also read at a prediction head 3 times larger than the
``bf16`` phase's, where some sphere pixels are decided too.

A limit that a fault's reading passes cannot see that fault. Prints one
JSON line a reading (hold, fault, reading, chip_smoke's limit) and the
card's name and power limit last. Needs one card::

    python3 bf16_fault_readings.py
"""

from __future__ import annotations

import contextlib
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as cs


@contextlib.contextmanager
def layer_norm_bf16_stats():
    orig = F.layer_norm

    def faulty(x, shape, weight=None, bias=None, eps=1e-5):
        if x.dtype != torch.bfloat16:
            return orig(x, shape, weight, bias, eps)
        dims = tuple(range(-len(shape), 0))
        xc = x - x.mean(dims, keepdim=True)
        y = xc * torch.rsqrt((xc * xc).mean(dims, keepdim=True) + eps)
        if weight is not None:
            y = y * weight.to(y.dtype)
        return y if bias is None else y + bias.to(y.dtype)

    F.layer_norm = faulty
    try:
        yield
    finally:
        F.layer_norm = orig


@contextlib.contextmanager
def xmem_similarity_bf16():
    from d3fields_tpu_torch.models.xmem import memory

    orig = memory.similarity

    def bf(t):
        return None if t is None else t.to(torch.bfloat16)

    memory.similarity = lambda mk, ms, qk, qe: orig(bf(mk), bf(ms), bf(qk), bf(qe)).float()
    try:
        yield
    finally:
        memory.similarity = orig


def emit(hold: str, fault: str, reading, limit, **extra) -> None:
    cs.emit({"hold": hold, "fault": fault, "reading": reading, "limit": limit, **extra})


def dinov2_readings(dev) -> None:
    from d3fields_tpu_torch.models import dinov2

    cfg = dinov2.Dinov2Config.vit_large()
    model = dinov2.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    bb32 = dinov2.Dinov2Backbone(model, device=dev)
    bb16 = dinov2.Dinov2Backbone(model, compute_dtype="bfloat16", device=dev)
    images = cs.scene(seed=100)["color"]
    with torch.no_grad():
        f32 = bb32(images, patch_hw=(24, 32))
        for fault, ctx in (("none", contextlib.nullcontext), ("layer_norm_bf16_stats",
                                                               layer_norm_bf16_stats)):
            with ctx():
                f16 = bb16(images, patch_hw=(24, 32))
            emit("dinov2_cos_deficit_vs_f32", fault, cs.cos_deficit(f16, f32),
                 cs.BF16_FEATURE_COS)


def segment_readings(dev) -> None:
    from d3fields_tpu_torch.models.groundingdino.detector import (
        GroundingDinoDetector, tokenize_classes)
    from d3fields_tpu_torch.models.sam.predictor import SamPredictor

    gmodel, smodel = cs.segment_models(dev)
    det32 = GroundingDinoDetector(gmodel, tokenize=cs.tokenize, device=dev)
    det16 = GroundingDinoDetector(gmodel, tokenize=cs.tokenize, device=dev,
                                  compute_dtype="bfloat16")
    sam32 = SamPredictor(smodel, device=dev)
    sam16 = SamPredictor(smodel, device=dev, compute_dtype="bfloat16")
    images = cs.scene(seed=300)["color"]
    ids = np.repeat(tokenize_classes(cs.SEG_QUERIES, cs.tokenize)[0], len(images), axis=0)
    pixels = det32.prep(images)
    want = cs.detector_intermediates(det32.model, pixels, ids)
    with torch.no_grad():
        e32 = sam32.model.encode(sam32.prep(images))
    for fault, ctx in (("none", contextlib.nullcontext),
                       ("layer_norm_bf16_stats", layer_norm_bf16_stats)):
        with ctx():
            got = cs.detector_intermediates(det16.model, pixels, ids)
            with torch.no_grad():
                e16 = sam16.model.encode(sam16.prep(images))
        row = cs.detector_dtype_reading(got, want)
        emit("gdino_encoder_cos_deficit_vs_f32", fault, row["encoder_cos_deficit"],
             cs.DTYPE_ENCODER_COS)
        emit("gdino_min_selected_overlap_vs_f32", fault, min(row["selected_overlap_per_view"]),
             cs.DTYPE_MIN_SELECTED_OVERLAP, per_view=row["selected_overlap_per_view"])
        emit("sam_embedding_cos_deficit_vs_f32", fault, cs.cos_deficit(e16, e32),
             cs.BF16_FEATURE_COS)


def xmem_readings(dev, frames: int = cs.BF16_XMEM_FRAMES) -> None:
    from d3fields_tpu_torch.config import XMemConfig

    runs, _ = cs.xmem_dtype_runs(dev, frames)
    cfg16 = XMemConfig(compute_dtype="bfloat16")
    with xmem_similarity_bf16():
        runs["fault"] = cs.xmem_track(dev, cs.xmem_deciding_model(dev, XMemConfig(), seed=5),
                                      cfg16, frames)
    for fault, name in (("none", "bf16"), ("xmem_similarity_bf16", "fault")):
        rows = [cs.xmem_dtype_reading(got, want) for got, want in
                zip(runs[name]["probs"][1:], runs["f32"]["probs"][1:])]
        emit("xmem_min_decided_share", fault, min(r["decided_share"] for r in rows),
             cs.BF16_XMEM_MIN_DECIDED)
        emit("xmem_min_label_agreement_decided", fault,
             min(r["label_agreement_decided"] for r in rows), cs.BF16_XMEM_MIN_AGREE)
        emit("xmem_max_p99_abs_err", fault, max(r["p99_abs_err"] for r in rows),
             cs.BF16_XMEM_P99_ATOL, per_frame=[r["p99_abs_err"] for r in rows])
    # the head 3x larger, its bias lowered by 2: the spheres decide pixels too
    head = {"scale": 3 * cs.BF16_XMEM_HEAD_SCALE, "bias": -2.0}
    runs, _ = cs.xmem_dtype_runs(dev, 6, **head)
    rows = [cs.xmem_dtype_reading(got, want) for got, want in
            zip(runs["bf16"]["probs"][1:], runs["f32"]["probs"][1:])]
    emit("xmem_min_label_agreement_decided", "none",
         min(r["label_agreement_decided"] for r in rows), cs.BF16_XMEM_MIN_AGREE, head=head,
         decided_labels=[r["decided_labels"] for r in rows],
         decided_share=[r["decided_share"] for r in rows])


def main() -> int:
    if not torch.cuda.is_available():
        print("bf16_fault_readings: no CUDA device is visible", file=sys.stderr)
        return 2
    from d3fields_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    dinov2_readings(dev)
    torch.cuda.empty_cache()
    segment_readings(dev)
    torch.cuda.empty_cache()
    xmem_readings(dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

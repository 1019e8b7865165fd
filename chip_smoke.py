#!/usr/bin/env python3
"""GPU smoke run of d3fields_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU (Hopper):

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``d3fields_tpu_torch/csrc``
with nvcc (one nvcc per source, all started together), holds each against
its plain PyTorch version on the card, at the main path's shapes and at a
shape for every route of the kernel (each kernel's bf16-table route too),
and times it (``fused_weighted_interp`` through every route that fits, f32
and bf16 tables, at the shapes where the wrapper picks each),
then drives the port's two paths at full width, with random weights from
seeded generators:

1. the field query: DINOv2 ViT-L/14 -> ``Fusion.update`` ->
   ``Fusion.batch_eval`` of 1,048,576 points over 4 views, 3 requests;
2. first-frame open-text segmentation: GroundingDINO swin-T + SAM ViT-H
   behind ``GroundedSAMBackend.segment_views`` on a 4-view 240x320 rig,
   3 requests; then the detector's forward held to the plain gather on the
   card and to the CPU, and SAM's decoder and encoder held to the CPU;
3. ``golden``: the apps ``vis_repr`` and ``vis_tracking`` at the arguments
   of the committed goldens, held to tests/golden/*.npz;
4. ``vis_repr`` at full width (``--synthetic --feat_dim 1024 --step
   0.004``: 2,445,000 grid points), each stage timed, the mesh held to the
   port's own CPU run;
5. ``vis_repr_backends``: the same app with the DINOv2 backbone of 1. and
   the GroundedSAM backend of 2. on the synthetic rig's colour and depth;
6. ``tracking``: vis_tracking's staged loop at full width (2 frames of 4
   views at 240x320, 1,024-d descriptors, 100 keypoints per instance from
   a 10.7M-point grid, 100 Adam steps a frame), the recovered drift checked
   and frame 0's keypoints held to the CPU's;
7. ``xmem``: ``VideoMaskTracker.process`` with a full-width XMem (ResNet-50
   key and ResNet-18 value encoders, ``XMemConfig()``) on the drifting
   spheres, seeded on frame 0 and propagated 70 frames at 480x640
   (consolidations at frames 45 and 70), frames 0-5 held to the CPU;
8. ``serving_step``: DINOv2 ViT-L/14 -> XMem propagation -> field -> rigid
   tracking, frames 1-4 staged (``Fusion.update`` ->
   ``text_queries_for_inst_mask`` -> ``rigid_tracking_steps``), through
   ``FusedFrameStep.step`` and through ``step_segment``, held together;
9. ``recorded_scene``: the recorded-scene path. The drifting spheres are
   written as a 4-frame 4-view recorded scene (PNG colour and depth, .npy
   cameras), full-width random checkpoints in the reference layouts
   (torch-hub DINOv2 ViT-L/14, huggingface GroundingDINO swin-T and SAM
   ViT-H, XMem.pth) and a vocab are written beside it, and the apps build
   their backends from those files (``apps/_backends.py``): ``vis_repr
   --data_path`` is held bit for bit to ``vis_repr.run`` with the in-memory
   models, and ``vis_tracking --data_path --fused --segment 2`` to the
   staged loop over the same frames; ``precompute_pca --images`` on 4 of
   the recorded colour frames with the written DINOv2 checkpoint;
10. ``eval_xmem``: XMem evaluation (``apps/eval_xmem.py``) at full width on
   three 480x854 (DAVIS 480p) videos of 24 PNG frames with paletted
   annotations, one of them with an object entering on frame 3:
   sequential, ``--video_batch 2`` and ``--flip``, then ``merge_scores``;
   held to the port's CPU run and batched to sequential;
11. ``train_xmem``: XMem training (``models/xmem/trainer.py``). The loss
   and every leaf's gradient of a small model's rollout on the card are
   held to the CPU's; then ``apps/train_xmem.py`` trains a full-width
   ``XMemConfig()`` at the reference's 384x384 crop with stage 3's clip
   shape (8 frames, 3 reference frames, 3 objects, batch 2) on 480x854 PNG
   videos for 4 steps and a ``--resume`` of 1 more, and ``eval_xmem
   --ckpt`` reads its checkpoint; the committed JPEG fixtures are decoded
   and held to their recorded ``cv2.imread`` SHA-256, and a stage-0 run
   trains on them (``--static_root``). Since slice 12 its dp part runs
   ``train_xmem --dp 2`` at that width (global batch 2, 3 steps) as two
   processes of a gloo group on the one card, held to a ``--dp 0`` run
   from the same seeded weights (losses, the first averaged gradient, the
   final checkpoint; both ranks' leaves bit-equal), ``train_step`` over
   NCCL at world size 1 bit-equal to the plain step, and ``--dp 2`` with
   no group refused on one GPU;
12. ``click_track``: ``apps/click_track.py`` with SAM ViT-H and
   ``XMemConfig()`` read from checkpoints in the reference layouts, on a
   480x854 video of 24 PNG frames: two groups of four clicks (the second
   entering at frame 8), ``--refine 1``; SAM's point decode on the card
   held to the same decoder on the CPU fed the card's image embedding;
13. ``interactive``: ``apps/interactive.py`` with f-BRS (HRNet-18s, OCR
   64), S2M (DeepLabV3+ ResNet-50) and ``XMemConfig()`` from checkpoints,
   a 24-frame 480x854 uncompressed AVI through ``--video``: a free stroke,
   three f-BRS clicks (f-BRS-B and the zoom-in from the second), undo, a
   scribble, forward propagation, the five overlays, then a resumed run
   propagating backward; f-BRS's forward and one BRS loss and gradient, and
   S2M's probabilities held to the CPU, each run's saved masks to the
   session's;
14. ``bf16`` (run after 5., on the models of 1. and 2.): the JAX package's
   bf16 compute dtype. The field query of 1. with the backbone's weights
   rounded to bf16 (3 requests), its descriptors held to the f32 ones on
   the card and to a CPU bf16 run of one view; ``segment_views`` of 2.
   with GroundingDINO's gated trunk and SAM's ViT-H trunk in bf16 (3
   requests; the encoder's gathers take deform_gather's bf16-table route),
   the detector held to the f32 one (its encoder output and the proposals
   it selects; the detection-level rule is reported) and SAM's embedding
   to its f32 one; XMem of 7. in bf16 for 20 frames beside an f32 tracker,
   probabilities and labels off the near-ties held to it; and 8. with
   DINOv2 and XMem in bf16 for 2 frames. Since slice 11 the field query's
   3 requests also run through ``fused_weighted_interp``'s bf16-table
   route (``batch_eval(..., matmul_dtype="bfloat16")``), held to the f32
   route (descriptors 1 - cos < 1e-3, ``dist`` and ``valid_mask`` equal);
15. ``parallel`` (run after 14., on its models): multi-device inference
   on the one card, over meshes of ``[cuda:0]`` and ``[cuda:0, cuda:0]``:
   ``sharded_batch_eval`` of 1,048,576 points at dp = 1 (bit-equal to
   ``batch_eval``) and dp = 2 (within the kernel's tolerance), through the
   kernel's f32 and bf16 routes; ``shard_views`` at dp = 2 of DINOv2
   ViT-L/14, GroundingDINO swin-T (f32 and bf16 trunk), SAM ViT-H and
   XMem (6 frames), each held to its unsharded self; and
   ``initialize_distributed`` over NCCL at world size 1 with
   ``sync_batch_norm`` and ``all_gather_points`` held to a plain batch
   norm and the identity. Two shards on one device run the split,
   replication and gather code, not two cards.

The ``tracking`` phase and the recorded tracking runs also write
``tracking.avi`` (the ``TrackVis`` mosaics, uncompressed AVI) in the app's
consumer and hold its first and last frames to a ``TrackVis`` recomputed
from the saved match points.

Every kernel's launch counter is set to 0 just before each path's requests
and read just after them, so the run shows each path went through its
kernels (the tracking, XMem, serving-step, evaluation and training paths
have none: the tracking loss differentiates the unfused field query, as in
the JAX package, and XMem runs no TPU kernel there either; nor do the
interactive tools). After the counted
requests, one more request of each path is traced with torch.profiler for the device time by
kernel and the device's idle share (traces under build/traces/), and each
kernel is held and timed on the inputs a request gives it: one field-query
tile, and the first encoder and decoder layers of one detection. The
apps write their outputs under build/chip_smoke/.

Output: one JSON object per phase, then the ``kernels`` line, then the
card's name and power limit as nvidia-smi gives them, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero without that line. With no CUDA device it exits with 2.
TF32 is off for matmul and cuDNN, so every float32 part computes in full
float32, the bf16 phase's f32 parts included.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import zlib
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor-core) peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

N_POINTS = 1 << 20
TILE = 131072
NAMES = ("dino_feats", "mask")
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5  # only the summation order differs


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps: int = 20, warmup: int = 3, windows: int = 5) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``reps``
    back-to-back calls (so that the host's launch time hides behind the
    device's work), after ``warmup`` calls; the median of ``windows`` such
    windows."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def scene(seed: int, num_views=4, H=240, W=320, num_inst=4):
    """An observation at bench.py's shapes (4 views @ 240x320, 4-channel
    full-res mask), made with numpy from ``seed``."""
    rs = np.random.RandomState(seed)
    depth = (0.6 + 0.2 * rs.rand(num_views, H, W)).astype(np.float32)
    K = np.tile(np.array([[260.0, 0, W / 2], [0, 260.0, H / 2], [0, 0, 1]], np.float32),
                (num_views, 1, 1))
    poses = []
    for v in range(num_views):
        th = 2 * np.pi * v / num_views
        c, s = np.cos(th), np.sin(th)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        t = np.array([0.02 * v, -0.01 * v, 0.8], np.float32)
        poses.append(np.concatenate([R, t[:, None]], 1))
    return {
        "color": rs.randint(0, 255, (num_views, H, W, 3)).astype(np.uint8),
        "depth": depth,
        "pose": np.stack(poses),
        "K": K,
        "mask": rs.rand(num_views, H, W, num_inst).astype(np.float32),
    }


def kernel_inputs(dev, V, hw, C, N, image_hw, xy_range, seed):
    from d3fields_tpu_torch.fields import geometry

    rng = np.random.default_rng(seed)
    h, w = hw
    feats = torch.as_tensor(rng.standard_normal((V, h * w, C), dtype=np.float32), device=dev)
    xy = torch.as_tensor(rng.uniform(*xy_range, size=(V, N, 2)).astype(np.float32), device=dev)
    vw = torch.as_tensor(rng.uniform(0, 1, size=(V, N)).astype(np.float32), device=dev)
    idx, tw = geometry.bilinear_taps(xy, image_hw, hw)
    return feats, idx, (tw * vw[..., None]).contiguous()


def compare(out, ref):
    """The largest error where the plain version is finite, and whether the
    kernel holds to it at KERNEL_RTOL / KERNEL_ATOL, NaN where it is NaN."""
    fin = torch.isfinite(ref)
    err = float((out - ref)[fin].abs().max()) if bool(fin.any()) else 0.0
    ok = bool(torch.allclose(out, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL, equal_nan=True))
    return err, ok


def kernel_time(kernel: str, shape: str, fns: dict, moved: int, flops: int,
                peak_flops: float = PEAK_F32_FLOPS, **extra) -> dict:
    """Times each callable of ``fns`` (a None stays None), emits one
    ``kernel_time`` line with the bound of the work, and returns its times
    and bound. The bound counts ``moved`` bytes at the HBM rate and
    ``flops`` at ``peak_flops`` (the float32 peak unless given)."""
    times = {k: (cuda_ms(f) if f is not None else None) for k, f in fns.items()}
    bytes_ms, ops_ms = moved / PEAK_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    row = {**times, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    emit({"phase": "kernel_time", "kernel": kernel, "shape": shape, **row, "bytes": moved,
          "flops": flops, **extra})
    return row


# field-query kernel checks: V, patch grid, C, N, image size, xy range
FUSED_SHAPES = {
    # the main path: 4 views, 24x32 DINOv2 patch grid, 1024-d, one 131072-point tile
    "main": (4, (24, 32), 1024, TILE, (240, 320), (-10.0, 330.0)),
    # a larger patch grid of the same width and tile: 16-channel slices do
    # not fit, 8-channel ones do
    "slice8": (4, (30, 40), 1024, TILE, (240, 320), (-10.0, 330.0)),
    # too wide for any slice (4 x 4,800 rows x 16 B > 227 KB): the direct route
    "direct_large_grid": (4, (60, 80), 256, 20000, (240, 320), (-10.0, 330.0)),
    # a ragged last slice (132 = 8 x 16 + 4)
    "ragged": (3, (6, 8), 132, 77, (48, 64), (-5.0, 70.0)),
    # a ragged last slice of the bf16 route too (136 = 4 x 32 + 8 = 8 x 16 + 8)
    "ragged8": (3, (6, 8), 136, 77, (48, 64), (-5.0, 70.0)),
    # tests/test_kernels.py:27-48: taps fall outside, C not a multiple of 4 (direct)
    "edge": (3, (6, 8), 130, 77, (48, 64), (-5.0, 70.0)),
    "one_view": (1, (24, 32), 1024, 4097, (240, 320), (-10.0, 330.0)),
    "narrow": (2, (6, 8), 3, 1000, (48, 64), (-5.0, 70.0)),
}


def fused_route(feats, idx, w, cs: int):
    """One launch of the field-query kernel's C entry with its route forced
    (``cs`` channels per slice, 0 for the direct gather; the bf16-table
    entry for a bf16 ``feats``), to hold and time the routes against each
    other on the same inputs. Counts no launch."""
    from d3fields_tpu_torch import _build
    from d3fields_tpu_torch.fields import kernels

    V, P, C = feats.shape
    N = idx.shape[1]
    out = torch.empty((N, C), dtype=torch.float32, device=feats.device)
    lib = _build.load("fused_interp", kernels.declare_fused_interp)
    entry = (lib.d3f_fused_weighted_interp_bf16 if feats.dtype == torch.bfloat16
             else lib.d3f_fused_weighted_interp)
    _build.launch("fused_weighted_interp", feats.device, entry, feats.data_ptr(),
                  idx.data_ptr(), w.data_ptr(), out.data_ptr(), V, P, N, C, cs)
    return out


def time_fused_weighted_interp(shape: str, feats, idx, w, matmul_dtype: str = "float32",
                               **extra) -> dict:
    """The kernel, its plain version and ``F.embedding_bag`` on one input
    (at 'bfloat16', ``feats`` is the bf16 table and embedding_bag runs on it
    with the weights rounded to bf16: its output is bf16)."""
    from d3fields_tpu_torch.fields import kernels

    V, P, C = feats.shape
    N = idx.shape[1]
    flat_idx = (idx.long() + (torch.arange(V, device=idx.device) * P)[:, None, None])
    flat_idx = flat_idx.permute(1, 0, 2).reshape(N, 4 * V).contiguous()
    flat_w = w.permute(1, 0, 2).reshape(N, 4 * V).to(feats.dtype).contiguous()
    table = feats.reshape(V * P, C)

    def library():
        return F.embedding_bag(flat_idx, table, mode="sum", per_sample_weights=flat_w)

    lib_err, _ = compare(library().float(),
                         kernels.fused_weighted_interp_plain(feats, idx, w, matmul_dtype))
    moved = (feats.numel() * feats.element_size() + idx.numel() * idx.element_size()
             + w.numel() * w.element_size() + N * C * 4)
    return kernel_time(
        "fused_weighted_interp", shape,
        {"ms": lambda: kernels.fused_weighted_interp(feats, idx, w, matmul_dtype),
         "plain_ms": lambda: kernels.fused_weighted_interp_plain(feats, idx, w, matmul_dtype),
         "library_ms": library},
        moved, 2 * 4 * V * N * C, slice_channels=kernels.slice_channels(V, P, C, feats.dtype),
        matmul_dtype=matmul_dtype, library_max_abs_err=lib_err,
        library_dtype=str(library().dtype), **extra)


# the shapes at which every route that fits is held and timed, so that the
# run shows whether kernels.slice_channels picks the fastest
ROUTE_SHAPES = ("main", "slice8")


def time_routes(label: str, feats, idx, w, ref) -> tuple:
    """Every route the table fits, forced, held to the plain version's
    ``ref`` and timed; one ``route_choice`` line says which the wrapper
    picks and which was fastest. Returns (route_ms, worst error)."""
    from d3fields_tpu_torch.fields import kernels

    V, P, C = feats.shape
    size = feats.element_size()
    widths = kernels.SLICE_CHANNELS if size == 4 else kernels.SLICE_CHANNELS_BF16
    fits = [cs for cs in widths if cs <= C and V * P * cs * size <= kernels.SMEM_PER_BLOCK]
    route_ms, worst = {}, 0.0
    for cs in fits + [0]:
        out = fused_route(feats, idx, w, cs)
        torch.cuda.synchronize()
        err, ok = compare(out, ref)
        route_ms[cs] = cuda_ms(lambda: fused_route(feats, idx, w, cs))
        emit({"phase": "kernel_check", "kernel": "fused_weighted_interp",
              "shape": f"{label}_slices_{cs}", "table": str(feats.dtype), "slice_channels": cs,
              "max_abs_err": err, "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL, "ok": ok,
              "ms": route_ms[cs]})
        check(ok, f"fused_weighted_interp ({feats.dtype}) with {cs}-channel slices disagrees "
                  f"at {label}")
        worst = max(worst, err)
    emit({"phase": "route_choice", "kernel": "fused_weighted_interp", "shape": label,
          "table": str(feats.dtype), "V": V, "P": P, "C": C, "N": idx.shape[1],
          "picked": kernels.slice_channels(V, P, C, feats.dtype),
          "fastest": min(route_ms, key=route_ms.get),
          "route_ms": {str(k): v for k, v in route_ms.items()}})
    return route_ms, worst


def check_fused_weighted_interp(dev):
    """The kernel against its plain version at the main path's shape, at a
    shape for each route and at edge shapes; at ROUTE_SHAPES, every route
    that fits, each timed."""
    from d3fields_tpu_torch.fields import kernels

    worst, worst16, routes16 = 0.0, 0.0, {}
    for i, (label, (V, hw, C, N, image_hw, xy_range)) in enumerate(FUSED_SHAPES.items()):
        feats, idx, w = kernel_inputs(dev, V, hw, C, N, image_hw, xy_range, seed=i)
        out = kernels.fused_weighted_interp(feats, idx, w)
        torch.cuda.synchronize()
        ref = kernels.fused_weighted_interp_plain(feats, idx, w)
        err, ok = compare(out, ref)
        emit({"phase": "kernel_check", "kernel": "fused_weighted_interp", "shape": label,
              "V": V, "P": hw[0] * hw[1], "C": C, "N": N,
              "slice_channels": kernels.slice_channels(V, hw[0] * hw[1], C),
              "max_abs_err": err, "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL, "ok": ok})
        check(ok, f"fused_weighted_interp disagrees with its plain version at {label}")
        worst = max(worst, err)
        if label in ROUTE_SHAPES:
            route_ms, route_err = time_routes(label, feats, idx, w, ref)
            worst = max(worst, route_err)
        if label == "main":
            main, main_route_ms = (feats, idx, w), route_ms
        worst16 = max(worst16, check_fused_bf16(label, feats, idx, w, routes16))
        del feats, idx, w, out, ref

    times = time_fused_weighted_interp(
        "main", *main, route_ms={str(k): v for k, v in main_route_ms.items()})
    bf16_times = time_fused_weighted_interp(
        "main_bf16", main[0].to(torch.bfloat16), *main[1:], "bfloat16",
        route_ms={str(k): v for k, v in routes16["main"].items()})
    return {"name": "fused_weighted_interp", "route": "cuda",
            "source": "d3fields_tpu_torch/csrc/fused_interp.cu",
            "replaces": "d3fields_tpu/fields/kernels.py:144", "max_abs_err": worst, **times,
            "bf16_route": {"route": "cuda", "shape": "main_bf16", "max_abs_err": worst16,
                           **bf16_times}}


def check_fused_bf16(label: str, feats, idx, w, routes16: dict) -> float:
    """The bf16 route (``matmul_dtype='bfloat16'``: the table and the tap
    weights rounded to bf16, f32 sums) on one FUSED_SHAPES input, held to
    its plain version; at ROUTE_SHAPES every bf16 route that fits, forced
    and timed (into ``routes16``). Returns the largest error."""
    from d3fields_tpu_torch.fields import kernels

    V, P, C = feats.shape
    f16 = feats.to(torch.bfloat16)
    before = kernels.fused_weighted_interp.launches_bf16
    out = kernels.fused_weighted_interp(f16, idx, w, "bfloat16")
    torch.cuda.synchronize()
    check(kernels.fused_weighted_interp.launches_bf16 == before + 1,
          f"fused_weighted_interp took another route than bf16 at {label}_bf16")
    ref = kernels.fused_weighted_interp_plain(f16, idx, w, "bfloat16")
    err, ok = compare(out, ref)
    # the f32 route on the same rounded values: the same products, summed
    # in the order of the f32 route's own kernel
    f32 = kernels.fused_weighted_interp(f16.float(), idx, w.to(torch.bfloat16).float())
    both_slice = bool(kernels.slice_channels(V, P, C) and
                      kernels.slice_channels(V, P, C, torch.bfloat16))
    vs_f32 = float((out - f32).abs().max()) if out.numel() else 0.0
    emit({"phase": "kernel_check", "kernel": "fused_weighted_interp", "shape": f"{label}_bf16",
          "V": V, "P": P, "C": C, "N": idx.shape[1],
          "slice_channels": kernels.slice_channels(V, P, C, torch.bfloat16),
          "max_abs_err": err, "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL, "ok": ok,
          "max_abs_err_vs_f32_route": vs_f32, "both_routes_slice": both_slice})
    check(ok, f"fused_weighted_interp's bf16 route disagrees with its plain version at {label}")
    # where both routes stage slices they sum each channel's products in one
    # order: equal; elsewhere within the kernels' tolerance
    check(vs_f32 == 0.0 if both_slice else
          bool(torch.allclose(out, f32, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)),
          f"fused_weighted_interp's bf16 route differs from the f32 route on the rounded "
          f"values at {label}: {vs_f32}")
    if label in ROUTE_SHAPES:
        routes16[label], route_err = time_routes(f"{label}_bf16", f16, idx, w, ref)
        err = max(err, route_err)
    return err


def capture_interp_inputs(state, pts):
    """The (feats, idx, w) that ``eval_field_fused`` hands the kernel for one
    tile of points, read by standing in for the module's kernel entry (the
    stand-in returns the plain version's result and launches nothing)."""
    from d3fields_tpu_torch.fields import kernels

    calls, kernel = [], kernels.fused_weighted_interp

    def capture(feats, idx, w, matmul_dtype="float32", *, out=None):
        calls.append((feats, idx, w))
        return kernels.fused_weighted_interp_plain(feats, idx, w, matmul_dtype, out=out)

    kernels.fused_weighted_interp = capture
    try:
        with torch.no_grad():
            kernels.eval_field_fused(state, pts, NAMES)
    finally:
        kernels.fused_weighted_interp = kernel
    check(len(calls) == 1, f"eval_field_fused called the kernel {len(calls)} times")
    return calls[0]


# the detector's 4 levels at 800x1067: S = Q = 17,821 encoder queries per view
GDINO_LEVELS = ((100, 134), (50, 67), (25, 34), (13, 17))

# deformable-gather kernel checks: B, levels, nh, hd, P, Q, loc range, share of NaN positions
GATHER_SHAPES = {
    # 4 views, the 4 real levels, Q = S (tools/bench_gather.py:48-60)
    "encoder": (4, GDINO_LEVELS, 8, 32, 4, 17821, (-0.05, 1.05), 0.0),
    # the decoder's 900 queries over the same maps
    "decoder": (4, GDINO_LEVELS, 8, 32, 4, 900, (-0.05, 1.05), 0.0),
    # tests/test_groundingdino.py:465-473: samples out of bounds, hd = 8
    "edge": (2, ((13, 17), (7, 9), (4, 5)), 4, 8, 4, 333, (-0.2, 1.2), 0.0),
    # hd = 12: 3 lanes per corner row, 10 lane groups and 2 idle lanes
    "hd12": (2, ((13, 17), (7, 9)), 4, 12, 4, 500, (-0.2, 1.2), 0.0),
    # L*P = 48 > 32 lanes: two rounds of the index phase
    "lp48": (2, ((13, 17), (7, 9), (4, 5)), 8, 32, 16, 300, (-0.2, 1.2), 0.0),
    # hd = 160: 40 float4s per corner row, two channel passes of the warp
    "hd160": (1, ((13, 17), (7, 9)), 2, 160, 4, 200, (-0.2, 1.2), 0.0),
    # samples far outside [0, 1] and NaN positions (NaN rows, equal to the CPU's)
    "far_nan": (2, ((13, 17), (7, 9), (4, 5)), 8, 32, 4, 333, (-3.0, 4.0), 0.01),
    # hd not a multiple of 4 (scalar route), one level, samples far outside [0, 1]
    "odd_hd": (2, ((23, 31),), 3, 6, 3, 1000, (-3.0, 4.0), 0.0),
}
# the shapes held again with a bf16 value table (the bf16-table route):
# 16-byte loads at hd = 32 and 8, 8-byte loads at hd = 12
GATHER_BF16_SHAPES = ("encoder", "decoder", "edge", "hd12")
# Against the f32 route on the same values widened (exactly) to f32: both
# take the JAX package's positions and weights and sum in f32, only the
# order of the sum differs. grid_sample, in the plain version, rounds its
# bilinear weights otherwise (up to 2.0e-6 at the 100x134 level, on the
# CPU as on the card): the outputs part by up to 4.4e-6 in either route
# at the encoder shape (NVIDIA H100 80GB HBM3, 700 W; PERF.md), so the
# plain version holds both routes at KERNEL_RTOL / KERNEL_ATOL.
GATHER_BF16_RTOL, GATHER_BF16_ATOL = 1e-5, 1e-6


def gather_inputs(dev, B, levels, nh, hd, P, Q, loc_range, nan_share, seed):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in levels)
    L = len(levels)
    value = rng.standard_normal((B, S, nh, hd), dtype=np.float32)
    loc = rng.uniform(*loc_range, size=(B, Q, nh, L, P, 2)).astype(np.float32)
    loc[rng.uniform(size=loc.shape) < nan_share] = np.nan
    attn = rng.uniform(0, 1, size=(B, Q, nh, L, P)).astype(np.float32)
    attn /= attn.sum(axis=(-2, -1), keepdims=True)
    return tuple(torch.as_tensor(a, device=dev) for a in (value, loc, attn))


def gather_bytes(value, levels, loc, attn) -> dict:
    """The bytes the gather must move on these inputs: each (batch, pixel,
    head) row of ``value`` that an in-map corner of a sample touches, read
    once; loc and attn read once; the output written once."""
    B, S, nh, hd = value.shape
    Q, P = loc.shape[1], loc.shape[4]
    dev = value.device
    b = torch.arange(B, device=dev).view(B, 1, 1, 1)
    head = torch.arange(nh, device=dev).view(1, 1, nh, 1)
    keys, start = [], 0
    for li, (h, w) in enumerate(levels):
        g = 2.0 * loc[:, :, :, li] - 1.0  # (B, Q, nh, P, 2), the kernel's arithmetic
        x0 = torch.floor(((g[..., 0] + 1.0) * w - 1.0) * 0.5)
        y0 = torch.floor(((g[..., 1] + 1.0) * h - 1.0) * 0.5)
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            x, y = x0 + dx, y0 + dy
            inb = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            pix = start + y.clamp(0, h - 1).nan_to_num(0).long() * w \
                + x.clamp(0, w - 1).nan_to_num(0).long()
            keys.append(((b * S + pix) * nh + head)[inb])
        start += h * w
    rows = int(torch.unique(torch.cat(keys)).numel())
    moved = rows * hd * value.element_size() + (loc.numel() + attn.numel() + B * Q * nh * hd) * 4
    return {"moved": moved, "value_rows_touched": rows, "value_rows": B * S * nh}


def time_deform_gather(shape: str, value, levels, loc, attn, **extra) -> dict:
    """The kernel and its plain version on one input, with the bound of
    the value rows these samples touch."""
    from d3fields_tpu_torch.models.groundingdino import deform_gather as dg

    B, Q, nh, L, P, _ = loc.shape
    hd = value.shape[-1]
    traffic = gather_bytes(value, levels, loc, attn)
    flops = 2 * 4 * B * Q * nh * L * P * hd  # 4 corners, a multiply and an add each
    return kernel_time(
        "deform_gather", shape,
        {"ms": lambda: dg.deform_gather(value, levels, loc, attn),
         "plain_ms": lambda: dg.deform_gather_plain(value, levels, loc, attn),
         # no single PyTorch call computes this function: grid_sample
         # samples one level and sums nothing
         "library_ms": None},
        traffic["moved"], flops, Q=Q,
        value_rows_touched=traffic["value_rows_touched"], value_rows=traffic["value_rows"],
        **extra)


def check_field_tile(dev):
    """The field query's tile kernel (``csrc/field_tile.cu``) at the main
    path's shape (4 views of 240x320, the 24x32x1024 patch grid, the
    4-channel mask, one 131,072-point tile) against the plain chain
    (``kernels._eval_field_fused_plain``) on the CPU over the tile's
    first 32,768 points; timed alone, as a whole tile (its launch and the
    descriptor kernel's) and beside the plain chain's tile on the card."""
    from d3fields_tpu_torch.fields import kernels
    from d3fields_tpu_torch.fields.state import state_from_obs

    obs = scene(seed=7)
    feats = np.random.RandomState(7).standard_normal((4, 24, 32, 1024)).astype(np.float32)
    state, cpu_state = (state_from_obs(obs, dino_feats=feats, mask=obs["mask"], device=d)
                        for d in (dev, "cpu"))
    pts = np.random.RandomState(8).uniform(-0.5, 0.5, (TILE, 3)).astype(np.float32)
    p = torch.as_tensor(pts, device=dev)
    V, (H, W), (h, w) = state.num_views, state.image_hw, state.dino_feats.shape[1:3]
    mc = state.mask.shape[-1]
    checked = 32768
    with torch.no_grad():
        got = {k: v[:checked].cpu() for k, v in kernels.eval_field_fused(state, p, NAMES).items()}
        want = kernels._eval_field_fused_plain(cpu_state, torch.as_tensor(pts[:checked]), NAMES,
                                               "float32")
    errs = {k: float((got[k] - want[k]).abs().max()) for k in ("dist", *NAMES)}
    ok = (torch.equal(got["valid_mask"], want["valid_mask"])
          and torch.allclose(got["dist"], want["dist"], rtol=0, atol=1e-6)
          and torch.allclose(got["mask"], want["mask"], rtol=0, atol=1e-5)
          and torch.allclose(got["dino_feats"], want["dino_feats"], rtol=KERNEL_RTOL,
                             atol=KERNEL_ATOL))
    emit({"phase": "kernel_check", "kernel": "field_tile", "shape": "main", "V": V,
          "image_hw": [H, W], "patch_hw": [h, w], "mask_channels": mc, "N": TILE,
          "checked": checked, "valid_share": float(want["valid_mask"].float().mean()),
          "valid_mismatch": int((got["valid_mask"] != want["valid_mask"]).sum()),
          "max_abs_err": errs, "ok": ok})
    check(ok, f"field_tile disagrees with the plain chain on the CPU: {errs}")

    out = {"dist": torch.empty(TILE, device=dev),
           "valid_mask": torch.empty(TILE, dtype=torch.bool, device=dev),
           "dino_feats": torch.empty((TILE, 1024), device=dev),
           "mask": torch.empty((TILE, mc), device=dev)}
    idx = torch.empty((V, TILE, 4), dtype=torch.int32, device=dev)
    tw = torch.empty((V, TILE, 4), device=dev)
    full = {"mask": state.mask}
    # the points read, distance, validity, the taps and the mask's rows
    # written once, the depth and mask maps read once
    moved = TILE * (12 + 4 + 1 + 2 * 16 * V + 4 * mc) + V * H * W * 4 * (1 + mc)
    with torch.no_grad():
        row = kernel_time(
            "field_tile", "main",
            {"ms": lambda: kernels.field_tile(state, p, out, full, idx, tw, (h, w)),
             "plain_ms": lambda: kernels._eval_field_fused_plain(state, p, NAMES, "float32"),
             "tile_ms": lambda: kernels.eval_field_fused(state, p, NAMES, out=out)},
            moved, 0, plain="the plain chain's tile on the card, descriptor kernel included",
            tile="field_tile and the descriptor kernel writing in place")
    return {"name": "field_tile", "route": "cuda", "source": "d3fields_tpu_torch/csrc/field_tile.cu",
            "replaces": "d3fields_tpu/fields/kernels.py:286-348 (the point-wise part, XLA-fused)",
            "max_abs_err": errs, "library_ms": None, **row}


def check_deform_gather(dev):
    """The deformable-attention kernel against its plain version at the
    detector's encoder and decoder shapes and at a shape for each route and
    edge; times at the encoder's and the decoder's shapes."""
    from d3fields_tpu_torch.models.groundingdino import deform_gather as dg

    worst, inputs = 0.0, {}
    for i, (label, (B, levels, nh, hd, P, Q, loc_range, nan_share)) in \
            enumerate(GATHER_SHAPES.items()):
        value, loc, attn = gather_inputs(dev, B, levels, nh, hd, P, Q, loc_range, nan_share,
                                         seed=10 + i)
        out = dg.deform_gather(value, levels, loc, attn)
        torch.cuda.synchronize()
        ref = dg.deform_gather_plain(value, levels, loc, attn)
        err, ok = compare(out, ref)
        nan_rows = {}
        if nan_share:
            # NaN rows where a sample position is NaN, as on the CPU and in JAX
            cpu = dg.deform_gather_plain(value.cpu(), levels, loc.cpu(), attn.cpu())
            nan_rows = {"nan_rows": int(torch.isnan(ref).any(-1).sum()),
                        "nan_rows_cpu": int(torch.isnan(cpu).any(-1).sum()),
                        "nan_equal_cpu": bool(torch.equal(torch.isnan(out).cpu(),
                                                          torch.isnan(cpu)))}
            check(nan_rows["nan_equal_cpu"] and nan_rows["nan_rows_cpu"] > 0,
                  f"deform_gather's NaN rows differ from the CPU's at {label}: {nan_rows}")
        emit({"phase": "kernel_check", "kernel": "deform_gather", "shape": label, "B": B,
              "levels": levels, "nh": nh, "hd": hd, "P": P, "Q": Q,
              "route": "float4" if hd % 4 == 0 else "float", **nan_rows, "max_abs_err": err,
              "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL, "ok": ok})
        check(ok, f"deform_gather disagrees with its plain version at {label}")
        worst = max(worst, err)
        if label in ("encoder", "decoder"):
            inputs[label] = (value, loc, attn)

    time_deform_gather("decoder", inputs["decoder"][0], GDINO_LEVELS, *inputs["decoder"][1:])
    times = time_deform_gather("encoder", inputs["encoder"][0], GDINO_LEVELS,
                               *inputs["encoder"][1:])

    # the bf16-table route on the same inputs, the value table rounded to bf16
    worst16 = 0.0
    for label in GATHER_BF16_SHAPES:
        B, levels, nh, hd, P, Q, loc_range, nan_share = GATHER_SHAPES[label]
        value, loc, attn = gather_inputs(dev, B, levels, nh, hd, P, Q, loc_range, nan_share,
                                         seed=10 + list(GATHER_SHAPES).index(label))
        value = value.to(torch.bfloat16)
        before = dg.deform_gather.launches_bf16
        out = dg.deform_gather(value, levels, loc, attn)
        torch.cuda.synchronize()
        check(dg.deform_gather.launches_bf16 == before + 1,
              f"deform_gather took another route than bf16 at {label}_bf16")
        err, ok = compare(out, dg.deform_gather_plain(value, levels, loc, attn))
        f32 = dg.deform_gather(value.float(), levels, loc, attn)
        err_f32 = float((out - f32).abs().max())
        ok_f32 = bool(torch.allclose(out, f32, rtol=GATHER_BF16_RTOL, atol=GATHER_BF16_ATOL))
        emit({"phase": "kernel_check", "kernel": "deform_gather", "shape": f"{label}_bf16",
              "B": B, "levels": levels, "nh": nh, "hd": hd, "P": P, "Q": Q,
              "route": f"bf16x{dg.bf16_width(hd)}", "max_abs_err": err,
              "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL, "ok": ok,
              "max_abs_err_vs_f32_route": err_f32, "rtol_vs_f32_route": GATHER_BF16_RTOL,
              "atol_vs_f32_route": GATHER_BF16_ATOL, "ok_vs_f32_route": ok_f32})
        check(ok, f"deform_gather's bf16 route disagrees with its plain version at {label}")
        check(ok_f32, f"deform_gather's bf16 route disagrees with its f32 route at {label}: "
                      f"{err_f32}")
        worst16 = max(worst16, err)
        if label == "encoder":
            bf16_times = time_deform_gather("encoder_bf16", value, GDINO_LEVELS, loc, attn)
    return {"name": "deform_gather", "route": "cuda",
            "source": "d3fields_tpu_torch/csrc/deform_gather.cu",
            "replaces": "d3fields_tpu/models/groundingdino/gather_pallas.py:238",
            "max_abs_err": worst, **times,
            "bf16_route": {"route": "cuda", "shape": "encoder_bf16", "max_abs_err": worst16,
                           **bf16_times}}


# SAM vision-attention shapes: B (views or windows), heads, grid, head width
SAM_ATTN_SHAPES = {
    "global": (4, 16, (64, 64), 80),   # ViT-H's global layers on 4 views
    "window": (100, 16, (14, 14), 80),  # its windowed layers: 4 x 25 windows of 14x14
    "vitb_global": (1, 12, (64, 64), 64),
    "tiny_window": (3, 2, (14, 14), 16),
    "small_grid": (2, 3, (8, 8), 16),    # one key tile, the staged tables
    "ragged": (2, 4, (10, 13), 64),      # L = 130: a ragged last tile of rows and keys
}
SAM_ATTN_F32_RTOL = 1e-5  # only the summation order and the exponential differ
SAM_ATTN_BF16_MIN_COS = 0.995  # the JAX bf16 budget (tests/test_sam.py:212)


def sam_attn_inputs(dev, B, nh, hw, hd, dtype, seed):
    """qkv (B, L, 3, nh, hd) as the projection writes it, and the two
    relative tables; N(0, 1) and N(0, 0.1^2), made on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, w = hw
    qkv = torch.randn((B, h * w, 3 * nh * hd), generator=gen, device=dev)
    rel_h = torch.randn((2 * h - 1, hd), generator=gen, device=dev) * 0.1
    rel_w = torch.randn((2 * w - 1, hd), generator=gen, device=dev) * 0.1
    return (qkv.reshape(B, h * w, 3, nh, hd).to(dtype), rel_h.to(dtype), rel_w.to(dtype))


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def hold_attention(kernel: str, shape: str, got, want, exact, bf16_launched: bool,
                   **info) -> None:
    """Emits one ``kernel_check`` line of an attention kernel's output
    ``got`` against its plain chain's ``want`` and checks it: f32 at
    SAM_ATTN_F32_RTOL; bf16 per row within the JAX bf16 budget of the plain
    bf16 chain, at least as close as that chain to ``exact()`` (the f32
    chain on the same bf16 inputs), and launched on the bf16 route."""
    line = {"phase": "kernel_check", "kernel": kernel, "shape": shape, **info,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "rel_l2_err": rel_l2(got, want)}
    if got.dtype == torch.float32:
        ok = bool(torch.allclose(got, want, rtol=SAM_ATTN_F32_RTOL,
                                 atol=SAM_ATTN_F32_RTOL * float(want.abs().max())))
        line.update(rtol=SAM_ATTN_F32_RTOL, ok=ok)
    else:
        ref = exact()
        cos = F.cosine_similarity(got.float(), want.float(), dim=-1).min()
        kernel_err, chain_err = rel_l2(got, ref), rel_l2(want, ref)
        ok = bool(cos > SAM_ATTN_BF16_MIN_COS and kernel_err <= chain_err and bf16_launched)
        line.update(min_row_cos=float(cos), min_cos=SAM_ATTN_BF16_MIN_COS,
                    rel_l2_err_vs_f32=kernel_err, chain_rel_l2_err_vs_f32=chain_err, ok=ok)
    emit(line)
    check(ok, f"{kernel} disagrees with the plain chain at {shape}: {line}")


def check_sam_attention(dev):
    """SAM's vision-attention kernel (``csrc/sam_attention.cu``), both
    routes, against the plain chain on the card at every
    :data:`SAM_ATTN_SHAPES` entry (:func:`hold_attention`). Timed
    at the ViT-H global and window shapes beside the plain chain and
    ``F.scaled_dot_product_attention`` given the materialised bias (its
    time leaves the bias's making out)."""
    from d3fields_tpu_torch.models import attention as sa

    rows = {}
    for i, (label, (B, nh, hw, hd)) in enumerate(SAM_ATTN_SHAPES.items()):
        for dtype in (torch.float32, torch.bfloat16):
            name = "f32" if dtype == torch.float32 else "bf16"
            qkv, rel_h, rel_w = sam_attn_inputs(dev, B, nh, hw, hd, dtype, seed=40 + i)
            before = sa.sam_attention.launches_bf16
            with torch.no_grad():
                got = sa.sam_attention(qkv, rel_h, rel_w, hw)
                torch.cuda.synchronize()
                want = sa.sam_attention_plain(qkv, rel_h, rel_w, hw)
                hold_attention("sam_attention", f"{label}_{name}", got, want,
                               lambda: sa.sam_attention_plain(qkv.float(), rel_h.float(),
                                                              rel_w.float(), hw),
                               sa.sam_attention.launches_bf16 == before + 1,
                               B=B, nh=nh, hw=list(hw), hd=hd)
            if label in ("global", "window"):
                rows[f"{label}_{name}"] = time_sam_attention(f"{label}_{name}", qkv, rel_h, rel_w,
                                                             hw)
            del qkv, got, want
            torch.cuda.empty_cache()
    return {"name": "sam_attention", "route": "cuda",
            "source": "d3fields_tpu_torch/csrc/sam_attention.cu",
            "replaces": "none (d3fields_tpu/models/sam/model.py:135 _vision_attention, XLA-fused)",
            "max_abs_err": None, **rows["global_bf16"], "shapes": rows}


def time_sam_attention(shape: str, qkv, rel_h, rel_w, hw) -> dict:
    """The wrapper (its bias GEMM and the kernel), the kernel's launch alone,
    the plain chain and the library's fused attention given the
    materialised bias (and, beside it, without any bias), at one shape; the
    bound counts q . k and p v at the route's peak and q, k, v, the bias
    terms and the output moved once."""
    from d3fields_tpu_torch import _build
    from d3fields_tpu_torch.models import attention as sa

    B, L, _, nh, hd = qkv.shape
    h, w = hw
    size = qkv.element_size()
    rows = sa.bias_rows(qkv[:, :, 0], rel_h, rel_w)
    out = torch.empty((B, L, nh * hd), dtype=qkv.dtype, device=qkv.device)
    # launch_ms: the kernel's C entry alone, uncounted
    lib = _build.load("sam_attention", sa.declare)
    entry = lib.d3f_sam_attention_bf16 if qkv.dtype == torch.bfloat16 else lib.d3f_sam_attention_f32
    q0, k0, v0 = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    args = (q0.data_ptr(), k0.data_ptr(), v0.data_ptr(), rows.data_ptr(), out.data_ptr(),
            B, L, nh, h, w, hd, q0.stride(0), q0.stride(1), q0.stride(2), hd ** -0.5)
    moved = size * (4 * B * L * nh * hd) + rows.numel() * size
    flops = 4 * B * nh * L * L * hd
    peak = PEAK_BF16_FLOPS if qkv.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    heads = qkv.permute(2, 0, 3, 1, 4)  # (3, B, nh, L, hd)
    q, k, v = heads[0], heads[1], heads[2]
    bias = sa.rel_pos_bias(hw, rel_h, rel_w, q.reshape(B * nh, L, hd)).reshape(B, nh, L, L)
    with torch.no_grad():
        row = kernel_time(
            "sam_attention", shape,
            {"ms": lambda: sa.sam_attention(qkv, rel_h, rel_w, hw),
             "launch_ms": lambda: _build.launch("sam_attention", qkv.device, entry, *args),
             "plain_ms": lambda: sa.sam_attention_plain(qkv, rel_h, rel_w, hw),
             "library_ms": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias),
             "library_no_bias_ms": lambda: F.scaled_dot_product_attention(q, k, v)},
            moved, flops, peak_flops=peak, dtype=str(qkv.dtype).replace("torch.", ""),
            wrapper="ms: the bias GEMM and the kernel; launch_ms: the kernel alone",
            library="F.scaled_dot_product_attention given the (B, nh, L, L) bias")
    row["launch_peak_share"] = row["bound_ms"] / row["launch_ms"]
    return row


# DINOv2 attention shapes (the kernel's bias-free mode): B (views), tokens
VIT_ATTN_SHAPES = {
    "vit_l": (4, 769),   # ViT-L/14 on the rig's 4 views: a 24x32 grid and CLS
    "ragged": (2, 130),  # a ragged last tile of rows and keys
}


def check_vit_attention(dev):
    """DINOv2's attention (``models/attention.py::vit_attention``, the
    kernel's bias-free mode), both routes, held to the plain chain on the
    card at every :data:`VIT_ATTN_SHAPES` entry (:func:`hold_attention`);
    timed at ViT-L's shape beside the plain chain and
    ``F.scaled_dot_product_attention``."""
    from d3fields_tpu_torch import _build
    from d3fields_tpu_torch.models import attention as at

    rows = {}
    for i, (label, (B, L)) in enumerate(VIT_ATTN_SHAPES.items()):
        for dtype in (torch.float32, torch.bfloat16):
            name = "f32" if dtype == torch.float32 else "bf16"
            gen = torch.Generator(device=dev).manual_seed(60 + i)
            qkv = torch.randn((B, L, 3 * 16 * 64), generator=gen, device=dev)
            qkv = qkv.reshape(B, L, 3, 16, 64).to(dtype)
            before = at.vit_attention.launches_bf16
            with torch.no_grad():
                got = at.vit_attention(qkv)
                torch.cuda.synchronize()
                want = at.vit_attention_plain(qkv)
                hold_attention("vit_attention", f"{label}_{name}", got, want,
                               lambda: at.vit_attention_plain(qkv.float()),
                               at.vit_attention.launches_bf16 == before + 1,
                               B=B, L=L, nh=16, hd=64)
            if label != "vit_l":
                continue
            out = torch.empty((B, L, 16 * 64), dtype=dtype, device=dev)
            lib = _build.load("sam_attention", at.declare)
            entry = lib.d3f_attention_bf16 if dtype == torch.bfloat16 else lib.d3f_attention_f32
            q0, k0, v0 = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            args = (q0.data_ptr(), k0.data_ptr(), v0.data_ptr(), out.data_ptr(), B, L, 16, 64,
                    q0.stride(0), q0.stride(1), q0.stride(2), 0.125)
            heads = qkv.permute(2, 0, 3, 1, 4)
            with torch.no_grad():
                rows[f"{label}_{name}"] = kernel_time(
                    "vit_attention", f"{label}_{name}",
                    {"ms": lambda: at.vit_attention(qkv),
                     "launch_ms": lambda: _build.launch("sam_attention", dev, entry, *args),
                     "plain_ms": lambda: at.vit_attention_plain(qkv),
                     "library_ms": lambda: F.scaled_dot_product_attention(
                         heads[0], heads[1], heads[2])},
                    qkv.element_size() * 4 * B * L * 16 * 64, 4 * B * 16 * L * L * 64,
                    peak_flops=PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS,
                    dtype=name, library="F.scaled_dot_product_attention")
            del qkv, got, want
    return {"name": "vit_attention", "route": "cuda",
            "source": "d3fields_tpu_torch/csrc/sam_attention.cu (bias-free mode)",
            "replaces": "none (d3fields_tpu/models/dinov2.py _block's attention, XLA-fused)",
            "max_abs_err": None, **rows["vit_l_bf16"], "shapes": rows}


def capture_gather_inputs(detector, images) -> dict:
    """The gather inputs of the first encoder and the first decoder layer of
    the detector's forward on ``images`` (the forward a segment_views
    request runs), read through the forward's ``gather`` argument."""
    from d3fields_tpu_torch.models.groundingdino.deform_gather import deform_gather
    from d3fields_tpu_torch.models.groundingdino.detector import tokenize_classes

    calls = []

    def capture(value, shapes, loc, attn):
        calls.append((value, tuple(shapes), loc, attn))
        return deform_gather(value, shapes, loc, attn)

    ids = np.repeat(tokenize_classes(SEG_QUERIES, tokenize)[0], len(images), axis=0)
    with torch.no_grad():
        detector.model(detector.prep(images), ids, gather=capture)
    cfg = detector.model.cfg
    check(len(calls) == cfg.encoder_layers + cfg.decoder_layers,
          f"{len(calls)} gather calls in one forward")
    return {"request_encoder": calls[0], "request_decoder": calls[cfg.encoder_layers]}


def kernel_wrappers():
    from d3fields_tpu_torch.fields.kernels import field_tile, fused_weighted_interp
    from d3fields_tpu_torch.models.groundingdino.deform_gather import deform_gather
    from d3fields_tpu_torch.models.attention import sam_attention, vit_attention

    return {"fused_weighted_interp": fused_weighted_interp, "field_tile": field_tile,
            "deform_gather": deform_gather, "sam_attention": sam_attention,
            "vit_attention": vit_attention}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_bf16"):
            fn.launches_bf16 = 0


def launch_counts() -> dict:
    """Each kernel's launches, and under ``<kernel>_bf16`` those of its
    bf16-table route (counted in ``<kernel>`` too), for the kernels that
    have one."""
    wrappers = kernel_wrappers()
    return {**{name: fn.launches for name, fn in wrappers.items()},
            **{f"{name}_bf16": fn.launches_bf16 for name, fn in wrappers.items()
               if hasattr(fn, "launches_bf16")}}


def serve(dev, num_requests: int = 3):
    """The main path at full width: 3 requests of update + batch_eval,
    then one more request traced by torch.profiler. Returns the launches,
    the DINOv2 backbone and the requests' update_ms."""
    from d3fields_tpu_torch import D3FieldsConfig, FusionConfig, Fusion
    from d3fields_tpu_torch.fields import kernels
    from d3fields_tpu_torch.models import dinov2

    t0 = time.perf_counter()
    cfg = dinov2.Dinov2Config.vit_large()
    model = dinov2.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    backbone = dinov2.Dinov2Backbone(model, device=dev)
    fus = Fusion(config=D3FieldsConfig(fusion=FusionConfig(query_tile=TILE)),
                 feature_backend=backbone, device=dev)
    check(fus.config.fusion.use_pallas, "the facade must take the fused kernel path")
    pts = np.random.RandomState(1).uniform(-0.5, 0.5, (N_POINTS, 3)).astype(np.float32)
    torch.cuda.synchronize()
    emit({"phase": "setup", "model": "dinov2_vit_large_random", "params":
          sum(p.numel() for p in model.parameters()), "seconds": time.perf_counter() - t0})

    tiles = -(-N_POINTS // TILE)
    update_ms = []
    reset_launch_counts()
    for r in range(num_requests):
        obs = scene(seed=100 + r)
        before = kernels.fused_weighted_interp.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = fus.update(obs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fus.batch_eval(pts, NAMES)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launched = kernels.fused_weighted_interp.launches - before
        update_ms.append((t1 - t0) * 1e3)
        # the checks below run the unfused path only: they launch no kernel
        verify_request(dev, state, pts, out, launched, tiles)
        emit({"phase": "request", "request": r, "update_ms": (t1 - t0) * 1e3,
              "batch_eval_ms": (t2 - t1) * 1e3, "pts_per_s": N_POINTS / (t2 - t1),
              "points": N_POINTS, "tile": TILE, "kernel_launches": launched,
              "valid_points": int(out["valid_mask"].sum())})
        del out
    counts = launch_counts()
    for kernel in ("fused_weighted_interp", "field_tile"):  # every tile fused: two launches
        check(counts[kernel] == num_requests * tiles,
              f"{kernel} launched {counts[kernel]} times, expected {num_requests * tiles}")
    check(counts["deform_gather"] == 0, "the field query launched the detector's kernel")
    layers = cfg.num_layers * num_requests  # DINOv2's attention: one launch a layer, f32
    check(counts["vit_attention"] == layers and counts["vit_attention_bf16"] == 0,
          f"DINOv2's attention launched {counts['vit_attention']} times, expected {layers}")

    # where the request time goes: the feature backend alone, and the
    # backbone on the CPU for one view as a check of the card's descriptors
    images = scene(seed=100)["color"]
    bb_ms = cuda_ms(lambda: backbone(images, patch_hw=(24, 32)), reps=5, warmup=1)
    feats_gpu = backbone(images[:1], patch_hw=(24, 32)).cpu()
    cpu_bb = dinov2.Dinov2Backbone(
        dinov2.Dinov2(cfg, device="cpu").eval(), device="cpu")
    cpu_bb.model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    feats_cpu = cpu_bb(images[:1], patch_hw=(24, 32))
    a, b = feats_gpu.reshape(-1, cfg.hidden_size), feats_cpu.reshape(-1, cfg.hidden_size)
    cos_deficit = float((1 - F.cosine_similarity(a, b, dim=-1)).max())
    dino_err = float((feats_gpu - feats_cpu).abs().max())
    emit({"phase": "dinov2", "backbone_ms": bb_ms, "views": 4, "tokens_per_view": 768,
          "gpu_vs_cpu_max_abs_err": dino_err, "gpu_vs_cpu_cos_deficit": cos_deficit})
    check(torch.allclose(feats_gpu, feats_cpu, rtol=2e-3, atol=2e-4) and cos_deficit < 1e-3,
          "DINOv2 descriptors on the card disagree with the CPU")
    obs = scene(seed=100)
    profile_stage("update", lambda: fus.update(obs))
    profile_stage("batch_eval", lambda: fus.batch_eval(pts, NAMES))
    # the kernel on the inputs of one tile of a request (request 0's scene)
    feats, idx, w = capture_interp_inputs(fus.state, torch.as_tensor(pts[:TILE], device=dev))
    err, ok = compare(kernels.fused_weighted_interp(feats, idx, w),
                      kernels.fused_weighted_interp_plain(feats, idx, w))
    emit({"phase": "kernel_check", "kernel": "fused_weighted_interp", "shape": "request_tile",
          "V": feats.shape[0], "P": feats.shape[1], "C": feats.shape[2], "N": idx.shape[1],
          "max_abs_err": err, "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL, "ok": ok})
    check(ok, "fused_weighted_interp disagrees with its plain version on a request tile")
    time_fused_weighted_interp("request_tile", feats, idx, w,
                               valid_points=int((w.sum((0, 2)) > 0).sum()))
    return counts, backbone, update_ms


# the names of the port's CUDA kernels (csrc/*.cu) in a profiler trace
PORT_KERNELS = ("fused_interp_slice_kernel", "fused_weighted_interp_kernel",
                "field_tile_kernel", "deform_gather_kernel", "sam_attention_bf16_kernel",
                "sam_attention_f32_kernel")


def profile_stage(stage: str, fn, top: int = 12) -> dict:
    """Device time by kernel, the device's idle share and the host's waits
    for the device over one call of ``fn`` (after one untraced warm-up
    call), read from the trace that torch.profiler writes to
    build/traces/chip_smoke_<stage>.json. Returns the emitted row."""
    import collections
    import os
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(os.path.join("build", "traces"), exist_ok=True)
    path = os.path.join("build", "traces", f"chip_smoke_{stage}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name = collections.Counter()
    count = collections.Counter()
    port = collections.defaultdict(list)  # each launch of the port's kernels
    for e in device:
        by_name[e["name"][:80]] += e["dur"] / 1e3
        count[e["name"][:80]] += 1
        for kernel in PORT_KERNELS:
            if kernel in e["name"]:
                port[kernel].append(e["dur"] / 1e3)
    busy_ms = sum(by_name.values())
    # the host's waits for the device: every synchronisation, among them a
    # blocking copy's and the traced call's closing one
    waits = [e for e in events if e.get("cat") == "cuda_runtime" and "Synchronize" in e["name"]]
    row = {"phase": "profile", "stage": stage, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms, "device_ops": len(device),
           "host_waits": len(waits), "host_wait_ms": sum(e["dur"] for e in waits) / 1e3,
           "top": [{"name": k, "device_ms": v, "count": count[k]}
                   for k, v in by_name.most_common(top)],
           "port_kernel_launch_ms": port}
    emit(row)
    return row


def verify_request(dev, state, pts, out, launched, tiles):
    """Shapes, finiteness, the launch count, and the fused path on the card
    against the unfused eval_field on the CPU."""
    from d3fields_tpu_torch.fields import fusion

    n = pts.shape[0]
    C = state.dino_feats.shape[-1]
    check(out["dist"].shape == (n,) and out["valid_mask"].shape == (n,), "dist/valid shape")
    check(out["dino_feats"].shape == (n, C) and out["mask"].shape == (n, 4), "feature shapes")
    for k in ("dist", "dino_feats", "mask"):
        check(bool(torch.isfinite(out[k]).all()), f"{k} is not finite")
    check(launched == tiles, f"kernel launched {launched} times for {tiles} tiles")
    check(bool(out["valid_mask"].any()), "no point is valid")

    # the fused path on the card against the unfused eval_field on the CPU:
    # the tile kernel (csrc/field_tile.cu) rounds each op as the CPU's torch
    # does, where the card's torch divides by a scalar through its
    # reciprocal, so the CPU is the oracle that agrees point for point
    cpu_state = state.replace(**{f: getattr(state, f).cpu() for f in
                                 ("depth", "pose", "K", "dino_feats", "mask")})
    ref = fusion.eval_field(cpu_state, torch.as_tensor(pts[:65536]), NAMES)
    got = {k: out[k][:65536].cpu() for k in ref}
    check(torch.equal(ref["valid_mask"], got["valid_mask"]), "valid_mask card vs CPU")
    for k, rtol, atol in (("dist", 0.0, 1e-6), ("mask", 0.0, 1e-5),
                          ("dino_feats", 1e-4, 1e-5)):
        check(torch.allclose(got[k], ref[k], rtol=rtol, atol=atol),
              f"{k} card vs CPU: max err {float((got[k] - ref[k]).abs().max())}")

# ---------------------------------------------------------------------------
# slice 2: first-frame open-text segmentation (GroundingDINO + SAM)
# ---------------------------------------------------------------------------

SEG_QUERIES = ["mug", "red can"]  # bench.py:481
SEG_TOL = dict(rtol=2e-3, atol=2e-4)  # the DINOv2 check's: f32 sums in other orders


def tokenize(text: str):
    """A toy tokenizer (the repository has no BERT vocabulary), the same in
    every process: crc32, not the per-process salted hash() of a str."""
    return [200 + zlib.crc32(w.encode()) % 1000 for w in text.split()]


def pick_box_threshold(detector, rigs, lo: int = 4, hi: int = 16):
    """The box threshold that leaves ``lo``-``hi`` boxes in the most views
    of all the rigs (ties: the mean count nearest 8), read from one
    detection call per rig that keeps every query. The random weights make
    the scores arbitrary, and they shift from view to view by more than
    the gap between a view's 4th and 17th score, so not every view can sit
    in the window; the phase says how many do. Duplicate removal keeps a
    box whatever boxes of lower confidence there are, so the count above a
    threshold is read off here."""
    confs = [np.sort(d.confidence) for rig in rigs
             for d in detector.predict_with_classes_batch(rig, SEG_QUERIES, box_threshold=-1.0)]
    cands = np.unique(np.concatenate(confs))
    counts = np.stack([len(c) - np.searchsorted(c, cands, side="right") for c in confs], 1)
    in_window = ((counts >= lo) & (counts <= hi)).sum(1)
    best = np.lexsort((np.abs(counts.mean(1) - 8), -in_window))[0]
    # midway to the next score, so that a rounding difference between runs
    # moves no box across the threshold
    thr = (float(cands[best]) + float(cands[min(best + 1, len(cands) - 1)])) / 2
    flat = [int((c > thr).sum()) for c in confs]
    per_view = np.reshape(flat, (len(rigs), -1)).tolist()
    in_window = sum(lo <= n <= hi for n in flat)
    emit({"phase": "box_threshold", "box_threshold": thr, "window": [lo, hi],
          "views_in_window": in_window, "views": len(confs),
          "boxes_per_view_per_request": per_view,
          "top5_per_view": [c[::-1][:5].tolist() for c in confs]})
    check(all(sum(v) > 0 for v in per_view), f"box threshold {thr} leaves a rig without a box")
    check(2 * in_window >= len(confs),
          f"box threshold {thr} leaves {lo}-{hi} boxes in fewer than half the views: {per_view}")
    return thr, per_view


def instrument(obj, method: str, key: str, times: dict) -> None:
    """Time ``obj.method`` on the host clock between synchronisations."""
    fn = getattr(obj, method)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times[key] = (time.perf_counter() - t0) * 1e3
        return out

    setattr(obj, method, timed)


def check_view_masks(views, hw, queries) -> None:
    """The contract of test_groundingdino.py:168-178 for every view."""
    for vm in views:
        check(vm.labels[0] == "background" and vm.confidences[0] == 1.0, "background first")
        check(vm.masks.dtype == np.bool_ and vm.masks.shape[1:] == tuple(hw), "bool masks")
        check(vm.masks.shape[0] == len(vm.labels) == vm.confidences.shape[0], "mask count")
        check(set(vm.labels[1:]) <= set(queries), "labels are queries")
        check(np.array_equal(vm.masks[0], ~np.any(vm.masks[1:], axis=0)),
              "background is the complement of the union")


def segment_models(dev):
    """GroundingDINO swin-T and SAM ViT-H with random weights from seeded
    generators: the models of the segmentation phases."""
    from d3fields_tpu_torch.models.groundingdino import model as gd
    from d3fields_tpu_torch.models.sam import model as sam

    gmodel = gd.init_params(gd.GroundingDinoConfig(), torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    with torch.no_grad():
        # At huggingface's init scale the random model's contrastive logits
        # are dot products of two unit-scale 256-d features, O(10-100): the
        # sigmoid of ~400 of the 900 queries' best token is 1.0 in float32
        # and no box threshold separates a few boxes (measured on the card).
        # Scaling the text features after the encoder's last layer norm by
        # 0.05 brings the logits to O(1), as a trained model's are.
        last = gmodel.model.encoder.layers[-1].text_enhancer_layer.layer_norm_after
        last.weight.mul_(0.05)
        last.bias.mul_(0.05)
    smodel = sam.init_params(sam.SamConfig.vit_huge(), torch.Generator(device=dev).manual_seed(1),
                             device=dev)
    return gmodel, smodel


def segment(dev, num_requests: int = 3):
    """Slice 2's path at full width: GroundingDINO swin-T + SAM ViT-H
    (random weights from seeded generators) behind
    ``GroundedSAMBackend.segment_views``, 3 requests of a 4-view 240x320 rig;
    then the card held to the plain gather and to the CPU, and one more
    request traced by torch.profiler. Returns the launches and the backend."""
    from d3fields_tpu_torch.models.groundingdino.deform_gather import (
        deform_gather, deform_gather_plain)
    from d3fields_tpu_torch.models.groundingdino.detector import GroundingDinoDetector
    from d3fields_tpu_torch.models.sam.predictor import SamPredictor
    from d3fields_tpu_torch.seg.grounded_sam import GroundedSAMBackend

    t0 = time.perf_counter()
    gmodel, smodel = segment_models(dev)
    gcfg = gmodel.cfg
    detector = GroundingDinoDetector(gmodel, tokenize=tokenize, device=dev)
    predictor = SamPredictor(smodel, device=dev)
    backend = GroundedSAMBackend(detector, predictor)
    rigs = [scene(seed=300 + r)["color"] for r in range(num_requests)]
    thr, at_thr = pick_box_threshold(detector, rigs)
    torch.cuda.synchronize()
    emit({"phase": "segment_setup", "detector": "groundingdino_swin_t_random",
          "detector_params": sum(p.numel() for p in detector.model.parameters()),
          "sam": "sam_vit_h_random", "sam_params": sum(p.numel() for p in predictor.model.parameters()),
          "views": 4, "image_hw": [240, 320], "detector_hw": list(detector.resized_hw(240, 320)),
          "queries": SEG_QUERIES, "box_threshold": thr,
          "seconds": time.perf_counter() - t0})

    times = {}
    instrument(detector, "predict_with_classes_batch", "detector_ms", times)
    instrument(predictor, "set_images", "sam_encode_ms", times)
    instrument(predictor, "predict_boxes_views", "sam_decode_ms", times)
    per_request = gcfg.encoder_layers + gcfg.decoder_layers  # every deformable attention
    reset_launch_counts()
    for r, images in enumerate(rigs):
        before = launch_counts()["deform_gather"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        views = backend.segment_views(images, SEG_QUERIES, [thr])
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
        launched = launch_counts()["deform_gather"] - before
        boxes = [len(vm.labels) - 1 for vm in views]
        emit({"phase": "request", "path": "segment_views", "request": r, **times,
              "total_ms": total_ms, "boxes_per_view": boxes,
              "views_with_4_to_16_boxes": sum(4 <= b <= 16 for b in boxes),
              "kernel_launches": launched})
        check_view_masks(views, images.shape[1:3], SEG_QUERIES)
        check(boxes == at_thr[r], f"boxes per view {boxes}, the threshold pick read {at_thr[r]}")
        check(launched == per_request,
              f"deform_gather launched {launched} times in a request, expected {per_request}")
        check(sum(boxes) > 0, "no box was detected, so SAM did not run")
    counts = launch_counts()
    check(counts["deform_gather"] == num_requests * per_request, f"launch counts {counts}")
    check(counts["fused_weighted_interp"] == 0, "segmentation launched the field kernel")
    for obj, method in ((detector, "predict_with_classes_batch"), (predictor, "set_images"),
                        (predictor, "predict_boxes_views")):
        delattr(obj, method)  # back to the class's method

    hold_detector(detector, rigs[0])
    hold_sam(dev, detector, predictor, rigs[0], thr)
    profile_stage("segment_views", lambda: backend.segment_views(rigs[0], SEG_QUERIES, [thr]))
    # the kernel on the inputs of request 0's first encoder and decoder layers
    for label, (value, shapes, loc, attn) in capture_gather_inputs(detector, rigs[0]).items():
        err, ok = compare(deform_gather(value, shapes, loc, attn),
                          deform_gather_plain(value, shapes, loc, attn))
        emit({"phase": "kernel_check", "kernel": "deform_gather", "shape": label,
              "Q": loc.shape[1], "max_abs_err": err, "rtol": KERNEL_RTOL,
              "atol": KERNEL_ATOL, "ok": ok})
        check(ok, f"deform_gather disagrees with its plain version on {label}")
        time_deform_gather(label, value, shapes, loc, attn)
    return counts, backend


def detector_intermediates(model, pixels, ids, gather=None):
    """The forward's encoder output, query-selection scores and selected
    indices (read with forward hooks), logits and boxes, on the CPU."""
    grabbed = {}
    hooks = [
        model.model.encoder.layers[-1].register_forward_hook(
            lambda m, i, o: grabbed.__setitem__("encoder", o)),
        model.model.enc_output_norm.register_forward_hook(
            lambda m, i, o: grabbed.__setitem__("obj_query", o)),
    ]
    try:
        with torch.no_grad():
            logits, boxes = model(pixels, ids, gather=gather)
    finally:
        for h in hooks:
            h.remove()
    vision, text = (t.float() for t in grabbed["encoder"])  # bf16 in a bf16 trunk
    scores = torch.matmul(grabbed["obj_query"], text.transpose(1, 2)).amax(-1)
    idx = torch.topk(scores, model.cfg.num_queries, dim=1).indices
    out = {"encoder": vision, "scores": scores, "selected": idx, "logits": logits,
           "boxes": boxes}
    return {k: v.cpu() for k, v in out.items()}


# The decoder past the discrete top-900 selection. A near-tie that swaps two
# selected queries moves every other query's self-attention a little; a
# fault moves logits (O(1) once the text features are scaled) and boxes (in
# [0, 1]) by their whole scale. Sound readings, against the plain gather on
# the card and against the CPU (PERF.md): logits 1.7e-4 and 9.0e-5, boxes
# 2.7e-6 and 3.6e-6, 3,594 of 3,600 and 898 of 900 selections agree.
DECODER_LOGIT_ATOL, DECODER_BOX_ATOL, MIN_AGREEING = 1e-3, 1e-4, 0.99


# Two compute dtypes (the bf16 phase). tests/test_groundingdino.py:408-440's
# detection-level rule (every top-10 query of one at IoU > 0.9 with one of
# the other's top 10, sorted best-token scores within 0.05) holds on the
# CPU tests' tiny model; at full width the random model's 17,821 proposal
# scores are so close that any rounding reorders the top 900, and the
# decoder pairs its query embeddings with the proposals by rank. On an
# NVIDIA H100 80GB HBM3 (700 W; PERF.md) the bf16 forward with the kernel
# and the same forward with the plain gather, which differ only in the
# order of f32 sums, gave top-10 IoUs of 0.0-0.105. So the rule is
# reported, and what it cannot blur is held: the bf16 encoder's output at
# the JAX package's bf16 budget (1 - cos < 1e-3, tests/test_dinov2.py:99)
# and the set of the 900 selected proposals per view (97.9-98.4% shared
# with f32 on every run there). The sound readings and those of planted
# dtype faults (bf16_fault_readings.py) are in PERF.md.
DETECTION_MIN_IOU, DETECTION_SCORE_GAP = 0.9, 0.05
DTYPE_ENCODER_COS, DTYPE_MIN_SELECTED_OVERLAP = 1e-3, 0.97


def top10_agreement(logits_a, boxes_a, logits_b, boxes_b) -> tuple:
    """One view's (largest gap of the sorted best-token scores, smallest
    best IoU of a top-10 query of ``a`` against the top 10 of ``b``)."""
    s_a, s_b = torch.sigmoid(logits_a).amax(-1), torch.sigmoid(logits_b).amax(-1)
    top_a, top_b = boxes_a[torch.argsort(-s_a)[:10]], boxes_b[torch.argsort(-s_b)[:10]]

    def corners(b):
        return torch.cat([b[:, :2] - b[:, 2:] / 2, b[:, :2] + b[:, 2:] / 2], -1)

    ca, cb = corners(top_a), corners(top_b)
    lt = torch.maximum(ca[:, None, :2], cb[None, :, :2])
    rb = torch.minimum(ca[:, None, 2:], cb[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    iou = inter / (top_a[:, 2:].prod(-1)[:, None] + top_b[:, 2:].prod(-1)[None] - inter + 1e-9)
    gap = float((torch.sort(s_a).values - torch.sort(s_b).values).abs().max())
    return gap, float(iou.amax(1).min())


def cos_deficit(a, b) -> float:
    """The largest 1 - cos between matching feature vectors (the last axis)."""
    a, b = a.reshape(-1, a.shape[-1]).float(), b.reshape(-1, b.shape[-1]).float()
    return float((1 - F.cosine_similarity(a, b, dim=-1)).max())


def detector_dtype_reading(a: dict, b: dict) -> dict:
    """Two compute dtypes' detector intermediates (``detector_intermediates``)
    side by side: the encoder output's largest 1 - cos, each view's share of
    selected proposals in common, and the detection-level rule's readings."""
    views = [top10_agreement(a["logits"][v], a["boxes"][v], b["logits"][v], b["boxes"][v])
             for v in range(a["logits"].shape[0])]
    return {"encoder_cos_deficit": cos_deficit(a["encoder"], b["encoder"]),
            "encoder_max_abs_err": float((a["encoder"] - b["encoder"]).abs().max()),
            "selection_score_max_abs_err": float((a["scores"] - b["scores"]).abs().max()),
            "selected_overlap_per_view": [len(set(x.tolist()) & set(y.tolist())) / len(x)
                                          for x, y in zip(a["selected"], b["selected"])],
            "queries_agreeing_in_rank": int((a["selected"] == b["selected"]).sum()),
            "queries": int(a["selected"].numel()),
            "sorted_score_max_gap_per_view": [g for g, _ in views],
            "top10_min_iou_per_view": [i for _, i in views]}


def compare_detector_dtypes(label: str, a: dict, b: dict) -> None:
    """The bf16 detector against the f32 one: the encoder output held at
    DTYPE_ENCODER_COS and each view's selected proposals at
    DTYPE_MIN_SELECTED_OVERLAP; the detection-level rule reported (see
    DETECTION_MIN_IOU)."""
    row = detector_dtype_reading(a, b)
    emit({"phase": "hold_detector", "against": label, **row,
          "reported_rule": {"min_iou": DETECTION_MIN_IOU, "max_score_gap": DETECTION_SCORE_GAP},
          "encoder_cos_tol": DTYPE_ENCODER_COS,
          "min_selected_overlap": DTYPE_MIN_SELECTED_OVERLAP})
    check(row["encoder_cos_deficit"] < DTYPE_ENCODER_COS,
          f"encoder output vs {label}: 1 - cos {row['encoder_cos_deficit']}")
    check(min(row["selected_overlap_per_view"]) >= DTYPE_MIN_SELECTED_OVERLAP,
          f"selected proposals vs {label}: {row['selected_overlap_per_view']}")


def compare_detections(label: str, a: dict, b: dict) -> None:
    """Encoder output and selection scores at SEG_TOL; the decoder's logits
    and boxes on the queries whose selected index agrees, at
    DECODER_LOGIT_ATOL and DECODER_BOX_ATOL."""
    enc_err = float((a["encoder"] - b["encoder"]).abs().max())
    score_err = float((a["scores"] - b["scores"]).abs().max())
    agree = a["selected"] == b["selected"]
    la, lb = a["logits"][agree], b["logits"][agree]
    fin = torch.isfinite(lb)
    logit_err = float((la[fin] - lb[fin]).abs().max()) if bool(fin.any()) else 0.0
    box_err = float((a["boxes"][agree] - b["boxes"][agree]).abs().max()) if bool(agree.any()) \
        else 0.0
    emit({"phase": "hold_detector", "against": label, "encoder_max_abs_err": enc_err,
          "selection_score_max_abs_err": score_err,
          "queries_agreeing": int(agree.sum()), "queries": int(agree.numel()),
          "logits_max_abs_err_on_agreeing": logit_err, "boxes_max_abs_err_on_agreeing": box_err})
    check(torch.allclose(a["encoder"], b["encoder"], **SEG_TOL), f"encoder output vs {label}")
    check(torch.allclose(a["scores"], b["scores"], **SEG_TOL), f"selection scores vs {label}")
    check(float(agree.float().mean()) >= MIN_AGREEING,
          f"{int(agree.sum())} of {agree.numel()} selected queries agree vs {label}")
    check(torch.equal(torch.isfinite(la), fin), f"finite logits vs {label}")
    check(logit_err <= DECODER_LOGIT_ATOL and box_err <= DECODER_BOX_ATOL,
          f"decoder outputs vs {label}")


def hold_detector(detector, images) -> None:
    """The kernel's forward against the plain gather's on the card (4
    views), and against the CPU for view 0 alone."""
    from d3fields_tpu_torch.models.groundingdino import model as gd
    from d3fields_tpu_torch.models.groundingdino.deform_gather import deform_gather_plain
    from d3fields_tpu_torch.models.groundingdino.detector import tokenize_classes

    model = detector.model
    ids = np.repeat(tokenize_classes(SEG_QUERIES, tokenize)[0], len(images), axis=0)
    pixels = detector.prep(images)
    card = detector_intermediates(model, pixels, ids)
    compare_detections("plain_gather_on_card", card,
                       detector_intermediates(model, pixels, ids, gather=deform_gather_plain))
    cpu_model = gd.GroundingDino(model.cfg, device="cpu").eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    on_cpu = detector_intermediates(cpu_model, pixels[:1].cpu(), ids[:1])
    emit({"phase": "hold_detector_cpu", "view": 0, "cpu_seconds": time.perf_counter() - t0})
    compare_detections("cpu_view0", detector_intermediates(model, pixels[:1], ids[:1]), on_cpu)


def hold_sam(dev, detector, predictor, images, thr) -> None:
    """SAM's box decode and mask postprocess for one view on the card
    against the CPU from the same embedding (mask logits before the
    threshold, bool masks except where |logit| < 1e-4), and SAM's encoder
    for view 0 on the CPU."""
    from d3fields_tpu_torch.models.sam import model as sam

    dets = detector.predict_with_classes_batch(images, SEG_QUERIES, thr)
    v = next((i for i, d in enumerate(dets) if len(d.xyxy)), None)
    check(v is not None, "no view has a box to decode")
    predictor.set_images(images)
    H, W = predictor._orig_hw
    rh, rw = predictor._resized_hw
    boxes = torch.as_tensor(dets[v].xyxy * np.asarray([rw / W, rh / H, rw / W, rh / H],
                                                      np.float32))
    emb = predictor.image_embeddings()[v:v + 1].expand(len(boxes), -1, -1, -1)
    model = predictor.model
    cpu_sam = sam.Sam(model.cfg, device="cpu").eval()
    cpu_sam.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    with torch.no_grad():
        low, iou = model.decode_boxes(emb, boxes.to(dev))
        low_cpu, iou_cpu = cpu_sam.decode_boxes(emb.cpu(), boxes)
        logits = predictor._postprocess(low).cpu()
        logits_cpu = predictor._postprocess(low_cpu)
    scale = float(logits_cpu.abs().max())
    sure = logits_cpu.abs() >= 1e-4
    mask_agree = bool(torch.equal((logits > 0)[sure], (logits_cpu > 0)[sure]))
    emit({"phase": "hold_sam_decoder", "view": v, "boxes": len(boxes),
          "low_res_max_abs_err": float((low.cpu() - low_cpu).abs().max()),
          "iou_max_abs_err": float((iou.cpu() - iou_cpu).abs().max()),
          "mask_logit_max_abs_err": float((logits - logits_cpu).abs().max()),
          "mask_logit_scale": scale, "knife_edge_share": float(1 - sure.float().mean()),
          "masks_agree_off_knife_edge": mask_agree})
    check(torch.allclose(logits, logits_cpu, rtol=1e-4, atol=1e-4 * scale), "mask logits vs CPU")
    check(torch.allclose(iou.cpu(), iou_cpu, rtol=1e-4, atol=1e-5), "iou vs CPU")
    check(mask_agree, "thresholded masks vs CPU")

    t0 = time.perf_counter()
    with torch.no_grad():
        emb_cpu = cpu_sam.encode(predictor.prep(images[:1]).cpu())
    seconds = time.perf_counter() - t0
    emb_card = predictor.image_embeddings()[:1].cpu()
    a, b = emb_card.reshape(-1, emb_card.shape[-1]), emb_cpu.reshape(-1, emb_cpu.shape[-1])
    cos_deficit = float((1 - F.cosine_similarity(a, b, dim=-1)).max())
    emit({"phase": "hold_sam_encoder", "view": 0, "cpu_seconds": seconds,
          "max_abs_err": float((emb_card - emb_cpu).abs().max()),
          "cos_deficit": cos_deficit})
    check(torch.allclose(emb_card, emb_cpu, **SEG_TOL) and cos_deficit < 1e-3,
          "SAM image embedding on the card vs the CPU")


# ---------------------------------------------------------------------------
# slice 4: the two headline apps, vis_repr and vis_tracking
# ---------------------------------------------------------------------------

OUT = os.path.join("build", "chip_smoke")
# the goldens' app arguments (tools/gen_golden.py:51,57-58)
GOLDEN_VIS_REPR_ARGS = ["--synthetic", "--step", "0.015"]
GOLDEN_VIS_TRACKING_FAST_ARGS = ["--synthetic", "--frames", "2", "--num_kypts", "8",
                                 "--iters", "10"]
# tests/test_golden.py:42-56 (triangles identical) and 115-128
VIS_REPR_ATOL = {"dist": 1e-4, "vertices": 1e-3, "mask": 1e-4, "color": 1e-3,
                 "desc_pca": 1e-3}
VIS_TRACKING_ATOL = {"src_pts": 1e-6, "match_pts": 5e-4, "loss_history": 1e-5}
# The tracking phase's drift check, tests/test_tracking.py:102's 4e-3 on the
# recovered translation of each frame. The synthetic scene's 1,024-d
# descriptors (sines of 25x random projections) vary on a sub-centimetre
# scale, so 100 Adam steps at lr 0.01 end a few mm off the drift: on an H100
# 1.2-2.9 mm, the same in every run; a CPU's other summation order ends
# 1.6-4.8 mm off (PERF.md).
TRACK_DRIFT_ATOL = 4e-3
TRACK_DRIFT = np.array([[0.008, 0.004, 0.0], [-0.005, 0.006, 0.0]])  # vis_tracking.py:104-105
VIS_REPR_STEP = 0.004  # vis_repr.py:45's default


def reset_and_count(fn):
    """``fn()`` with every launch counter set to 0 just before it; returns
    (fn's result, the counts just after)."""
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def max_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) if a.size else 0.0


def held(label: str, got: dict, want: dict, atol: dict) -> dict:
    """Max abs errors of ``got`` against ``want`` for the keys of ``atol``;
    fails unless every shape agrees and every error is within its atol."""
    errs = {}
    for k, tol in atol.items():
        check(np.shape(got[k]) == np.shape(want[k]),
              f"{label} {k}: shape {np.shape(got[k])} != {np.shape(want[k])}")
        errs[k] = max_err(got[k], want[k])
        check(errs[k] <= tol, f"{label} {k}: max abs error {errs[k]} > {tol}")
    return errs


def tracking_outputs(out: str, frames: int) -> dict:
    """vis_tracking's pickles, as tests/test_golden.py reads them."""
    import pickle

    match, losses = [], []
    for t in range(frames):
        with open(os.path.join(out, f"match_pts_{t:06d}.pkl"), "rb") as f:
            match.append(np.stack(pickle.load(f)).astype(np.float32))
        with open(os.path.join(out, f"loss_hist_{t:06d}.pkl"), "rb") as f:
            losses.append(np.asarray(pickle.load(f), np.float32))
    with open(os.path.join(out, "src_feats.pkl"), "rb") as f:
        info = pickle.load(f)
    return {"match_pts": np.stack(match), "loss_history": np.stack(losses),
            "src_pts": np.stack([info[k]["src_pts"] for k in sorted(info)]).astype(np.float32)}


def golden(dev) -> dict:
    """The port's two apps on the card at the goldens' arguments, held to
    tests/golden/*.npz at the goldens' tolerances."""
    from d3fields_tpu_torch.apps import vis_repr, vis_tracking

    out = os.path.join(OUT, "golden")
    dump = os.path.join(out, "vis_repr.npz")
    t0 = time.perf_counter()
    code, counts = reset_and_count(lambda: vis_repr.main(
        GOLDEN_VIS_REPR_ARGS + ["--out", os.path.join(out, "vis_repr"), "--dump_arrays", dump],
        device=dev))
    seconds = time.perf_counter() - t0
    check(code == 0, "vis_repr exited with an error")
    got = dict(np.load(dump))
    want = dict(np.load(os.path.join("tests", "golden", "vis_repr.npz")))
    check(np.array_equal(got["triangles"], want["triangles"]), "vis_repr golden: triangles")
    errs = held("vis_repr golden", got, want, VIS_REPR_ATOL)
    check(counts["fused_weighted_interp"] > 0 and counts["deform_gather"] == 0,
          f"vis_repr golden launch counts {counts}")
    emit({"phase": "golden", "app": "vis_repr", "args": GOLDEN_VIS_REPR_ARGS,
          "max_abs_err": errs, "atol": VIS_REPR_ATOL, "triangles_identical": True,
          "vertices": int(got["vertices"].shape[0]), "launches": counts, "seconds": seconds})

    track = os.path.join(out, "vis_tracking")
    t0 = time.perf_counter()
    code, tcounts = reset_and_count(lambda: vis_tracking.main(
        GOLDEN_VIS_TRACKING_FAST_ARGS + ["--out", track], device=dev))
    seconds = time.perf_counter() - t0
    check(code == 0, "vis_tracking exited with an error")
    want = dict(np.load(os.path.join("tests", "golden", "vis_tracking_fast.npz")))
    errs = held("vis_tracking golden", tracking_outputs(track, 2), want, VIS_TRACKING_ATOL)
    emit({"phase": "golden", "app": "vis_tracking", "args": GOLDEN_VIS_TRACKING_FAST_ARGS,
          "max_abs_err": errs, "atol": VIS_TRACKING_ATOL, "launches": tcounts,
          "seconds": seconds})
    return {k: counts[k] + tcounts[k] for k in counts}


@contextlib.contextmanager
def timed_function(module, name: str, times: dict):
    """Replaces ``module.name`` with a version that appends its host
    milliseconds between synchronisations to ``times[name]``, and puts the
    original back on exit."""
    original = getattr(module, name)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(*args, **kwargs)
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, original)


def vis_repr_run(fusion, obs, queries, thresholds, boundaries, label: str) -> dict:
    """``vis_repr.run`` at ``vis_repr.py``'s default step, with smoothing and
    marching tetrahedra timed apart."""
    from d3fields_tpu_torch.apps import vis_repr
    from d3fields_tpu_torch.mesh import _native, smoothing

    times = {}
    with timed_function(smoothing, "smooth_volume", times), \
            timed_function(_native, "marching_tetrahedra", times):
        res = vis_repr.run(fusion, obs, queries, thresholds, boundaries, VIS_REPR_STEP,
                           os.path.join(OUT, label))
    res["stage_ms"] = {**{k: v * 1e3 for k, v in res["seconds"].items()},
                       "smoothing": sum(times["smooth_volume"]),
                       "marching_tetrahedra": sum(times["marching_tetrahedra"])}
    return res


def vis_repr_arrays(res) -> dict:
    """The golden's arrays from a ``vis_repr.run`` result, on the host."""
    from d3fields_tpu_torch.ops.pca import pca_transform

    vout = res["vertex_query"]
    return {"dist": res["grid"]["dist"].cpu().numpy(), "vertices": res["vertices"],
            "triangles": res["triangles"], "mask": vout["mask"].cpu().numpy(),
            "color": vout["color_tensor"].cpu().numpy(),
            "desc_pca": pca_transform(vout["dino_feats"], res["pca"]).cpu().numpy()}


def vis_repr_full(dev) -> dict:
    """``vis_repr --synthetic --feat_dim 1024 --step 0.004`` on the card:
    stage times, the launch counts of the vertex query, one profiled run,
    and the mesh held to the port's own CPU run at the goldens' tolerances."""
    from d3fields_tpu_torch import Fusion, FusionConfig
    from d3fields_tpu_torch.apps import vis_repr

    obs, queries, thresholds, boundaries, backend = vis_repr.synthetic_inputs(4, 1024)

    def app(device):
        backend.reset()
        fusion = Fusion(num_cam=4, mask_backend=backend, device=device)
        return vis_repr_run(fusion, obs, queries, thresholds, boundaries, f"vis_repr_{device}")

    app(dev)  # warm-up: allocator and cuBLAS
    res, counts = reset_and_count(lambda: app(dev))
    tile = FusionConfig().query_tile
    nv = res["vertices"].shape[0]
    check(counts["fused_weighted_interp"] == -(-nv // tile) and counts["deform_gather"] == 0,
          f"vis_repr launched {counts} for {nv} vertices in tiles of {tile}")
    check(bool(torch.isfinite(res["grid"]["dist"]).all()), "vis_repr grid dist is not finite")
    got = vis_repr_arrays(res)
    t0 = time.perf_counter()
    cpu = vis_repr_arrays(app(torch.device("cpu")))
    cpu_seconds = time.perf_counter() - t0
    check(np.array_equal(got["triangles"], cpu["triangles"]), "vis_repr triangles card vs CPU")
    errs = held("vis_repr card vs CPU", got, cpu, VIS_REPR_ATOL)
    emit({"phase": "vis_repr", "args": ["--synthetic", "--feat_dim", "1024", "--step",
                                        str(VIS_REPR_STEP)],
          "grid_points": int(got["dist"].shape[0]), "vertices": nv,
          "triangles": int(got["triangles"].shape[0]), "labels": res["labels"],
          "stage_ms": res["stage_ms"], "wall_ms": sum(res["seconds"].values()) * 1e3,
          "launches": counts, "card_vs_cpu_max_abs_err": errs, "triangles_identical": True,
          "cpu_seconds": cpu_seconds})
    profile_stage("vis_repr", lambda: app(dev))
    return counts


def vis_repr_backends(dev, backbone, seg_backend) -> dict:
    """``vis_repr.run`` with the real-data backends (random weights): DINOv2
    ViT-L/14 features and GroundingDINO + SAM masks on the synthetic rig's
    colour and depth, the box threshold picked on that rig as segment()
    picks it."""
    from d3fields_tpu_torch import Fusion
    from d3fields_tpu_torch.apps import vis_repr

    obs, _, _, boundaries, _ = vis_repr.synthetic_inputs(4, 1024)
    obs = {k: obs[k] for k in ("color", "depth", "pose", "K")}
    # the facade hands the backend RGB; the obs colour is BGR
    thr, _ = pick_box_threshold(seg_backend.detector,
                                [np.ascontiguousarray(obs["color"][..., ::-1])])
    fusion = Fusion(num_cam=4, feature_backend=backbone, mask_backend=seg_backend, device=dev)

    def app():
        return vis_repr_run(fusion, obs, SEG_QUERIES, [thr], boundaries, "vis_repr_backends")

    res, counts = reset_and_count(app)
    gcfg = seg_backend.detector.model.cfg
    check(counts["fused_weighted_interp"] > 0 and
          counts["deform_gather"] == gcfg.encoder_layers + gcfg.decoder_layers,
          f"vis_repr_backends launch counts {counts}")
    check(bool(torch.isfinite(res["grid"]["dist"]).all()), "vis_repr_backends dist not finite")
    check(res["vertices"].shape[0] > 0 and res["triangles"].shape[0] > 0, "empty mesh")
    check(res["labels"][0] == "background", f"consensus labels {res['labels']}")
    emit({"phase": "vis_repr_backends", "queries": SEG_QUERIES, "box_threshold": thr,
          "boxes_per_view": [len(vm.labels) - 1 for vm in fusion.view_masks],
          "labels": res["labels"], "vertices": int(res["vertices"].shape[0]),
          "stage_ms": res["stage_ms"], "wall_ms": sum(res["seconds"].values()) * 1e3,
          "launches": counts})
    profile_stage("vis_repr_backends", app)
    return counts


def tracking(dev) -> dict:
    """vis_tracking's staged loop at full width: 2 frames of the drifting
    spheres at 240x320 with 1,024-d descriptors, 100 keypoints per instance
    at res 0.003 (a 10.7M-point grid; 0.002, 36M points, before slice 11),
    ``TrackingConfig()`` (100 Adam steps) at every frame, and
    the app's consumer: each frame's ``TrackVis`` mosaic into tracking.avi
    and its match_pts pickle, held afterwards to a ``TrackVis`` recomputed
    from the pickles. ``Fusion.select_features_rand_v2`` on frame 0's state
    is held to the CPU's."""
    from d3fields_tpu_torch import Fusion
    from d3fields_tpu_torch.apps.vis_tracking import SYNTHETIC_BOUNDARIES, synthetic_frame
    from d3fields_tpu_torch.config import TrackingConfig
    from d3fields_tpu_torch.fields.geometry import create_grid
    from d3fields_tpu_torch.track.keypoints import select_keypoints
    from d3fields_tpu_torch.track.rigid import (
        boundary_vectors, rigid_tracking_steps, stack_keypoints)
    from d3fields_tpu_torch.utils.io import save_pickle
    from d3fields_tpu_torch.utils.synthetic import sphere_mask_backend
    from d3fields_tpu_torch.utils.visualization import TrackVis, jet_colors

    labels, frames, res_kp, per_inst = ["shoe", "shoe"], 2, 0.003, 100
    out_dir = os.path.join(OUT, "tracking")
    os.makedirs(out_dir, exist_ok=True)
    scenes = [synthetic_frame(t, 4, 240, 320, 1024) for t in range(frames)]

    def fusion_at(t, device, fus=None):
        backend = sphere_mask_backend(scenes[t], labels)
        fus = fus or Fusion(num_cam=4, mask_backend=backend, device=device)
        fus.mask_backend = backend
        fus.update({k: scenes[t][k] for k in ("color", "depth", "pose", "K", "dino_feats")})
        fus.text_queries_for_inst_mask(["shoe"], [0.5], boundaries=SYNTHETIC_BOUNDARIES)
        return fus

    def select(fus):
        return select_keypoints(fus.state, fus.consensus_mask_label, SYNTHETIC_BOUNDARIES,
                                per_inst, res=res_kp, init_idx=0)

    cfg = TrackingConfig()
    reset_launch_counts()
    fus, rows = None, []
    for t in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fus = fusion_at(t, dev, fus)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        row = {"frame": t, "update_masks_ms": (t1 - t0) * 1e3}
        if t == 0:
            feats, pts, ids = select(fus)
            torch.cuda.synchronize()
            row["select_keypoints_ms"] = (time.perf_counter() - t1) * 1e3
            src_feats, last = stack_keypoints(feats, pts, dev)
            lo, hi = boundary_vectors(SYNTHETIC_BOUNDARIES, dev)
            first = None
            track_info = {f"inst_{i}": {"src_pts_color": (jet_colors(
                np.linspace(0, 1, p.shape[0])) * 255).astype(np.uint8)} for p, i in zip(pts, ids)}
            vis = TrackVis(scenes[0]["pose"], scenes[0]["K"], out_dir)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = rigid_tracking_steps(fus.state, src_feats, last, lo, hi, cfg)
        torch.cuda.synchronize()
        row["tracking_ms"] = (time.perf_counter() - t2) * 1e3
        match = out["match_pts"]
        check(bool(torch.isfinite(match).all() and torch.isfinite(out["loss_history"]).all()),
              f"tracking frame {t}: not finite")
        disp = (match - last).mean(1).cpu().numpy()  # (I, 3): each instance's translation
        true = TRACK_DRIFT if t else np.zeros_like(TRACK_DRIFT)
        if first is None:
            first = match.mean(1).cpu().numpy()
        # vis_tracking's consumer: the video frame and the pickle
        t3 = time.perf_counter()
        pts_list = list(match.cpu().numpy())
        vis.visualize_match_pts(pts_list, scenes[t]["color"], track_info)
        row["trackvis_ms"] = (time.perf_counter() - t3) * 1e3
        save_pickle(os.path.join(out_dir, f"match_pts_{t:06d}.pkl"), pts_list)
        row.update({
            "translation": disp.tolist(), "true_drift": true.tolist(),
            "translation_err": max_err(disp, true), "t_err": max_err(out["t"].cpu(), true),
            "cumulative_err": max_err(match.mean(1).cpu().numpy() - first, t * TRACK_DRIFT),
            "loss_first": out["loss_history"][0].tolist(),
            "loss_last": out["loss_history"][-1].tolist()})
        emit({"phase": "tracking_frame", **row})
        if t:
            check(row["translation_err"] <= TRACK_DRIFT_ATOL,
                  f"tracking frame {t}: translation off the drift by {row['translation_err']}")
        rows.append(row)
        last = match
    counts = launch_counts()
    check(sum(counts.values()) == 0, f"the tracking path launched {counts}")
    vis.close()
    video = check_tracking_video(out_dir, frames, [sc["color"] for sc in scenes],
                                 scenes[0]["pose"], scenes[0]["K"], track_info)

    # frame 0's keypoints against the port's CPU run of the same frame
    t0 = time.perf_counter()
    cpu_fus = fusion_at(0, torch.device("cpu"))
    cpu_feats, cpu_pts, cpu_ids = select(cpu_fus)
    cpu_seconds = time.perf_counter() - t0
    v2 = hold_depth_keypoints(fusion_at(0, dev), cpu_fus, per_inst)
    check(cpu_ids == ids, f"keypoint instances {ids} on the card, {cpu_ids} on the CPU")
    check(all(np.array_equal(a, b) for a, b in zip(pts, cpu_pts)),
          "frame 0's src_pts differ between the card and the CPU")
    feat_err = max(max_err(a, b) for a, b in zip(feats, cpu_feats))
    grid_points = int(create_grid(SYNTHETIC_BOUNDARIES, res_kp)[0].shape[0])
    emit({"phase": "tracking", "frames": frames, "image_hw": [240, 320], "feat_dim": 1024,
          "keypoints_per_instance": per_inst, "instances": ids,
          "keypoint_grid_points": grid_points,
          "keypoint_tiles": -(-grid_points // 32768), "iters": cfg.iters,
          "select_keypoints_ms": rows[0]["select_keypoints_ms"],
          "tracking_ms": [r["tracking_ms"] for r in rows],
          "translation_err": [r["translation_err"] for r in rows],
          "drift_atol": TRACK_DRIFT_ATOL, "src_pts_identical_to_cpu": True,
          "src_feats_card_vs_cpu_max_abs_err": feat_err, "cpu_select_seconds": cpu_seconds,
          "trackvis_ms": [r["trackvis_ms"] for r in rows], "tracking_video": video,
          "select_features_rand_v2": v2, "launches": counts})
    check(feat_err <= 1e-5, f"keypoint descriptors card vs CPU: {feat_err}")
    # one frame's 100 steps, and 64 of the keypoint grid query's tiles, traced
    profile_stage("tracking_frame", lambda: rigid_tracking_steps(
        fus.state, src_feats, last, lo, hi, cfg))
    from d3fields_tpu_torch.fields import fusion as ffusion

    sample = create_grid(SYNTHETIC_BOUNDARIES, res_kp)[0][:64 * 32768]
    profile_stage("select_keypoints_64_tiles",
                  lambda: ffusion.batch_eval(fus.state, sample, ("mask",), tile=32768))
    return counts


def check_tracking_video(out_dir: str, frames: int, colors, pose, K, track_info) -> dict:
    """tracking.avi has one frame per tracked frame, and its first and last
    frames equal a ``TrackVis`` recomputed from the match_pts pickles."""
    from d3fields_tpu_torch.utils.avi import read_avi
    from d3fields_tpu_torch.utils.io import load_pickle
    from d3fields_tpu_torch.utils.visualization import TrackVis

    video = read_avi(os.path.join(out_dir, "tracking.avi"))
    check(video.shape[0] == frames, f"{out_dir}/tracking.avi: {video.shape[0]} frames, "
                                    f"{frames} tracked")
    again = TrackVis(pose, K, os.path.join(out_dir, "recomputed"))
    for t in range(frames):
        mosaic = again.visualize_match_pts(
            load_pickle(os.path.join(out_dir, f"match_pts_{t:06d}.pkl")), colors[t], track_info)
        if t in (0, frames - 1):
            check(np.array_equal(video[t], mosaic),
                  f"{out_dir}/tracking.avi frame {t} differs from TrackVis of its pickle")
    again.close()
    return {"frames": int(video.shape[0]), "mosaic_hw": list(video.shape[1:3]),
            "first_and_last_equal_recomputed": True}


def hold_depth_keypoints(fus, cpu_fus, n_per_instance: int) -> dict:
    """``Fusion.select_features_rand_v2`` on the card against the CPU:
    points identical, descriptors within 1e-5, the bound of the phase's
    grid keypoints (1,024-d descriptors summed over 4 views in float32 in
    another order: 3.6e-6 apart on an H100)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = fus.select_features_rand_v2(None, n_per_instance, per_instance=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    cpu = cpu_fus.select_features_rand_v2(None, n_per_instance, per_instance=True)
    check(card.keys() == cpu.keys() and len(card) > 0,
          f"depth keypoints: instances {sorted(card)} on the card, {sorted(cpu)} on the CPU")
    errs = {}
    for k in card:
        check(np.array_equal(card[k]["src_pts"], cpu[k]["src_pts"]),
              f"depth keypoints {k}: points differ between the card and the CPU")
        a, b = card[k]["src_feats"], cpu[k]["src_feats"]
        errs[k] = max_err(a, b)
        check(errs[k] <= 1e-5, f"depth keypoints {k}: descriptors card vs CPU {errs[k]}")
    return {"instances": sorted(card), "points": {k: list(v["src_pts"].shape)
                                                  for k, v in card.items()},
            "src_feats_card_vs_cpu_max_abs_err": errs, "ms": ms}


# ---------------------------------------------------------------------------
# slice 5: XMem video-mask propagation and the per-frame serving step
# ---------------------------------------------------------------------------

# mem_every 5: working memory fills (10 frames) at frame 45 and, after
# the 5 frames a consolidation keeps, again at frame 70
XMEM_FRAMES = 70
XMEM_HOLD_FRAMES = 6      # frames 0-5 held to the port's CPU run
# tests/test_parallel_train.py:481-486's bound for a rounding-only difference
XMEM_PROB_ATOL, XMEM_MIN_AGREE = 2e-3, 0.995
XMEM_RIG_HW = (240, 320)  # the synthetic rig; XMem runs at 480x640 (size 480)
SERVING_FRAMES = 4
SERVING_KEYPOINT_RES = 0.005  # the keypoint grid's step: 2.3M candidates
# Eager PyTorch runs the fused and the staged frame as the same operations
# in the same order; only a nondeterministic reduction could part them.
SERVING_ATOL = 1e-5


def xmem_model(dev, cfg, seed: int):
    """Full-width XMem with random weights at PyTorch's default scale for
    convolutions and linear layers (U(+-1/sqrt(fan_in)), what the reference's
    untrained modules hold), drawn from a seeded generator, identity batch
    norms, and the prediction head scaled by 10.

    Not ``network.init_params``: its N(0, 2/fan_in) convolutions without
    trained batch-norm statistics grow ResNet-50's features to ~1e3 and the
    shrinkage to ~1.6e6 at 480x640, which turns the top-k attention into a
    hard argmax whose picks flip on rounding (the port's CPU run against the
    JAX package's, same weights: probabilities 2.4e-2 apart). The head's
    scale spreads the untrained logits, which otherwise tie every pixel's
    objects within rounding."""
    from d3fields_tpu_torch.models.xmem.network import XMem

    model = XMem(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                bound = 1.0 / float(np.sqrt(m.weight[0].numel()))
                m.weight.uniform_(-bound, bound, generator=gen)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.reset_parameters()
        model.decoder.pred.weight.mul_(10.0)
    return model.eval()


def sphere_frame(t: int, feat_dim: int = 16) -> dict:
    """Frame t of vis_tracking's drifting spheres on the 4-view rig, with
    the index mask (0 background, 1 and 2 the spheres) under 'index'."""
    from d3fields_tpu_torch.apps.vis_tracking import synthetic_frame

    sc = synthetic_frame(t, 4, *XMEM_RIG_HW, feat_dim)
    sm = sc["sphere_masks"]  # (V, 2, H, W)
    sc["index"] = np.where(sm[:, 0], 1, np.where(sm[:, 1], 2, 0)).astype(np.uint8)
    return sc


def hold_probs(label: str, got, want) -> dict:
    """Probabilities (V, O+1, H, W) of the card against the CPU's: the
    largest error, the label agreement over all pixels, and over the pixels
    whose CPU top-two margin exceeds twice XMEM_PROB_ATOL (elsewhere a
    label is a near-tie that rounding decides)."""
    got, want = np.asarray(got), np.asarray(want)
    err = max_err(got, want)
    top2 = np.sort(want, axis=1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 2 * XMEM_PROB_ATOL
    same = got.argmax(1) == want.argmax(1)
    row = {"max_abs_err": err, "label_agreement": float(same.mean()),
           "label_agreement_off_near_ties": float(same[sure].mean()) if sure.any() else 1.0,
           "near_tie_share": float(1 - sure.mean())}
    check(err <= XMEM_PROB_ATOL, f"{label}: probabilities {err} apart")
    check(row["label_agreement_off_near_ties"] >= XMEM_MIN_AGREE, f"{label}: labels {row}")
    return row


def xmem_phase(dev, frames: int = XMEM_FRAMES) -> dict:
    """``VideoMaskTracker.process`` at full width: 4 views at 240x320 (XMem
    at 480x640, a 30x40 key grid), the two spheres seeded on frame 0 and
    propagated ``frames`` frames with ``XMemConfig()`` (top-k 30, a memory
    frame every 5, working memory 5-10 frames, 128 prototypes, 10,000
    long-term elements). Frames 0-5 held to the port's CPU run; one normal
    and one memory frame profiled."""
    from d3fields_tpu_torch.config import XMemConfig
    from d3fields_tpu_torch.models.xmem.network import XMem
    from d3fields_tpu_torch.seg.video_tracker import VideoMaskTracker

    cfg = XMemConfig()
    model = xmem_model(dev, cfg, seed=5)
    tracker = VideoMaskTracker(model, cfg, 4, 2, XMEM_RIG_HW, size=cfg.size, device=dev)
    core = tracker.core
    scenes = [sphere_frame(t) for t in range(frames + 2 * cfg.mem_every + 4)]
    rgb = [np.ascontiguousarray(sc["color"][..., ::-1]) for sc in scenes]

    def allocator_counts() -> dict:
        """The caching allocator's device mallocs and frees, and its retries
        (a failed malloc that frees the cache and waits for the card): with
        the garbage collector's time, what a slow frame is checked for."""
        if dev.type != "cuda":
            return {}
        st = torch.cuda.memory_stats(dev)
        return {k: st.get(k, 0) for k in ("segment.all.allocated", "segment.all.freed",
                                          "num_alloc_retries")}

    gc_ms = [0.0, 0.0]  # the frame's time in Python's garbage collector; a start time

    def gc_timer(event, _info):
        if event == "start":
            gc_ms[1] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_ms[1]) * 1e3

    def run(t):
        torch.cuda.synchronize()
        before = allocator_counts()
        gc_ms[0] = 0.0
        t0 = time.perf_counter()
        onehot = tracker.process(rgb[t], scenes[0]["index"] if t == 0 else None)
        ms = (time.perf_counter() - t0) * 1e3
        check(onehot.shape == (4,) + XMEM_RIG_HW + (3,) and np.isfinite(onehot).all(),
              f"xmem frame {t}: one-hot")
        after = allocator_counts()
        return ms, {**{k: after[k] - before[k] for k in after}, "gc_ms": gc_ms[0]}

    rows, card_probs = [], []

    def body():
        for t in range(frames + 1):
            ms, alloc = run(t)
            if t < XMEM_HOLD_FRAMES:
                card_probs.append(tracker.last_prob.cpu().numpy())
            rows.append({"frame": t, "ms": ms, "memory_frame": core.last_mem_ti == t,
                         "w_size": core.mem.w_size, "l_size": core.mem.l_size,
                         "allocator": alloc})

    gc.callbacks.append(gc_timer)
    try:
        _, counts = reset_and_count(body)
    finally:
        gc.callbacks.remove(gc_timer)
    check(sum(counts.values()) == 0, f"the xmem path launched {counts}")
    prob = tracker.last_prob
    check(bool(torch.isfinite(prob).all()), "xmem probabilities are not finite")
    check(torch.allclose(prob.sum(1), torch.ones_like(prob[:, 0]), atol=1e-4),
          "xmem probabilities do not sum to 1")
    consolidated = [r["frame"] for r, q in zip(rows[1:], rows) if r["l_size"] > q["l_size"]]
    check(len(consolidated) >= 1, "no consolidation in the xmem run")

    t0 = time.perf_counter()
    cpu_model = XMem(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu = VideoMaskTracker(cpu_model, cfg, 4, 2, XMEM_RIG_HW, size=cfg.size, device="cpu")
    holds = []
    for t in range(XMEM_HOLD_FRAMES):
        cpu.process(rgb[t], scenes[0]["index"] if t == 0 else None)
        holds.append({"frame": t, **hold_probs(f"xmem frame {t} card vs CPU",
                                               card_probs[t], cpu.last_prob.numpy())})
    cpu_seconds = time.perf_counter() - t0

    normal = [r["ms"] for r in rows[1:] if not r["memory_frame"]]
    memory = [r["ms"] for r in rows[1:] if r["memory_frame"]]
    emit({"phase": "xmem", "views": 4, "image_hw": list(XMEM_RIG_HW),
          "xmem_hw": list(tracker.resized_hw), "key_grid": list(core.mem.hidden.shape[-2:]),
          "frames": frames,
          "config": dataclasses.asdict(cfg), "seed_ms": rows[0]["ms"],
          "normal_frame_ms_median": float(np.median(normal)),
          "memory_frame_ms_median": float(np.median(memory)),
          "normal_frame_ms": normal, "memory_frame_ms": memory,
          "memory_frames": [r["frame"] for r in rows if r["memory_frame"]],
          "consolidation_frames": consolidated,
          "consolidation_frame_ms": [rows[t]["ms"] for t in consolidated],
          "w_size": [r["w_size"] for r in rows], "l_size": [r["l_size"] for r in rows],
          # the frames on which the allocator went to the device or Python
          # collected garbage
          "allocator_frames": [{"frame": r["frame"], "ms": r["ms"], **r["allocator"]}
                               for r in rows if any(r["allocator"].values())],
          "card_vs_cpu": holds, "cpu_seconds": cpu_seconds,
          "prob_atol": XMEM_PROB_ATOL, "min_label_agreement": XMEM_MIN_AGREE,
          "launches": counts})
    # profile_stage runs a warm-up frame, then the traced one: step on until
    # the traced frame is of the kind wanted
    def next_frame():
        tracker.process(rgb[core.curr_ti + 1])

    def traced_frame_is_memory():
        ti, last = core.curr_ti, core.last_mem_ti
        if ti + 1 - last >= cfg.mem_every:
            last = ti + 1
        return ti + 2 - last >= cfg.mem_every

    for stage, memory in (("xmem_normal_frame", False), ("xmem_memory_frame", True)):
        while traced_frame_is_memory() != memory:
            next_frame()
        profile_stage(stage, next_frame)
        check((core.last_mem_ti == core.curr_ti) == memory, f"{stage}: the wrong kind of frame")
    return counts


def serving_step(dev, frames: int = SERVING_FRAMES, compute_dtype: str = "float32") -> dict:
    """The per-frame serving step at full width on the drifting spheres:
    DINOv2 ViT-L/14 (``resize_mode='device'``) -> XMem propagation (the
    tracker of ``xmem_phase``, built by the facade's
    ``video_tracker_factory``) -> the field -> ``rigid_tracking_steps`` with
    ``TrackingConfig()`` (100 Adam steps). Frame 0 runs consensus and seeds
    the tracker; frames 1-4 run the staged way (``update`` ->
    ``text_queries_for_inst_mask`` -> ``rigid_tracking_steps``), then
    through ``FusedFrameStep.step`` on a second tracker seeded alike, then
    through ``step_segment`` on a third; the three held together.
    ``compute_dtype`` is DINOv2's and XMem's (the ``bf16`` phase runs
    'bfloat16')."""
    import warnings

    from d3fields_tpu_torch import Fusion
    from d3fields_tpu_torch.apps.vis_tracking import SYNTHETIC_BOUNDARIES
    from d3fields_tpu_torch.config import TrackingConfig, XMemConfig
    from d3fields_tpu_torch.models import dinov2
    from d3fields_tpu_torch.seg.video_tracker import VideoMaskTracker
    from d3fields_tpu_torch.serving import FusedFrameStep, prefetch_to_device
    from d3fields_tpu_torch.track.keypoints import select_keypoints
    from d3fields_tpu_torch.track.rigid import (
        boundary_vectors, rigid_tracking_steps, stack_keypoints)
    from d3fields_tpu_torch.utils.synthetic import sphere_mask_backend

    t0 = time.perf_counter()
    backbone = dinov2.Dinov2Backbone(
        dinov2.init_params(dinov2.Dinov2Config.vit_large(),
                           torch.Generator(device=dev).manual_seed(0), device=dev),
        compute_dtype=compute_dtype, resize_mode="device", device=dev)
    xcfg = XMemConfig(compute_dtype=compute_dtype)
    xmodel = xmem_model(dev, xcfg, seed=5)

    def factory(num_views, num_objects, image_hw):
        return VideoMaskTracker(xmodel, xcfg, num_views, num_objects, image_hw,
                                size=xcfg.size, device=dev)

    scenes = [sphere_frame(t) for t in range(frames + 3)]
    obs = [{k: sc[k] for k in ("color", "depth", "pose", "K")} for sc in scenes]
    fus = Fusion(num_cam=4, feature_backend=backbone,
                 mask_backend=sphere_mask_backend(scenes[0], ["shoe", "shoe"]),
                 video_tracker_factory=factory, device=dev)
    tcfg = TrackingConfig()
    fus.update(obs[0])
    index0, labels = fus.text_queries_for_inst_mask(["shoe"], [0.5],
                                                    boundaries=SYNTHETIC_BOUNDARIES)
    check(labels == ["background", "shoe", "shoe"], f"consensus labels {labels}")
    feats, pts, _ = select_keypoints(fus.state, labels, SYNTHETIC_BOUNDARIES, 100,
                                     res=SERVING_KEYPOINT_RES, init_idx=0)
    src_feats, last0 = stack_keypoints(feats, pts, dev)
    lo, hi = boundary_vectors(SYNTHETIC_BOUNDARIES, dev)
    torch.cuda.synchronize()
    emit({"phase": "serving_setup", "compute_dtype": compute_dtype,
          "backbone": "dinov2_vit_large_random",
          "xmem": "xmem_full_width_random", "views": 4, "image_hw": list(XMEM_RIG_HW),
          "keypoints": list(last0.shape), "keypoint_res": SERVING_KEYPOINT_RES,
          "seconds": time.perf_counter() - t0})

    def seeded_step():
        tr = factory(4, 2, XMEM_RIG_HW)
        tr.process(np.ascontiguousarray(scenes[0]["color"][..., ::-1]), index0.astype(np.uint8))
        return FusedFrameStep(backbone, tr, obs[0]["depth"], obs[0]["pose"], obs[0]["K"],
                              lo, hi, tcfg, xmem_bgr_to_rgb=True, mu=fus.config.fusion.mu)

    def timed(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t1) * 1e3

    def staged():
        rows, outs, last = [], [], last0
        for t in range(1, frames + 1):
            _, update_ms = timed(lambda: fus.update(obs[t]))
            _, masks_ms = timed(lambda: fus.text_queries_for_inst_mask(
                ["shoe"], [0.5], boundaries=SYNTHETIC_BOUNDARIES))
            out, track_ms = timed(lambda: rigid_tracking_steps(fus.state, src_feats, last,
                                                               lo, hi, tcfg))
            out["mask"] = fus.video_tracker.last_prob[:, 1:].permute(0, 2, 3, 1)
            last = out["match_pts"]
            outs.append(out)
            rows.append({"update_ms": update_ms, "masks_ms": masks_ms, "tracking_ms": track_ms,
                         "frame_ms": update_ms + masks_ms + track_ms})
        return outs, rows

    (staged_outs, staged_rows), counts = reset_and_count(staged)
    # the fused run takes frames already on the card, so that a step
    # makes no host sync; set_sync_debug_mode counts any it makes
    dev_frames = list(prefetch_to_device(
        ({"color": sc["color"], "depth": sc["depth"]} for sc in scenes), device=dev))
    torch.cuda.synchronize()

    def host_syncs(fn):
        """fn()'s result and where each host sync it made was called from
        (torch.cuda.set_sync_debug_mode; setting the mode warns once that it
        is experimental, which is not a sync)."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return out, [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                     if "called a synchronizing CUDA operation" in str(w.message)]

    # the detector sees a sync where there is one (on the card; a CPU
    # rehearsal has none to see)
    check(dev.type != "cuda" or
          len(host_syncs(lambda: float(torch.ones(1, device=dev).sum()))[1]) == 1,
          "set_sync_debug_mode did not report a tensor read by the host")

    def fused_run():
        step = seeded_step()
        outs, ms, syncs, last = [], [], [], last0
        for t in range(1, frames + 1):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out, where = host_syncs(lambda: step.step(
                dev_frames[t]["color"], src_feats, last, depth=dev_frames[t]["depth"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            syncs.append(where)
            last = out["match_pts"]
            outs.append(out)
        return outs, ms, syncs, step

    (fused_outs, fused_ms, syncs, step), fcounts = reset_and_count(fused_run)
    errs = []
    for t, (a, b) in enumerate(zip(fused_outs, staged_outs), start=1):
        row = {k: float((a[k] - b[k]).abs().max()) for k in
               ("match_pts", "t", "log_r", "loss_history", "mask")}
        errs.append({"frame": t, **row})
        for k in ("match_pts", "t", "log_r", "loss_history", "mask"):
            check(bool(torch.isfinite(a[k]).all()), f"fused frame {t}: {k} not finite")
            check(row[k] <= SERVING_ATOL, f"fused vs staged frame {t}: {k} {row[k]}")
    check(not any(syncs), f"the fused steps synchronised with the host at {syncs}")
    seg_step = seeded_step()
    frames_u8 = torch.stack([dev_frames[t]["color"] for t in range(1, frames + 1)])
    depths = torch.stack([dev_frames[t]["depth"] for t in range(1, frames + 1)])
    (seg_out, seg_ms), scounts = reset_and_count(
        lambda: timed(lambda: seg_step.step_segment(frames_u8, src_feats, last0, depths)))
    seg_errs = []
    for t, a in enumerate(fused_outs):
        row = {k: float((seg_out[k][t] - a[k]).abs().max()) for k in a}
        seg_errs.append({"frame": t + 1, **row})
        check(max(row.values()) <= SERVING_ATOL, f"step_segment vs step frame {t + 1}: {row}")
    check((seg_step.tracker.core.curr_ti, seg_step.tracker.core.last_mem_ti)
          == (step.tracker.core.curr_ti, step.tracker.core.last_mem_ti)
          == (fus.video_tracker.core.curr_ti, fus.video_tracker.core.last_mem_ti),
          "the trackers' counters differ")
    # DINOv2's attention, one launch a layer of each backbone call; nothing else
    layers = backbone.cfg.num_layers
    for c in (counts, fcounts, scounts):
        dino = c["vit_attention"]
        check(dino > 0 and dino % layers == 0 and sum(c.values()) == dino + c["vit_attention_bf16"],
              f"the serving step launched {c}")
    emit({"phase": "serving_step", "compute_dtype": compute_dtype, "frames": frames,
          "iters": tcfg.iters,
          "staged": staged_rows, "fused_frame_ms": fused_ms,
          "step_segment_ms": seg_ms, "step_segment_ms_per_frame": seg_ms / frames,
          "fused_vs_staged_max_abs_err": errs, "step_segment_vs_step_max_abs_err": seg_errs,
          "atol": SERVING_ATOL, "host_syncs_in_fused_steps": syncs,
          "drift_of_the_spheres": TRACK_DRIFT.tolist(),
          "translation": [(o["match_pts"] - p).mean(1).tolist() for o, p in zip(
              fused_outs, [last0] + [o["match_pts"] for o in fused_outs[:-1]])],
          "launches": counts})
    last = fused_outs[-1]["match_pts"]
    nxt = [frames]

    def one_fused_frame():
        nxt[0] += 1
        step.step(dev_frames[nxt[0]]["color"], src_feats, last, depth=dev_frames[nxt[0]]["depth"])

    profile_stage("serving_fused_frame" + ("" if compute_dtype == "float32" else "_bf16"),
                  one_fused_frame)
    return counts, {"fused_frame_ms": fused_ms,
                    "staged_frame_ms": [r["frame_ms"] for r in staged_rows]}


# ---------------------------------------------------------------------------
# slice 6: the recorded-scene path (checkpoint files -> the apps)
# ---------------------------------------------------------------------------

RECORDED_FRAMES = 4  # the fewest that drive both a segment of 2 and a lone step
SCENE_DIR = os.path.join(OUT, "scene")
CKPT_DIR = os.path.join(OUT, "ckpts")
# vis_repr --synthetic's workspace (vis_repr.synthetic_inputs)
REPR_BOUNDS = ["--x_lower", "-0.3", "--x_upper", "0.5", "--y_lower", "-0.3", "--y_upper", "0.35",
               "--z_lower", "0.001", "--z_upper", "0.3"]
# the two spheres over 6 frames' drift: 3.9M keypoint candidates at
# select_keypoints' 2 mm, not SYNTHETIC_BOUNDARIES' 36M (10-17 s a run)
TRACK_BOUNDS = ["--x_lower", "-0.16", "--x_upper", "0.3", "--y_lower", "-0.16", "--y_upper", "0.2",
                "--z_lower", "0.001", "--z_upper", "0.2",
                "--kypts_z_lower", "0.001", "--kypts_z_upper", "0.2"]


def write_vocab(path: str) -> None:
    """A BERT vocab.txt (special tokens at BERT's ids) that holds the words
    of SEG_QUERIES at the ids the toy tokenizer gives them, so that the
    wordpiece tokenizer of the checkpoint-built detector feeds the random
    model the ids the segmentation phase fed it."""
    ids = {w: tokenize(w)[0] for q in SEG_QUERIES for w in q.split()}
    lines = [f"[unused{i}]" for i in range(1013)]
    for i, tok in ((0, "[PAD]"), (100, "[UNK]"), (101, "[CLS]"), (102, "[SEP]"),
                   (103, "[MASK]"), (1012, ".")):
        lines[i] = tok
    for w, i in ids.items():
        check(lines[i].startswith("[unused"), f"vocab id {i} of {w!r} is taken")
        lines[i] = w
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def recorded_scene(dev, serving_ms: dict) -> dict:
    """Both apps on a recorded scene with backends built from checkpoint
    files. The 4-view 240x320 drifting spheres, RECORDED_FRAMES frames, are written as
    PNG files and .npy cameras under build/chip_smoke/scene; full-width
    random checkpoints in the reference layouts (torch-hub DINOv2 ViT-L/14,
    huggingface GroundingDINO swin-T and SAM ViT-H, XMem.pth at
    ``XMemConfig()``) and a vocab under build/chip_smoke/ckpts, deleted at
    the end. ``vis_repr --data_path`` is held bit for bit to ``vis_repr.run``
    with the in-memory models on the same ``load_frame`` observation;
    ``vis_tracking --data_path --fused --segment 2`` to the staged loop over
    the same frames at SERVING_ATOL. The tracking runs take the analytic
    sphere masks through ``_backends.build_mask_backend``: random
    GroundingDINO weights give no stable instances to track."""
    import shutil

    from d3fields_tpu_torch.apps import _backends
    from d3fields_tpu_torch.config import XMemConfig
    from d3fields_tpu_torch.models import dinov2
    from d3fields_tpu_torch.utils import io

    t0 = time.perf_counter()
    scenes = [sphere_frame(t) for t in range(RECORDED_FRAMES)]
    for t, sc in enumerate(scenes):
        io.save_frame(SCENE_DIR, t, sc)
    scene_seconds = time.perf_counter() - t0

    os.makedirs(CKPT_DIR, exist_ok=True)
    dmodel = dinov2.init_params(dinov2.Dinov2Config.vit_large(),
                                torch.Generator(device=dev).manual_seed(0), device=dev)
    gmodel, smodel = segment_models(dev)
    xmodel = xmem_model(dev, XMemConfig(), seed=5)
    hub = dict(dmodel.state_dict(), mask_token=torch.zeros(1, dmodel.cfg.hidden_size))
    env, write_s, sizes = {}, {}, {}
    for var, sd, name in (("D3F_DINOV2_CKPT", hub, "dinov2_vitl14.pth"),
                          ("D3F_GDINO_CKPT", gmodel.state_dict(), "groundingdino_swint.pth"),
                          ("D3F_SAM_CKPT", smodel.state_dict(), "sam_vit_h.pth"),
                          ("D3F_XMEM_CKPT", xmodel.state_dict(), "XMem.pth")):
        env[var] = os.path.join(CKPT_DIR, name)
        t0 = time.perf_counter()
        torch.save({k: v.cpu() for k, v in sd.items()}, env[var])
        write_s[name] = time.perf_counter() - t0
        sizes[name] = os.path.getsize(env[var])
    env["D3F_BERT_VOCAB"] = os.path.join(CKPT_DIR, "vocab.txt")
    write_vocab(env["D3F_BERT_VOCAB"])

    times = {}
    try:
        with mock.patch.dict(os.environ, env), \
                timed_function(io, "load_frame", times), \
                timed_function(_backends, "build_feature_backend", times), \
                timed_function(_backends, "build_mask_backend", times), \
                timed_function(_backends, "build_video_tracker_factory", times):
            repr_row, repr_counts = recorded_vis_repr(dev, dmodel, gmodel, smodel, env)
            track_row, track_counts = recorded_tracking(dev)
            pca_row, pca_counts = recorded_precompute_pca(dev)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    counts = {k: repr_counts[k] + track_counts[k] + pca_counts[k] for k in repr_counts}
    emit({"phase": "recorded_scene", "views": 4, "image_hw": list(XMEM_RIG_HW),
          "frames": RECORDED_FRAMES, "write_scene_seconds": scene_seconds,
          "checkpoint_bytes": sizes, "checkpoint_write_seconds": write_s,
          "checkpoint_load_seconds": {k: [ms / 1e3 for ms in v] for k, v in times.items()
                                      if k.startswith("build_")},
          "load_frame_ms": times["load_frame"], "vis_repr": repr_row, "tracking": track_row,
          "precompute_pca": pca_row,
          "serving_step_fused_frame_ms": serving_ms["fused_frame_ms"],
          "serving_step_staged_frame_ms": serving_ms["staged_frame_ms"],
          "mask_backend_of_tracking": "analytic sphere masks through "
                                      "_backends.build_mask_backend: random GroundingDINO "
                                      "weights give no stable instances to track",
          "launches": counts})
    return counts


def recorded_vis_repr(dev, dmodel, gmodel, smodel, env):
    """``vis_repr.main --data_path`` through ``_backends``, counted, then
    ``vis_repr.run`` with the in-memory models, held bit for bit."""
    from d3fields_tpu_torch import Fusion
    from d3fields_tpu_torch.apps import _backends, vis_repr
    from d3fields_tpu_torch.config import Boundaries
    from d3fields_tpu_torch.models import dinov2
    from d3fields_tpu_torch.models.groundingdino.detector import GroundingDinoDetector
    from d3fields_tpu_torch.models.sam.predictor import SamPredictor
    from d3fields_tpu_torch.seg.grounded_sam import GroundedSAMBackend
    from d3fields_tpu_torch.utils import io

    obs = io.load_frame(SCENE_DIR, 0, 4)
    detector = GroundingDinoDetector(
        gmodel, _backends._wordpiece_tokenizer(env["D3F_BERT_VOCAB"]), device=dev)
    # the facade hands the backend RGB; the obs colour is BGR
    thr, _ = pick_box_threshold(detector, [np.ascontiguousarray(obs["color"][..., ::-1])])
    dump = os.path.join(OUT, "recorded_vis_repr.npz")
    argv = ["--data_path", SCENE_DIR, "--t", "0", "--query_texts", *SEG_QUERIES,
            "--query_thresholds", repr(thr), "--step", str(VIS_REPR_STEP), *REPR_BOUNDS,
            "--out", os.path.join(OUT, "recorded_vis_repr"), "--dump_arrays", dump]
    t0 = time.perf_counter()
    code, counts = reset_and_count(lambda: vis_repr.main(argv, device=dev))
    seconds = time.perf_counter() - t0
    check(code == 0, "vis_repr --data_path exited with an error")
    gcfg = gmodel.cfg
    check(counts["deform_gather"] == gcfg.encoder_layers + gcfg.decoder_layers
          and counts["fused_weighted_interp"] > 0, f"vis_repr --data_path launch counts {counts}")
    got = dict(np.load(dump))
    boundaries = Boundaries(*(float(v) for v in REPR_BOUNDS[1::2]))
    # the backend builds DINOv2 in bf16, as the JAX app does
    fusion = Fusion(num_cam=4, feature_backend=dinov2.Dinov2Backbone(
                        dmodel, compute_dtype="bfloat16", device=dev),
                    mask_backend=GroundedSAMBackend(detector, SamPredictor(smodel, device=dev)),
                    device=dev)
    res = vis_repr_run(fusion, obs, SEG_QUERIES, [thr], boundaries, "recorded_vis_repr_memory")
    want = vis_repr_arrays(res)
    identical = {k: bool(np.array_equal(got[k], want[k])) for k in want}
    errs = {k: max_err(got[k], want[k]) if got[k].shape == want[k].shape else None for k in want}
    check(all(identical.values()), f"vis_repr from files vs in memory: {errs}")
    check(res["vertices"].shape[0] > 0, "empty mesh")
    return {"box_threshold": thr, "labels": res["labels"],
            "boxes_per_view": [len(vm.labels) - 1 for vm in fusion.view_masks],
            "vertices": int(res["vertices"].shape[0]), "grid_points": int(got["dist"].shape[0]),
            "main_seconds": seconds, "in_memory_stage_ms": res["stage_ms"],
            "bit_identical_to_in_memory": identical, "launches": counts}, counts


def recorded_tracking(dev):
    """``vis_tracking --data_path`` staged and ``--fused --segment 2`` over
    the RECORDED_FRAMES frames, DINOv2 and XMem from the files, held at
    SERVING_ATOL."""
    from d3fields_tpu_torch import Fusion, serving
    from d3fields_tpu_torch.apps import _backends, vis_tracking
    from d3fields_tpu_torch.models import dinov2
    from d3fields_tpu_torch.track import rigid
    from d3fields_tpu_torch.utils import io, visualization
    from d3fields_tpu_torch.utils.synthetic import sphere_mask_backend

    build = _backends.build_feature_backend
    scene0 = sphere_frame(0)

    def device_resize(*args, **kwargs):
        # the resize FusedFrameStep runs, so that the staged loop computes
        # what the fused frames do
        fb = build(*args, **kwargs)
        return dinov2.Dinov2Backbone(fb.model, compute_dtype=fb.compute_dtype,
                                     resize_mode="device", device=fb.device)

    argv = ["--data_path", SCENE_DIR, "--frames", str(RECORDED_FRAMES), "--query_texts", "shoe",
            "--query_thresholds", "0.5", *TRACK_BOUNDS]
    staged_dir, fused_dir = os.path.join(OUT, "recorded_staged"), os.path.join(OUT, "recorded_fused")
    staged_t, fused_t, vis_t = {}, {}, {}
    with mock.patch.object(_backends, "build_mask_backend",
                           lambda *a, **k: sphere_mask_backend(scene0, ["shoe", "shoe"])), \
            mock.patch.object(_backends, "build_feature_backend", device_resize), \
            timed_function(visualization.TrackVis, "visualize_match_pts", vis_t):
        with timed_function(Fusion, "update", staged_t), \
                timed_function(Fusion, "text_queries_for_inst_mask", staged_t), \
                timed_function(rigid, "rigid_tracking_steps", staged_t):
            t0 = time.perf_counter()
            code, counts = reset_and_count(lambda: vis_tracking.main(
                argv + ["--out", staged_dir], device=dev))
            staged_s = time.perf_counter() - t0
        check(code == 0, "vis_tracking --data_path exited with an error")
        with timed_function(serving.FusedFrameStep, "step", fused_t), \
                timed_function(serving.FusedFrameStep, "step_segment", fused_t):
            t0 = time.perf_counter()
            code, fcounts = reset_and_count(lambda: vis_tracking.main(
                argv + ["--fused", "--segment", "2", "--out", fused_dir], device=dev))
            fused_s = time.perf_counter() - t0
        check(code == 0, "vis_tracking --data_path --fused --segment 2 exited with an error")
    tracked = RECORDED_FRAMES - 1
    check(len(fused_t["step_segment"]) == tracked // 2 and len(fused_t["step"]) == tracked % 2,
          f"fused frames {fused_t}: want {tracked // 2} 2-frame segments and a 1-frame tail")
    staged, fused = tracking_outputs(staged_dir, RECORDED_FRAMES), \
        tracking_outputs(fused_dir, RECORDED_FRAMES)
    obs = [io.load_frame(SCENE_DIR, t, 4) for t in range(RECORDED_FRAMES)]
    videos = {}
    for name, d in (("staged", staged_dir), ("fused", fused_dir)):
        info = io.load_pickle(os.path.join(d, "src_feats.pkl"))
        videos[name] = check_tracking_video(d, RECORDED_FRAMES, [o["color"] for o in obs],
                                            obs[0]["pose"], obs[0]["K"], info)
    for k in staged:
        check(np.isfinite(staged[k]).all(), f"staged {k} is not finite")
    errs = held("recorded fused vs staged", fused, staged, dict.fromkeys(staged, SERVING_ATOL))
    staged_frame_ms = [sum(staged_t[k][t] for k in staged_t) for t in range(1, RECORDED_FRAMES)]
    fused_frame_ms = [ms / 2 for ms in fused_t["step_segment"] for _ in range(2)] + fused_t["step"]
    drift = np.diff(staged["match_pts"].mean(2), axis=0)  # (frames - 1, I, 3)
    return {"keypoints": list(staged["src_pts"].shape), "staged_frame_ms": staged_frame_ms,
            "staged_stage_ms": staged_t, "fused_frame_ms": fused_frame_ms,
            "step_segment_ms": fused_t["step_segment"], "step_ms": fused_t["step"],
            "staged_main_seconds": staged_s, "fused_main_seconds": fused_s,
            "fused_vs_staged_max_abs_err": errs, "atol": SERVING_ATOL,
            "trackvis_ms": vis_t["visualize_match_pts"], "tracking_videos": videos,
            "translation_per_frame": drift.tolist(),
            "launches": {"staged": counts, "fused": fcounts}}, \
        {k: counts[k] + fcounts[k] for k in counts}


def recorded_precompute_pca(dev):
    """``precompute_pca --images`` on 4 of the recorded colour PNGs at
    ``--patch_h/w 75`` with the written DINOv2 checkpoint: the components
    finite and orthonormal within 1e-5."""
    from d3fields_tpu_torch.apps import precompute_pca
    from d3fields_tpu_torch.ops.pca import PCAParams

    images = [os.path.join(SCENE_DIR, f"camera_{v}", "color", "0.png") for v in range(4)]
    out = os.path.join(OUT, "pca.pkl")
    t0 = time.perf_counter()
    code, counts = reset_and_count(lambda: precompute_pca.main(
        ["--images", *images, "--patch_h", "75", "--patch_w", "75", "--out", out], device=dev))
    seconds = time.perf_counter() - t0
    check(code == 0, "precompute_pca --images exited with an error")
    params = PCAParams.load(out)
    comps = params.components.astype(np.float64)
    ortho = max_err(comps @ comps.T, np.eye(3))
    check(comps.shape == (3, params.mean.shape[0]) and np.isfinite(comps).all()
          and np.isfinite(params.mean).all()
          and ortho <= 1e-5, f"precompute_pca components {comps.shape}, orthonormal to {ortho}")
    return {"images": len(images), "patch_hw": [75, 75], "seconds": seconds,
            "components": list(comps.shape), "orthonormal_max_err": ortho,
            "launches": counts}, counts


# ---------------------------------------------------------------------------
# slice 7: XMem evaluation (eval_xmem, merge_scores) at DAVIS 480p
# ---------------------------------------------------------------------------

EVAL_DIR = os.path.join(OUT, "eval_xmem")
EVAL_HW = (480, 854)   # DAVIS 480p
EVAL_FRAMES = 24
EVAL_HOLD_FRAMES = 3   # video 1's first propagated frames held to the CPU
EVAL_ENTRY = 3         # video 3's object 2 is first annotated on this frame


EVAL_DRIFTS = {"vid_1": np.array([[0.008, 0.004, 0.0], [-0.005, 0.006, 0.0]]),
               "vid_2": np.array([[-0.006, 0.003, 0.0], [0.004, -0.005, 0.0]])}


def eval_frame(drift: np.ndarray, t: int) -> dict:
    """Frame t of a drifting-sphere video at EVAL_HW, one view."""
    from d3fields_tpu_torch.utils.synthetic import render_sphere_scene

    return render_sphere_scene(num_views=1, H=EVAL_HW[0], W=EVAL_HW[1], feat_dim=4,
                               focal=520.0, sphere_offsets=drift * t)


def write_eval_videos(root: str) -> dict:
    """Three 480x854 drifting-sphere videos of EVAL_FRAMES PNG frames in the
    generic ``<video>/{frames,masks}`` layout, densely annotated with
    paletted index masks: vid_1 and vid_2 (two drifts) carry both spheres
    from frame 0; vid_3 is vid_1's frames with sphere 2 annotated from
    frame EVAL_ENTRY (the multi-group path). An ImageSets split holds vid_1
    alone, for the CPU run."""
    from d3fields_tpu_torch.utils.png import save_png
    from d3fields_tpu_torch.utils.visualization import save_index_mask_png

    for t in range(EVAL_FRAMES):
        for vid, drift in EVAL_DRIFTS.items():
            sc = eval_frame(drift, t)
            sm = sc["sphere_masks"][0]
            index = np.where(sm[0], 1, np.where(sm[1], 2, 0)).astype(np.uint8)
            videos = [(vid, index)]
            if vid == "vid_1":
                videos.append(("vid_3", np.where(index == 2, 2 if t >= EVAL_ENTRY else 0,
                                                 index).astype(np.uint8)))
            for name, mask in videos:
                for sub in ("frames", "masks"):
                    os.makedirs(os.path.join(root, name, sub), exist_ok=True)
                save_png(os.path.join(root, name, "frames", f"{t:05d}.png"), sc["color"][0],
                         filter_type=0)
                save_index_mask_png(os.path.join(root, name, "masks", f"{t:05d}.png"), mask)
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    with open(os.path.join(root, "ImageSets", "hold.txt"), "w") as f:
        f.write("vid_1\n")
    return {"videos": ["vid_1", "vid_2", "vid_3"], "frames": EVAL_FRAMES,
            "image_hw": list(EVAL_HW), "object_2_enters_vid_3_at": EVAL_ENTRY}


def eval_scores(out: str, vid: str, t: int) -> np.ndarray:
    """A saved --save_scores frame as (1, O+1, H, W) float32."""
    return np.load(os.path.join(out, vid, f"{t:05d}.npy")).astype(np.float32).transpose(
        2, 0, 1)[None]


def eval_xmem(dev) -> dict:
    """``apps/eval_xmem.py`` at full width (``XMemConfig()``, the ``xmem``
    phase's seeded weights written as XMem.pth and read through
    ``--ckpt``) on three 480x854 videos of 24 frames, at ``--size 480``:
    sequential, ``--video_batch 2`` and ``--flip``, all with
    ``--save_scores``; then ``merge_scores`` of the plain and the flipped
    scores. Held: vid_1's first propagated frames to the port's CPU run and
    the batched scores to the sequential ones (XMEM_PROB_ATOL,
    XMEM_MIN_AGREE; the scores are float16 files); J, F and JF in [0, 1];
    the merged masks' shape and labels."""
    import shutil

    from d3fields_tpu_torch.apps import eval_xmem as app
    from d3fields_tpu_torch.apps import merge_scores
    from d3fields_tpu_torch.config import XMemConfig
    from d3fields_tpu_torch.utils.png import read_png

    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    data = os.path.join(EVAL_DIR, "data")
    t0 = time.perf_counter()
    layout = write_eval_videos(data)
    write_seconds = time.perf_counter() - t0
    ckpt = os.path.join(EVAL_DIR, "XMem.pth")
    cfg = XMemConfig()
    torch.save({k: v.cpu() for k, v in xmem_model(dev, cfg, seed=5).state_dict().items()}, ckpt)
    base = ["--data_root", data, "--frames", "0", "--size", "480", "--ckpt", ckpt,
            "--key_dim", str(cfg.key_dim), "--value_dim", str(cfg.value_dim),
            "--hidden_dim", str(cfg.hidden_dim), "--save_scores"]
    runs, counts = {}, {}
    try:
        for name, extra in (("sequential", []), ("batched", ["--video_batch", "2"]),
                            ("flip", ["--flip"])):
            out = os.path.join(EVAL_DIR, name)
            t0 = time.perf_counter()
            code, counts[name] = reset_and_count(lambda: app.main(base + extra + ["--out", out],
                                                                  device=dev))
            seconds = time.perf_counter() - t0
            check(code == 0, f"eval_xmem {name} exited with an error")
            check(sum(counts[name].values()) == 0, f"eval_xmem {name} launched {counts[name]}")
            with open(os.path.join(out, "metrics.json")) as f:
                g = json.load(f)["global"]
            check(all(0.0 <= g[k] <= 1.0 for k in ("J", "F", "JF")), f"eval_xmem {name}: {g}")
            runs[name] = {"fps": g["fps"], "ms_per_frame": 1e3 / g["fps"], "J": g["J"],
                          "F": g["F"], "JF": g["JF"], "fg_iou": g["fg_iou_frame_mean"],
                          "wall_seconds": seconds}
        t0 = time.perf_counter()
        cpu_out = os.path.join(EVAL_DIR, "cpu")
        check(app.main(base + ["--split", "hold", "--frames", str(EVAL_HOLD_FRAMES + 1),
                               "--out", cpu_out], device="cpu") == 0, "eval_xmem on the CPU")
        cpu_seconds = time.perf_counter() - t0
    finally:
        os.remove(ckpt)
    seq, bat = os.path.join(EVAL_DIR, "sequential"), os.path.join(EVAL_DIR, "batched")
    holds = [{"frame": t, **hold_probs(f"eval_xmem vid_1 frame {t} card vs CPU",
                                       eval_scores(seq, "vid_1", t), eval_scores(cpu_out, "vid_1", t))}
             for t in range(1, EVAL_HOLD_FRAMES + 1)]
    batch_holds = {vid: [hold_probs(f"eval_xmem {vid} frame {t} batched vs sequential",
                                    eval_scores(bat, vid, t), eval_scores(seq, vid, t))
                         for t in range(1, EVAL_FRAMES)] for vid in ("vid_1", "vid_2")}
    merged = os.path.join(EVAL_DIR, "merged")
    check(merge_scores.main(["--inputs", seq, os.path.join(EVAL_DIR, "flip"), "--out", merged],
                            device=dev) == 0, "merge_scores exited with an error")
    for vid in layout["videos"]:
        names = sorted(os.listdir(os.path.join(merged, vid)))
        check(len(names) == EVAL_FRAMES - 1, f"merge_scores {vid}: {len(names)} frames")
        for n in names:
            m = read_png(os.path.join(merged, vid, n))
            check(m.shape == EVAL_HW and int(m.max()) <= 2, f"merged {vid}/{n}: {m.shape}")
    shutil.rmtree(data, ignore_errors=True)
    emit({"phase": "eval_xmem", **layout, "size": 480, "config": "XMemConfig()",
          "write_seconds": write_seconds, "runs": runs, "card_vs_cpu": holds,
          "cpu_seconds": cpu_seconds,
          "batched_vs_sequential": {vid: {"max_abs_err": max(r["max_abs_err"] for r in rows),
                                          "min_label_agreement_off_near_ties": min(
                                              r["label_agreement_off_near_ties"] for r in rows)}
                                    for vid, rows in batch_holds.items()},
          "prob_atol": XMEM_PROB_ATOL, "min_label_agreement": XMEM_MIN_AGREE,
          "launches": counts})
    return {k: sum(c[k] for c in counts.values()) for k in counts["sequential"]}


TRAIN_DIR = os.path.join(OUT, "train_xmem")
TRAIN_HW = (384, 384)        # the reference's training crop (XMem/dataset/vos_dataset.py)
TRAIN_STEPS = 4              # then a --resume for one more
XMEM_WIDTH_ARGS = []         # XMemConfig()'s widths, the apps' defaults
TRAIN_HOLD = dict(key_dim=16, value_dim=32, hidden_dim=8)  # tests/test_parallel_train.py:62
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_MIN_COS = 1e-5, 1e-4, 0.9999
# A leaf whose gradient norm is below this share of the whole gradient's is
# rounding noise around a true zero (key_proj's bias: one shift of every
# key leaves the L2 similarity as it was; 1.4e-14 of the norm on the CPU,
# where one thread against eight gives it a cosine of -0.31). Its cosine
# is not held; the global error holds it.
TRAIN_GRAD_NOISE_SHARE = 1e-10
JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                             "torch_jpeg")


def rollout_grads(model, batch, rollout, dev) -> tuple:
    """The mean rollout loss of ``batch`` (numpy) on ``dev`` and every
    trainable leaf's gradient, as numpy."""
    from d3fields_tpu_torch.models.xmem import trainer as TR

    leaves = TR.train_leaves(model)
    loss = TR.sequence_loss(model, TR.to_device_batch(batch, dev), 0, rollout=rollout)[0].mean()
    loss.backward()
    return float(loss.detach()), {n: (torch.zeros_like(t) if t.grad is None else t.grad).cpu()
                                  .numpy().astype(np.float64) for n, t in leaves}


def hold_train_grads(dev) -> dict:
    """A small model's rollout loss and gradients on the card against the
    CPU: same weights (PyTorch's default conv scale, ``xmem_model``: the
    He-normal ``init_params`` makes the rollout amplify rounding ~100x),
    the same batch (B=2, T=3, 2 objects, 32x32) and deep-update coins."""
    from d3fields_tpu_torch.config import XMemConfig
    from d3fields_tpu_torch.models.xmem import trainer as TR
    from d3fields_tpu_torch.models.xmem.network import XMem

    cfg = XMemConfig(**TRAIN_HOLD)
    rs = np.random.RandomState(0)
    nb, T, O, H, W = 2, 3, 2, 32, 32
    batch = {"frames": rs.rand(nb, T, H, W, 3).astype(np.float32),
             "first_gt": (rs.rand(nb, O, H, W) > 0.5).astype(np.float32),
             "cls_gt": rs.randint(0, O + 1, (nb, T, H, W)),
             "selector": np.ones((nb, O), np.float32)}
    # seed 1 draws both values of frame 1's coin (frames 0 and T-1 are not
    # read), so both branches of the deep update are held
    rollout = TR.draw_rollout(torch.Generator().manual_seed(1), nb, T, 0)
    read = rollout.deep_update[:, 1:T - 1]
    check(bool(read.any()) and not bool(read.all()),
          f"train_xmem coins take one branch only: {rollout.deep_update.tolist()}")
    cpu = xmem_model(torch.device("cpu"), cfg, seed=7)
    card = XMem(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    cpu_loss, cpu_grads = rollout_grads(cpu, batch, rollout, torch.device("cpu"))
    card_loss, card_grads = rollout_grads(card.eval(), batch, rollout, dev)
    names = sorted(cpu_grads)
    g = np.concatenate([card_grads[k].ravel() for k in names])
    r = np.concatenate([cpu_grads[k].ravel() for k in names])
    cos, noise = {}, {}
    for k in names:
        a, b = card_grads[k].ravel(), cpu_grads[k].ravel()
        na, nb_ = np.linalg.norm(a), np.linalg.norm(b)
        if nb_ < TRAIN_GRAD_NOISE_SHARE * np.linalg.norm(r):
            noise[k] = {"cpu_norm_share": float(nb_ / np.linalg.norm(r)),
                        "card_norm_share": float(na / np.linalg.norm(r))}
            continue
        cos[k] = float(a @ b / (na * nb_))
    row = {"loss_card": card_loss, "loss_cpu": cpu_loss,
           "loss_rel_err": abs(card_loss - cpu_loss) / abs(cpu_loss),
           "grad_global_rel_err": float(np.linalg.norm(g - r) / np.linalg.norm(r)),
           "grad_min_cos": min(cos.values()), "grad_min_cos_leaf": min(cos, key=cos.get),
           "leaves": len(names), "leaves_at_rounding_noise": noise,
           "deep_update_coins": rollout.deep_update.tolist()}
    check(row["loss_rel_err"] <= TRAIN_LOSS_RTOL, f"train_xmem loss card vs CPU: {row}")
    check(row["grad_global_rel_err"] <= TRAIN_GRAD_RTOL, f"train_xmem grads card vs CPU: {row}")
    check(row["grad_min_cos"] >= TRAIN_GRAD_MIN_COS, f"train_xmem grad cosine: {row}")
    return row


def train_losses(out: str) -> list:
    with open(os.path.join(out, "train.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    return [r["loss"] for r in rows if r.get("prefix") == "train"]


@contextlib.contextmanager
def timed_training(times: dict):
    """Time every ``trainer.train_step`` between synchronisations (the app
    otherwise reads the loss late and overlaps steps with the next batch's
    loading) and every clip loader's ``batch`` on the host clock."""
    from d3fields_tpu_torch.models.xmem import data as D
    from d3fields_tpu_torch.models.xmem import trainer as TR

    step, batch = TR.train_step, D.VideoClipLoader.batch

    def timed_step(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args, **kwargs)
        torch.cuda.synchronize()
        times["step_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_batch(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = batch(self, *args, **kwargs)
        times["batch_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    TR.train_step, D.VideoClipLoader.batch = timed_step, timed_batch
    try:
        yield
    finally:
        TR.train_step, D.VideoClipLoader.batch = step, batch


def train_static(dev) -> tuple:
    """Every committed JPEG fixture against its recorded SHA-256, then
    stage 0 (``--static_root``) on the fixtures with saliency masks written
    as PNG: 2 steps, batch 4, 3 frames at TRAIN_HW."""
    import hashlib
    import shutil

    from d3fields_tpu_torch.apps import train_xmem as app
    from d3fields_tpu_torch.utils.png import imread_color, save_png

    with open(os.path.join(JPEG_FIXTURES, "expected.json")) as f:
        expected = json.load(f)
    root = os.path.join(TRAIN_DIR, "static")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    for name, want in expected.items():
        img = imread_color(os.path.join(JPEG_FIXTURES, name))
        check(list(img.shape) == want["shape"], f"JPEG {name}: shape {img.shape}")
        check(hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"],
              f"JPEG {name}: not the bytes cv2.imread gives")
        shutil.copy(os.path.join(JPEG_FIXTURES, name), os.path.join(root, name))
        grey = img.astype(np.int64).sum(-1)
        mask = np.where(grey > np.median(grey), 255, 0).astype(np.uint8)
        save_png(os.path.join(root, name[:-4] + ".png"), np.repeat(mask[..., None], 3, axis=2))
    decode_seconds = time.perf_counter() - t0
    out = os.path.join(TRAIN_DIR, "stage0")
    times = {"step_ms": [], "batch_ms": []}
    argv = ["--stage", "0", "--static_root", root, "--steps", "2", "--batch", "4",
            "--num_frames", "3", "--size", *map(str, TRAIN_HW), *XMEM_WIDTH_ARGS,
            "--save_every", "100", "--log_every", "1", "--out", out]
    with timed_training(times):
        code, counts = reset_and_count(lambda: app.main(argv, device=dev))
    check(code == 0, "train_xmem --stage 0 exited with an error")
    losses = train_losses(out)
    check(len(losses) == 2 and np.isfinite(losses).all(), f"stage 0 losses {losses}")
    return {"fixtures": sorted(expected), "decode_and_write_seconds": decode_seconds,
            "stage0": {"losses": losses, **times}}, counts


def profile_train_step(dev, argv, ckpt: str) -> None:
    """Device time by kernel and idle share of a full-width training step
    from ``ckpt``, on a batch of the app's loader (``profile_stage``)."""
    from d3fields_tpu_torch.apps import train_xmem as app
    from d3fields_tpu_torch.config import XMemConfig
    from d3fields_tpu_torch.models.xmem import trainer as TR

    args = app.resolve_stage_args(app.build_parser().parse_args(argv + ["--steps", "1"]))
    loader, _ = app.make_loader(args)
    cfg = XMemConfig(key_dim=args.key_dim, value_dim=args.value_dim, hidden_dim=args.hidden_dim)
    state = TR.load_checkpoint(ckpt, cfg, TR.make_optimizer(), dev)
    batch = TR.to_device_batch(loader.batch(args.batch), dev)
    profile_stage("train_step", lambda: TR.train_step(
        state, batch, num_ref_frames=args.num_ref_frames, start_warm=args.start_warm,
        end_warm=args.end_warm))


TRAIN_DP_STEPS = 3
TRAIN_DP_LIMIT_S = 300    # each dp child's, killed after
# tests/test_torch_xmem_train.py's rule for two runs of AdamW whose
# gradients differ by rounding: an element may end more than a quarter step
# (of lr) from the other run's only where that run's first moment was below
# a tenth of its leaf's rms after some step (Adam's first steps are +-lr
# whatever a gradient's size, so a gradient that is rounding noise around
# zero may step the other way)
TRAIN_DP_STEP_TOL, TRAIN_DP_FLIP_SHARE = 0.25, 0.1


def train_dp_argv(data: str, weights: str, out: str, dp: int) -> list:
    """The dp part's ``train_xmem`` flags: the full-width run's clip shape,
    a global batch of 2, TRAIN_DP_STEPS steps from ``weights``."""
    return ["--data_root", data, "--num_frames", "8", "--num_ref_frames", "3",
            "--max_num_obj", "3", "--batch", "2", "--size", *map(str, TRAIN_HW),
            *XMEM_WIDTH_ARGS, "--steps", str(TRAIN_DP_STEPS), "--log_every", "1",
            "--load_network", weights, "--dp", str(dp), "--out", out]


def train_dp_rank(rank: int, addr: str, device: str, argv: list, out: str) -> None:
    """One rank of ``train_dp``'s two, in a process of its own (``python
    -c``): a gloo group on ``device``, one card for both (NCCL puts no two
    ranks on one device; gloo stages its all-reduce through the host, every
    tensor stays on the card), ``train_xmem`` with ``argv`` on that device
    with every step and every gradient average timed between
    synchronisations; its row under ``out``, and rank 0's first averaged
    gradient."""
    import hashlib

    import torch.distributed as dist

    from d3fields_tpu_torch.apps import train_xmem as app
    from d3fields_tpu_torch.models.xmem import trainer as TR
    from d3fields_tpu_torch.parallel import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    import torch.distributed.nn as _  # noqa: F401  (before the group: see initialize_distributed)
    dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=2, rank=rank)
    row = {"rank": rank, "backend": dist.get_backend(), "device": str(dev), "step_ms": [],
           "allreduce_ms": []}
    last = []
    step, average = TR.train_step, ops.average_gradients

    def timed_step(state, *args, **kwargs):
        sync()
        t0 = time.perf_counter()
        result = step(state, *args, **kwargs)
        sync()
        row["step_ms"].append((time.perf_counter() - t0) * 1e3)
        last[:] = [state]
        return result

    def timed_average(leaves, group=None):
        sync()
        t0 = time.perf_counter()
        average(leaves, group)
        sync()
        row["allreduce_ms"].append((time.perf_counter() - t0) * 1e3)
        row["leaves_reduced"] = len(leaves)
        row["bytes_reduced"] = sum(t.numel() * t.element_size() for t in leaves)
        if rank == 0 and len(row["allreduce_ms"]) == 1:
            torch.save(torch.cat([t.grad.reshape(-1) for t in leaves]).cpu(),
                       os.path.join(out, "dp_first_grad.pt"))

    TR.train_step, ops.average_gradients = timed_step, timed_average
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    try:
        row["code"] = app.main(argv, device=dev)
    finally:
        TR.train_step, ops.average_gradients = step, average
    sync()
    row["launches"] = launch_counts()
    row["max_memory_allocated_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30 if cuda
                                       else "not measured (CPU)")
    digest = hashlib.sha256()
    for _, t in TR.train_leaves(last[0].model):
        digest.update(t.detach().cpu().numpy().tobytes())
    row["leaves_sha256"] = digest.hexdigest()
    with open(os.path.join(out, f"dp_rank{rank}.json"), "w") as f:
        json.dump(row, f)
    dist.barrier()
    dist.destroy_process_group()


def leaf_readings(got: dict, want: dict, noise_share: float) -> dict:
    """The global relative error of ``got`` against ``want`` (dicts of
    arrays by leaf) and the least cosine over the leaves whose norm is at
    least ``noise_share`` of the whole's."""
    names = sorted(want)
    g = np.concatenate([np.asarray(got[k], np.float64).ravel() for k in names])
    r = np.concatenate([np.asarray(want[k], np.float64).ravel() for k in names])
    cos = {}
    for k in names:
        a, b = np.asarray(got[k], np.float64).ravel(), np.asarray(want[k], np.float64).ravel()
        if np.linalg.norm(b) >= noise_share * np.linalg.norm(r):
            cos[k] = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    return {"global_rel_err": float(np.linalg.norm(g - r) / np.linalg.norm(r)),
            "min_cos": min(cos.values()), "min_cos_leaf": min(cos, key=cos.get)}


def train_dp_two_ranks(dev, data: str, out: str) -> tuple:
    """(a) ``train_xmem --dp 2`` as two gloo ranks on the one card against
    the one-process ``--dp 0`` run on the same data and seed: the losses at
    TRAIN_LOSS_RTOL, the first step's averaged gradient and the final
    checkpoints' AdamW first moments at TRAIN_GRAD_RTOL and
    TRAIN_GRAD_MIN_COS, the final checkpoints' leaves by the
    TRAIN_DP_STEP_TOL rule, both ranks' leaves bit-equal. Returns (its row,
    the one-process run's launches)."""
    import socket

    from d3fields_tpu_torch.apps import train_xmem as app
    from d3fields_tpu_torch.config import XMemConfig
    from d3fields_tpu_torch.models.xmem import trainer as TR

    # Both runs start from xmem_model's weights (--load_network), not the
    # app's network.init_params: from those He-normal weights the rollout
    # amplifies rounding so far that two right runs part after a step
    # (a CPU rehearsal at small widths: the first averaged gradient 3.8e-5
    # from the one-process one, the first moments 6.5% apart after 3 steps).
    weights = os.path.abspath(os.path.join(out, "XMem.pth"))
    args = app.resolve_stage_args(app.build_parser().parse_args(
        train_dp_argv(data, weights, out, 0)))
    cfg = XMemConfig(key_dim=args.key_dim, value_dim=args.value_dim, hidden_dim=args.hidden_dim)
    torch.save({k: v.cpu() for k, v in xmem_model(dev, cfg, seed=11).state_dict().items()},
               weights)
    first, noise = {}, {}
    update = TR.apply_update

    def recording_update(state):
        leaves = TR.train_leaves(state.model)
        if not first:
            first.update({n: t.grad.detach().cpu().numpy() for n, t in leaves})
        update(state)
        for n, t in leaves:
            mu = state.optimizer.state[t]["exp_avg"]
            m = (mu.abs() < TRAIN_DP_FLIP_SHARE * mu.double().square().mean().sqrt()).cpu()
            noise[n] = m if n not in noise else noise[n] | m

    one = {"step_ms": [], "batch_ms": []}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    TR.apply_update = recording_update
    try:
        with timed_training(one):
            code, counts = reset_and_count(lambda: app.main(
                train_dp_argv(data, weights, os.path.join(out, "dp0"), 0), device=dev))
    finally:
        TR.apply_update = update
    one["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    check(code == 0, "train_xmem --dp 0 exited with an error")
    torch.cuda.empty_cache()

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        addr = f"localhost:{sk.getsockname()[1]}"
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    device = f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda" else str(dev)
    argv = train_dp_argv(os.path.abspath(data), weights, os.path.abspath(os.path.join(out, "dp2")),
                         2)
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.train_dp_rank({r}, {addr!r}, "
                               f"{device!r}, {argv!r}, {os.path.abspath(out)!r})"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=TRAIN_DP_LIMIT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    dp_seconds = time.perf_counter() - t0
    check(all(p.returncode == 0 for p in procs),
          "a train_xmem --dp 2 rank failed: " + " | ".join(e[-2000:] for _, e in logs))
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"dp_rank{r}.json")) as f:
            ranks.append(json.load(f))
    check(all(r["code"] == 0 for r in ranks), f"train_xmem --dp 2 ranks returned {ranks}")
    check(ranks[0]["leaves_sha256"] == ranks[1]["leaves_sha256"],
          "the two ranks' leaves differ after training")

    losses, want = train_losses(os.path.join(out, "dp2")), train_losses(os.path.join(out, "dp0"))
    check(len(losses) == len(want) == TRAIN_DP_STEPS, f"dp losses {losses} vs {want}")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    flat = torch.load(os.path.join(out, "dp_first_grad.pt"), weights_only=True).numpy()
    sizes = np.cumsum([v.size for v in first.values()])[:-1]
    got = {n: v.reshape(first[n].shape) for n, v in zip(first, np.split(flat, sizes))}
    grad = leaf_readings(got, first, TRAIN_GRAD_NOISE_SHARE)

    a, b = (torch.load(os.path.join(out, run, "ckpt_final.pt"), map_location="cpu",
                       weights_only=True) for run in ("dp2", "dp0"))
    lr = args.lr
    off, flips, worst = 0, 0, 0.0
    for n in first:
        err = (a["model"][n] - b["model"][n]).abs().double()
        over = err > TRAIN_DP_STEP_TOL * lr
        off += int((over & ~noise[n]).sum())
        flips += int((over & noise[n]).sum())
        worst = max(worst, float(err.max()) / lr)
    moments = [{n: s["exp_avg"].numpy() for n, s in zip(first, c["optimizer"]["state"].values())}
               for c in (a, b)]
    row = {"ranks": ranks, "backend": ranks[0]["backend"], "world_size": 2,
           "global_batch": 2, "steps": TRAIN_DP_STEPS, "children_seconds": dp_seconds,
           "one_process": {**one, "losses": want},
           "losses": losses, "loss_rel_err": loss_rel, "first_grad": grad,
           "final_leaves": {"elements_off": off, "elements_off_at_noise": flips,
                            "max_err_in_steps": worst, "step_tol": TRAIN_DP_STEP_TOL,
                            "flip_share": TRAIN_DP_FLIP_SHARE},
           "final_first_moment": leaf_readings(moments[0], moments[1], TRAIN_GRAD_NOISE_SHARE)}
    check(max(loss_rel) <= TRAIN_LOSS_RTOL, f"train_xmem dp losses vs one process: {row}")
    check(grad["global_rel_err"] <= TRAIN_GRAD_RTOL and grad["min_cos"] >= TRAIN_GRAD_MIN_COS,
          f"train_xmem dp first gradient vs one process: {grad}")
    check(off == 0, f"train_xmem dp final leaves vs one process: {row['final_leaves']}")
    moment = row["final_first_moment"]
    check(moment["global_rel_err"] <= TRAIN_GRAD_RTOL and moment["min_cos"] >= TRAIN_GRAD_MIN_COS,
          f"train_xmem dp final first moments vs one process: {moment}")
    return row, counts


def train_dp_nccl(dev) -> dict:
    """(b) ``train_step`` with the group of ``initialize_distributed`` over
    NCCL at world size 1 (an explicit ``localhost`` address) against the
    plain step: two steps of a small model, drawn rollouts, bit for bit.
    The backward pass is not bit-reproducible from run to run on the card
    (cuDNN's weight gradients and atomic scatters sum in varying order), so
    the group's step is handed the plain step's gradients before its
    average; the losses, the draws, the shard check, the average and the
    update are its own. The gradients it computed are reported against
    the plain ones."""
    import socket

    import torch.distributed as dist

    from d3fields_tpu_torch.config import XMemConfig
    from d3fields_tpu_torch.models.xmem import trainer as TR
    from d3fields_tpu_torch.parallel import initialize_distributed, ops

    cfg = XMemConfig(**TRAIN_HOLD)
    rs = np.random.RandomState(3)
    nb, T, O, H, W = 2, 4, 2, 32, 32
    batch = TR.to_device_batch({"frames": rs.rand(nb, T, H, W, 3).astype(np.float32),
                                "first_gt": (rs.rand(nb, O, H, W) > 0.5).astype(np.float32),
                                "cls_gt": rs.randint(0, O + 1, (nb, T, H, W)),
                                "selector": np.ones((nb, O), np.float32)}, dev)
    grads, own = [], []
    update, average = TR.apply_update, ops.average_gradients

    def recording_update(state):
        grads.append([t.grad.clone() for _, t in TR.train_leaves(state.model)])
        update(state)

    def handed_average(leaves, group=None):
        given = grads[len(own)]
        own.append(max(float((t.grad - g).abs().max()) for t, g in zip(leaves, given)))
        for t, g in zip(leaves, given):
            t.grad = g.clone()
        average(leaves, group)

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    check(initialize_distributed(f"localhost:{port}", 1, 0, device=dev), "initialize_distributed")
    try:
        runs = []
        for group, module, name, fn in ((None, TR, "apply_update", recording_update),
                                        (dist.group.WORLD, ops, "average_gradients",
                                         handed_average)):
            setattr(module, name, fn)
            try:
                state = TR.init_train_state(xmem_model(dev, cfg, seed=7), TR.make_optimizer())
                losses = []
                for _ in range(2):
                    state, out = TR.train_step(state, batch, num_ref_frames=2, group=group)
                    losses.append(out["loss"])
            finally:
                TR.apply_update, ops.average_gradients = update, average
            runs.append((torch.stack(losses), [t.detach().clone()
                                               for _, t in TR.train_leaves(state.model)]))
        row = {"backend": dist.get_backend(), "world_size": dist.get_world_size(),
               "losses": runs[0][0].tolist(),
               "loss_equal": bool(torch.equal(runs[0][0], runs[1][0])),
               "leaves_equal": all(torch.equal(x, y) for x, y in zip(runs[0][1], runs[1][1])),
               "own_grad_max_abs_diff": own}
    finally:
        dist.destroy_process_group()
    check(row["backend"] == ("nccl" if dev.type == "cuda" else "gloo") and row["loss_equal"]
          and row["leaves_equal"] and len(own) == 2, f"train_step over NCCL at world size 1: {row}")
    return row


def train_dp(dev, data: str) -> dict:
    """The ``train_xmem`` phase's dp part: (a) two gloo ranks on the one
    card against one process, (b) the step over NCCL at world size 1, (c)
    ``--dp 2`` with no group and one visible GPU refused. Two ranks on one
    card show the dp code right on the card, not a multi-card speed.
    Returns the one-process run's launches."""
    import shutil

    from d3fields_tpu_torch.apps import train_xmem as app

    out = os.path.join(TRAIN_DIR, "dp")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    row, counts = train_dp_two_ranks(dev, data, out)
    row["nccl_world_size_1"] = train_dp_nccl(dev)
    refused = None
    if torch.cuda.device_count() == 1:
        try:
            app.main(train_dp_argv(data, os.path.join(out, "XMem.pth"),
                                   os.path.join(out, "refused"), 2), device=dev)
        except RuntimeError as e:
            refused = str(e)
        check(refused is not None and "2 CUDA device(s) asked for, 1 visible" in refused,
              f"train_xmem --dp 2 on one GPU with no group: {refused!r}")
    row["refused_on_one_gpu"] = refused
    emit({"phase": "train_xmem", "path": "dp", **row, "seconds": time.perf_counter() - t0,
          "note": "two ranks share one card over gloo: the dp code on the card, "
                  "not a multi-card speed", "launches": counts})
    shutil.rmtree(out, ignore_errors=True)  # 0.7 GB checkpoints
    return counts


def train_xmem(dev) -> dict:
    """Phase ``train_xmem``: gradients card vs CPU, full-width training with
    a resume and the checkpoint's evaluation, the JPEG fixtures and a
    stage-0 run."""
    import shutil

    from d3fields_tpu_torch.apps import eval_xmem as eval_app
    from d3fields_tpu_torch.apps import train_xmem as app

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    hold = hold_train_grads(dev)
    hold["seconds"] = time.perf_counter() - t0
    data = os.path.join(TRAIN_DIR, "data")
    t0 = time.perf_counter()
    layout = write_eval_videos(data)
    write_seconds = time.perf_counter() - t0
    out = os.path.join(TRAIN_DIR, "run")
    argv = ["--data_root", data, "--num_frames", "8", "--num_ref_frames", "3",
            "--max_num_obj", "3", "--batch", "2", "--size", *map(str, TRAIN_HW),
            *XMEM_WIDTH_ARGS, "--save_every", str(TRAIN_STEPS), "--log_every", "1",
            "--out", out]
    times = {"step_ms": [], "batch_ms": []}
    counts = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timed_training(times):
        code, counts["train"] = reset_and_count(
            lambda: app.main(argv + ["--steps", str(TRAIN_STEPS)], device=dev))
    train_seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(code == 0, "train_xmem exited with an error")
    ckpt = os.path.join(out, f"ckpt_{TRAIN_STEPS}.pt")
    check(os.path.exists(ckpt), f"no {ckpt}")
    resume = {"step_ms": [], "batch_ms": []}
    with timed_training(resume):
        code, counts["resume"] = reset_and_count(
            lambda: app.main(argv + ["--steps", str(TRAIN_STEPS + 1), "--resume", ckpt],
                             device=dev))
    check(code == 0, "train_xmem --resume exited with an error")
    final = os.path.join(out, "ckpt_final.pt")
    check(torch.load(final, weights_only=True)["it"] == TRAIN_STEPS + 1,
          "the resumed run did not end at its step budget")
    losses = train_losses(out)
    check(len(losses) == TRAIN_STEPS + 1 and np.isfinite(losses).all(), f"losses {losses}")
    ev = os.path.join(TRAIN_DIR, "eval")
    code, counts["eval"] = reset_and_count(lambda: eval_app.main(
        ["--data_root", data, "--frames", "4", "--size", "480", "--ckpt", final,
         *XMEM_WIDTH_ARGS, "--out", ev], device=dev))
    check(code == 0, "eval_xmem --ckpt on the trained checkpoint exited with an error")
    with open(os.path.join(ev, "metrics.json")) as f:
        g = json.load(f)["global"]
    check(all(0.0 <= g[k] <= 1.0 for k in ("J", "F", "JF")), f"eval of the checkpoint: {g}")
    profile_train_step(dev, argv, final)
    counts["dp"] = train_dp(dev, data)
    shutil.rmtree(data, ignore_errors=True)
    torch.cuda.empty_cache()
    jpeg, counts["stage0"] = train_static(dev)
    for k in ("step_ms", "batch_ms"):
        jpeg["stage0"][k + "_median"] = float(np.median(jpeg["stage0"][k]))
    emit({"phase": "train_xmem", "card_vs_cpu": hold,
          "loss_rtol": TRAIN_LOSS_RTOL, "grad_rtol": TRAIN_GRAD_RTOL,
          "grad_min_cos": TRAIN_GRAD_MIN_COS, "grad_noise_share": TRAIN_GRAD_NOISE_SHARE,
          "full_width": {"config": "XMemConfig()", "crop": list(TRAIN_HW), "num_frames": 8,
                         "num_ref_frames": 3, "max_num_obj": 3, "batch": 2,
                         "videos": layout["videos"], "video_hw": layout["image_hw"],
                         "write_seconds": write_seconds, "losses": losses,
                         "step_ms": times["step_ms"],
                         "step_ms_median_2_4": float(np.median(times["step_ms"][1:4])),
                         "resume_step_ms": resume["step_ms"],
                         "batch_ms": times["batch_ms"] + resume["batch_ms"],
                         "batch_ms_median": float(np.median(times["batch_ms"])),
                         "max_memory_allocated_gib": peak / 2**30,
                         "train_seconds": train_seconds},
          "eval_of_checkpoint": {"J": g["J"], "F": g["F"], "fps": g["fps"]},
          "jpeg": jpeg, "launches": counts})
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)  # checkpoints of 0.3 GB each
    return {k: sum(c[k] for c in counts.values()) for k in counts["train"]}


CLICK_DIR = os.path.join(OUT, "click_track")
CLICK_ENTRY = 8  # the second object's clicks come on this frame
# two groups of four clicks, two foreground and two background, in 854x480
# pixels: the first on sphere 1 of frame 0, the second on sphere 2 of frame 8
CLICK_GROUPS = (f"430,180;450,200;100,80,0;700,420,0|@{CLICK_ENTRY}:"
                "560,330;540,300;60,400,0;800,60,0")
SAM_HOLD_REL = 1e-3      # card vs CPU decoder logits and IoU, relative to their scale
MASK_MIN_AGREE = 0.999   # the chosen mask, card vs CPU (knife-edge logits may flip)


def sam_checkpoint(dev, path: str):
    """SAM ViT-H with random weights (``segment_models``' SAM), written as a
    huggingface state dict; returns the model."""
    from d3fields_tpu_torch.models.sam import model as sam

    smodel = sam.init_params(sam.SamConfig.vit_huge(), torch.Generator(device=dev).manual_seed(1),
                             device=dev)
    torch.save({k: v.cpu() for k, v in smodel.state_dict().items()}, path)
    return smodel


def hold_point_decode(dev, smodel, rgb: np.ndarray) -> dict:
    """The first click group through ``SamPredictor.predict_points`` on the
    card, and through the same decoder on the CPU fed the card's image
    embedding: low-res logits and IoU within SAM_HOLD_REL of their scale,
    the same best channel, its mask agreeing on MASK_MIN_AGREE of the
    pixels."""
    from d3fields_tpu_torch.apps.click_track import parse_clicks
    from d3fields_tpu_torch.models.sam import model as sam
    from d3fields_tpu_torch.models.sam.predictor import SamPredictor

    _, pts, lbls = parse_clicks(CLICK_GROUPS)[0]
    card = SamPredictor(smodel, device=dev).set_image(rgb)
    masks, iou, low = card.predict_points(pts[None], lbls[None])
    cpu_model = sam.Sam(smodel.cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in smodel.state_dict().items()})
    cpu = SamPredictor(cpu_model, device="cpu")
    cpu._image_embs = [e.cpu() for e in card._image_embs]
    cpu._orig_hw, cpu._resized_hw = card._orig_hw, card._resized_hw
    cmasks, ciou, clow = cpu.predict_points(pts[None], lbls[None])
    low, clow, iou, ciou = (t.cpu().numpy() for t in (low, clow, iou, ciou))
    row = {"logit_scale": float(np.abs(clow).max()),
           "logit_rel_err": max_err(low, clow) / float(np.abs(clow).max()),
           "iou_rel_err": max_err(iou, ciou) / float(np.abs(ciou).max()),
           "best": [int(iou[0].argmax()), int(ciou[0].argmax())]}
    best = row["best"][1]
    row["mask_agreement"] = float((masks[0, best].cpu() == cmasks[0, best]).float().mean())
    check(row["logit_rel_err"] <= SAM_HOLD_REL and row["iou_rel_err"] <= SAM_HOLD_REL,
          f"click_track decode card vs CPU: {row}")
    check(row["best"][0] == row["best"][1], f"click_track best channel card vs CPU: {row}")
    check(row["mask_agreement"] >= MASK_MIN_AGREE, f"click_track chosen mask: {row}")
    return row


def click_track(dev) -> dict:
    """``apps/click_track.py`` at full width: SAM ViT-H and ``XMemConfig()``
    from checkpoints written in the reference layouts, one 480x854 video of
    EVAL_FRAMES PNG frames, ``--size 480 --refine 1``, two groups of four
    clicks, the second entering at frame CLICK_ENTRY. Timed: SAM's encode
    and point decode, XMem per frame, the app's FPS; held: the point decode
    on the card against the CPU (``hold_point_decode``)."""
    import io
    import shutil

    from d3fields_tpu_torch.apps import click_track as app
    from d3fields_tpu_torch.config import XMemConfig
    from d3fields_tpu_torch.models.sam.predictor import SamPredictor
    from d3fields_tpu_torch.seg.video_tracker import VideoMaskTracker
    from d3fields_tpu_torch.utils.png import imread_color, read_png, save_png

    shutil.rmtree(CLICK_DIR, ignore_errors=True)
    frames = os.path.join(CLICK_DIR, "data", "vid_1", "frames")
    os.makedirs(frames)
    t0 = time.perf_counter()
    for t in range(EVAL_FRAMES):
        save_png(os.path.join(frames, f"{t:05d}.png"),
                 eval_frame(EVAL_DRIFTS["vid_1"], t)["color"][0], filter_type=0)
    write_seconds = time.perf_counter() - t0
    ckpt = {"sam": os.path.join(CLICK_DIR, "sam_vit_h.pth"),
            "xmem": os.path.join(CLICK_DIR, "XMem.pth")}
    t0 = time.perf_counter()
    smodel = sam_checkpoint(dev, ckpt["sam"])
    torch.save({k: v.cpu() for k, v in xmem_model(dev, XMemConfig(), seed=5).state_dict().items()},
               ckpt["xmem"])
    ckpt_seconds = time.perf_counter() - t0
    out = os.path.join(CLICK_DIR, "out")
    argv = ["--data_root", os.path.join(CLICK_DIR, "data"), "--frames", "0", "--size", "480",
            "--refine", "1", "--clicks", CLICK_GROUPS, "--sam_ckpt", ckpt["sam"],
            "--xmem_ckpt", ckpt["xmem"], *XMEM_WIDTH_ARGS, "--out", out]
    times, stdout = {}, io.StringIO()
    try:
        with timed_function(SamPredictor, "set_image", times), \
                timed_function(SamPredictor, "predict_points", times), \
                timed_function(VideoMaskTracker, "process", times), \
                contextlib.redirect_stdout(stdout):
            t0 = time.perf_counter()
            code, counts = reset_and_count(lambda: app.main(argv, device=dev))
            wall = time.perf_counter() - t0
    finally:
        for path in ckpt.values():
            os.remove(path)
    check(code == 0, "click_track exited with an error")
    # SAM's encoder: one attention launch a vision layer, f32 route
    encodes = len(times["set_image"])
    check(counts["sam_attention"] == 32 * encodes and counts["sam_attention_bf16"] == 0
          and sum(counts.values()) == counts["sam_attention"],
          f"click_track launched {counts} over {encodes} encodes")
    log = stdout.getvalue().splitlines()
    fps = [float(ln.split()[-1]) for ln in log if "FPS:" in ln]
    check(len(fps) == 1, f"click_track printed no FPS: {log}")
    names = sorted(os.listdir(os.path.join(out, "vid_1")))
    check(names == [f"{t:05d}.png" for t in range(EVAL_FRAMES)], f"click_track wrote {names}")
    labels = set()
    for n in names:
        m = read_png(os.path.join(out, "vid_1", n))
        check(m.shape == EVAL_HW and int(m.max()) <= 2, f"click_track {n}: {m.shape}")
        labels |= set(np.unique(m).tolist())
    rgb0 = np.ascontiguousarray(imread_color(os.path.join(frames, "00000.png"))[..., ::-1])
    hold = hold_point_decode(dev, smodel, rgb0)
    del smodel
    torch.cuda.empty_cache()
    proc = times["process"]
    plain = [ms for t, ms in enumerate(proc) if t not in (0, CLICK_ENTRY)]
    emit({"phase": "click_track", "video_hw": list(EVAL_HW), "frames": EVAL_FRAMES,
          "size": 480, "sam": "vit_huge", "xmem": "XMemConfig()", "clicks": CLICK_GROUPS,
          "refine": 1, "write_frames_seconds": write_seconds,
          "checkpoint_write_seconds": ckpt_seconds,
          "sam_encode_ms": times["set_image"], "point_decode_ms": times["predict_points"],
          "xmem_ms_per_frame": proc, "xmem_ms_median": float(np.median(plain)),
          "fps": fps[0], "wall_seconds": wall, "labels_seen": sorted(labels),
          "card_vs_cpu": hold, "sam_hold_rel": SAM_HOLD_REL, "launches": counts,
          "app_log": log})
    shutil.rmtree(CLICK_DIR, ignore_errors=True)
    return counts


IA_DIR = os.path.join(OUT, "interactive")
FBRS_HOLD_REL = 2e-4   # card vs CPU: f-BRS logits, the BRS loss and gradient, to scale
S2M_HOLD_ATOL = 3e-4   # card vs CPU S2M probabilities (tests/test_interactive.py:300)
IA_SCRIPT = (
    "goto 0\n"
    "object 1\n"
    "free 1 400,200 460,220\n"
    "commit\n"
    "click 440 190 +\n"     # one click: the network alone
    "click 600 300 -\n"     # from here f-BRS-B and the zoom-in crop
    "click 430 170 +\n"
    "undo\n"
    "scribble 1 420,180 440,190 470,200\n"
    "commit\n"
    "propagate forward\n"
    "import_layer {layer}\n"
    + "".join(f"vis {m} {{out}}/{m}.png\n" for m in ("davis", "fade", "light", "popup", "layered"))
    + "save\n")


def default_scale(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Convolutions at PyTorch's default scale, U(+-1/sqrt(fan_in)), from a
    seeded generator, identity batch norms: the JAX ``init_params`` scale of
    0.1 saturates S2M's ResNet-50 and f-BRS's HRNet (every probability 0 or
    1)."""
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                bound = float(m.weight[0].numel()) ** -0.5
                m.weight.uniform_(-bound, bound, generator=gen)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.reset_parameters()
    return model.eval()


def interactive_models(dev):
    """f-BRS at ``FbrsConfig()`` (HRNet-18s, OCR 64), S2M DeepLabV3+
    ResNet-50 and XMem at ``XMemConfig()``. The class heads of f-BRS (x10)
    and S2M (x100) spread the untrained logits, which otherwise sit within
    0.05 of 0 and leave every pixel's label to rounding."""
    from d3fields_tpu_torch.config import XMemConfig
    from d3fields_tpu_torch.models.fbrs import model as fm
    from d3fields_tpu_torch.models.s2m import model as s2

    fmodel = default_scale(fm.FbrsModel(fm.FbrsConfig(), device=dev), 2)
    with torch.no_grad():
        fmodel.feature_extractor.cls_head.weight.mul_(10.0)
    smodel = default_scale(s2.S2M(device=dev), 3)
    with torch.no_grad():
        smodel.classifier.classifier[3].weight.mul_(100.0)
    return fmodel, smodel, xmem_model(dev, XMemConfig(), seed=5)


def hold_fbrs_s2m(dev, fmodel, smodel, rgb: np.ndarray, prev_mask: np.ndarray) -> dict:
    """On the card against the CPU: the f-BRS forward logits of a flipped
    pair with two clicks, one BRS loss and gradient at a fixed (scale, bias)
    over the card's cached features, and S2M's probabilities at one
    scribble."""
    import copy

    from d3fields_tpu_torch.interact.session import _draw_path
    from d3fields_tpu_torch.models.common import IMAGENET_MEAN, IMAGENET_STD
    from d3fields_tpu_torch.models.fbrs import predictor as fp
    from d3fields_tpu_torch.models.s2m import S2MController

    img = ((rgb.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
    H, W = img.shape[:2]
    x = torch.from_numpy(img).permute(2, 0, 1)[None]
    x = torch.cat([x, x.flip(-1)])
    pts = torch.tensor([[[190.0, 440.0], [300.0, 600.0]], [[190.0, W - 441.0], [300.0, W - 601.0]]])
    cpu_f = copy.deepcopy(fmodel).cpu()
    with torch.no_grad():
        card = fmodel(x.to(dev), pts.to(dev)).cpu().numpy()
        ref = cpu_f(x, pts).numpy()
        feats = fmodel.backbone_feats(x.to(dev), pts.to(dev))
    scale = float(np.abs(ref).max())
    row = {"fbrs_logit_scale": scale, "fbrs_logit_rel_err": max_err(card, ref) / scale}
    clicks = [fp.Click(True, (190.0, 440.0)), fp.Click(False, (300.0, 600.0))]
    pos, neg = fp._click_masks(clicks, (H, W))
    pos = torch.from_numpy(np.concatenate([pos, pos[:, :, ::-1]]))
    neg = torch.from_numpy(np.concatenate([neg, neg[:, :, ::-1]]))
    sb = np.random.RandomState(0).normal(0, 0.05, 2 * fmodel.cfg.backbone.feats_channels)
    out = {}
    for name, model, d in (("card", fmodel, dev), ("cpu", cpu_f, torch.device("cpu"))):
        pred = fp.FbrsPredictor(model, device=d)
        pred.input_data = feats.to(d)
        loss, grad = pred.val_grad(sb, pos.to(d), neg.to(d), (H, W))[:2]
        out[name] = (float(loss), grad.cpu().numpy())
    gscale = float(np.abs(out["cpu"][1]).max())
    row.update({"brs_loss": [out["card"][0], out["cpu"][0]],
                "brs_loss_rel_err": abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0]),
                "brs_grad_scale": gscale,
                "brs_grad_rel_err": max_err(out["card"][1], out["cpu"][1]) / gscale})
    scr = _draw_path(np.full((H, W), 255, np.uint8), [(420, 180), (440, 190), (470, 200)], 1, 3)
    scr = _draw_path(scr, [(100, 400), (200, 420)], 0, 3)
    card_p = S2MController(smodel, 1, device=dev).interact(img, prev_mask, scr)
    cpu_p = S2MController(copy.deepcopy(smodel).cpu(), 1, device="cpu").interact(img, prev_mask,
                                                                                   scr)
    row["s2m_max_abs_err"] = max_err(card_p, cpu_p)
    row["s2m_prob_range"] = [float(cpu_p.min()), float(cpu_p.max())]
    for k in ("fbrs_logit_rel_err", "brs_loss_rel_err", "brs_grad_rel_err"):
        check(row[k] <= FBRS_HOLD_REL, f"interactive {k}: {row}")
    check(row["s2m_max_abs_err"] <= S2M_HOLD_ATOL, f"interactive S2M card vs CPU: {row}")
    return row


def interactive(dev) -> dict:
    """``apps/interactive.py`` at full width: f-BRS (HRNet-18s, OCR 64), S2M
    (DeepLabV3+ ResNet-50) and XMem (``XMemConfig()``) from checkpoints in
    the reference layouts, a 24-frame 480x854 uncompressed AVI through
    ``--video`` at ``--size 480``. The first script: a free stroke, three
    f-BRS clicks (BRS and the zoom-in from the second), undo, a scribble,
    commit, ``propagate forward``, an RGBA layer enlarged to the frame, the
    five overlays, save; the second run resumes from the saved masks and
    propagates backward. Timed: f-BRS per click with its L-BFGS evaluation
    count, a NoBRS forward, S2M per scribble, XMem per propagated frame,
    each run's wall; held: ``hold_fbrs_s2m``, and each run's saved masks
    equal to the session's."""
    import io
    import shutil

    from d3fields_tpu_torch.apps import interactive as app
    from d3fields_tpu_torch.interact import InteractiveSession
    from d3fields_tpu_torch.models.fbrs.predictor import FBRSController
    from d3fields_tpu_torch.models.s2m import S2MController
    from d3fields_tpu_torch.utils.avi import AviWriter
    from d3fields_tpu_torch.utils.png import read_png, save_png

    shutil.rmtree(IA_DIR, ignore_errors=True)
    os.makedirs(IA_DIR)
    video = os.path.join(IA_DIR, "clip.avi")
    t0 = time.perf_counter()
    with AviWriter(video) as w:
        for t in range(EVAL_FRAMES):
            w.write(eval_frame(EVAL_DRIFTS["vid_1"], t)["color"][0])
    layer = os.path.join(IA_DIR, "layer.png")
    lay = np.random.RandomState(0).randint(0, 256, (240, 427, 3)).astype(np.uint8)
    save_png(layer, lay)
    write_seconds = time.perf_counter() - t0
    fmodel, smodel, xmodel = interactive_models(dev)
    ckpt = {"fbrs": os.path.join(IA_DIR, "fbrs.pth"), "s2m": os.path.join(IA_DIR, "s2m.pth"),
            "xmem": os.path.join(IA_DIR, "XMem.pth")}
    for name, m in (("fbrs", fmodel), ("s2m", smodel), ("xmem", xmodel)):
        torch.save({k: v.cpu() for k, v in m.state_dict().items()}, ckpt[name])
    del xmodel
    ws, out = os.path.join(IA_DIR, "ws"), os.path.join(IA_DIR, "out")
    os.makedirs(out)
    base = ["--video", video, "--workspace", ws, "--size", "480", "--num_objects", "1",
            "--fbrs_ckpt", ckpt["fbrs"], "--s2m_ckpt", ckpt["s2m"], "--xmem_ckpt", ckpt["xmem"],
            *XMEM_WIDTH_ARGS]
    clicks, saved, runs, counts = [], [], {}, {}

    def interact(self, image, x, y, is_positive):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mask = interact_orig(self, image, x, y, is_positive)
        clicks.append({"ms": (time.perf_counter() - t0) * 1e3,
                       "evaluations": self.predictor.evaluations,
                       "zoom_in": self.predictor.zoom_in._object_roi is not None})
        return mask

    def save_masks(self, out_dir, names=None):
        saved.append((out_dir, list(names), self.masks.copy(), self._mask_known.copy()))
        return save_orig(self, out_dir, names)

    interact_orig, save_orig = FBRSController.interact, InteractiveSession.save_masks
    times = {}
    try:
        with mock.patch.object(FBRSController, "interact", interact), \
                mock.patch.object(InteractiveSession, "save_masks", save_masks), \
                timed_function(S2MController, "interact", times), \
                timed_function(InteractiveSession, "_xmem_step", times):
            for name, script in (("first", IA_SCRIPT.format(layer=layer, out=out)),
                                 ("resume", f"goto {EVAL_FRAMES - 1}\npropagate backward\nsave\n")):
                path = os.path.join(IA_DIR, f"{name}.txt")
                with open(path, "w") as f:
                    f.write(script)
                n_saved, n_steps = len(saved), len(times.get("_xmem_step", []))
                stdout = io.StringIO()
                with contextlib.redirect_stdout(stdout):
                    t0 = time.perf_counter()
                    code, counts[name] = reset_and_count(
                        lambda: app.main(base + ["--script", path], device=dev))
                    wall = time.perf_counter() - t0
                check(code == 0, f"interactive {name} exited with an error")
                check(sum(counts[name].values()) == 0, f"interactive {name} launched {counts}")
                for out_dir, names, masks, known in saved[n_saved:]:
                    for t, n in enumerate(names):
                        if known[t]:
                            m = read_png(os.path.join(out_dir, n))
                            check(np.array_equal(m, masks[t]),
                                  f"interactive {name}: {n} differs from the session's mask")
                runs[name] = {"wall_seconds": wall, "xmem_steps": len(times["_xmem_step"]) - n_steps,
                              "log": stdout.getvalue().splitlines()}
    finally:
        for path in ckpt.values():
            os.remove(path)
    masks = sorted(os.listdir(os.path.join(ws, "masks")))
    check(masks == [f"{t:07d}.png" for t in range(EVAL_FRAMES)], f"interactive masks {masks}")
    check(saved[-1][3].all(), "the resumed run left frames without a mask")
    for m in ("davis", "fade", "light", "popup", "layered"):
        v = read_png(os.path.join(out, f"{m}.png"))
        check(v.shape == EVAL_HW + (3,), f"interactive vis {m}: {v.shape}")
    check(len(clicks) == 3 and clicks[0]["evaluations"] == 0
          and all(c["evaluations"] >= 1 and c["zoom_in"] for c in clicks[1:]),
          f"interactive f-BRS clicks: {clicks}")

    from d3fields_tpu_torch.utils.png import imread_color

    frame0 = os.path.join(ws, "images", "0000000.png")
    rgb = np.ascontiguousarray(imread_color(frame0)[..., ::-1])
    hold = hold_fbrs_s2m(dev, fmodel, smodel, rgb, read_png(os.path.join(ws, "masks",
                                                                           "0000000.png")))
    x = torch.randn(2, 3, *EVAL_HW, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    pts = torch.tensor([[[190.0, 440.0], [-1.0, -1.0]]] * 2, device=dev)
    with torch.no_grad():
        nobrs_ms = cuda_ms(lambda: fmodel(x, pts), reps=5, warmup=2, windows=3)
    del fmodel, smodel
    torch.cuda.empty_cache()
    steps = times["_xmem_step"]
    emit({"phase": "interactive", "video_hw": list(EVAL_HW), "frames": EVAL_FRAMES, "size": 480,
          "models": {"fbrs": "FbrsConfig(): HRNet-18s, OCR 64", "s2m": "DeepLabV3+ ResNet-50",
                     "xmem": "XMemConfig()"},
          "write_seconds": write_seconds, "fbrs_clicks": clicks, "nobrs_forward_ms": nobrs_ms,
          "s2m_ms": times["interact"], "propagation_ms_per_frame": steps,
          "propagation_ms_median": float(np.median(steps)), "runs": runs,
          "card_vs_cpu": hold, "fbrs_hold_rel": FBRS_HOLD_REL, "s2m_hold_atol": S2M_HOLD_ATOL,
          "launches": counts})
    shutil.rmtree(IA_DIR, ignore_errors=True)
    return {k: sum(c[k] for c in counts.values()) for k in counts["first"]}


# ---------------------------------------------------------------------------
# slice 10: the bf16 compute dtype of DINOv2, GroundingDINO, SAM and XMem
# ---------------------------------------------------------------------------

# DINOv2 ViT-L/14's bf16 descriptors against f32 on the card, and the card's
# bf16 against the CPU's, and SAM's bf16 image embedding against f32:
# largest 1 - cos, held at the JAX package's bf16 budget
# (tests/test_dinov2.py:99). Sound and planted-fault readings: PERF.md.
BF16_FEATURE_COS = 1e-3
BF16_XMEM_FRAMES = 20
# bf16 XMem against f32, on xmem_phase's weights with the prediction head
# scaled to 100 times PyTorch's default and its bias lowered by 4, so that
# the background is decided on most pixels (at the head xmem_phase uses, no
# pixel's top two lie 0.02 apart). As tests/test_torch_xmem.py holds the
# CPU run against the JAX bf16 core: the labels agree on 99% of the pixels
# whose f32 top-two margin exceeds 0.1, which must be at least
# BF16_XMEM_MIN_DECIDED of them on every frame, and the probabilities'
# 99th-percentile drift stays under JAX's 0.1. Random weights tell the
# spheres apart by less than bf16 resolves: at a head 3 times larger some
# sphere pixels are decided and bf16 flips many of them
# (bf16_fault_readings.py; PERF.md), so only the background is held.
BF16_XMEM_HEAD_SCALE, BF16_XMEM_HEAD_BIAS = 10.0, -4.0
BF16_XMEM_MARGIN, BF16_XMEM_MIN_DECIDED, BF16_XMEM_MIN_AGREE = 0.1, 0.05, 0.99
BF16_XMEM_P99_ATOL = 0.1
BF16_SERVING_FRAMES = 2


def bf16_field_query(dev, backbone, f32_update_ms, num_requests: int = 3) -> dict:
    """The field query with a bf16 ViT-L/14 (the f32 backbone's weights
    rounded once): ``num_requests`` requests of update + batch_eval at the
    ``request`` phase's shapes; the descriptors held to the card's f32 and
    to the CPU's bf16 run of one view."""
    from d3fields_tpu_torch import D3FieldsConfig, FusionConfig, Fusion
    from d3fields_tpu_torch.fields import fusion
    from d3fields_tpu_torch.models import dinov2

    bb16 = dinov2.Dinov2Backbone(backbone.model, compute_dtype="bfloat16", device=dev)
    check(bb16.model.blocks[0].attn.qkv.weight.dtype == torch.bfloat16, "bf16 DINOv2 weights")
    fus = Fusion(config=D3FieldsConfig(fusion=FusionConfig(query_tile=TILE)),
                 feature_backend=bb16, device=dev)
    pts = np.random.RandomState(1).uniform(-0.5, 0.5, (N_POINTS, 3)).astype(np.float32)
    tiles = -(-N_POINTS // TILE)
    rows = []

    def requests():
        for r in range(num_requests):
            obs = scene(seed=100 + r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = fus.update(obs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fus.batch_eval(pts, NAMES)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            # the same query through the kernel's bf16-table route (the JAX
            # package's matmul_dtype on a TPU)
            out16 = fusion.batch_eval(state, pts, NAMES, tile=TILE, fused=True,
                                      matmul_dtype="bfloat16")
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            check(state.dino_feats.dtype == torch.float32, "bf16 DINOv2 gave non-f32 tokens")
            check(out["dino_feats"].shape == (N_POINTS, bb16.cfg.hidden_size)
                  and out16["dino_feats"].shape == out["dino_feats"].shape,
                  "bf16 field query shape")
            for k in ("dist", "dino_feats", "mask"):
                check(bool(torch.isfinite(out[k]).all() and torch.isfinite(out16[k]).all()),
                      f"bf16 field query: {k} not finite")
            route = bf16_route_reading(out16, out)
            rows.append({"update_ms": (t1 - t0) * 1e3, "batch_eval_ms": (t2 - t1) * 1e3,
                         "pts_per_s": N_POINTS / (t2 - t1),
                         "bf16_route_batch_eval_ms": (t3 - t2) * 1e3, "bf16_route": route})
            check(route["dist_equal"] and route["valid_mask_equal"] and route["mask_equal"],
                  f"the bf16 route moved the field's other outputs: {route}")
            check(route["cos_deficit"] < BF16_FEATURE_COS,
                  f"bf16 route descriptors vs the f32 route: {route}")
            del out, out16

    _, counts = reset_and_count(requests)
    check(counts["fused_weighted_interp"] == 2 * num_requests * tiles
          and counts["fused_weighted_interp_bf16"] == num_requests * tiles
          and counts["deform_gather"] == 0, f"bf16 field query launch counts {counts}")

    obs = scene(seed=100)
    profile_stage("update_bf16", lambda: fus.update(obs))
    images = obs["color"]
    with torch.no_grad():
        f16 = bb16(images, patch_hw=(24, 32))
        f32 = backbone(images, patch_hw=(24, 32))
    bb_ms = cuda_ms(lambda: bb16(images, patch_hw=(24, 32)), reps=5, warmup=1)
    cpu_model = dinov2.Dinov2(bb16.cfg, device="cpu").eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in backbone.model.state_dict().items()})
    t0 = time.perf_counter()
    f16_cpu = dinov2.Dinov2Backbone(cpu_model, compute_dtype="bfloat16", device="cpu")(
        images[:1], patch_hw=(24, 32))
    cpu_seconds = time.perf_counter() - t0
    vs_f32, vs_cpu = cos_deficit(f16, f32), cos_deficit(f16[:1].cpu(), f16_cpu)
    emit({"phase": "bf16", "path": "field_query", "requests": rows,
          "update_ms": [r["update_ms"] for r in rows], "f32_update_ms": f32_update_ms,
          "backbone_ms": bb_ms, "cos_deficit_vs_f32": vs_f32,
          "cos_deficit_vs_cpu_bf16_view0": vs_cpu,
          "max_abs_err_vs_f32": float((f16 - f32).abs().max()),
          "feature_scale": float(f32.abs().max()), "cpu_seconds": cpu_seconds,
          "cos_tol": BF16_FEATURE_COS, "launches": counts})
    check(f16.dtype == torch.float32 and vs_f32 < BF16_FEATURE_COS,
          f"bf16 DINOv2 descriptors vs f32: 1 - cos {vs_f32}")
    check(vs_cpu < BF16_FEATURE_COS, f"bf16 DINOv2 descriptors card vs CPU: 1 - cos {vs_cpu}")
    return counts


def bf16_route_reading(got: dict, want: dict) -> dict:
    """A field query through the kernel's bf16 route (``got``) against the
    same query through its f32 route: the descriptors' largest 1 - cos
    over the points whose f32 descriptor is not zero, and whether the
    outputs that do not pass through the kernel are equal."""
    keep = want["dino_feats"].norm(dim=-1) > 1e-3
    return {"cos_deficit": cos_deficit(got["dino_feats"][keep], want["dino_feats"][keep]),
            "max_abs_err": float((got["dino_feats"] - want["dino_feats"]).abs().max()),
            "points_compared": int(keep.sum()),
            "dist_equal": bool(torch.equal(got["dist"], want["dist"])),
            "valid_mask_equal": bool(torch.equal(got["valid_mask"], want["valid_mask"])),
            "mask_equal": bool(torch.equal(got["mask"], want["mask"]))}


def bf16_segment(dev, seg_backend, num_requests: int = 3) -> dict:
    """``segment_views`` with GroundingDINO (gated trunk in bf16) and SAM
    (ViT-H trunk in bf16) built from the ``segment`` phase's f32 models, on
    its rigs: ``num_requests`` requests, then the detector held to the f32
    detector (``compare_detector_dtypes``) and SAM's bf16 image
    embedding to its f32 one (1 - cos, as the DINOv2 descriptors)."""
    from d3fields_tpu_torch.models.groundingdino.detector import (
        GroundingDinoDetector, tokenize_classes)
    from d3fields_tpu_torch.models.sam.predictor import SamPredictor
    from d3fields_tpu_torch.seg.grounded_sam import GroundedSAMBackend

    det32, sam32 = seg_backend.detector, seg_backend.sam
    det16 = GroundingDinoDetector(det32.model, tokenize=tokenize, device=dev,
                                  compute_dtype="bfloat16")
    sam16 = SamPredictor(sam32.model, device=dev, compute_dtype="bfloat16")
    backend = GroundedSAMBackend(det16, sam16)
    gcfg = det16.model.cfg
    rigs = [scene(seed=300 + r)["color"] for r in range(num_requests)]
    thr, at_thr = pick_box_threshold(det16, rigs)
    times, rows = {}, []
    instrument(det16, "predict_with_classes_batch", "detector_ms", times)
    instrument(sam16, "set_images", "sam_encode_ms", times)
    instrument(sam16, "predict_boxes_views", "sam_decode_ms", times)

    def requests():
        for r, images in enumerate(rigs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            views = backend.segment_views(images, SEG_QUERIES, [thr])
            torch.cuda.synchronize()
            boxes = [len(vm.labels) - 1 for vm in views]
            rows.append({"request": r, **times, "total_ms": (time.perf_counter() - t0) * 1e3,
                         "boxes_per_view": boxes})
            check_view_masks(views, images.shape[1:3], SEG_QUERIES)
            check(boxes == at_thr[r], f"bf16 boxes per view {boxes}, the pick read {at_thr[r]}")

    _, counts = reset_and_count(requests)
    n = num_requests
    check(counts["deform_gather"] == n * (gcfg.encoder_layers + gcfg.decoder_layers)
          and counts["deform_gather_bf16"] == n * gcfg.encoder_layers
          and counts["fused_weighted_interp"] == 0, f"bf16 segmentation launch counts {counts}")
    for obj, method in ((det16, "predict_with_classes_batch"), (sam16, "set_images"),
                        (sam16, "predict_boxes_views")):
        delattr(obj, method)
    profile_stage("segment_views_bf16", lambda: backend.segment_views(rigs[0], SEG_QUERIES, [thr]))

    ids = np.repeat(tokenize_classes(SEG_QUERIES, tokenize)[0], len(rigs[0]), axis=0)
    pixels = det32.prep(rigs[0])
    compare_detector_dtypes("f32_detector", detector_intermediates(det16.model, pixels, ids),
                            detector_intermediates(det32.model, pixels, ids))
    with torch.no_grad():
        e16 = sam16.model.encode(sam16.prep(rigs[0]))
        e32 = sam32.model.encode(sam32.prep(rigs[0]))
    sam_cos = cos_deficit(e16, e32)
    emit({"phase": "bf16", "path": "segment_views", "requests": rows, "box_threshold": thr,
          "detector": "groundingdino_swin_t_random, gated trunk bf16",
          "sam": "sam_vit_h_random, trunk bf16",
          "sam_embedding_cos_deficit_vs_f32": sam_cos,
          "sam_embedding_max_abs_err_vs_f32": float((e16 - e32).abs().max()),
          "cos_tol": BF16_FEATURE_COS, "launches": counts})
    check(e16.dtype == torch.float32 and sam_cos < BF16_FEATURE_COS,
          f"SAM's bf16 image embedding vs f32: 1 - cos {sam_cos}")
    return counts


def xmem_deciding_model(dev, cfg, seed: int, scale: float = BF16_XMEM_HEAD_SCALE,
                        bias: float = BF16_XMEM_HEAD_BIAS):
    """``xmem_model`` with the prediction head scaled by ``scale`` and
    ``bias`` added to its bias: weights under which the labels are decided
    on part of the sphere frames."""
    model = xmem_model(dev, cfg, seed)
    with torch.no_grad():
        model.decoder.pred.weight.mul_(scale)
        model.decoder.pred.bias.add_(bias)
    return model


def xmem_dtype_reading(got, want) -> dict:
    """One frame's probabilities (V, O+1, H, W) of the bf16 run against the
    f32 run's: the largest and the 99th-percentile drift, the share of
    pixels whose f32 top-two margin exceeds BF16_XMEM_MARGIN (decided), and
    the label agreement over all pixels and over the decided ones, and the
    decided pixels' f32 labels counted (background, sphere 1, sphere 2)."""
    top2 = np.sort(want, axis=1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > BF16_XMEM_MARGIN
    same = got.argmax(1) == want.argmax(1)
    return {"max_abs_err": max_err(got, want),
            "p99_abs_err": float(np.quantile(np.abs(got - want), 0.99)),
            "decided_share": float(sure.mean()),
            "decided_labels": np.bincount(want.argmax(1)[sure], minlength=want.shape[1]).tolist(),
            "label_agreement": float(same.mean()),
            "label_agreement_decided": float(same[sure].mean()) if sure.any() else None}


def xmem_track(dev, model, cfg, frames: int) -> dict:
    """A tracker of ``model`` under ``cfg`` over ``frames`` sphere frames after
    the seed: each frame's ms, probabilities and whether it was a memory
    frame, and the tracker."""
    from d3fields_tpu_torch.seg.video_tracker import VideoMaskTracker

    tr = VideoMaskTracker(model, cfg, 4, 2, XMEM_RIG_HW, size=cfg.size, device=dev)
    out = {"ms": [], "probs": [], "memory": [], "tracker": tr}
    for t in range(frames + 1):
        sc = sphere_frame(t)
        rgb = np.ascontiguousarray(sc["color"][..., ::-1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.process(rgb, sc["index"] if t == 0 else None)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["probs"].append(tr.last_prob.cpu().numpy())
        out["memory"].append(tr.core.last_mem_ti == t)
    return out


def xmem_dtype_runs(dev, frames: int, **head) -> tuple:
    """f32 and bf16 trackers of ``xmem_deciding_model``'s weights (``head``:
    its ``scale`` and ``bias``) over ``frames`` sphere frames after the
    seed: each one's ``xmem_track``, and the bf16 run's launches (the f32
    run is the reference, not counted)."""
    from d3fields_tpu_torch.config import XMemConfig

    cfg32 = XMemConfig()
    cfg16 = dataclasses.replace(cfg32, compute_dtype="bfloat16")
    model = xmem_deciding_model(dev, cfg32, seed=5, **head)
    runs = {"f32": xmem_track(dev, model, cfg32, frames)}
    runs["bf16"], counts = reset_and_count(lambda: xmem_track(dev, model, cfg16, frames))
    check(runs["bf16"]["tracker"].core.model.decoder.pred.weight.dtype == torch.bfloat16,
          "bf16 XMem weights")
    return runs, counts


def bf16_xmem(dev, frames: int = BF16_XMEM_FRAMES) -> dict:
    """``xmem_phase``'s scene with ``XMemConfig(compute_dtype='bfloat16')``
    for ``frames`` frames after the seed, beside an f32 tracker of the same
    weights (``xmem_deciding_model``) on the same frames: each one's ms a
    frame, and the bf16 probabilities and decided labels against the f32
    ones."""
    runs, counts = xmem_dtype_runs(dev, frames)
    check(sum(counts.values()) == 0, f"the bf16 xmem path launched {counts}")
    agree = []
    for t in range(frames + 1):
        got, want = runs["bf16"]["probs"][t], runs["f32"]["probs"][t]
        check(np.isfinite(got).all() and got.dtype == np.float32, f"bf16 xmem frame {t}")
        agree.append({"frame": t, **xmem_dtype_reading(got, want)})
    check(agree[0]["max_abs_err"] <= 1e-6, f"bf16 xmem seed frame vs f32: {agree[0]}")
    for a in agree[1:]:
        check(a["decided_share"] >= BF16_XMEM_MIN_DECIDED,
              f"bf16 xmem frame {a['frame']}: too few decided pixels to hold the labels: {a}")
        check(a["label_agreement_decided"] >= BF16_XMEM_MIN_AGREE,
              f"bf16 xmem labels vs f32: {a}")
        check(a["p99_abs_err"] < BF16_XMEM_P99_ATOL, f"bf16 xmem probabilities vs f32: {a}")

    def medians(name, memory):
        run = runs[name]
        return float(np.median([m for m, f in zip(run["ms"][1:], run["memory"][1:])
                                if f == memory]))

    emit({"phase": "bf16", "path": "xmem", "frames": frames,
          "xmem_hw": list(runs["bf16"]["tracker"].resized_hw),
          "head": {"scale": BF16_XMEM_HEAD_SCALE, "bias": BF16_XMEM_HEAD_BIAS},
          "normal_frame_ms_median": medians("bf16", False),
          "memory_frame_ms_median": medians("bf16", True),
          "f32_normal_frame_ms_median": medians("f32", False),
          "f32_memory_frame_ms_median": medians("f32", True),
          "frame_ms": runs["bf16"]["ms"], "f32_frame_ms": runs["f32"]["ms"],
          "memory_frames": [t for t, f in enumerate(runs["bf16"]["memory"]) if f],
          "vs_f32": agree, "margin": BF16_XMEM_MARGIN, "min_decided": BF16_XMEM_MIN_DECIDED,
          "min_agreement": BF16_XMEM_MIN_AGREE, "p99_atol": BF16_XMEM_P99_ATOL,
          "launches": counts})
    return counts, runs["f32"]["tracker"].core.model


def bf16_phase(dev, backbone, seg_backend, f32_update_ms) -> tuple:
    """Slice 10's path, the bf16 compute dtype at full width: the field
    query with a bf16 DINOv2 (and, since slice 11, through the kernel's
    bf16-table route), segmentation with bf16 GroundingDINO and SAM
    trunks, XMem in bf16, and the serving step with both DINOv2 and XMem in
    bf16. Each part's counts are read around its own driven requests.
    Returns the summed launches and the f32 XMem model of the XMem part."""
    counts = {"field_query": bf16_field_query(dev, backbone, f32_update_ms),
              "segment_views": bf16_segment(dev, seg_backend)}
    counts["xmem"], xmodel = bf16_xmem(dev)
    counts["serving_step"], _ = serving_step(dev, BF16_SERVING_FRAMES,
                                             compute_dtype="bfloat16")
    total = {k: sum(c[k] for c in counts.values()) for k in counts["field_query"]}
    emit({"phase": "bf16", "path": "summary", "launches": counts, "total": total})
    return total, xmodel


# ---------------------------------------------------------------------------
# slice 11: multi-device inference (parallel/ and the four shard_views)
# ---------------------------------------------------------------------------

# the JAX package's tolerances for its sharded functions
# (tests/test_parallel_train.py): DINOv2 rtol 1e-4 / atol 1e-5; XMem
# probabilities atol 2e-3; sync_batch_norm rtol 2e-4 / atol 2e-4. SAM's
# embedding at tests/test_torch_sam.py's encoder tolerance, 1e-4 / 1e-4.
# The detector's boxes and confidences (rtol 1e-5 / atol 1e-4 and 1e-6
# there) cannot hold at full width on random weights: a forward of 2
# views and one of 4 round the GEMMs apart, and the near-tied proposal
# ranks reorder the selected queries (boxes 0.62 apart on an NVIDIA H100
# 80GB HBM3, 700 W; PERF.md), so the detector is held by
# compare_detections (f32) and compare_detector_dtypes (bf16).
PAR_DINO_TOL = dict(rtol=1e-4, atol=1e-5)
PAR_SAM_TOL = dict(rtol=1e-4, atol=1e-4)
PAR_XMEM_ATOL, PAR_BN_TOL = 2e-3, dict(rtol=2e-4, atol=2e-4)
PAR_XMEM_FRAMES = 6  # a memory frame (5) among them
PAR_SAM_BOXES = [np.array([[40.0, 30.0, 200.0, 180.0], [100.0, 60.0, 300.0, 220.0]], np.float32),
                 np.zeros((0, 4), np.float32),
                 np.array([[10.0, 10.0, 120.0, 100.0]], np.float32),
                 np.array([[60.0, 40.0, 260.0, 230.0]], np.float32)]


def sharded_field_query(dev, state, pts, mesh1, mesh2) -> dict:
    """``sharded_batch_eval`` of ``pts`` at dp = 1 over ``[dev]`` (held bit
    for bit to ``batch_eval``) and dp = 2 over ``[dev, dev]`` (held at the
    kernel's tolerance, ``valid_mask`` equal), through the kernel's f32 and
    bf16 routes. The unsharded reference runs outside the counted calls."""
    from d3fields_tpu_torch.fields import fusion
    from d3fields_tpu_torch.parallel import sharded_batch_eval

    rows = []

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    for md in ("float32", "bfloat16"):
        ref, ref_ms = timed(lambda: fusion.batch_eval(state, pts, NAMES, tile=TILE, fused=True,
                                                      matmul_dtype=md))

        def sharded():
            outs = {}
            for label, mesh in (("dp1", mesh1), ("dp2", mesh2)):
                outs[label] = timed(lambda: sharded_batch_eval(
                    mesh, state, pts, NAMES, tile=TILE, fused=True, matmul_dtype=md))
            return outs

        outs, counts = reset_and_count(sharded)
        row = {"matmul_dtype": md, "points": int(pts.shape[0]), "batch_eval_ms": ref_ms,
               "launches": counts}
        for label, (out, ms) in outs.items():
            errs = {k: float((out[k].float() - ref[k].float()).abs().max()) for k in ref}
            row[label] = {"ms": ms, "max_abs_err": errs,
                          "equal": all(torch.equal(out[k], ref[k]) for k in ref),
                          "close": all(torch.allclose(out[k].float(), ref[k].float(),
                                                      rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
                                       for k in ref),
                          "device": str(out["dist"].device)}
        rows.append(row)
        emit({"phase": "parallel", "path": "sharded_batch_eval", **row})
        check(row["dp1"]["equal"], f"sharded_batch_eval at dp = 1 differs from batch_eval ({md})")
        check(row["dp2"]["close"] and torch.equal(outs["dp2"][0]["valid_mask"], ref["valid_mask"]),
              f"sharded_batch_eval at dp = 2 disagrees with batch_eval ({md}): {row['dp2']}")
        tiles = -(-pts.shape[0] // TILE)
        check(counts["fused_weighted_interp"] == 2 * tiles and counts["fused_weighted_interp_bf16"]
              == (2 * tiles if md == "bfloat16" else 0), f"sharded field query launches {counts}")
        del ref, outs
    return {k: sum(r["launches"][k] for r in rows) for k in rows[0]["launches"]}


def sharded_views(dev, backbone, seg_backend, xmodel, mesh2) -> dict:
    """``shard_views`` at dp = 2 over ``[dev, dev]`` on the models of the
    earlier phases (new wrappers, the same weights: a repeated device shares
    one replica), each held to its unsharded self on a 4-view rig: DINOv2
    ViT-L/14, GroundingDINO swin-T in f32 and with its bf16 trunk (each
    shard's forward launching deform_gather on its 2 views, the bf16-table
    route for the bf16 encoder), SAM ViT-H's embeddings and box decode, and
    XMem for PAR_XMEM_FRAMES frames (labels held off the near-ties).
    Returns the launches of the sharded calls."""
    from d3fields_tpu_torch.config import XMemConfig
    from d3fields_tpu_torch.models import dinov2
    from d3fields_tpu_torch.models.groundingdino.detector import (
        GroundingDinoDetector, tokenize_classes)
    from d3fields_tpu_torch.models.sam.predictor import SamPredictor

    counts, report = [], {}

    def counted(fn):
        out, c = reset_and_count(fn)
        counts.append(c)
        return out

    def ms_of(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    images = scene(seed=100)["color"]
    bb2 = dinov2.Dinov2Backbone(backbone.model, device=dev).shard_views(mesh2)
    check(bb2.model is backbone.model, "a repeated device must share the backbone's replica")
    f2 = counted(lambda: bb2(images, patch_hw=(24, 32)))
    f1 = backbone(images, patch_hw=(24, 32))
    report["dinov2"] = {"max_abs_err": float((f2 - f1).abs().max()),
                        "cos_deficit": cos_deficit(f2, f1), "equal": bool(torch.equal(f2, f1)),
                        "sharded_ms": ms_of(lambda: bb2(images, patch_hw=(24, 32))),
                        "unsharded_ms": ms_of(lambda: backbone(images, patch_hw=(24, 32)))}
    check(f2.shape == f1.shape and torch.allclose(f2, f1, **PAR_DINO_TOL),
          f"DINOv2 sharded vs unsharded: {report['dinov2']}")

    rig = scene(seed=300)["color"]
    ids = tokenize_classes(SEG_QUERIES, tokenize)[0]
    det_model = seg_backend.detector.model
    for dtype in ("float32", "bfloat16"):
        one = GroundingDinoDetector(det_model, tokenize=tokenize, device=dev, compute_dtype=dtype)
        two = GroundingDinoDetector(det_model, tokenize=tokenize, device=dev,
                                    compute_dtype=dtype).shard_views(mesh2)
        l2, b2 = counted(lambda: two.forward_views(rig, ids))
        # each shard's forward read with hooks, as forward_views runs it
        shards = [detector_intermediates(two._views.replicas[d], two.prep(x),
                                         np.repeat(ids, x.shape[0], axis=0))
                  for d, x in zip(two._views.devices, two._views.split(rig))]
        sharded = {k: torch.cat([p[k] for p in shards]) for k in shards[0]}
        check(torch.equal(sharded["logits"], l2.cpu()) and torch.equal(sharded["boxes"], b2.cpu()),
              "the shards' hooked forwards differ from forward_views")
        whole = detector_intermediates(one.model, one.prep(rig), np.repeat(ids, len(rig), axis=0))
        report[f"groundingdino_{dtype}"] = {
            "boxes_max_abs_err": float((sharded["boxes"] - whole["boxes"]).abs().max()),
            "equal": bool(torch.equal(sharded["logits"], whole["logits"])
                          and torch.equal(sharded["boxes"], whole["boxes"])),
            "sharded_ms": ms_of(lambda: two.forward_views(rig, ids)),
            "unsharded_ms": ms_of(lambda: one.forward_views(rig, ids)),
            "launches": counts[-1]}
        # where the split's time goes: the device's busy time and idle share,
        # and the host's waits for the device, in a traced forward of each
        for label, det in (("dp2", two), ("dp1", one)):
            row = profile_stage(f"parallel_groundingdino_{dtype}_{label}",
                                lambda: det.forward_views(rig, ids), top=5)
            report[f"groundingdino_{dtype}"][f"trace_{label}"] = {
                k: row[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                    "device_ops", "host_waits", "host_wait_ms")}
        # two views a forward round the GEMMs otherwise than four, and the
        # random model's near-tied proposal ranks turn that into reordered
        # queries: held as the kernel is held to the plain gather (f32) and
        # as bf16 is held to f32
        if dtype == "float32":
            compare_detections("unsharded_4_views", sharded, whole)
        else:
            compare_detector_dtypes("unsharded_4_views_bf16", sharded, whole)
        layers = det_model.cfg.encoder_layers + det_model.cfg.decoder_layers
        check(counts[-1]["deform_gather"] == 2 * layers and counts[-1]["deform_gather_bf16"] ==
              (2 * det_model.cfg.encoder_layers if dtype == "bfloat16" else 0),
              f"sharded detector launches {counts[-1]}")
        del one, two

    sam1 = SamPredictor(seg_backend.sam.model, device=dev)
    sam2 = SamPredictor(seg_backend.sam.model, device=dev).shard_views(mesh2)
    got = counted(lambda: sam2.set_images(rig).predict_boxes_views(PAR_SAM_BOXES))
    want = sam1.set_images(rig).predict_boxes_views(PAR_SAM_BOXES)
    e2, e1 = sam2.image_embeddings(), sam1.image_embeddings()
    agree = [float((m2 == m1).float().mean()) for (m2, _), (m1, _) in zip(got, want) if len(m1)]
    iou_err = max(float((i2 - i1).abs().max()) for (_, i2), (_, i1) in zip(got, want) if len(i1))
    report["sam"] = {"embedding_max_abs_err": float((e2 - e1).abs().max()),
                     "embedding_scale": float(e1.abs().max()), "mask_agreement": agree,
                     "iou_max_abs_err": iou_err,
                     "sharded_encode_ms": ms_of(lambda: sam2.set_images(rig)),
                     "unsharded_encode_ms": ms_of(lambda: sam1.set_images(rig))}
    check(torch.allclose(e2, e1, **PAR_SAM_TOL) and min(agree) > 0.999 and iou_err < 1e-3,
          f"SAM sharded vs unsharded: {report['sam']}")
    del sam1, sam2, e1, e2

    cfg = XMemConfig()
    runs = {}
    for label in ("unsharded", "sharded"):
        def track(label=label):
            from d3fields_tpu_torch.seg.video_tracker import VideoMaskTracker

            tr = VideoMaskTracker(xmodel, cfg, 4, 2, XMEM_RIG_HW, size=cfg.size, device=dev)
            if label == "sharded":
                tr.core.shard_views(mesh2)
            probs, ms = [], []
            for t in range(PAR_XMEM_FRAMES + 1):
                sc = sphere_frame(t)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.process(np.ascontiguousarray(sc["color"][..., ::-1]),
                           sc["index"] if t == 0 else None)
                ms.append((time.perf_counter() - t0) * 1e3)
                probs.append(tr.last_prob.cpu().numpy())
            return probs, ms, tr.core
        runs[label] = counted(track) if label == "sharded" else track()
    frames = [xmem_dtype_reading(g, w) for g, w in zip(runs["sharded"][0], runs["unsharded"][0])]
    core = runs["sharded"][2]
    report["xmem"] = {"frames": PAR_XMEM_FRAMES, "vs_unsharded": frames,
                      "groups": len(core.mems), "memory_frames": core.last_mem_ti,
                      "sharded_frame_ms": runs["sharded"][1],
                      "unsharded_frame_ms": runs["unsharded"][1]}
    for t, f in enumerate(frames):
        check(f["max_abs_err"] <= PAR_XMEM_ATOL and f["decided_share"] > 0 and
              f["label_agreement_decided"] == 1.0,
              f"XMem sharded vs unsharded, frame {t}: {f}")
    check(core.last_mem_ti > 0, "no memory frame in the sharded XMem run")
    emit({"phase": "parallel", "path": "shard_views", "dp": 2, "devices": [str(dev)] * 2,
          **report})
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def nccl_collectives(dev) -> dict:
    """``initialize_distributed`` over NCCL at world size 1 (an explicit
    ``localhost`` address), where ``sync_batch_norm`` must equal a global
    batch norm and ``all_gather_points`` the identity."""
    import socket

    from d3fields_tpu_torch.parallel import (
        all_gather_points, initialize_distributed, sync_batch_norm)

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    check(initialize_distributed(f"localhost:{port}", 1, 0, device=dev), "initialize_distributed")
    try:
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn(8, 6, 6, 16, device=dev, generator=g)
        scale = torch.rand(16, device=dev, generator=g) + 0.5
        bias = torch.randn(16, device=dev, generator=g)
        y, mean, var = sync_batch_norm(x, scale, bias)
        ref = F.batch_norm(x.permute(0, 3, 1, 2), None, None, scale, bias, training=True,
                           eps=1e-5).permute(0, 2, 3, 1)
        pts = torch.randn(1000, 3, device=dev, generator=g)
        gathered = all_gather_points(pts)
        row = {"backend": torch.distributed.get_backend(), "world_size":
               torch.distributed.get_world_size(),
               "bn_max_abs_err": float((y - ref).abs().max()),
               "mean_max_abs_err": float((mean - x.mean((0, 1, 2))).abs().max()),
               "gather_equal": bool(torch.equal(gathered, pts))}
    finally:
        torch.distributed.destroy_process_group()
    emit({"phase": "parallel", "path": "collectives", **row})
    check(row["backend"] == ("nccl" if dev.type == "cuda" else "gloo")
          and torch.allclose(y, ref, **PAR_BN_TOL)
          and row["gather_equal"], f"NCCL collectives: {row}")
    return row


def parallel_phase(dev, backbone, seg_backend, xmodel) -> dict:
    """Slice 11's path, multi-device inference, on the one card: meshes of
    ``[dev]`` and of ``[dev, dev]`` (dp = 2 on one device runs the split,
    replication and gather code of two devices, not two cards). The field
    query of a new observation through ``sharded_batch_eval`` (f32 and bf16
    routes, 1,048,576 points), ``shard_views`` of DINOv2, GroundingDINO,
    SAM and XMem, and the collectives over NCCL. Returns the launches of
    the sharded calls."""
    from d3fields_tpu_torch import D3FieldsConfig, FusionConfig, Fusion
    from d3fields_tpu_torch.parallel import make_mesh

    mesh1, mesh2 = make_mesh(1, devices=[dev]), make_mesh(2, devices=[dev, dev])
    fus = Fusion(config=D3FieldsConfig(fusion=FusionConfig(query_tile=TILE)),
                 feature_backend=backbone, device=dev)
    state = fus.update(scene(seed=101))
    pts = np.random.RandomState(2).uniform(-0.5, 0.5, (N_POINTS, 3)).astype(np.float32)
    field = sharded_field_query(dev, state, pts, mesh1, mesh2)
    views = sharded_views(dev, backbone, seg_backend, xmodel, mesh2)
    nccl_collectives(dev)
    total = {k: field[k] + views[k] for k in field}
    emit({"phase": "parallel", "path": "summary", "launches": total})
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    from d3fields_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda")
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "tf32_cudnn": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    seconds = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": seconds,
          "ptxas": {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
                    for k, v in _build.build_log.items()}})

    wall, t_lap = {"build": time.perf_counter() - t0}, [time.perf_counter()]

    def lap(name: str) -> None:
        """Record the wall seconds of the phase that just ended."""
        now = time.perf_counter()
        wall[name], t_lap[0] = now - t_lap[0], now

    rows = [check_fused_weighted_interp(dev), check_field_tile(dev), check_deform_gather(dev),
            check_sam_attention(dev), check_vit_attention(dev)]
    lap("kernel_check")
    by_path = {}
    by_path["serve"], backbone, f32_update_ms = serve(dev)
    torch.cuda.empty_cache()
    lap("serve")
    by_path["segment"], seg_backend = segment(dev)
    lap("segment")
    by_path["golden"] = golden(dev)
    lap("golden")
    by_path["vis_repr"] = vis_repr_full(dev)
    lap("vis_repr")
    by_path["vis_repr_backends"] = vis_repr_backends(dev, backbone, seg_backend)
    lap("vis_repr_backends")
    by_path["bf16"], xmodel = bf16_phase(dev, backbone, seg_backend, f32_update_ms)
    torch.cuda.empty_cache()
    lap("bf16")
    by_path["parallel"] = parallel_phase(dev, backbone, seg_backend, xmodel)
    del backbone, seg_backend, xmodel
    torch.cuda.empty_cache()
    lap("parallel")
    by_path["tracking"] = tracking(dev)
    torch.cuda.empty_cache()
    lap("tracking")
    by_path["xmem"] = xmem_phase(dev)
    torch.cuda.empty_cache()
    lap("xmem")
    by_path["serving_step"], serving_ms = serving_step(dev)
    torch.cuda.empty_cache()
    lap("serving_step")
    by_path["recorded_scene"] = recorded_scene(dev, serving_ms)
    torch.cuda.empty_cache()
    lap("recorded_scene")
    by_path["eval_xmem"] = eval_xmem(dev)
    torch.cuda.empty_cache()
    lap("eval_xmem")
    by_path["train_xmem"] = train_xmem(dev)
    torch.cuda.empty_cache()
    lap("train_xmem")
    by_path["click_track"] = click_track(dev)
    torch.cuda.empty_cache()
    lap("click_track")
    by_path["interactive"] = interactive(dev)
    lap("interactive")
    emit({"phase": "phase_seconds", **wall, "total": time.perf_counter() - t0})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    for row in rows:
        row["launches_by_path"] = {path: c[row["name"]] for path, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    # each bf16-table route's own launches (counted in its kernel's too)
    for row in rows:
        bf16 = row.get("bf16_route")
        if bf16 is None:
            continue
        bf16["launches_by_path"] = {path: c.get(f"{row['name']}_bf16", 0)
                                    for path, c in by_path.items()}
        bf16["launches"] = sum(bf16["launches_by_path"].values())
        for path in ("bf16", "parallel"):
            check(bf16["launches_by_path"][path] > 0,
                  f"the {path} phase launched no bf16-table {row['name']}")
    emit({"kernels": [{k: row.get(k) for k in keys + ("launches_by_path", "bf16_route")}
                      for row in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

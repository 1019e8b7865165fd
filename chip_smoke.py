#!/usr/bin/env python3
"""GPU smoke run of d3fields_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU (Hopper):

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``d3fields_tpu_torch/csrc``
with nvcc (one nvcc per source, all started together), holds each against
its plain PyTorch version on the card, at the main path's shapes and at a
shape for every route of the kernel, and times it (``fused_weighted_interp``
through every route that fits, at the shapes where the wrapper picks each),
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
6. ``tracking``: vis_tracking's staged loop at full width (4 frames of 4
   views at 240x320, 1,024-d descriptors, 100 keypoints per instance from
   a 36M-point grid, 100 Adam steps a frame), the recovered drift checked
   and frame 0's keypoints held to the CPU's;
7. ``xmem``: ``VideoMaskTracker.process`` with a full-width XMem (ResNet-50
   key and ResNet-18 value encoders, ``XMemConfig()``) on the drifting
   spheres, seeded on frame 0 and propagated 70 frames at 480x640
   (consolidations at frames 45 and 70), frames 0-5 held to the CPU;
8. ``serving_step``: DINOv2 ViT-L/14 -> XMem propagation -> field -> rigid
   tracking, frames 1-4 staged (``Fusion.update`` ->
   ``text_queries_for_inst_mask`` -> ``rigid_tracking_steps``), through
   ``FusedFrameStep.step`` and through ``step_segment``, held together.

Every kernel's launch counter is set to 0 just before each path's requests
and read just after them, so the run shows each path went through its
kernels (the tracking, XMem and serving-step paths have none: the
tracking loss differentiates the unfused field query, as in the JAX
package, and XMem runs no TPU kernel there either). After the counted
requests, one more request of each path is traced with torch.profiler for the device time by
kernel and the device's idle share (traces under build/traces/), and each
kernel is held and timed on the inputs a request gives it: one field-query
tile, and the first encoder and decoder layers of one detection. The
apps write their outputs under build/chip_smoke/.

Output: one JSON object per phase, then the ``kernels`` line, then the
card's name and power limit as nvidia-smi gives them, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero without that line. With no CUDA device it exits with 2.
TF32 is off for matmul and cuDNN, so every comparison is in full float32.
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

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor-core) peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

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


def kernel_time(kernel: str, shape: str, fns: dict, moved: int, flops: int, **extra) -> dict:
    """Times each callable of ``fns`` (a None stays None), emits one
    ``kernel_time`` line with the bound of the work, and returns its times
    and bound. The bound counts ``moved`` bytes at the HBM rate and
    ``flops`` at the float32 peak."""
    times = {k: (cuda_ms(f) if f is not None else None) for k, f in fns.items()}
    bytes_ms, ops_ms = moved / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
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
    # tests/test_kernels.py:27-48: taps fall outside, C not a multiple of 4 (direct)
    "edge": (3, (6, 8), 130, 77, (48, 64), (-5.0, 70.0)),
    "one_view": (1, (24, 32), 1024, 4097, (240, 320), (-10.0, 330.0)),
    "narrow": (2, (6, 8), 3, 1000, (48, 64), (-5.0, 70.0)),
}


def fused_route(feats, idx, w, cs: int):
    """One launch of the field-query kernel's C entry with its route forced
    (``cs`` channels per slice, 0 for the direct gather), to hold and time
    the routes against each other on the same inputs. Counts no launch."""
    from d3fields_tpu_torch.fields import kernels

    V, P, C = feats.shape
    N = idx.shape[1]
    out = torch.empty((N, C), dtype=torch.float32, device=feats.device)
    err = kernels._kernel()(feats.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
                            V, P, N, C, cs, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"fused_weighted_interp with {cs}-channel slices: CUDA error {err}")
    return out


def time_fused_weighted_interp(shape: str, feats, idx, w, **extra) -> dict:
    """The kernel, its plain version and ``F.embedding_bag`` on one input."""
    from d3fields_tpu_torch.fields import kernels

    V, P, C = feats.shape
    N = idx.shape[1]
    flat_idx = (idx.long() + (torch.arange(V, device=idx.device) * P)[:, None, None])
    flat_idx = flat_idx.permute(1, 0, 2).reshape(N, 4 * V).contiguous()
    flat_w = w.permute(1, 0, 2).reshape(N, 4 * V).contiguous()
    table = feats.reshape(V * P, C)

    def library():
        return F.embedding_bag(flat_idx, table, mode="sum", per_sample_weights=flat_w)

    lib_err, _ = compare(library(), kernels.fused_weighted_interp_plain(feats, idx, w))
    moved = (feats.numel() + idx.numel() + w.numel() + N * C) * 4
    return kernel_time(
        "fused_weighted_interp", shape,
        {"ms": lambda: kernels.fused_weighted_interp(feats, idx, w),
         "plain_ms": lambda: kernels.fused_weighted_interp_plain(feats, idx, w),
         "library_ms": library},
        moved, 2 * 4 * V * N * C, slice_channels=kernels.slice_channels(V, P, C),
        library_max_abs_err=lib_err, **extra)


# the shapes at which every route that fits is held and timed, so that the
# run shows whether kernels.slice_channels picks the fastest
ROUTE_SHAPES = ("main", "slice8")


def time_routes(label: str, feats, idx, w, ref) -> tuple:
    """Every route the table fits, forced, held to the plain version's
    ``ref`` and timed; one ``route_choice`` line says which the wrapper
    picks and which was fastest. Returns (route_ms, worst error)."""
    from d3fields_tpu_torch.fields import kernels

    V, P, C = feats.shape
    fits = [cs for cs in kernels.SLICE_CHANNELS
            if cs <= C and V * P * cs * 4 <= kernels.SMEM_PER_BLOCK]
    route_ms, worst = {}, 0.0
    for cs in fits + [0]:
        out = fused_route(feats, idx, w, cs)
        torch.cuda.synchronize()
        err, ok = compare(out, ref)
        route_ms[cs] = cuda_ms(lambda: fused_route(feats, idx, w, cs))
        emit({"phase": "kernel_check", "kernel": "fused_weighted_interp",
              "shape": f"{label}_slices_{cs}", "slice_channels": cs, "max_abs_err": err,
              "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL, "ok": ok, "ms": route_ms[cs]})
        check(ok, f"fused_weighted_interp with {cs}-channel slices disagrees at {label}")
        worst = max(worst, err)
    emit({"phase": "route_choice", "kernel": "fused_weighted_interp", "shape": label,
          "V": V, "P": P, "C": C, "N": idx.shape[1], "picked": kernels.slice_channels(V, P, C),
          "fastest": min(route_ms, key=route_ms.get),
          "route_ms": {str(k): v for k, v in route_ms.items()}})
    return route_ms, worst


def check_fused_weighted_interp(dev):
    """The kernel against its plain version at the main path's shape, at a
    shape for each route and at edge shapes; at ROUTE_SHAPES, every route
    that fits, each timed."""
    from d3fields_tpu_torch.fields import kernels

    worst = 0.0
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
        del feats, idx, w, out, ref

    times = time_fused_weighted_interp(
        "main", *main, route_ms={str(k): v for k, v in main_route_ms.items()})
    return {"name": "fused_weighted_interp", "route": "cuda",
            "source": "d3fields_tpu_torch/csrc/fused_interp.cu",
            "replaces": "d3fields_tpu/fields/kernels.py:144", "max_abs_err": worst, **times}


def capture_interp_inputs(state, pts):
    """The (feats, idx, w) that ``eval_field_fused`` hands the kernel for one
    tile of points, read by standing in for the module's kernel entry (the
    stand-in returns the plain version's result and launches nothing)."""
    from d3fields_tpu_torch.fields import kernels

    calls, kernel = [], kernels.fused_weighted_interp

    def capture(feats, idx, w):
        calls.append((feats, idx, w))
        return kernels.fused_weighted_interp_plain(feats, idx, w)

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
    moved = (rows * hd + loc.numel() + attn.numel() + B * Q * nh * hd) * 4
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
    return {"name": "deform_gather", "route": "cuda",
            "source": "d3fields_tpu_torch/csrc/deform_gather.cu",
            "replaces": "d3fields_tpu/models/groundingdino/gather_pallas.py:238",
            "max_abs_err": worst, **times}


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
    from d3fields_tpu_torch.fields.kernels import fused_weighted_interp
    from d3fields_tpu_torch.models.groundingdino.deform_gather import deform_gather

    return {"fused_weighted_interp": fused_weighted_interp, "deform_gather": deform_gather}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def serve(dev, num_requests: int = 3):
    """The main path at full width: 3 requests of update + batch_eval,
    then one more request traced by torch.profiler. Returns the launches
    and the DINOv2 backbone."""
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
        # the checks below run the unfused path only: they launch no kernel
        verify_request(dev, state, pts, out, launched, tiles)
        emit({"phase": "request", "request": r, "update_ms": (t1 - t0) * 1e3,
              "batch_eval_ms": (t2 - t1) * 1e3, "pts_per_s": N_POINTS / (t2 - t1),
              "points": N_POINTS, "tile": TILE, "kernel_launches": launched,
              "valid_points": int(out["valid_mask"].sum())})
        del out
    counts = launch_counts()
    launches = counts["fused_weighted_interp"]
    check(launches == num_requests * tiles,
          f"fused_weighted_interp launched {launches} times, expected {num_requests * tiles}")
    check(counts["deform_gather"] == 0, "the field query launched the detector's kernel")

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
    return launches, backbone


# the names of the port's CUDA kernels (csrc/*.cu) in a profiler trace
PORT_KERNELS = ("fused_interp_slice_kernel", "fused_weighted_interp_kernel",
                "deform_gather_kernel")


def profile_stage(stage: str, fn, top: int = 12) -> None:
    """Device time by kernel and the device's idle share over one call of
    ``fn`` (after one untraced warm-up call), read from the trace that
    torch.profiler writes to build/traces/chip_smoke_<stage>.json."""
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
        device = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
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
    emit({"phase": "profile", "stage": stage, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms, "device_ops": len(device),
          "top": [{"name": k, "device_ms": v, "count": count[k]}
                  for k, v in by_name.most_common(top)],
          "port_kernel_launch_ms": port})


def verify_request(dev, state, pts, out, launched, tiles):
    """Shapes, finiteness, the launch count, the fused path against the
    unfused eval_field on the card, and the card against the CPU."""
    from d3fields_tpu_torch.fields import fusion

    n = pts.shape[0]
    C = state.dino_feats.shape[-1]
    check(out["dist"].shape == (n,) and out["valid_mask"].shape == (n,), "dist/valid shape")
    check(out["dino_feats"].shape == (n, C) and out["mask"].shape == (n, 4), "feature shapes")
    for k in ("dist", "dino_feats", "mask"):
        check(bool(torch.isfinite(out[k]).all()), f"{k} is not finite")
    check(launched == tiles, f"kernel launched {launched} times for {tiles} tiles")
    check(bool(out["valid_mask"].any()), "no point is valid")

    sub = torch.as_tensor(pts[:65536], device=dev)
    ref = fusion.eval_field(state, sub, NAMES)
    check(torch.equal(ref["valid_mask"], out["valid_mask"][:65536]), "valid_mask fused vs unfused")
    for k, rtol, atol in (("dist", 0.0, 1e-5), ("mask", 0.0, 1e-5),
                          ("dino_feats", 1e-4, 1e-5)):
        check(torch.allclose(out[k][:65536], ref[k], rtol=rtol, atol=atol),
              f"{k} fused vs unfused: max err {float((out[k][:65536] - ref[k]).abs().max())}")

    cpu_state = state.replace(**{f: getattr(state, f).cpu() for f in
                                 ("depth", "pose", "K", "dino_feats", "mask")})
    ref = fusion.eval_field(cpu_state, torch.as_tensor(pts[:4096]), NAMES)
    check(torch.equal(ref["valid_mask"], out["valid_mask"][:4096].cpu()), "valid_mask card vs CPU")
    for k, rtol, atol in (("dist", 1e-5, 1e-6), ("mask", 1e-4, 1e-5),
                          ("dino_feats", 1e-4, 1e-5)):
        check(torch.allclose(out[k][:4096].cpu(), ref[k], rtol=rtol, atol=atol),
              f"{k} card vs CPU")

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


def segment(dev, num_requests: int = 3):
    """Slice 2's path at full width: GroundingDINO swin-T + SAM ViT-H
    (random weights from seeded generators) behind
    ``GroundedSAMBackend.segment_views``, 3 requests of a 4-view 240x320 rig;
    then the card held to the plain gather and to the CPU, and one more
    request traced by torch.profiler. Returns the launches and the backend."""
    from d3fields_tpu_torch.models.groundingdino import model as gd
    from d3fields_tpu_torch.models.groundingdino.deform_gather import (
        deform_gather, deform_gather_plain)
    from d3fields_tpu_torch.models.groundingdino.detector import GroundingDinoDetector
    from d3fields_tpu_torch.models.sam import model as sam
    from d3fields_tpu_torch.models.sam.predictor import SamPredictor
    from d3fields_tpu_torch.seg.grounded_sam import GroundedSAMBackend

    t0 = time.perf_counter()
    gcfg, scfg = gd.GroundingDinoConfig(), sam.SamConfig.vit_huge()
    gmodel = gd.init_params(gcfg, torch.Generator(device=dev).manual_seed(0), device=dev)
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
    detector = GroundingDinoDetector(gmodel, tokenize=tokenize, device=dev)
    predictor = SamPredictor(
        sam.init_params(scfg, torch.Generator(device=dev).manual_seed(1), device=dev),
        device=dev)
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
    return counts["deform_gather"], backend


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
    vision, text = grabbed["encoder"]
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
    emb = predictor._image_embs[v:v + 1].expand(len(boxes), -1, -1, -1)
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
    emb_card = predictor._image_embs[:1].cpu()
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
    """vis_tracking's staged loop at full width: 4 frames of the drifting
    spheres at 240x320 with 1,024-d descriptors, 100 keypoints per instance
    at res 0.002, ``TrackingConfig()`` (100 Adam steps) at every frame."""
    from d3fields_tpu_torch import Fusion
    from d3fields_tpu_torch.apps.vis_tracking import SYNTHETIC_BOUNDARIES, synthetic_frame
    from d3fields_tpu_torch.config import TrackingConfig
    from d3fields_tpu_torch.fields.geometry import create_grid
    from d3fields_tpu_torch.track.keypoints import select_keypoints
    from d3fields_tpu_torch.track.rigid import (
        boundary_vectors, rigid_tracking_steps, stack_keypoints)
    from d3fields_tpu_torch.utils.synthetic import sphere_mask_backend

    labels, frames, res_kp, per_inst = ["shoe", "shoe"], 4, 0.002, 100
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

    # frame 0's keypoints against the port's CPU run of the same frame
    t0 = time.perf_counter()
    cpu_feats, cpu_pts, cpu_ids = select(fusion_at(0, torch.device("cpu")))
    cpu_seconds = time.perf_counter() - t0
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
          "launches": counts})
    check(feat_err <= 1e-5, f"keypoint descriptors card vs CPU: {feat_err}")
    # one frame's 100 steps, and 64 of the keypoint grid query's tiles, traced
    profile_stage("tracking_frame", lambda: rigid_tracking_steps(
        fus.state, src_feats, last, lo, hi, cfg))
    from d3fields_tpu_torch.fields import fusion as ffusion

    sample = create_grid(SYNTHETIC_BOUNDARIES, res_kp)[0][:64 * 32768]
    profile_stage("select_keypoints_64_tiles",
                  lambda: ffusion.batch_eval(fus.state, sample, ("mask",), tile=32768))
    return counts


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


def serving_step(dev, frames: int = SERVING_FRAMES) -> dict:
    """The per-frame serving step at full width on the drifting spheres:
    DINOv2 ViT-L/14 (``resize_mode='device'``) -> XMem propagation (the
    tracker of ``xmem_phase``, built by the facade's
    ``video_tracker_factory``) -> the field -> ``rigid_tracking_steps`` with
    ``TrackingConfig()`` (100 Adam steps). Frame 0 runs consensus and seeds
    the tracker; frames 1-4 run the staged way (``update`` ->
    ``text_queries_for_inst_mask`` -> ``rigid_tracking_steps``), then
    through ``FusedFrameStep.step`` on a second tracker seeded alike, then
    through ``step_segment`` on a third; the three held together."""
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
        resize_mode="device", device=dev)
    xcfg = XMemConfig()
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
    emit({"phase": "serving_setup", "backbone": "dinov2_vit_large_random",
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
    for c in (counts, fcounts, scounts):
        check(sum(c.values()) == 0, f"the serving step launched {c}")
    emit({"phase": "serving_step", "frames": frames, "iters": tcfg.iters,
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

    profile_stage("serving_fused_frame", one_fused_frame)
    return counts


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

    rows = [check_fused_weighted_interp(dev), check_deform_gather(dev)]
    by_path = {}
    by_path["serve"] = {"fused_weighted_interp": 0, "deform_gather": 0}
    by_path["serve"]["fused_weighted_interp"], backbone = serve(dev)
    torch.cuda.empty_cache()
    by_path["segment"] = {"fused_weighted_interp": 0, "deform_gather": 0}
    by_path["segment"]["deform_gather"], seg_backend = segment(dev)
    by_path["golden"] = golden(dev)
    by_path["vis_repr"] = vis_repr_full(dev)
    by_path["vis_repr_backends"] = vis_repr_backends(dev, backbone, seg_backend)
    del backbone, seg_backend
    torch.cuda.empty_cache()
    by_path["tracking"] = tracking(dev)
    torch.cuda.empty_cache()
    by_path["xmem"] = xmem_phase(dev)
    torch.cuda.empty_cache()
    by_path["serving_step"] = serving_step(dev)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    for row in rows:
        row["launches_by_path"] = {path: c[row["name"]] for path, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    emit({"kernels": [{k: row[k] for k in keys + ("launches_by_path",)} for row in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

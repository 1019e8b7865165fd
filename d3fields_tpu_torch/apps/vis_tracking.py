"""Video keypoint tracking demo (reference ``vis_tracking.py``).

Counterpart of ``d3fields_tpu/apps/vis_tracking.py``'s staged loop, with
the same flags. Per frame: Fusion.update + text queries (consensus on frame
0; after it XMem propagation, or re-detection relabelled by overlap); at
t=0 keypoints are farthest-point-sampled per instance and their
descriptors recorded; every frame then solves a rigid SE(3) fit through the
differentiable field (torch autograd, Adam) and writes
``match_pts_<t>.pkl`` and ``loss_hist_<t>.pkl`` (``src_feats.pkl`` at t=0)
and a frame of ``tracking.avi``, the keypoints reprojected into every view
(``utils.visualization.TrackVis``; the JAX app writes ``tracking.mp4``, an
mp4v video through OpenCV, and the port, with no video encoder, writes
uncompressed AVI):

  python -m d3fields_tpu_torch.apps.vis_tracking --synthetic --frames 6 --out out/track
  python -m d3fields_tpu_torch.apps.vis_tracking --data_path data/<scene> \\
      --query_texts shoe --query_thresholds 0.5 [--fused [--segment N]]

A recorded scene is read with ``utils.io.load_frame``; DINOv2, GroundingDINO
+ SAM and the XMem video tracker are built from the ``D3F_*`` checkpoint
files by ``apps/_backends.py`` (without ``D3F_XMEM_CKPT`` every frame is
re-detected). ``--fused`` runs frame 0 the staged way, then every frame
through ``serving.FusedFrameStep`` (DINOv2 -> XMem propagation -> field ->
tracking); ``--segment N`` takes full chunks of N frames through
``step_segment`` and a shorter tail frame by frame. It needs the XMem
tracker, so it is refused with ``--synthetic``, as in the JAX app. It runs
on CUDA unless ``main`` is given another ``device``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from d3fields_tpu_torch.config import Boundaries, TrackingConfig


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_path", default=None)
    p.add_argument("--query_texts", nargs="+", default=["shoe"])
    p.add_argument("--query_thresholds", nargs="+", type=float, default=[0.5])
    p.add_argument("--num_cam", type=int, default=4)
    p.add_argument("--frames", type=int, default=0, help="0 = all")
    p.add_argument("--num_kypts", type=int, default=100)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out", default="out/vis_tracking")
    # reference vis_tracking.py:21-40 defaults (tabletop scenes, objects at
    # z < 0.02); --synthetic overrides with the sphere scene's workspace
    p.add_argument("--x_lower", type=float, default=-0.4)
    p.add_argument("--x_upper", type=float, default=0.4)
    p.add_argument("--y_lower", type=float, default=-0.4)
    p.add_argument("--y_upper", type=float, default=0.3)
    p.add_argument("--z_lower", type=float, default=-0.3)
    p.add_argument("--z_upper", type=float, default=0.02)
    p.add_argument("--kypts_z_lower", type=float, default=-0.2)
    p.add_argument("--kypts_z_upper", type=float, default=-0.02)
    p.add_argument("--pipeline_depth", type=int, default=0,
                   help="frames of host-visible lag: device work for frame "
                        "t+1 is launched before frame t's pickles are "
                        "written (serving.AsyncFrameLoop). 0 = the "
                        "reference's synchronous loop; outputs are "
                        "identical either way")
    p.add_argument("--segment", type=int, default=0,
                   help="with --fused: frames per FusedFrameStep.step_segment call")
    p.add_argument("--fused", action="store_true",
                   help="each frame through serving.FusedFrameStep (DINOv2 -> XMem "
                        "propagation -> field -> tracking); needs the XMem tracker "
                        "of the recorded-scene path")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="record the program's spans: a chrome trace to PATH, "
                        "their summary on stderr")
    return p


def synthetic_frame(t: int, num_cam: int = 4, H: int = 120, W: int = 160,
                    feat_dim: int = 32) -> dict:
    """Frame ``t`` of the synthetic video: the two spheres drift linearly,
    a rigid motion the tracker must recover."""
    from d3fields_tpu_torch.utils.synthetic import render_sphere_scene

    offs = np.array([[0.008 * t, 0.004 * t, 0.0],
                     [-0.005 * t, 0.006 * t, 0.0]])
    return render_sphere_scene(num_views=num_cam, H=H, W=W, feat_dim=feat_dim,
                               sphere_offsets=offs)


# the synthetic scene's workspace
SYNTHETIC_BOUNDARIES = Boundaries(-0.3, 0.6, -0.4, 0.4, 0.001, 0.4)


def main(argv=None, *, device=None):
    """The CLI. ``device`` defaults to CUDA and raises when no GPU is visible."""
    from d3fields_tpu_torch.utils.profiling import traced

    args = build_parser().parse_args(argv)
    with traced(args.trace):
        return _track(args, device)


def _track(args, device):
    from d3fields_tpu_torch.fields.fusion import Fusion
    from d3fields_tpu_torch.serving import AsyncFrameLoop
    from d3fields_tpu_torch.track.keypoints import select_keypoints
    from d3fields_tpu_torch.track.rigid import (
        boundary_vectors, rigid_tracking_steps, stack_keypoints,
    )
    from d3fields_tpu_torch.utils.device import resolve_device
    from d3fields_tpu_torch.utils.io import save_pickle
    from d3fields_tpu_torch.utils.visualization import TrackVis, jet_colors

    if args.fused and args.synthetic:
        raise SystemExit(
            "--fused requires the XMem video tracker (real-data path with "
            "D3F_XMEM_CKPT); the synthetic demo serves analytic per-frame "
            "masks with no tracker to fuse")
    if args.segment > 1 and not args.fused:
        raise SystemExit(
            "--segment batches frames through FusedFrameStep.step_segment "
            "and does nothing on the staged path — add --fused")
    device = resolve_device(device)
    boundaries = Boundaries(args.x_lower, args.x_upper, args.y_lower, args.y_upper,
                            args.z_lower, args.z_upper)
    # separate keypoint-selection bounds (reference kypts_boundaries,
    # vis_tracking.py:35-40)
    kypts_boundaries = Boundaries(args.x_lower, args.x_upper, args.y_lower, args.y_upper,
                                  args.kypts_z_lower, args.kypts_z_upper)
    os.makedirs(args.out, exist_ok=True)

    if args.synthetic:
        from d3fields_tpu_torch.utils.synthetic import sphere_mask_backend

        frames = args.frames or 6
        boundaries = kypts_boundaries = SYNTHETIC_BOUNDARIES
        labels = args.query_texts * 2 if len(args.query_texts) == 1 else args.query_texts
        backend = sphere_mask_backend(synthetic_frame(0, args.num_cam), labels)
        fusion = Fusion(num_cam=args.num_cam, mask_backend=backend, device=device)

        def get_obs(t):
            # the frame's descriptors, and its analytic masks served as
            # per-frame re-detection of text_queries_for_inst_mask
            scene = synthetic_frame(t, args.num_cam)
            backend.per_view = sphere_mask_backend(scene, labels).per_view
            backend.reset()
            return {k: scene[k] for k in ("color", "depth", "pose", "K", "dino_feats")}
    else:
        from d3fields_tpu_torch.apps import _backends
        from d3fields_tpu_torch.utils.io import load_frame, num_frames

        frames = args.frames or num_frames(args.data_path)
        feature_backend, mask_backend = _backends.build_real_backends(device=device)
        # XMem propagation when D3F_XMEM_CKPT is set (reference behaviour);
        # otherwise per-frame re-detection with overlap relabelling
        fusion = Fusion(num_cam=args.num_cam, feature_backend=feature_backend,
                        mask_backend=mask_backend,
                        video_tracker_factory=_backends.build_video_tracker_factory(
                            device=device),
                        device=device)

        def get_obs(t):
            return load_frame(args.data_path, t, args.num_cam)

    cfg = TrackingConfig(iters=args.iters)
    src_feats = last_match = lo = hi = fused = vis = None
    track_info = {}

    def consume(t, out):
        # the host side of the pipeline: the video frame and per-frame
        # pickles (reference vis_tracking.py:136-138), `pipeline_depth`
        # frames behind the device
        match_pts = out["match_pts"]
        pts_list = [match_pts[i] for i in range(match_pts.shape[0])]
        vis.visualize_match_pts(pts_list, out["color"], track_info)
        save_pickle(os.path.join(args.out, f"match_pts_{t:06d}.pkl"), pts_list)
        # per-iteration (feat, dist, reg, oob) losses: the numerics-sensitive
        # record of the whole differentiable pipeline
        save_pickle(os.path.join(args.out, f"loss_hist_{t:06d}.pkl"), out["loss_history"])
        print(f"[vis_tracking] frame {t}: {time.perf_counter() - out['t0']:.2f}s "
              f"submit-to-consume, {sum(p.shape[0] for p in pts_list)} pts")

    loop = AsyncFrameLoop(consume, depth=args.pipeline_depth)
    seg_buf = []

    def flush_segment():
        # a full chunk of --segment frames through step_segment
        nonlocal last_match
        outs = fused.step_segment(np.stack([o["color"] for _, o, _ in seg_buf]), src_feats,
                                  last_match, depths=np.stack([o["depth"] for _, o, _ in seg_buf]))
        last_match = outs["match_pts"][-1]
        for i, (ti, o, ti0) in enumerate(seg_buf):
            loop.submit(ti, {"match_pts": outs["match_pts"][i],
                             "loss_history": outs["loss_history"][i], "t0": ti0,
                             "color": o["color"]})
        seg_buf.clear()

    def fused_step(t, obs, t0):
        # one frame through FusedFrameStep: DINOv2, XMem propagation, the
        # field and tracking, with no host sync
        nonlocal last_match
        out = fused.step(obs["color"], src_feats, last_match, depth=obs["depth"])
        last_match = out["match_pts"]
        loop.submit(t, {"match_pts": last_match, "loss_history": out["loss_history"],
                        "t0": t0, "color": obs["color"]})

    for t in range(frames):
        t0 = time.perf_counter()
        obs = get_obs(t)
        if fused is not None:
            if args.segment > 1:
                seg_buf.append((t, obs, t0))
                if len(seg_buf) == args.segment:
                    flush_segment()
            else:
                fused_step(t, obs, t0)
            continue
        fusion.update(obs)
        fusion.text_queries_for_inst_mask(args.query_texts, args.query_thresholds,
                                          boundaries=boundaries)
        if t == 0:
            feats, pts, inst_ids = select_keypoints(
                fusion.state, fusion.consensus_mask_label, kypts_boundaries,
                args.num_kypts, res=0.002, init_idx=0,
            )
            for f, p, i in zip(feats, pts, inst_ids):
                colors = (jet_colors(np.linspace(0, 1, p.shape[0])) * 255).astype(np.uint8)
                track_info[f"inst_{i}"] = {"src_feats": f, "src_pts": p,
                                           "src_pts_color": colors}
            save_pickle(os.path.join(args.out, "src_feats.pkl"), track_info)
            vis = TrackVis(obs["pose"], obs["K"], args.out)
            # the tracking chain's state stays on the device across frames
            src_feats, last_match = stack_keypoints(feats, pts, fusion.device)
            lo, hi = boundary_vectors(boundaries, fusion.device)
        # the reference optimizes at EVERY frame including t=0 (refining the
        # FPS samples onto the field surface, vis_tracking.py:130-134)
        res = rigid_tracking_steps(fusion.state, src_feats, last_match, lo, hi, cfg)
        last_match = res["match_pts"]
        loop.submit(t, {"match_pts": last_match, "loss_history": res["loss_history"], "t0": t0,
                        "color": obs["color"]})
        if args.fused and t == 0:
            # the seed frame went the staged way (detection seeds the
            # tracker); every later frame runs FusedFrameStep
            from d3fields_tpu_torch.models.dinov2 import Dinov2Backbone
            from d3fields_tpu_torch.serving import FusedFrameStep

            if fusion.video_tracker is None:
                raise SystemExit(
                    "--fused needs the XMem video tracker — set "
                    "D3F_XMEM_CKPT so frames propagate instead of "
                    "re-detecting per frame")
            fb = feature_backend
            if fb.resize_mode != "device":
                # the fused step resizes on the device: the same weights, in
                # the same compute dtype, behind a device-resize wrapper
                fb = Dinov2Backbone(fb.model, compute_dtype=fb.compute_dtype,
                                    pos_interpolate=fb.pos_interpolate,
                                    resize_mode="device", device=fb.device)
            # obs colour is BGR (cv2 convention): DINOv2 takes it as it is
            # (as Fusion.update does) while the tracker was seeded with RGB,
            # so the step flips the XMem branch's input
            fused = FusedFrameStep(fb, fusion.video_tracker, obs["depth"], obs["pose"],
                                   obs["K"], lo, hi, cfg, xmem_bgr_to_rgb=True,
                                   mu=fusion.config.fusion.mu)

    # a tail shorter than --segment: per-frame fused steps
    for ti, o, ti0 in seg_buf:
        fused_step(ti, o, ti0)
    loop.flush()
    vis.close()
    print(f"[vis_tracking] wrote {args.out}/tracking.avi and the pickles")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

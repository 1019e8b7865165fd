"""Video keypoint tracking demo (reference ``vis_tracking.py``).

Counterpart of ``d3fields_tpu/apps/vis_tracking.py``'s staged loop, with
the same flags. Per frame: Fusion.update + text queries (consensus on frame
0, re-detection relabelled by overlap after); at t=0 keypoints are
farthest-point-sampled per instance and their descriptors recorded; every
frame then solves a rigid SE(3) fit through the differentiable field (torch
autograd, Adam) and writes ``match_pts_<t>.pkl`` and ``loss_hist_<t>.pkl``
(``src_feats.pkl`` at t=0):

  python -m d3fields_tpu_torch.apps.vis_tracking --synthetic --frames 6 --out out/track

It runs on CUDA unless ``main`` is given another ``device``. Not ported
yet: the reprojection-mosaic video ``tracking.mp4`` (``TrackVis``) and the
recorded-scene path with checkpoint-built backends and XMem propagation.
``--fused`` (``serving.FusedFrameStep``) needs that path's XMem tracker, so
it is refused with ``--synthetic`` as in the JAX app.
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
    args = build_parser().parse_args(argv)
    from d3fields_tpu_torch.fields.fusion import Fusion
    from d3fields_tpu_torch.serving import AsyncFrameLoop
    from d3fields_tpu_torch.track.keypoints import select_keypoints
    from d3fields_tpu_torch.track.rigid import (
        boundary_vectors, rigid_tracking_steps, stack_keypoints,
    )
    from d3fields_tpu_torch.utils.io import save_pickle
    from d3fields_tpu_torch.utils.synthetic import sphere_mask_backend
    from d3fields_tpu_torch.utils.visualization import jet_colors

    if args.fused and args.synthetic:
        raise SystemExit(
            "--fused requires the XMem video tracker (real-data path with "
            "D3F_XMEM_CKPT); the synthetic demo serves analytic per-frame "
            "masks with no tracker to fuse")
    if args.segment > 1 and not args.fused:
        raise SystemExit(
            "--segment batches frames through FusedFrameStep.step_segment "
            "and does nothing on the staged path — add --fused")
    if not args.synthetic:
        raise SystemExit(
            "only --synthetic runs in d3fields_tpu_torch so far: recorded scenes "
            "need the frame loader, the checkpoint-built backends and XMem, "
            "which are not ported yet")
    os.makedirs(args.out, exist_ok=True)

    frames = args.frames or 6
    boundaries = kypts_boundaries = SYNTHETIC_BOUNDARIES
    get_frame = lambda t: synthetic_frame(t, args.num_cam)  # noqa: E731
    scene0 = get_frame(0)
    labels = args.query_texts * 2 if len(args.query_texts) == 1 else args.query_texts
    backend = sphere_mask_backend(scene0, labels)
    fusion = Fusion(num_cam=args.num_cam, mask_backend=backend, device=device)

    def refresh_masks(sc):
        # serve the current frame's analytic masks (per-frame re-detection
        # of text_queries_for_inst_mask)
        backend.per_view = sphere_mask_backend(sc, labels).per_view
        backend.reset()

    cfg = TrackingConfig(iters=args.iters)
    src_feats = last_match = lo = hi = None

    def consume(t, out):
        # the host side of the pipeline: per-frame pickles (reference
        # vis_tracking.py:136-138), `pipeline_depth` frames behind the device
        match_pts = out["match_pts"]
        pts_list = [match_pts[i] for i in range(match_pts.shape[0])]
        save_pickle(os.path.join(args.out, f"match_pts_{t:06d}.pkl"), pts_list)
        # per-iteration (feat, dist, reg, oob) losses: the numerics-sensitive
        # record of the whole differentiable pipeline
        save_pickle(os.path.join(args.out, f"loss_hist_{t:06d}.pkl"), out["loss_history"])
        print(f"[vis_tracking] frame {t}: {time.perf_counter() - out['t0']:.2f}s "
              f"submit-to-consume, {sum(p.shape[0] for p in pts_list)} pts")

    loop = AsyncFrameLoop(consume, depth=args.pipeline_depth)
    for t in range(frames):
        t0 = time.perf_counter()
        scene = get_frame(t)
        obs = {k: scene[k] for k in ("color", "depth", "pose", "K", "dino_feats")}
        refresh_masks(scene)
        fusion.update(obs)
        fusion.text_queries_for_inst_mask(args.query_texts, args.query_thresholds,
                                          boundaries=boundaries)
        if t == 0:
            feats, pts, inst_ids = select_keypoints(
                fusion.state, fusion.consensus_mask_label, kypts_boundaries,
                args.num_kypts, res=0.002, init_idx=0,
            )
            track_info = {}
            for f, p, i in zip(feats, pts, inst_ids):
                colors = (jet_colors(np.linspace(0, 1, p.shape[0])) * 255).astype(np.uint8)
                track_info[f"inst_{i}"] = {"src_feats": f, "src_pts": p,
                                           "src_pts_color": colors}
            save_pickle(os.path.join(args.out, "src_feats.pkl"), track_info)
            # the tracking chain's state stays on the device across frames
            src_feats, last_match = stack_keypoints(feats, pts, fusion.device)
            lo, hi = boundary_vectors(boundaries, fusion.device)
        # the reference optimizes at EVERY frame including t=0 (refining the
        # FPS samples onto the field surface, vis_tracking.py:130-134)
        res = rigid_tracking_steps(fusion.state, src_feats, last_match, lo, hi, cfg)
        last_match = res["match_pts"]
        loop.submit(t, {"match_pts": last_match, "loss_history": res["loss_history"], "t0": t0})
    loop.flush()
    print(f"[vis_tracking] wrote pickles to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

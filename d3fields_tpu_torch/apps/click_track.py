"""Headless click-to-track: seed objects with SAM point prompts, then
propagate them through the video with XMem.

Counterpart of ``d3fields_tpu/apps/click_track.py``, with the same flags:
the capability of the reference's interactive demo (``XMem/
interactive_demo.py`` and the ``inference/interact/`` click modules:
positive and negative clicks to a mask, then propagation) without the Qt
GUI. Clicks come from the command line, masks go to DAVIS-paletted PNGs.

  python -m d3fields_tpu_torch.apps.click_track --data_root <videos> \\
      --clicks "120,80;200,150,0|340,200" --out out/click_track

``--clicks``: object groups separated by ``|``; within a group, clicks
``x,y[,label]`` separated by ``;`` (label 1 = foreground, the default; 0 =
background). Each group seeds one object; ``@T:`` before a group seeds it
at frame T (mid-video entry).

Checkpoints: ``D3F_SAM_CKPT`` / ``D3F_XMEM_CKPT`` (or ``--sam_ckpt`` /
``--xmem_ckpt``), read by ``apps/_backends.py``; without them the models
run with random weights from seeded generators (a tiny SAM): the pipeline
runs end to end but the masks are noise. Frames are PNG or JPEG files, read
as ``cv2.imread`` reads them (``utils/png.py``, ``utils/jpeg.py``), and
decoded ahead in a background thread (``serving.host_prefetch``). Unlike
the JAX predictor, SAM decodes each group's clicks without padding their
count. It runs on CUDA unless ``main`` is given another ``device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", default=None,
                   help="video root (generic <video>/frames, DAVIS or YouTubeVOS checkout layout)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--clicks", required=False, default=None,
                   help="'x,y[,label];...|x,y...' — '|' separates objects, ';' separates "
                        "clicks, label 1=fg (default) 0=bg")
    p.add_argument("--refine", type=int, default=0,
                   help="iterative mask-input refinement rounds per object (upstream SAM's "
                        "mask_input loop)")
    p.add_argument("--frames", type=int, default=8,
                   help="frame cap per video; <=0 = all frames")
    p.add_argument("--size", type=int, default=480,
                   help="XMem processing short side (-1 = native)")
    p.add_argument("--sam_ckpt", default=None)
    p.add_argument("--xmem_ckpt", default=None)
    p.add_argument("--key_dim", type=int, default=64)
    p.add_argument("--value_dim", type=int, default=512)
    p.add_argument("--hidden_dim", type=int, default=64)
    # memory sizing (mid-video entry runs with long-term memory off, so size
    # the bounded working memory to the video, as in eval_xmem)
    p.add_argument("--mem_every", type=int, default=5)
    p.add_argument("--top_k", type=int, default=30)
    p.add_argument("--max_mid_term_frames", type=int, default=10)
    p.add_argument("--out", default="out/click_track")
    return p


def parse_clicks(spec: str):
    """'[@T:]x,y[,label];...|...' -> a list of (frame T, points (P, 2) f32,
    labels (P,) i32), one per object. ``@T:`` seeds that object at frame T
    (default 0): mid-video entry, like drawing a new object partway through
    an interactive session."""
    if not spec or not spec.strip():
        raise ValueError("no click groups given")
    groups = []
    for raw in spec.split("|"):
        grp, at = raw, 0
        if grp.startswith("@"):
            head, sep, grp = grp.partition(":")
            if not sep or not grp:
                raise ValueError(f"bad group {raw!r}: want '@T:clicks'")
            at = int(head[1:])
        pts, lbls = [], []
        for c in grp.split(";"):
            parts = [float(v) for v in c.split(",")] if c.strip() else []
            if len(parts) not in (2, 3):
                raise ValueError(f"bad click {c!r}: want x,y or x,y,label")
            lab = int(parts[2]) if len(parts) == 3 else 1
            if lab not in (0, 1):
                raise ValueError(f"bad click label {lab} in {c!r}: 1 = foreground, "
                                 "0 = background")
            pts.append(parts[:2])
            lbls.append(lab)
        groups.append((at, np.asarray(pts, np.float32), np.asarray(lbls, np.int32)))
    return groups


def _resolve_ckpt(explicit, env_var, what):
    """A configured checkpoint path that does not exist raises (a typo must
    not give random-weight noise); only an unset one returns None."""
    ckpt = explicit or os.environ.get(env_var)
    if ckpt and not os.path.exists(ckpt):
        raise FileNotFoundError(f"{what} checkpoint not found: {ckpt}")
    return ckpt


def _sam_predictor(args, device):
    import torch

    from d3fields_tpu_torch.apps._backends import load_sam
    from d3fields_tpu_torch.models.sam import model as S
    from d3fields_tpu_torch.models.sam.predictor import SamPredictor

    ckpt = _resolve_ckpt(args.sam_ckpt, "D3F_SAM_CKPT", "SAM")
    if ckpt:
        model = load_sam(ckpt, device)
    else:
        print("[click_track] no SAM checkpoint: random weights (smoke mode)")
        model = S.init_params(S.SamConfig.tiny_test(),
                              torch.Generator(device=device).manual_seed(0), device=device)
    return SamPredictor(model, device=device)


def _xmem(args, cfg, device):
    import torch

    from d3fields_tpu_torch.apps._backends import load_xmem
    from d3fields_tpu_torch.models.xmem import network as N

    ckpt = _resolve_ckpt(args.xmem_ckpt, "D3F_XMEM_CKPT", "XMem")
    if ckpt:
        return load_xmem(ckpt, cfg, device)
    print("[click_track] no XMem checkpoint: random weights (smoke mode)")
    return N.init_params(cfg, torch.Generator(device=device).manual_seed(1), device=device)


def seed_mask_from_clicks(predictor, rgb: np.ndarray, groups, refine: int = 0) -> np.ndarray:
    """Each click group (object id, points, labels) through SAM, taking the
    multimask output with the best IoU (upstream's select-best default);
    later objects overwrite earlier ones where masks overlap. ``refine``
    more rounds feed the winning low-res logits back as the mask prompt."""
    H, W = rgb.shape[:2]
    predictor.set_image(rgb)
    mask = np.zeros((H, W), np.uint8)
    for obj_id, pts, lbls in groups:
        m, iou, low = predictor.predict_points(pts[None], lbls[None])
        best = int(iou[0].argmax())
        for _ in range(refine):
            m, iou, low = predictor.predict_points(pts[None], lbls[None],
                                                   mask_input=low[:, best])
            best = int(iou[0].argmax())
        mask[m[0, best].cpu().numpy()] = obj_id
    return mask


def synthetic_video(frames: int):
    """The drifting spheres at 120x160: (name, get_rgb, n)."""
    from d3fields_tpu_torch.utils.synthetic import render_sphere_scene

    # synthetic videos have no natural end: <=0 picks a default run
    n_frames = 8 if frames <= 0 else max(frames, 2)

    def get_rgb(t):
        offs = np.array([[0.008 * t, 0.004 * t, 0.0], [-0.005 * t, 0.006 * t, 0.0]])
        sc = render_sphere_scene(num_views=1, H=120, W=160, feat_dim=4, sphere_offsets=offs)
        return sc["color"][0]

    return [("synthetic_0", get_rgb, n_frames)]


def directory_videos(root: str, frames: int):
    """(name, get_rgb, n) of every video under ``root``; frames read as
    ``cv2.imread(...)[..., ::-1]``."""
    from d3fields_tpu_torch.models.xmem.data import IMAGE_EXTS, resolve_video_dirs
    from d3fields_tpu_torch.utils.png import imread_color

    videos = []
    for vid, fdir, _mdir in resolve_video_dirs(root):
        names = sorted(n for n in os.listdir(fdir) if n.lower().endswith(IMAGE_EXTS))
        n = len(names) if frames <= 0 else min(len(names), frames)

        def get_rgb(t, names=names, fdir=fdir):
            return imread_color(os.path.join(fdir, names[t]))[..., ::-1]

        videos.append((vid, get_rgb, n))
    return videos


def main(argv=None, *, device=None):
    """The CLI. ``device`` defaults to CUDA and raises when no GPU is visible."""
    args = build_parser().parse_args(argv)
    from d3fields_tpu_torch.config import XMemConfig
    from d3fields_tpu_torch.seg.video_tracker import VideoMaskTracker
    from d3fields_tpu_torch.serving import host_prefetch
    from d3fields_tpu_torch.utils.device import resolve_device
    from d3fields_tpu_torch.utils.profiling import Throughput
    from d3fields_tpu_torch.utils.visualization import save_index_mask_png

    device = resolve_device(device)
    os.makedirs(args.out, exist_ok=True)
    if args.synthetic:
        videos = synthetic_video(args.frames)
    elif args.data_root is not None:
        videos = directory_videos(args.data_root, args.frames)
    else:
        raise SystemExit("need --data_root or --synthetic")
    if args.clicks is None:
        raise SystemExit("need --clicks 'x,y[,label];...|...'")
    groups = parse_clicks(args.clicks)
    predictor = _sam_predictor(args, device)
    xcfg = XMemConfig(key_dim=args.key_dim, value_dim=args.value_dim,
                      hidden_dim=args.hidden_dim, mem_every=args.mem_every, top_k=args.top_k,
                      max_mid_term_frames=args.max_mid_term_frames)
    model = _xmem(args, xcfg, device)

    # group the clicks by seed frame; object ids follow the group order
    by_frame = {}
    for i, (at, pts, lbls) in enumerate(groups):
        by_frame.setdefault(at, []).append((i + 1, pts, lbls))
    start = min(by_frame)
    multi_group = len(by_frame) > 1
    if multi_group and xcfg.enable_long_term:
        # mid-video entry needs the bounded working memory (models/xmem/memory.py)
        xcfg = dataclasses.replace(xcfg, enable_long_term=False)
        print("[click_track] objects enter mid-video -> long-term memory disabled")

    tp = Throughput()
    for vid, get_rgb, n_frames in videos:
        late = [t for t in by_frame if t >= n_frames]
        if late:
            raise SystemExit(
                f"seed frame(s) {sorted(late)} are past the end of {vid!r} ({n_frames} "
                "frames; --frames caps it) — those objects would silently never enter")
        rgb0 = np.ascontiguousarray(get_rgb(start))
        mask0 = seed_mask_from_clicks(predictor, rgb0, by_frame[start], refine=args.refine)
        vdir = os.path.join(args.out, vid)
        os.makedirs(vdir, exist_ok=True)
        save_index_mask_png(os.path.join(vdir, f"{start:05d}.png"), mask0)
        tracker = VideoMaskTracker(model, xcfg, num_views=1, num_objects=len(groups),
                                   image_hw=rgb0.shape[:2], size=args.size,
                                   multi_group=multi_group, device=device)
        tracker.process(rgb0[None], mask0[None], return_index=True)
        # decode the next frames in the background while the tracker runs
        frame_stream = host_prefetch(
            ((t, np.ascontiguousarray(get_rgb(t))) for t in range(start + 1, n_frames)), size=2)
        for t, rgb in frame_stream:
            if t in by_frame:
                # entering objects: their clicks through SAM on this frame
                # (outside the tracking clock), the mask to the tracker
                mt = seed_mask_from_clicks(predictor, rgb, by_frame[t], refine=args.refine)
                tp.start()
                idx = tracker.process(rgb[None], mt[None], return_index=True)
            else:
                tp.start()
                idx = tracker.process(rgb[None], return_index=True)
            tp.stop(units=1, result_tree=None)
            save_index_mask_png(os.path.join(vdir, f"{t:05d}.png"), idx[0])
        print(f"[click_track] {vid}: seeded {len(groups)} object(s) from clicks, propagated "
              f"{n_frames - start - 1} frames")
    print(f"[click_track] FPS: {tp.per_second:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

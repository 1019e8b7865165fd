"""XMem video-segmentation evaluation (reference ``XMem/eval.py``).

Counterpart of ``d3fields_tpu/apps/eval_xmem.py``, with the same flags.
Propagates masks over video directories, writes the predicted index masks
as paletted PNGs (``--save_scores`` adds the soft probabilities as .npy),
and reports FPS (``total_frames / total_process_time``,
``XMem/eval.py:248-250``) and DAVIS J&F in ``metrics.json``. Layouts:

  <root>/<video>/frames/*.png          RGB frames
  <root>/<video>/masks/<first>.png     index mask of the first frame

  <root>/JPEGImages/480p/<video>/*     DAVIS checkout
  <root>/Annotations/480p/<video>/*.png

  <root>/JPEGImages/<video>/*          YouTube-VOS checkout
  <root>/Annotations/<video>/*.png

or synthetic drifting-sphere videos with ``--synthetic``. Frames are PNG
or JPEG files, read as ``cv2.imread`` reads them (``utils/png.py``,
``utils/jpeg.py``).

Seeding follows the reference protocol: every annotation frame that brings
an unseen object id seeds the tracker (frame 0 for DAVIS, each object's
first appearance for YouTube-VOS, through the multi-group memory).
``--ckpt`` takes the reference's ``XMem.pth``, a checkpoint of the port's
``train_xmem``, a JAX ``.npz`` or a JAX trainer pickle with a ``"params"``
tree; without it the weights are random
(``network.init_params``, seeded). It runs on CUDA unless ``main`` is given
another ``device``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--frames", type=int, default=8,
                   help="frame cap per video; <=0 = all frames (directory "
                        "sources; synthetic always uses the cap)")
    p.add_argument("--size", type=int, default=480)
    p.add_argument("--ckpt", default=None,
                   help="XMem.pth, a train_xmem checkpoint, a JAX .npz, or a JAX "
                        "trainer checkpoint")
    p.add_argument("--key_dim", type=int, default=64)
    p.add_argument("--value_dim", type=int, default=512)
    p.add_argument("--hidden_dim", type=int, default=64)
    p.add_argument("--out", default="out/eval_xmem")
    p.add_argument("--flip", action="store_true",
                   help="test-time augmentation: propagate the horizontally "
                        "flipped video, un-flip predictions (XMem/eval.py --flip)")
    p.add_argument("--disable_long_term", action="store_true",
                   help="bounded working memory, no long-term consolidation "
                        "(XMem/eval.py --disable_long_term)")
    p.add_argument("--split", default=None,
                   help="ImageSets split to evaluate (XMem/eval.py --split); "
                        "default: every video under --data_root")
    # the reference's memory knobs (XMem/eval.py:52-60)
    p.add_argument("--max_mid_term_frames", type=int, default=10,
                   help="T_max in the paper")
    p.add_argument("--min_mid_term_frames", type=int, default=5,
                   help="T_min in the paper")
    p.add_argument("--max_long_term_elements", type=int, default=10000,
                   help="LT_max in the paper")
    p.add_argument("--num_prototypes", type=int, default=128,
                   help="P in the paper")
    p.add_argument("--top_k", type=int, default=30)
    p.add_argument("--mem_every", type=int, default=5,
                   help="r in the paper; increase to improve speed")
    p.add_argument("--deep_update_every", type=int, default=-1,
                   help="-1 synchronizes with mem_every")
    p.add_argument("--save_scores", action="store_true",
                   help="also save per-object probability maps as .npy for "
                        "multi-scale/flip merging (apps.merge_scores)")
    p.add_argument("--video_batch", type=int, default=1,
                   help="evaluate up to N same-shape, same-object-count "
                        "videos in lockstep on the tracker's view axis (the "
                        "reference eval is strictly per-video); multi-group "
                        "videos keep the per-video path")
    return p


def make_config(args):
    """CLI memory knobs -> XMemConfig (reference XMem/eval.py:51-60)."""
    from d3fields_tpu_torch.config import XMemConfig

    return XMemConfig(key_dim=args.key_dim, value_dim=args.value_dim,
                      hidden_dim=args.hidden_dim,
                      enable_long_term=not args.disable_long_term,
                      max_mid_term_frames=args.max_mid_term_frames,
                      min_mid_term_frames=args.min_mid_term_frames,
                      max_long_term_elements=args.max_long_term_elements,
                      num_prototypes=args.num_prototypes,
                      top_k=args.top_k, mem_every=args.mem_every,
                      deep_update_every=args.deep_update_every)


def load_model(args, cfg, device):
    """The XMem of ``--ckpt`` (``XMem.pth``, a training checkpoint of the
    port, a JAX ``.npz`` or a JAX trainer pickle's ``"params"``), or seeded
    random weights."""
    from d3fields_tpu_torch.apps._backends import load_xmem
    from d3fields_tpu_torch.models.xmem import network as xnet

    if not args.ckpt:
        return xnet.init_params(cfg, device=device).eval()
    return load_xmem(args.ckpt, cfg, device)


def synthetic_videos(frames: int):
    """One drifting-sphere video (120x160, 2 objects): (name, get_rgb,
    get_mask, n). Each frame is rendered once and kept."""
    from d3fields_tpu_torch.utils.synthetic import render_sphere_scene

    cache = {}

    def render(t):
        if t not in cache:
            offs = np.array([[0.008 * t, 0.004 * t, 0.0], [-0.005 * t, 0.006 * t, 0.0]])
            sc = render_sphere_scene(num_views=1, H=120, W=160, feat_dim=4,
                                     sphere_offsets=offs)
            m = np.zeros((120, 160), np.uint8)
            for si in range(sc["sphere_masks"].shape[1]):
                m[sc["sphere_masks"][0, si]] = si + 1
            cache[t] = (sc["color"][0], m)
        return cache[t]

    yield "synthetic_0", lambda t: render(t)[0], lambda t: render(t)[1], max(frames, 2)


def directory_videos(root: str, split, frames: int):
    """The videos of a directory layout: (name, get_rgb, get_mask, n)."""
    from d3fields_tpu_torch.models.xmem.data import (
        IMAGE_EXTS, load_index_mask, resolve_video_dirs)
    from d3fields_tpu_torch.utils.png import imread_color

    for vid, fdir, mdir in resolve_video_dirs(root, subset=split):
        names = sorted(n for n in os.listdir(fdir) if n.lower().endswith(IMAGE_EXTS))

        def get_rgb(t, names=names, fdir=fdir):
            return imread_color(os.path.join(fdir, names[t]))[..., ::-1]

        def get_mask(t, names=names, mdir=mdir):
            mpath = os.path.join(mdir, os.path.splitext(names[t])[0] + ".png")
            return load_index_mask(mpath) if os.path.exists(mpath) else None

        # the whole video, as the reference eval (--frames caps it)
        yield vid, get_rgb, get_mask, len(names) if frames <= 0 else min(len(names), frames)


def main(argv=None, *, device=None):
    """The CLI. ``device`` defaults to CUDA and raises when no GPU is visible."""
    args = build_parser().parse_args(argv)
    import torch

    from d3fields_tpu_torch.seg.video_tracker import VideoMaskTracker
    from d3fields_tpu_torch.serving import host_prefetch
    from d3fields_tpu_torch.utils.device import resolve_device
    from d3fields_tpu_torch.utils.metrics import davis_jf
    from d3fields_tpu_torch.utils.profiling import Throughput
    from d3fields_tpu_torch.utils.visualization import save_index_mask_png

    device = resolve_device(device)
    cfg = make_config(args)
    model = load_model(args, cfg, device)
    os.makedirs(args.out, exist_ok=True)
    if args.synthetic:
        videos = synthetic_videos(args.frames)
    elif args.data_root:
        videos = directory_videos(args.data_root, args.split, args.frames)
    else:
        raise SystemExit("--data_root or --synthetic is required")

    tp = Throughput()
    ious, jfs, per_video = [], [], {}

    def scan_video(vid, get_rgb, get_mask, n_frames):
        """Seed frames are the annotations that bring unseen object ids (the
        YouTube-VOS first-appearance protocol); on densely annotated layouts
        that is frame 0 alone and the rest is ground truth."""
        seeds, seen, gt_frames = {}, set(), set()
        for t in range(n_frames):
            m = get_mask(t)
            if m is None:
                continue
            gt_frames.add(t)
            new_ids = set(np.unique(m).tolist()) - {0} - seen
            if new_ids:
                seeds[t] = m
                seen |= new_ids
        if not seeds:
            print(f"[eval_xmem] {vid}: no annotated objects, skipped")
            return None
        # ground truth is decoded again at scoring time: only the seed
        # frames stay decoded
        return {"vid": vid, "get_rgb": get_rgb, "get_gt": get_mask, "n": n_frames,
                "seeds": seeds, "gt_frames": gt_frames, "start": min(seeds),
                "num_obj": max(seen), "multi_group": len(seeds) > 1}

    def emit_frame(rec, vdir, t, pred, prob, vid_jfs):
        """The frame's paletted PNG, its soft scores, and its J&F. Seed
        frames are not scored; on multi-group (first-appearance) videos only
        the ids a ground-truth frame holds are."""
        if args.flip:
            pred = pred[:, ::-1]
        pred = np.ascontiguousarray(pred)
        save_index_mask_png(os.path.join(vdir, f"{t:05d}.png"), pred)
        if args.save_scores:
            p = prob.transpose(1, 2, 0)
            if args.flip:
                p = p[:, ::-1]
            np.save(os.path.join(vdir, f"{t:05d}.npy"), p.astype(np.float16))
        gt = rec["get_gt"](t) if t in rec["gt_frames"] else None
        if t not in rec["seeds"] and gt is not None and gt.max() > 0:
            inter = ((pred > 0) & (gt > 0)).sum()
            union = ((pred > 0) | (gt > 0)).sum()
            ious.append(inter / max(union, 1))
            gt_ids = None
            if rec["multi_group"]:
                gt_ids = np.unique(gt)
                gt_ids = gt_ids[gt_ids > 0].tolist()
            m = davis_jf(pred, gt, rec["num_obj"], objects=gt_ids)
            jfs.append(m)
            vid_jfs.append(m)

    def finish_video(rec, vid_jfs):
        print(f"[eval_xmem] {rec['vid']}: {rec['n'] - rec['start'] - 1} frames propagated"
              + (f" ({len(rec['seeds'])} annotation frames)" if rec["multi_group"] else ""))
        if vid_jfs:
            row = {"J": float(np.mean([m["J"] for m in vid_jfs])),
                   "F": float(np.mean([m["F"] for m in vid_jfs])),
                   "frames_scored": len(vid_jfs)}
            row["JF"] = (row["J"] + row["F"]) / 2
            per_video[rec["vid"]] = row

    def flip_rgb(rgb):
        return np.ascontiguousarray(rgb[:, ::-1]) if args.flip else rgb

    def tracker_for(num_views, rec, hw, multi_group=False):
        return VideoMaskTracker(model, cfg, num_views, rec["num_obj"], hw, size=args.size,
                                multi_group=multi_group, device=device)

    def run_single(rec):
        vid_jfs = []
        seeds, start = rec["seeds"], rec["start"]
        rgb0, m0 = flip_rgb(rec["get_rgb"](start)), seeds[start]
        if args.flip:
            m0 = m0[:, ::-1]
        tracker = tracker_for(1, rec, rgb0.shape[:2], rec["multi_group"])
        vdir = os.path.join(args.out, rec["vid"])
        os.makedirs(vdir, exist_ok=True)
        tracker.process(np.ascontiguousarray(rgb0[None]), np.ascontiguousarray(m0[None]),
                        return_index=True)
        # frames are decoded in a background thread, 2 ahead of the tracker
        frame_stream = host_prefetch(
            ((t, flip_rgb(rec["get_rgb"](t))) for t in range(start + 1, rec["n"])), size=2)
        for t, rgb in frame_stream:
            tp.start()
            if t in seeds:
                m = seeds[t][:, ::-1] if args.flip else seeds[t]
                idx = tracker.process(rgb[None], np.ascontiguousarray(m[None]),
                                      return_index=True)
            else:
                idx = tracker.process(rgb[None], return_index=True)
            tp.stop(units=1)  # process() ends in a copy to the host
            prob = tracker.last_prob[0].cpu().numpy() if args.save_scores else None
            emit_frame(rec, vdir, t, idx[0], prob, vid_jfs)
        finish_video(rec, vid_jfs)

    def run_batch(recs, pad_to=None):
        """Videos of one (H, W, num_obj) group on the tracker's view axis
        (each view's memory is its own), in lockstep; a shorter video repeats
        its last frame, whose steps touch only its own memory and are not
        written. A ragged last chunk is padded with 1-frame copies of its
        first video, so a group keeps one view count."""
        real = len(recs)
        if pad_to and real < pad_to:
            recs = recs + [{**recs[0], "n": 1}] * (pad_to - real)
        max_n = max(r["n"] for r in recs)
        rgb0 = np.stack([flip_rgb(r["get_rgb"](0)) for r in recs])
        m0 = np.stack([r["seeds"][0] for r in recs])
        if args.flip:
            m0 = m0[:, :, ::-1]
        tracker = tracker_for(len(recs), recs[0], rgb0.shape[1:3])
        vdirs = []
        for r in recs:
            vdir = os.path.join(args.out, r["vid"])
            os.makedirs(vdir, exist_ok=True)
            vdirs.append(vdir)
        tracker.process(np.ascontiguousarray(rgb0), np.ascontiguousarray(m0), return_index=True)
        vid_jfs = [[] for _ in recs]

        def stacked_frames():
            for t in range(1, max_n):
                yield t, np.stack([flip_rgb(r["get_rgb"](min(t, r["n"] - 1))) for r in recs])

        for t, rgb in host_prefetch(stacked_frames(), size=2):
            live = [i for i, r in enumerate(recs) if t < r["n"]]
            tp.start()
            idx = tracker.process(rgb, return_index=True)
            tp.stop(units=len(live))
            prob = tracker.last_prob.cpu().numpy() if args.save_scores else None
            for i in live:
                emit_frame(recs[i], vdirs[i], t, idx[i],
                           prob[i] if prob is not None else None, vid_jfs[i])
        for r, jfl in zip(recs[:real], vid_jfs[:real]):
            finish_video(r, jfl)

    with torch.no_grad():
        records = [r for v in videos if (r := scan_video(*v)) is not None]
        if args.video_batch > 1:
            # single-group videos seeded at frame 0 batch; the others keep
            # the per-video path
            batchable = [r for r in records if not r["multi_group"] and r["start"] == 0]
            singles = [r for r in records if r["multi_group"] or r["start"] != 0]
            groups = {}
            for r in batchable:
                h, w = r["get_rgb"](0).shape[:2]
                groups.setdefault((h, w, r["num_obj"]), []).append(r)
            for key, recs in sorted(groups.items(), key=lambda kv: kv[0]):
                recs.sort(key=lambda r: r["n"])  # the fewest clamped tail steps
                for i in range(0, len(recs), args.video_batch):
                    chunk = recs[i:i + args.video_batch]
                    print(f"[eval_xmem] batching {len(chunk)} videos (hw={key[0]}x{key[1]}, "
                          f"{key[2]} objects): " + ", ".join(r["vid"] for r in chunk))
                    run_batch(chunk, pad_to=args.video_batch if i > 0 else None)
            for rec in singles:
                run_single(rec)
        else:
            for rec in records:
                run_single(rec)
    if per_video:
        # global J and F: the mean of per-sequence means (davis2017-evaluation);
        # frame-weighted means under their own names
        blob = {"per_video": per_video, "global": {
            "J": float(np.mean([v["J"] for v in per_video.values()])),
            "F": float(np.mean([v["F"] for v in per_video.values()])),
            "J_frame_mean": float(np.mean([m["J"] for m in jfs])),
            "F_frame_mean": float(np.mean([m["F"] for m in jfs])),
            "fg_iou_frame_mean": float(np.mean(ious)) if ious else None,
            "fps": tp.per_second}}
        g = blob["global"]
        g["JF"] = (g["J"] + g["F"]) / 2
        with open(os.path.join(args.out, "metrics.json"), "w") as f:
            json.dump(blob, f, indent=1)
    line = f"[eval_xmem] FPS: {tp.per_second:.2f}"
    if ious:
        line += f", fg-IoU vs GT: {np.mean(ious):.3f}"
    if jfs:
        J = np.mean([m["J"] for m in jfs])
        F = np.mean([m["F"] for m in jfs])
        line += f", J: {J:.3f}, F: {F:.3f}, J&F: {(J + F) / 2:.3f}"
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

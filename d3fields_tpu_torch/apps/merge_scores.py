"""Merge per-object probability maps of several eval runs into masks.

Counterpart of ``d3fields_tpu/apps/merge_scores.py`` (reference
``XMem/merge_multi_scale.py``): each input directory holds the
``--save_scores`` output of one ``apps.eval_xmem`` run (other processing
sizes, ``--flip``); per frame the probability maps are averaged (resized to
the first run's resolution where the sizes differ) and argmaxed into index
masks, written as paletted PNGs:

  python -m d3fields_tpu_torch.apps.merge_scores --inputs out/s480 out/s600_flip \\
      --out out/merged

It runs on the host (numpy, and torch for the resize); ``device`` is
checked as every entry point checks it, CUDA unless ``main`` is given
another.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--inputs", nargs="+", required=True,
                   help="eval_xmem --save_scores output roots to merge")
    p.add_argument("--out", required=True)
    return p


def _resize_prob(prob: np.ndarray, hw) -> np.ndarray:
    """(H, W, C) float32 -> (h, w, C), bilinear per channel with half-pixel
    centres (``cv2.resize``'s INTER_LINEAR on float32)."""
    if prob.shape[:2] == tuple(hw):
        return prob
    x = torch.from_numpy(np.ascontiguousarray(prob)).permute(2, 0, 1)[None]
    out = F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)
    return out[0].permute(1, 2, 0).numpy()


def merge_video(in_dirs, out_dir) -> int:
    """Average the per-frame .npy score maps of one video; returns the
    number of frames."""
    from d3fields_tpu_torch.utils.visualization import save_index_mask_png

    os.makedirs(out_dir, exist_ok=True)
    names = sorted(n for n in os.listdir(in_dirs[0]) if n.endswith(".npy"))
    for name in names:
        acc = None
        for d in in_dirs:
            prob = np.load(os.path.join(d, name)).astype(np.float32)
            acc = prob if acc is None else acc + _resize_prob(prob, acc.shape[:2])
        save_index_mask_png(os.path.join(out_dir, name.replace(".npy", ".png")),
                            acc.argmax(-1).astype(np.uint8))
    return len(names)


def main(argv=None, *, device=None):
    """The CLI. ``device`` defaults to CUDA and raises when no GPU is visible."""
    from d3fields_tpu_torch.utils.device import resolve_device

    args = build_parser().parse_args(argv)
    resolve_device(device)
    videos = sorted(v for v in os.listdir(args.inputs[0])
                    if os.path.isdir(os.path.join(args.inputs[0], v)))
    if not videos:  # flat layout: the roots are single-video score directories
        n = merge_video(args.inputs, args.out)
        print(f"[merge_scores] merged {n} frames from {len(args.inputs)} runs")
        return 0
    total = 0
    for vid in videos:
        dirs = [os.path.join(root, vid) for root in args.inputs]
        total += merge_video([d for d in dirs if os.path.isdir(d)], os.path.join(args.out, vid))
    print(f"[merge_scores] merged {len(videos)} videos ({total} frames) from "
          f"{len(args.inputs)} runs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

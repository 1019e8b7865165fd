"""Video data for XMem: the evaluation half.

Counterpart of ``d3fields_tpu/models/xmem/data.py:125-214``: the video
layouts the reference's ``XMem/eval.py`` reads (generic
``<root>/<video>/{frames,masks}``, DAVIS ``JPEGImages/480p``, YouTube-VOS
``JPEGImages/<video>``), ImageSets splits, and paletted annotation masks,
decoded through :mod:`d3fields_tpu_torch.utils.png` to their object
indices. The training half of the JAX module (clip sampling, the crop
augmentation, the thin-plate-spline warp and the loaders) belongs to XMem
training and is not ported yet.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np

from d3fields_tpu_torch.utils.png import read_png

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def load_split(root: str, subset: str) -> Optional[set]:
    """Video names of an ImageSets split (``<root>/ImageSets/**/
    <subset>.txt``, one name per line) — the reference's
    ``load_sub_davis``/``load_sub_yv`` (``util/load_subset.py``). None if
    the checkout carries no such split file."""
    for rel in (os.path.join("ImageSets", "2017", subset + ".txt"),
                os.path.join("ImageSets", "480p", subset + ".txt"),
                os.path.join("ImageSets", subset + ".txt")):
        path = os.path.join(root, rel)
        if os.path.exists(path):
            names = set()
            with open(path) as f:
                for ln in f:
                    ln = ln.strip()
                    if not ln:
                        continue
                    tok = ln.split()[0]
                    if "JPEGImages" in tok:
                        # 480p-style row: /JPEGImages[/<res>]/<video>/<file>
                        parts = os.path.normpath(tok).strip(os.sep).split(os.sep)
                        i = parts.index("JPEGImages")
                        names.add(parts[i + 2] if len(parts) > i + 3
                                  else parts[i + 1])
                    else:
                        names.add(tok)  # 2017-style row: just the name
            return names
    return None


def resolve_video_dirs(root: str, subset: Optional[str] = None):
    """Yield ``(video_name, frames_dir, masks_dir)`` for either the generic
    ``<root>/<video>/{frames,masks}`` layout or a DAVIS / YouTubeVOS
    checkout (``JPEGImages[/<res>]/<video>`` with annotations in the
    parallel ``Annotations`` tree — the layouts the reference's
    ``XMem/eval.py``/``train.py`` dataset paths point into).

    ``subset`` filters to an ImageSets split (e.g. ``"train"`` on a DAVIS
    trainval checkout — the reference's ``load_sub_davis`` guard against
    training on val videos). A missing split file keeps every video and
    warns."""
    keep = None
    if subset is not None:
        keep = load_split(root, subset)
        if keep is None:
            warnings.warn(
                f"no ImageSets/{subset}.txt under {root}; using ALL videos "
                "(make sure this checkout holds only the intended split)"
            )
    jdir = os.path.join(root, "JPEGImages")
    if os.path.isdir(jdir):
        adir = os.path.join(root, "Annotations")
        sub = sorted(d for d in os.listdir(jdir)
                     if os.path.isdir(os.path.join(jdir, d)))
        if sub:
            # DAVIS inserts a resolution level (480p/1080p/Full-Resolution)
            # whose entries are themselves directories of videos
            first = os.path.join(jdir, sub[0])
            inner = os.listdir(first)
            if inner and all(os.path.isdir(os.path.join(first, e))
                             for e in inner):
                res = "480p" if "480p" in sub else sub[0]
                jdir, adir = os.path.join(jdir, res), os.path.join(adir, res)
                sub = sorted(d for d in os.listdir(jdir)
                             if os.path.isdir(os.path.join(jdir, d)))
        for vid in sub:
            if keep is None or vid in keep:
                yield vid, os.path.join(jdir, vid), os.path.join(adir, vid)
        return
    for vid in sorted(os.listdir(root)):
        fdir = os.path.join(root, vid, "frames")
        if os.path.isdir(fdir) and (keep is None or vid in keep):
            yield vid, fdir, os.path.join(root, vid, "masks")


def load_index_mask(path: str) -> np.ndarray:
    """An index (annotation) mask with its object ids: a paletted PNG gives
    its palette indices, an RGB or RGBA one its first channel."""
    m = read_png(path)
    if m.ndim == 3:
        m = m[..., 0]
    return m

"""Video data for XMem: the training pipeline and the video layouts.

Counterpart of ``d3fields_tpu/models/xmem/data.py`` (the reference's
``XMem/dataset/vos_dataset.py``, ``static_dataset.py`` and ``tps.py``):

- the layouts the reference reads (generic ``<root>/<video>/{frames,masks}``,
  DAVIS ``JPEGImages/480p``, YouTube-VOS ``JPEGImages/<video>``), ImageSets
  splits, and paletted annotation masks decoded to their object indices;
- the training half: temporal-skip clip sampling, the shared
  crop-and-resize, the directory, synthetic and static-image sources, the
  clip loaders and the skip curriculum. Batches are numpy, as the JAX
  package's:

    frames   (B, T, H, W, 3) float32, ImageNet-normalised
    first_gt (B, O, H, W)    one-hot masks of frame 0
    cls_gt   (B, T, H, W)    int object indices (0 = background)
    selector (B, O)          1.0 for live objects

  (``trainer.to_device_batch`` moves one to the card).

The sampling is the JAX module's, numpy ``RandomState`` draw for draw, and
OpenCV's resizes, warps and remaps are reproduced byte for byte
(:mod:`d3fields_tpu_torch.utils.imgwarp`), so that from one seed the port
assembles the JAX package's clips bit for bit. Frames are read with
``utils/png.py::imread_color`` (PNG, and JPEG through ``utils/jpeg.py``).
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from d3fields_tpu_torch.models.common import IMAGENET_MEAN, IMAGENET_STD
from d3fields_tpu_torch.utils import imgwarp
from d3fields_tpu_torch.utils.png import imread_color, imread_gray, read_png

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def sample_frame_indices(length: int, num_frames: int, max_jump: int,
                         rs: np.random.RandomState) -> List[int]:
    """Temporal-skip sampling (``vos_dataset.py:112-126``)."""
    if length < num_frames:
        raise ValueError(
            f"video has {length} frames, need >= {num_frames} "
            "(the loader filters these out like the reference VOSDataset)"
        )
    jump = min(length, max_jump)
    idxs = [int(rs.randint(length))]
    acceptable = set(
        range(max(0, idxs[-1] - jump), min(length, idxs[-1] + jump + 1))
    ) - set(idxs)
    while len(idxs) < num_frames:
        nxt = int(rs.choice(sorted(acceptable)))
        idxs.append(nxt)
        acceptable |= set(
            range(max(0, nxt - jump), min(length, nxt + jump + 1))
        )
        acceptable -= set(idxs)
    idxs = sorted(idxs)
    if rs.rand() < 0.5:
        idxs = idxs[::-1]
    return idxs


def _crop_resize(img: np.ndarray, crop: Tuple[int, int, int, int],
                 out_hw: Tuple[int, int], nearest: bool) -> np.ndarray:
    y0, x0, h, w = crop
    return imgwarp.resize_u8(img[y0 : y0 + h, x0 : x0 + w], out_hw, nearest=nearest)


def assemble_clip(
    frames: np.ndarray, masks: np.ndarray, *, out_hw: Tuple[int, int],
    max_num_obj: int, rs: np.random.RandomState,
    crop_scale: Tuple[float, float] = (0.36, 1.0),
) -> Optional[Dict[str, np.ndarray]]:
    """(T, H, W, 3) uint8 + (T, H, W) index masks -> one trainer sample.

    A shared random crop-and-resize plays the role of the reference's
    geometric augmentations; objects absent from frame 0 are dropped
    (they cannot seed the memory), extra objects beyond ``max_num_obj``
    are subsampled (``vos_dataset.py:171-200``).
    """
    T, H, W = masks.shape
    scale = rs.uniform(*crop_scale)
    ch = max(2, int(round(H * np.sqrt(scale))))
    cw = max(2, int(round(W * np.sqrt(scale))))
    y0 = rs.randint(H - ch + 1)
    x0 = rs.randint(W - cw + 1)
    crop = (y0, x0, ch, cw)

    out_frames = np.stack([
        _crop_resize(frames[t], crop, out_hw, nearest=False) for t in range(T)
    ]).astype(np.float32) / 255.0
    out_frames = (out_frames - IMAGENET_MEAN) / IMAGENET_STD
    out_masks = np.stack([
        _crop_resize(masks[t].astype(np.uint8), crop, out_hw, nearest=True)
        for t in range(T)
    ])

    labels = np.unique(out_masks[0])
    labels = labels[labels != 0]
    if labels.shape[0] == 0:
        return None
    if labels.shape[0] > max_num_obj:
        labels = rs.choice(labels, size=max_num_obj, replace=False)

    oh, ow = out_hw
    first_gt = np.zeros((max_num_obj, oh, ow), np.float32)
    cls_gt = np.zeros((T, oh, ow), np.int64)
    selector = np.zeros((max_num_obj,), np.float32)
    for slot, lab in enumerate(labels):
        first_gt[slot] = out_masks[0] == lab
        cls_gt[out_masks == lab] = slot + 1
        selector[slot] = 1.0
    return {
        "frames": out_frames.astype(np.float32),
        "first_gt": first_gt,
        "cls_gt": cls_gt,
        "selector": selector,
    }


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


class DirectoryVideoSource:
    """Real-video training source over any layout ``resolve_video_dirs``
    understands (generic ``frames/masks``, DAVIS, YouTubeVOS) — the
    directory analogue of VOSDataset's im/gt roots. Every sampled frame
    must have an annotation (the VOS training contract)."""

    def __init__(self, root: str, subset: Optional[str] = None):
        self.root = root
        self._dirs = {v: (f, m)
                      for v, f, m in resolve_video_dirs(root, subset=subset)}
        self.videos = sorted(self._dirs)
        if not self.videos:
            raise FileNotFoundError(f"no videos under {root}")
        self._names = {}

    def _frame_names(self, video: str):
        if video not in self._names:
            fdir = self._dirs[video][0]
            self._names[video] = sorted(
                n for n in os.listdir(fdir)
                if n.lower().endswith(IMAGE_EXTS))
        return self._names[video]

    def load(self, video: str, indices: Sequence[int]):
        fdir, mdir = self._dirs[video]
        names = self._frame_names(video)
        frames, masks = [], []
        for i in indices:
            frames.append(imread_color(os.path.join(fdir, names[i]))[..., ::-1])
            mpath = os.path.join(
                mdir, os.path.splitext(names[i])[0] + ".png")
            if not os.path.exists(mpath):
                raise FileNotFoundError(
                    f"no annotation for frame {names[i]} of {video!r} "
                    f"(expected {mpath}); VOS training samples need a mask "
                    "on every frame"
                )
            masks.append(load_index_mask(mpath))
        return np.stack(frames), np.stack(masks)

    def length(self, video: str) -> int:
        return len(self._frame_names(video))


class SyntheticVideoSource:
    """Data-free source: drifting-sphere videos from utils.synthetic."""

    def __init__(self, num_videos: int = 8, length: int = 12,
                 hw: Tuple[int, int] = (96, 128)):
        self.videos = [f"synthetic_{i}" for i in range(num_videos)]
        self._length = length
        self.hw = hw

    def length(self, video: str) -> int:
        return self._length

    def load(self, video: str, indices: Sequence[int]):
        from d3fields_tpu_torch.utils.synthetic import render_sphere_scene

        seed = int(video.split("_")[-1])
        rs = np.random.RandomState(seed)
        vel = rs.uniform(-0.01, 0.01, (2, 3))
        vel[:, 2] = 0.0
        frames, masks = [], []
        for t in indices:
            sc = render_sphere_scene(
                num_views=1, H=self.hw[0], W=self.hw[1], feat_dim=4,
                seed=seed, sphere_offsets=vel * t,
            )
            frames.append(sc["color"][0])
            m = np.zeros(self.hw, np.uint8)
            for si in range(sc["sphere_masks"].shape[1]):
                m[sc["sphere_masks"][0, si]] = si + 1
            masks.append(m)
        return np.stack(frames), np.stack(masks)


def _stack_batch(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class VideoClipLoader:
    """Batches trainer samples with reference sampling semantics."""

    def __init__(self, source, *, num_frames: int = 3, max_jump: int = 5,
                 max_num_obj: int = 3, out_hw: Tuple[int, int] = (96, 128),
                 seed: int = 0, finetune: bool = False):
        self.source = source
        self.num_frames = num_frames
        self.max_jump = max_jump
        self.max_num_obj = max_num_obj
        self.out_hw = out_hw
        # finetune = fewer augmentations to train the sensory memory
        # (reference vos_dataset.py:56-60 zeroes the affine degrees/shear):
        # here the random crop-and-resize collapses to the full frame
        self.finetune = finetune
        self.rs = np.random.RandomState(seed)
        # the reference VOSDataset skips videos shorter than the clip
        # length; filter once here (source lengths are static)
        self.eligible = [
            v for v in source.videos if source.length(v) >= num_frames
        ]
        if not self.eligible:
            raise ValueError(
                f"no video has >= {num_frames} frames "
                f"({len(source.videos)} videos in the source)"
            )

    def set_max_jump(self, max_jump: int) -> None:
        self.max_jump = max_jump

    def set_finetune(self, finetune: bool) -> None:
        self.finetune = finetune

    def sample(self) -> Dict[str, np.ndarray]:
        for _ in range(200 * len(self.eligible)):
            video = self.eligible[self.rs.randint(len(self.eligible))]
            idxs = sample_frame_indices(
                self.source.length(video), self.num_frames, self.max_jump,
                self.rs,
            )
            frames, masks = self.source.load(video, idxs)
            out = assemble_clip(
                frames, masks, out_hw=self.out_hw,
                max_num_obj=self.max_num_obj, rs=self.rs,
                crop_scale=(1.0, 1.0) if self.finetune else (0.36, 1.0),
            )
            if out is not None:
                return out
        raise RuntimeError(
            "no sampleable clip: every attempt produced a frame-0 without "
            "labeled objects (empty/invalid masks in the source?)"
        )

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        return _stack_batch([self.sample() for _ in range(batch_size)])


class MixedClipLoader:
    """Weighted mixture over several clip loaders — the reference's
    ``ConcatDataset([davis_dataset] * 5 + [yv_dataset])``
    (``XMem/train.py:125-138``): each sample draws a loader with
    probability proportional to its weight (there: 5 x len(davis) vs
    len(yv)). ``jump_divisors`` carries the reference's per-dataset
    ``max_skip // 5`` scaling for datasets annotated every N frames."""

    def __init__(self, loaders: Sequence, weights: Sequence[float], *,
                 jump_divisors: Optional[Sequence[int]] = None,
                 seed: int = 0):
        if len(loaders) != len(weights) or not loaders:
            raise ValueError("need one weight per loader (and >= 1 loader)")
        self.loaders = list(loaders)
        w = np.asarray(weights, np.float64)
        if (w <= 0).any():
            raise ValueError(f"weights must be positive, got {weights}")
        self.p = w / w.sum()
        self.jump_divisors = list(jump_divisors or [1] * len(loaders))
        if len(self.jump_divisors) != len(self.loaders):
            raise ValueError("need one jump divisor per loader")
        self.rs = np.random.RandomState(seed)
        # apply the divisors to the initial skip immediately — the
        # reference constructs yv_dataset with max_skip//5 from iteration 0
        # (train.py:127-128), not only after the first schedule switch
        for ld, div in zip(self.loaders, self.jump_divisors):
            ld.max_jump = max(1, ld.max_jump // div)

    def set_max_jump(self, max_jump: int) -> None:
        for ld, div in zip(self.loaders, self.jump_divisors):
            ld.max_jump = max(1, max_jump // div)

    def set_finetune(self, finetune: bool) -> None:
        for ld in self.loaders:
            ld.finetune = finetune

    def sample(self) -> Dict[str, np.ndarray]:
        i = int(self.rs.choice(len(self.loaders), p=self.p))
        return self.loaders[i].sample()

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        return _stack_batch([self.sample() for _ in range(batch_size)])


def max_skip_schedule(stage: int, iterations: int) -> List[Tuple[int, int]]:
    """The temporal-skip curriculum as ``(change_iteration, skip_value)``
    pairs (reference ``train.py:155-202``): training starts at skip 5 and
    switches to 10, 15, then back to 5 at fractions of the stage's
    iteration budget — [0.1, 0.3, 0.8] for stage 1, [0.1, 0.3, 0.9] for
    stages 2/3. Stage 0 (static pseudo-videos) has no schedule."""
    if stage == 0:
        return []
    fracs = (0.1, 0.3, 0.8) if stage == 1 else (0.1, 0.3, 0.9)
    return [(round(iterations * f), v) for f, v in zip(fracs, (10, 15, 5))]


def skip_at(schedule: Sequence[Tuple[int, int]], it: int,
            initial: int = 5) -> int:
    """Scheduled max_skip at iteration ``it`` (last passed change wins)."""
    cur = initial
    for change_it, val in schedule:
        if it >= change_it:
            cur = val
    return cur


# ---------------------------------------------------------------------------
# Static-image pseudo-video pretraining (reference static_dataset.py + tps.py)
# ---------------------------------------------------------------------------

def _tps_backward_map(c_dst: np.ndarray, c_src: np.ndarray,
                      hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Thin-plate-spline backward map: remap coordinates (mapx, mapy) such
    that output(y, x) = input(f(y, x)), with f interpolating
    c_dst -> c_src (normalized [0,1] (y, x) control points).

    Self-contained port of the reference's ``thinplate`` usage
    (``XMem/dataset/tps.py:14-19``): U(r) = r^2 log r^2 kernel, affine +
    warp coefficients from the standard TPS linear system.
    """
    H, W = hw
    n = c_dst.shape[0]

    def U(r2):
        return np.where(r2 > 1e-12, r2 * np.log(np.maximum(r2, 1e-12)), 0.0)

    d2 = ((c_dst[:, None] - c_dst[None]) ** 2).sum(-1)     # (n, n)
    K = U(d2)
    P = np.concatenate([np.ones((n, 1)), c_dst], axis=1)   # (n, 3)
    A = np.zeros((n + 3, n + 3))
    A[:n, :n] = K
    A[:n, n:] = P
    A[n:, :n] = P.T
    rhs = np.concatenate([c_src, np.zeros((3, 2))], axis=0)
    coef = np.linalg.solve(A + 1e-9 * np.eye(n + 3), rhs)  # (n+3, 2)

    ys, xs = np.meshgrid(np.arange(H) / H, np.arange(W) / W, indexing="ij")
    grid = np.stack([ys.ravel(), xs.ravel()], 1)           # (HW, 2) (y, x)
    g2 = ((grid[:, None] - c_dst[None]) ** 2).sum(-1)      # (HW, n)
    basis = np.concatenate(
        [U(g2), np.ones((grid.shape[0], 1)), grid], axis=1
    )                                                      # (HW, n+3)
    out = basis @ coef                                     # (HW, 2) src (y, x)
    mapy = (out[:, 0] * H).reshape(H, W).astype(np.float32)
    mapx = (out[:, 1] * W).reshape(H, W).astype(np.float32)
    return mapx, mapy


def random_tps_warp(img: np.ndarray, mask: np.ndarray, scale: float,
                    rs: np.random.RandomState, n_ctrl_pts: int = 12):
    """Random TPS warp of an image + mask (``tps.py:22-37``): ``n_ctrl_pts``
    control points jittered by N(0, scale); bilinear image / nearest mask
    resampling."""
    h, w = mask.shape[:2]
    c_src = np.stack(
        [rs.choice(h, n_ctrl_pts, replace=False) / h,
         rs.choice(w, n_ctrl_pts, replace=False) / w], axis=1)
    c_dst = c_src + rs.normal(scale=scale, size=c_src.shape)
    mapx, mapy = _tps_backward_map(c_dst, c_src, (h, w))
    wi = imgwarp.remap_u8(img, mapx, mapy)
    wm = imgwarp.remap_u8(mask, mapx, mapy, nearest=True)
    return wi, wm


class StaticImageSource:
    """Pseudo-video clips from STATIC image+mask pairs — the reference's
    s0 pretraining stage (``StaticTransformDataset``,
    ``static_dataset.py:16-137``): every "frame" is an independent random
    affine jitter of the same image (rotation/scale/shear around a shared
    sequence-level scale), plus a 33%-probability TPS warp of scale 0.02.

    ``pairs``: list of (image (H, W, 3) uint8, mask (H, W) uint8 index),
    or ``root`` pointing at any of
    - a flat directory of ``X.jpg`` + ``X.png`` pairs (the reference's
      method-1 layout: DUTS, ecssd, BIG, HRSOD),
    - a class-subdirectory tree ``<class>/X.jpg + X.png`` (method 0, the
      FSS layout),
    - the reference's combined ``static_root`` holding the six datasets,
      mixed with the reference's duplication factors
      (``train.py:162-173``: fss/DUTS-TR/DUTS-TE/ecssd x1,
      BIG_small/HRSOD_small x5).
    Images load lazily at sample time (the reference keeps paths too) so
    tens of thousands of stills don't sit in RAM. Color jitter is
    brightness/contrast instead of torchvision ColorJitter.
    """

    # (subdir, method, multiplier) — reference train.py:162-173
    REFERENCE_STATIC_SETS = (
        ("fss", 0, 1), ("DUTS-TR", 1, 1), ("DUTS-TE", 1, 1),
        ("ecssd", 1, 1), ("BIG_small", 1, 5), ("HRSOD_small", 1, 5),
    )

    @staticmethod
    def _flat_pairs(d):
        return [(os.path.join(d, n), os.path.join(d, n[:-4] + ".png"))
                for n in sorted(os.listdir(d))
                if n.lower().endswith(".jpg")
                and os.path.exists(os.path.join(d, n[:-4] + ".png"))]

    @classmethod
    def _class_pairs(cls, d):
        out = []
        for c in sorted(os.listdir(d)):
            sub = os.path.join(d, c)
            if os.path.isdir(sub):
                out.extend(cls._flat_pairs(sub))
        return out

    def __init__(self, pairs=None, root: Optional[str] = None,
                 length: int = 1000, seed: int = 0):
        if pairs is None:
            pairs = []
            present = [(n, m, k) for n, m, k in self.REFERENCE_STATIC_SETS
                       if os.path.isdir(os.path.join(root, n))]
            if present:
                for name, method, mult in present:
                    d = os.path.join(root, name)
                    found = (self._class_pairs(d) if method == 0
                             else self._flat_pairs(d))
                    pairs.extend(found * mult)
            else:
                pairs = self._flat_pairs(root) or self._class_pairs(root)
            if not pairs:
                raise FileNotFoundError(f"no jpg/png pairs under {root}")
        self.pairs = pairs
        self.videos = [f"static_{i}" for i in range(len(pairs))]
        self._length = length  # virtual frames; every index is a new warp
        self.rs = np.random.RandomState(seed)

    def _resolve(self, i: int):
        """Lazy path -> array resolution (in-memory pairs pass through).
        An unreadable file (one corrupt jpg among tens of thousands of
        stills) must not kill a 150k-iteration stage-0 run: warn once and
        substitute the next readable pair."""
        for attempt in range(len(self.pairs)):
            img, mask = self.pairs[(i + attempt) % len(self.pairs)]
            if not isinstance(img, str):
                return img, mask
            try:
                im = imread_color(img)
                m = imread_gray(mask)
            except (OSError, ValueError):
                warnings.warn(f"unreadable static pair {img} / {mask}; "
                              "substituting the next one")
                continue
            # 0/255 binary masks (FSS/saliency layouts) binarize;
            # small-valued masks are already object INDICES — keep them
            if m.max() > 10:
                m = (m > 127).astype(np.uint8)
            return im[..., ::-1], m.astype(np.uint8)
        raise FileNotFoundError("no readable image/mask pair in the source")

    def length(self, video: str) -> int:
        return self._length

    def _one_frame(self, img, mask, seq_scale, rs):
        h, w = mask.shape
        ang = rs.uniform(-20, 20)
        sc = seq_scale * rs.uniform(0.9, 1.1)
        shear = np.deg2rad(rs.uniform(-10, 10))
        # center-anchored rotate+scale+shear (torchvision RandomAffine
        # anchors every component at the image center): T(c) S R T(-c)
        c = np.array([w / 2, h / 2])
        R = imgwarp.rotation_matrix_2d(tuple(c), ang, sc)[:, :2]  # 2x2
        Sh = np.array([[1.0, np.tan(shear)], [0.0, 1.0]])
        A = R @ Sh
        M = np.concatenate([A, (c - A @ c)[:, None]], axis=1)
        fill = (124, 116, 104)  # im_mean fill (range_transform.py)
        fi = imgwarp.warp_affine_u8(img, M, (w, h), border=fill)
        fm = imgwarp.warp_affine_u8(mask, M, (w, h), nearest=True, border=0)
        if rs.rand() < 0.33:
            fi, fm = random_tps_warp(fi, fm, scale=0.02, rs=rs)
        # brightness/contrast jitter (ColorJitter(0.1, 0.05) stand-in)
        alpha = rs.uniform(0.95, 1.05)
        beta = rs.uniform(-0.1, 0.1) * 255
        fi = np.clip(fi.astype(np.float32) * alpha + beta, 0, 255).astype(np.uint8)
        return fi, fm

    def load(self, video: str, indices: Sequence[int]):
        img, mask = self._resolve(int(video.split("_")[-1]))
        seq_scale = self.rs.uniform(0.8, 1.5)
        frames, masks = [], []
        for _ in indices:
            fi, fm = self._one_frame(img, mask, seq_scale, self.rs)
            frames.append(fi)
            masks.append(fm)
        return np.stack(frames), np.stack(masks)

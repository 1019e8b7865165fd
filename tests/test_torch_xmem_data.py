"""Port parity: the XMem training data pipeline (``models/xmem/data.py``,
``utils/imgwarp.py``, ``utils/png.py::imread_gray``) of d3fields_tpu_torch
against d3fields_tpu and OpenCV.

From the same ``RandomState`` seeds the port must assemble the JAX
package's clips bit for bit: its frame indices, crops, static-image warps,
thin-plate-spline warps and batches are compared with ``np.array_equal``.
Each OpenCV equivalent is held to ``cv2`` itself on random uint8 images and
random maps, byte for byte. The last tests are the ports of
tests/test_apps.py:405-480 and :547-620.
"""

import os

import cv2
import numpy as np
import pytest

from d3fields_tpu.models.xmem import data as JD
from d3fields_tpu_torch.models.xmem import data as D
from d3fields_tpu_torch.utils import imgwarp as IW
from d3fields_tpu_torch.utils.png import imread_gray


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _affine(rs, h, w):
    """A static-image jitter matrix, as ``StaticImageSource._one_frame``
    builds it."""
    c = np.array([w / 2, h / 2])
    R = cv2.getRotationMatrix2D(tuple(c), rs.uniform(-20, 20), rs.uniform(0.7, 1.6))
    A = R[:, :2] @ np.array([[1.0, np.tan(np.deg2rad(rs.uniform(-10, 10)))], [0.0, 1.0]])
    return np.concatenate([A, (c - A @ c)[:, None]], axis=1)


# ---------------------------------------------------------------------------
# the OpenCV equivalents against cv2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_resize_equals_cv2(seed):
    rs = np.random.RandomState(seed)
    for _ in range(40):
        H, W = rs.randint(1, 120, 2)
        h, w = rs.randint(1, 130, 2)
        img = rs.randint(0, 256, (H, W, 3), np.uint8)
        mask = rs.randint(0, 5, (H, W)).astype(np.uint8)
        assert np.array_equal(IW.resize_u8(img, (h, w)), cv2.resize(img, (w, h)))
        assert np.array_equal(IW.resize_u8(mask, (h, w), nearest=True),
                              cv2.resize(mask, (w, h), interpolation=cv2.INTER_NEAREST))
    # an exact 2x downscale in both axes, which OpenCV serves by its area path
    # (finetune mode's full-frame crop at 768 -> 384)
    img = rs.randint(0, 256, (768, 1024, 3), np.uint8)
    assert np.array_equal(IW.resize_u8(img, (384, 512)), cv2.resize(img, (512, 384)))


@pytest.mark.parametrize("seed", range(3))
def test_warp_affine_and_rotation_equal_cv2(seed):
    rs = np.random.RandomState(10 + seed)
    for _ in range(40):
        h, w = rs.randint(4, 150, 2)
        img = rs.randint(0, 256, (h, w, 3), np.uint8)
        mask = rs.randint(0, 4, (h, w)).astype(np.uint8)
        c, ang, sc = (w / 2, h / 2), rs.uniform(-20, 20), rs.uniform(0.7, 1.6)
        assert np.array_equal(IW.rotation_matrix_2d(c, ang, sc),
                              cv2.getRotationMatrix2D(c, ang, sc))
        M = _affine(rs, h, w)
        fill = (124, 116, 104)
        assert np.array_equal(
            IW.warp_affine_u8(img, M, (w, h), border=fill),
            cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR, borderValue=fill))
        assert np.array_equal(
            IW.warp_affine_u8(mask, M, (w, h), nearest=True),
            cv2.warpAffine(mask, M, (w, h), flags=cv2.INTER_NEAREST, borderValue=0))


@pytest.mark.parametrize("seed", range(3))
def test_remap_equals_cv2(seed):
    rs = np.random.RandomState(20 + seed)
    for i in range(40):
        h, w = rs.randint(2, 150, 2)
        img = rs.randint(0, 256, (h, w, 3), np.uint8)
        mask = rs.randint(0, 4, (h, w)).astype(np.uint8)
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        mapx = (xs + rs.normal(0, 4, (h, w))).astype(np.float32)
        mapy = (ys + rs.normal(0, 4, (h, w))).astype(np.float32)
        if i % 4 == 0:  # ties of the nearest rounding
            mapx, mapy = np.round(mapx * 2) / 2, np.round(mapy * 2) / 2
        assert np.array_equal(IW.remap_u8(img, mapx, mapy),
                              cv2.remap(img, mapx, mapy, cv2.INTER_LINEAR))
        assert np.array_equal(IW.remap_u8(mask, mapx, mapy, nearest=True),
                              cv2.remap(mask, mapx, mapy, cv2.INTER_NEAREST))


def test_imread_gray_equals_cv2(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(3)
    img = rs.randint(0, 256, (33, 47, 3), np.uint8)
    img[:5] = img[:5, :, :1]  # grey pixels of a colour file keep their value
    cv2.imwrite(str(tmp_path / "c.png"), img)
    cv2.imwrite(str(tmp_path / "g.png"), rs.randint(0, 256, (33, 47), np.uint8))
    pim = Image.fromarray(rs.randint(0, 4, (33, 47)).astype(np.uint8), mode="P")
    pim.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0, 10, 20, 30] + [0] * 756)
    pim.save(str(tmp_path / "p.png"))
    for n in ("c.png", "g.png", "p.png"):
        assert np.array_equal(imread_gray(str(tmp_path / n)),
                              cv2.imread(str(tmp_path / n), cv2.IMREAD_GRAYSCALE)), n


# ---------------------------------------------------------------------------
# the pipeline against the JAX package, from the same seeds
# ---------------------------------------------------------------------------

def test_sample_frame_indices_and_schedule_match_jax():
    for seed in range(30):
        args = (1 + seed % 4 + seed % 7, 1 + seed % 4, 1 + seed % 6)  # length, T, jump
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        for _ in range(5):
            assert D.sample_frame_indices(*args, a) == JD.sample_frame_indices(*args, b)
    for stage in (0, 1, 2, 3):
        for iters in (10, 1000, 150_000):
            sched = D.max_skip_schedule(stage, iters)
            assert sched == JD.max_skip_schedule(stage, iters)
            for it in (0, iters // 10, iters // 3, iters - 1, iters):
                assert D.skip_at(sched, it) == JD.skip_at(sched, it)


@pytest.mark.parametrize("crop_scale", [(0.36, 1.0), (1.0, 1.0)], ids=["normal", "finetune"])
def test_assemble_clip_matches_jax(crop_scale):
    rs = np.random.RandomState(4)
    for seed in range(6):
        T, H, W = 3, int(rs.randint(40, 120)), int(rs.randint(40, 160))
        frames = rs.randint(0, 256, (T, H, W, 3), np.uint8)
        masks = np.zeros((T, H, W), np.uint8)
        for o in range(1, 5):
            y, x = rs.randint(0, H - 10), rs.randint(0, W - 10)
            masks[:, y:y + 10, x:x + 12] = o
        kw = dict(out_hw=(48, 64), max_num_obj=3, crop_scale=crop_scale)
        a = D.assemble_clip(frames, masks, rs=np.random.RandomState(seed), **kw)
        b = JD.assemble_clip(frames, masks, rs=np.random.RandomState(seed), **kw)
        if b is None:
            assert a is None
        else:
            _same(a, b)
    # finetune mode at 768 -> 384: the full frame through the exact 2x path
    frames = rs.randint(0, 256, (2, 768, 768, 3), np.uint8)
    masks = np.zeros((2, 768, 768), np.uint8)
    masks[:, 100:400, 200:500] = 1
    kw = dict(out_hw=(384, 384), max_num_obj=1, crop_scale=(1.0, 1.0))
    _same(D.assemble_clip(frames, masks, rs=np.random.RandomState(0), **kw),
          JD.assemble_clip(frames, masks, rs=np.random.RandomState(0), **kw))


def test_random_tps_warp_matches_jax():
    rs = np.random.RandomState(5)
    for seed in range(4):
        h, w = int(rs.randint(30, 90)), int(rs.randint(30, 90))
        img = rs.randint(0, 256, (h, w, 3), np.uint8)
        mask = rs.randint(0, 3, (h, w)).astype(np.uint8)
        a = D.random_tps_warp(img, mask, 0.02 * (1 + seed), np.random.RandomState(seed))
        b = JD.random_tps_warp(img, mask, 0.02 * (1 + seed), np.random.RandomState(seed))
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _write_pairs(root, n, rs, ext=".jpg"):
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        img = cv2.GaussianBlur(rs.randint(0, 256, (60, 80, 3), np.uint8), (7, 7), 2)
        m = np.zeros((60, 80), np.uint8)
        m[10 + i:40, 15:50 + i] = 255
        cv2.imwrite(os.path.join(root, f"{i}{ext}"), img)
        cv2.imwrite(os.path.join(root, f"{i}.png"), m)


def test_static_image_source_matches_jax(tmp_path, monkeypatch):
    """Affine jitter, TPS warps (both branches of the 33% coin) and the
    colour jitter, from JPEG/PNG pairs on disk and from in-memory pairs."""
    rs = np.random.RandomState(6)
    _write_pairs(str(tmp_path), 3, rs)
    tps = []
    orig = D.random_tps_warp
    monkeypatch.setattr(D, "random_tps_warp", lambda *a, **k: tps.append(1) or orig(*a, **k))
    pairs = [(rs.randint(0, 256, (50, 70, 3), np.uint8),
              (rs.rand(50, 70) > 0.6).astype(np.uint8))]
    for kw in (dict(root=str(tmp_path), seed=3), dict(pairs=pairs, seed=1)):
        a, b = D.StaticImageSource(**kw), JD.StaticImageSource(**kw)
        assert a.videos == b.videos
        for v in a.videos * 2:
            fa, ma = a.load(v, [0, 1, 2])
            fb, mb = b.load(v, [0, 1, 2])
            assert np.array_equal(fa, fb) and np.array_equal(ma, mb)
    assert 0 < len(tps) < 3 * 2 * 4  # some frames warped, some not


def _write_video_root(root, rs, videos=("vidA", "vidB"), n=6, ext=".png"):
    for v, nobj in zip(videos, (1, 2)):
        fdir, mdir = os.path.join(root, v, "frames"), os.path.join(root, v, "masks")
        os.makedirs(fdir)
        os.makedirs(mdir)
        for t in range(n):
            cv2.imwrite(os.path.join(fdir, f"{t:05d}{ext}"),
                        rs.randint(0, 255, (36, 48, 3), np.uint8))
            m = np.zeros((36, 48), np.uint8)
            m[4 + t:24, 4:20] = 1
            if nobj > 1:
                m[6:30, 26:44 - t] = 2
            cv2.imwrite(os.path.join(mdir, f"{t:05d}.png"), m)


@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_clip_loaders_match_jax(tmp_path, ext):
    """VideoClipLoader over directory (PNG or JPEG frames) and synthetic
    sources, and MixedClipLoader over both directory roots, batch for
    batch, across a skip change and the finetune switch."""
    rs = np.random.RandomState(7)
    roots = [str(tmp_path / r) for r in ("davis", "yv")]
    for r in roots:
        _write_video_root(r, rs, ext=ext)
    kw = dict(num_frames=3, max_jump=5, max_num_obj=2, out_hw=(24, 32))

    def build(M):
        mk = lambda root, seed: M.VideoClipLoader(M.DirectoryVideoSource(root), seed=seed, **kw)
        return (M.MixedClipLoader([mk(roots[0], 0), mk(roots[1], 1)], [5.0, 1.0],
                                  jump_divisors=[1, 5]),
                M.VideoClipLoader(M.SyntheticVideoSource(num_videos=2, length=6, hw=(40, 56)),
                                  seed=2, **kw))

    for la, lb in zip(build(D), build(JD)):
        for step in range(3):
            if step == 1:
                la.set_max_jump(15)
                lb.set_max_jump(15)
            if step == 2:
                la.set_finetune(True)
                lb.set_finetune(True)
            _same(la.batch(2), lb.batch(2))


# ---------------------------------------------------------------------------
# ports of tests/test_apps.py:405-480 and :547-620
# ---------------------------------------------------------------------------

def test_stage_presets_and_skip_schedule():
    """Stage presets resolve to the reference Configuration defaults
    (util/configuration.py:35-79) and the skip curriculum matches
    train.py:155-202 (initial 5 -> 10 -> 15 -> 5 at stage fractions)."""
    from d3fields_tpu_torch.apps.train_xmem import build_parser, resolve_stage_args

    a = resolve_stage_args(build_parser().parse_args(["--stage", "3"]))
    assert (a.steps, a.finetune, a.lr_steps) == (100_000, 10_000, (80_000,))
    assert (a.num_frames, a.num_ref_frames, a.batch) == (8, 3, 8)
    a = resolve_stage_args(build_parser().parse_args(["--stage", "3", "--steps", "7"]))
    assert a.steps == 7 and a.num_frames == 8
    a = resolve_stage_args(build_parser().parse_args(["--stage", "0"]))
    assert a.max_num_obj == 1 and D.max_skip_schedule(0, a.steps) == []

    sched = D.max_skip_schedule(3, 100_000)
    assert sched == [(10_000, 10), (30_000, 15), (90_000, 5)]
    assert [D.skip_at(sched, i) for i in (0, 9_999, 10_000, 29_999, 30_000,
                                          89_999, 90_000)] == [5, 5, 10, 10, 15, 15, 5]
    assert D.max_skip_schedule(1, 10)[-1] == (8, 5)


def test_mixed_clip_loader(tmp_path):
    """MixedClipLoader: 5x-weighted sampling over both roots and the
    per-dataset max_skip // 5 scaling (reference train.py:125-138);
    finetune mode collapses the crop augmentation to the full frame."""
    rs = np.random.default_rng(0)
    for root, vid, nobj in [("davis", "vidA", 1), ("yv", "vidB", 2)]:
        fdir = tmp_path / root / vid / "frames"
        mdir = tmp_path / root / vid / "masks"
        fdir.mkdir(parents=True)
        mdir.mkdir()
        for t in range(6):
            cv2.imwrite(str(fdir / f"{t:05d}.png"), rs.integers(0, 255, (24, 32, 3), np.uint8))
            m = np.zeros((24, 32), np.uint8)
            m[4:20, 4:16] = 1
            if nobj > 1:
                m[4:20, 20:30] = 2
            cv2.imwrite(str(mdir / f"{t:05d}.png"), m)

    mk = lambda root, seed: D.VideoClipLoader(  # noqa: E731
        D.DirectoryVideoSource(str(tmp_path / root)), num_frames=3,
        max_jump=5, max_num_obj=2, out_hw=(24, 32), seed=seed)
    davis, yv = mk("davis", 0), mk("yv", 1)
    mixed = D.MixedClipLoader([davis, yv], [5.0, 1.0], jump_divisors=[1, 5])
    assert davis.max_jump == 5 and yv.max_jump == 1
    mixed.set_max_jump(15)
    assert davis.max_jump == 15 and yv.max_jump == 3
    mixed.set_max_jump(5)
    assert davis.max_jump == 5 and yv.max_jump == 1

    b = mixed.batch(4)
    assert b["frames"].shape == (4, 3, 24, 32, 3)
    marks = [int(mixed.rs.choice(2, p=mixed.p)) for _ in range(60)]
    assert sum(m == 0 for m in marks) > 40

    mixed.set_finetune(True)
    assert davis.finetune and yv.finetune
    s = davis.sample()
    assert s["cls_gt"].shape == (3, 24, 32)
    got = s["cls_gt"][0] > 0
    assert got[10, 8] and not got[2, 2]  # the un-cropped mask geometry


def test_static_image_source_layouts(tmp_path):
    """StaticImageSource resolves the reference's static_root recipe
    (train.py:162-173): fss class-subdir layout, flat jpg/png layouts,
    and the 1/1/5 duplication multipliers; images load lazily by path."""
    rs = np.random.default_rng(0)

    def put_pair(d, stem):
        os.makedirs(d, exist_ok=True)
        cv2.imwrite(os.path.join(d, stem + ".jpg"), rs.integers(0, 255, (24, 32, 3), np.uint8))
        m = np.zeros((24, 32), np.uint8)
        m[6:18, 8:24] = 255  # binary saliency mask
        cv2.imwrite(os.path.join(d, stem + ".png"), m)

    root = str(tmp_path / "static")
    put_pair(os.path.join(root, "fss", "classA"), "1")
    put_pair(os.path.join(root, "fss", "classB"), "1")
    put_pair(os.path.join(root, "DUTS-TR"), "a")
    put_pair(os.path.join(root, "BIG_small"), "b")

    src = D.StaticImageSource(root=root)
    assert len(src.videos) == 8  # 2 fss x1 + 1 DUTS x1 + 1 BIG x5
    frames, masks = src.load(src.videos[0], [0, 1])
    assert frames.shape == (2, 24, 32, 3) and masks.max() <= 1
    assert len(D.StaticImageSource(root=os.path.join(root, "DUTS-TR")).videos) == 1
    assert len(D.StaticImageSource(root=os.path.join(root, "fss")).videos) == 2


def test_directory_video_source_davis_layout(tmp_path):
    """DirectoryVideoSource trains off a DAVIS checkout directly (JPEG
    frames): paletted annotation PNGs keep their object indices, and a
    frame without an annotation fails loudly."""
    from PIL import Image

    root = tmp_path / "DAVIS"
    fdir = root / "JPEGImages" / "480p" / "bear"
    adir = root / "Annotations" / "480p" / "bear"
    fdir.mkdir(parents=True)
    adir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for t in range(3):
        cv2.imwrite(str(fdir / f"{t:05d}.jpg"), rng.integers(0, 255, (32, 48, 3), np.uint8))
        if t < 2:  # frame 2 deliberately unannotated
            m = np.zeros((32, 48), np.uint8)
            m[8:16, 8:24] = 1
            m[20:28, 30:40] = 2
            pim = Image.fromarray(m, mode="P")
            pim.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0] + [0] * 759)
            pim.save(str(adir / f"{t:05d}.png"))

    src = D.DirectoryVideoSource(str(root))
    assert src.videos == ["bear"] and src.length("bear") == 3
    frames, masks = src.load("bear", [0, 1])
    assert frames.shape == (2, 32, 48, 3)
    want = np.stack([cv2.imread(str(fdir / f"{t:05d}.jpg"))[..., ::-1] for t in (0, 1)])
    assert np.array_equal(frames, want)  # the JPEG frames as cv2 reads them
    assert sorted(np.unique(masks).tolist()) == [0, 1, 2]
    with pytest.raises(FileNotFoundError, match="no annotation"):
        src.load("bear", [2])

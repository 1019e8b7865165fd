"""Port parity: XMem evaluation (``apps/eval_xmem.py``, ``apps/merge_scores.py``)
of d3fields_tpu_torch against d3fields_tpu.

One video goes through the JAX app and the port's, with one ``.npz``
checkpoint written by the JAX package: the soft probabilities at 1e-4,
the ``.npy`` scores equal to their float16 cast, and the index masks equal
off the near-ties (as ``tests/test_torch_xmem.py`` holds the tracker). A
near-tie label that rounding flips moves J and F by ~1e-4, so each app's
``metrics.json`` is held at 1e-12 to the JAX ``davis_jf`` of its own masks.
The other cases are the JAX app's own
cases of ``tests/test_apps.py`` run on the port. Frames are written by
OpenCV and masks by Pillow, which only the tests import.
"""

import json
import os
import pickle

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from d3fields_tpu.apps import eval_xmem as jeval
from d3fields_tpu.seg import video_tracker as jvt
from d3fields_tpu.utils.convert import save_params
from d3fields_tpu_torch.apps import eval_xmem as teval
from d3fields_tpu_torch.apps import merge_scores as tmerge
from d3fields_tpu_torch.seg import video_tracker as tvt
from test_torch_xmem import tiny_xmem

TINY = ["--size", "48", "--key_dim", "8", "--value_dim", "16", "--hidden_dim", "8"]
PALETTE = [0, 0, 0, 128, 0, 0, 0, 128, 0] + [0] * (253 * 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _save_mask(path, m, palette=PALETTE):
    p = Image.fromarray(m, mode="P")
    p.putpalette(palette)
    p.save(str(path))


def _write_video(fdir, mdir, T, H=48, W=64, seed=0, masks=True, ext=".png"):
    """Random frames and two drifting boxes, annotated on every frame."""
    rs = np.random.RandomState(seed)
    os.makedirs(fdir, exist_ok=True)
    os.makedirs(mdir, exist_ok=True)
    for t in range(T):
        cv2.imwrite(os.path.join(fdir, f"{t:05d}{ext}"),
                    (rs.rand(H, W, 3) * 255).astype(np.uint8))
        if masks:
            m = np.zeros((H, W), np.uint8)
            m[8 + t:24 + t, 6:30] = 1
            m[26:44, 34 + t:58 + t] = 2
            _save_mask(os.path.join(mdir, f"{t:05d}.png"), m)


def _read(path):
    return np.array(Image.open(path))


def _record_probs(monkeypatch, module, sink):
    """Every VideoMaskTracker.process of ``module`` appends its float32
    probabilities to ``sink``."""
    orig = module.VideoMaskTracker.process

    def process(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        p = self.last_prob
        sink.append(np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p))
        return out

    monkeypatch.setattr(module.VideoMaskTracker, "process", process)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """One narrow XMem (PyTorch's default initialisation: JAX's
    ``init_params`` makes the attention a hard argmax whose picks differ
    between the packages by rounding) in the three formats ``--ckpt``
    reads: the JAX ``.npz``, a JAX trainer pickle, and ``XMem.pth``."""
    d = tmp_path_factory.mktemp("ckpt")
    model, jparams, _ = tiny_xmem(5)
    paths = {"npz": str(d / "xmem.npz"), "trainer": str(d / "ckpt.pkl"), "pth": str(d / "XMem.pth")}
    save_params(paths["npz"], jparams)
    import jax
    import optax

    # the JAX trainer's save_checkpoint layout: numpy leaves in optax's types
    state = (optax.ScaleByAdamState(count=np.zeros((), np.int32), mu={}, nu={}),
             optax.EmptyState())
    with open(paths["trainer"], "wb") as f:
        pickle.dump({"it": 3, "params": jax.tree.map(np.asarray, jparams), "opt_state": state}, f)
    torch.save(model.state_dict(), paths["pth"])
    return paths


def test_eval_xmem_matches_jax(tmp_path, ckpts, monkeypatch):
    """A 4-frame, 2-object directory video with paletted masks through both
    apps with the same .npz."""
    _write_video(tmp_path / "data" / "vid0" / "frames", tmp_path / "data" / "vid0" / "masks", 4)
    argv = ["--data_root", str(tmp_path / "data"), "--frames", "0", "--ckpt", ckpts["npz"],
            "--save_scores", *TINY]
    jprobs, tprobs = [], []
    _record_probs(monkeypatch, jvt, jprobs)
    _record_probs(monkeypatch, tvt, tprobs)
    assert jeval.main(argv + ["--out", str(tmp_path / "j")]) == 0
    assert teval.main(argv + ["--out", str(tmp_path / "t")], device="cpu") == 0
    assert len(jprobs) == len(tprobs) == 4
    for t, (a, b) in enumerate(zip(jprobs, tprobs)):
        np.testing.assert_allclose(b, a, atol=1e-4, err_msg=f"frame {t}")
        if t == 0:
            continue
        # the untrained model ties the two objects within 1e-3 at most
        # pixels; a label is held where the margin exceeds twice the tolerance
        top2 = np.sort(a[0], axis=0)[-2:]
        sure = top2[1] - top2[0] > 2e-4
        assert sure.mean() > 0.2
        for pred, probs, root in ((a, jprobs, "j"), (b, tprobs, "t")):
            png = _read(tmp_path / root / "vid0" / f"{t:05d}.png")
            np.testing.assert_array_equal(png, pred[0].argmax(0))
            scores = np.load(tmp_path / root / "vid0" / f"{t:05d}.npy")
            np.testing.assert_array_equal(scores, pred[0].transpose(1, 2, 0).astype(np.float16))
        np.testing.assert_array_equal(b[0].argmax(0)[sure], a[0].argmax(0)[sure])
    from d3fields_tpu.utils.metrics import davis_jf

    for root in ("j", "t"):
        got = json.load(open(tmp_path / root / "metrics.json"))
        scores = [davis_jf(_read(tmp_path / root / "vid0" / f"{t:05d}.png"),
                           _read(tmp_path / "data" / "vid0" / "masks" / f"{t:05d}.png"), 2)
                  for t in (1, 2, 3)]
        assert got["per_video"]["vid0"]["frames_scored"] == 3
        for k in ("J", "F"):
            assert got["global"][k] == pytest.approx(np.mean([m[k] for m in scores]),
                                                      abs=1e-12), (root, k)
        assert 0.0 < got["global"]["J"] < 1.0 and got["global"]["fps"] > 0


@pytest.mark.parametrize("fmt", ["trainer", "pth"])
def test_eval_xmem_checkpoint_formats_agree(tmp_path, ckpts, fmt):
    """A trainer pickle's params and the torch state dict give what the
    .npz gives, bit for bit."""
    _write_video(tmp_path / "data" / "vid0" / "frames", tmp_path / "data" / "vid0" / "masks", 3)
    base = ["--data_root", str(tmp_path / "data"), "--frames", "0", "--save_scores", *TINY]
    for name in ("npz", fmt):
        assert teval.main(base + ["--ckpt", ckpts[name], "--out", str(tmp_path / name)],
                          device="cpu") == 0
    for t in (1, 2):
        np.testing.assert_array_equal(np.load(tmp_path / fmt / "vid0" / f"{t:05d}.npy"),
                                      np.load(tmp_path / "npz" / "vid0" / f"{t:05d}.npy"))


def test_eval_xmem_flip_scores_and_merge(tmp_path):
    """--flip with --save_scores, then merge_scores of the plain and flipped
    runs (tests/test_apps.py:112-143)."""
    common = ["--synthetic", "--frames", "3", "--save_scores", *TINY]
    out_a, out_b = str(tmp_path / "plain"), str(tmp_path / "flip")
    assert teval.main(common + ["--out", out_a], device="cpu") == 0
    assert teval.main(common + ["--out", out_b, "--flip"], device="cpu") == 0
    for out in (out_a, out_b):
        assert os.path.exists(os.path.join(out, "synthetic_0", "00001.png"))
    prob = np.load(os.path.join(out_a, "synthetic_0", "00001.npy"))
    assert prob.ndim == 3 and prob.shape[:2] == (120, 160)
    np.testing.assert_allclose(prob.sum(-1), 1.0, atol=2e-2)
    merged = str(tmp_path / "merged")
    assert tmerge.main(["--inputs", out_a, out_b, "--out", merged], device="cpu") == 0
    m = _read(os.path.join(merged, "synthetic_0", "00001.png"))
    flipped = np.load(os.path.join(out_b, "synthetic_0", "00001.npy")).astype(np.float32)
    want = (prob.astype(np.float32) + flipped).argmax(-1)
    assert m.shape == (120, 160)
    np.testing.assert_array_equal(m, want)


def test_merge_scores_resize_equals_cv2():
    """_resize_prob is cv2.resize's INTER_LINEAR on float32, up and down."""
    rs = np.random.RandomState(0)
    prob = rs.rand(30, 41, 3).astype(np.float32)
    for hw in ((60, 80), (17, 23), (30, 41)):
        # float32 sums in another order: a few ulps
        np.testing.assert_allclose(tmerge._resize_prob(prob, hw),
                                   cv2.resize(prob, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR),
                                   rtol=0, atol=1e-5)


def test_eval_xmem_video_batch_matches_sequential(tmp_path, ckpts):
    """--video_batch 2 over three same-shape videos of 5, 3 and 4 frames (a
    ragged padded chunk, last-frame clamping) and a fourth of another shape
    against the sequential run (tests/test_apps.py:206-267). PyTorch's CPU
    convolutions round differently at another batch width, so the scores
    agree within a float16 step of each other and the labels off the
    near-ties, where the JAX case asks bit-identity."""
    lengths = {"vid_a": 5, "vid_b": 3, "vid_c": 4, "vid_d": 4}
    shapes = {"vid_a": (48, 64), "vid_b": (48, 64), "vid_c": (48, 48), "vid_d": (48, 64)}
    for i, (vid, T) in enumerate(lengths.items()):
        root = tmp_path / "data" / vid
        _write_video(root / "frames", root / "masks", T, *shapes[vid], seed=i)
    common = ["--data_root", str(tmp_path / "data"), "--frames", "0", "--ckpt", ckpts["npz"],
              "--save_scores", *TINY]
    out_seq, out_bat = str(tmp_path / "seq"), str(tmp_path / "bat")
    assert teval.main(common + ["--out", out_seq], device="cpu") == 0
    assert teval.main(common + ["--out", out_bat, "--video_batch", "2"], device="cpu") == 0
    for vid, T in lengths.items():
        for t in range(1, T):
            a = np.load(os.path.join(out_seq, vid, f"{t:05d}.npy")).astype(np.float32)
            b = np.load(os.path.join(out_bat, vid, f"{t:05d}.npy")).astype(np.float32)
            np.testing.assert_allclose(b, a, rtol=0, atol=5e-4, err_msg=f"{vid} frame {t}")
            top2 = np.sort(a, axis=-1)[..., -2:]
            sure = top2[..., 1] - top2[..., 0] > 2e-3
            seq_png = _read(os.path.join(out_seq, vid, f"{t:05d}.png"))
            bat_png = _read(os.path.join(out_bat, vid, f"{t:05d}.png"))
            np.testing.assert_array_equal(bat_png[sure], seq_png[sure], err_msg=f"{vid} {t}")
        assert not os.path.exists(os.path.join(out_bat, vid, f"{T:05d}.png"))
    seq = json.load(open(os.path.join(out_seq, "metrics.json")))
    bat = json.load(open(os.path.join(out_bat, "metrics.json")))
    assert seq["per_video"].keys() == bat["per_video"].keys() == lengths.keys()
    for vid in seq["per_video"]:
        assert seq["per_video"][vid]["frames_scored"] == bat["per_video"][vid]["frames_scored"]


def test_eval_xmem_long_video_memory_churn(tmp_path):
    """The eval loop across working-memory consolidations and long-term
    evictions (tests/test_apps.py:269-314, 16 frames where that runs 40)."""
    from d3fields_tpu_torch.models.xmem import core

    consolidations = []
    orig = core.XMemCore.step

    def step(self, *args, **kwargs):
        l_size = self.mem.l_size
        out = orig(self, *args, **kwargs)
        consolidations.append(self.mem.l_size != l_size)
        return out

    T = 16
    out = str(tmp_path / "out")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(core.XMemCore, "step", step)
        assert teval.main(["--synthetic", "--frames", str(T), *TINY, "--mem_every", "2",
                           "--max_mid_term_frames", "4", "--min_mid_term_frames", "2",
                           "--num_prototypes", "4", "--max_long_term_elements", "64",
                           "--top_k", "5", "--out", out], device="cpu") == 0
    assert sum(consolidations) >= 2
    outs = sorted(os.listdir(os.path.join(out, "synthetic_0")))
    assert outs == [f"{t:05d}.png" for t in range(1, T)]
    for t in (T // 2, T - 1):
        pred = _read(os.path.join(out, "synthetic_0", f"{t:05d}.png"))
        assert pred.shape == (120, 160) and pred.max() <= 2
    g = json.load(open(os.path.join(out, "metrics.json")))["global"]
    assert 0.0 <= g["J"] <= 1.0 and 0.0 <= g["F"] <= 1.0 and g["fps"] > 0


@pytest.mark.parametrize("long_term", [True, False], ids=["long_term", "disable_long_term"])
def test_eval_xmem_directory_palette_masks(tmp_path, ckpts, long_term):
    """Paletted annotations decode to object indices; --frames 0 runs the
    whole video; metrics.json's per-video and global rows
    (tests/test_apps.py:316-369)."""
    vdir = tmp_path / "data" / "vid0"
    _write_video(vdir / "frames", vdir / "masks", 4)
    out = str(tmp_path / "out")
    assert teval.main(["--data_root", str(tmp_path / "data"), "--frames", "0", *TINY,
                       "--ckpt", ckpts["npz"], "--out", out]
                      + ([] if long_term else ["--disable_long_term",
                                               "--max_mid_term_frames", "4"]),
                      device="cpu") == 0
    assert sorted(os.listdir(os.path.join(out, "vid0"))) == ["00001.png", "00002.png",
                                                             "00003.png"]
    assert _read(os.path.join(out, "vid0", "00001.png")).max() <= 2
    metrics = json.load(open(os.path.join(out, "metrics.json")))
    assert set(metrics) == {"per_video", "global"}
    vid = metrics["per_video"]["vid0"]
    assert vid["frames_scored"] == 3 and 0.0 <= vid["JF"] <= 1.0
    assert metrics["global"]["J"] == pytest.approx(vid["J"])
    assert metrics["global"]["JF"] == pytest.approx(vid["JF"])


def test_eval_xmem_memory_knobs_reach_config():
    """tests/test_apps.py:487-507 on the port, and its config equals the
    JAX app's for the same flags."""
    import dataclasses

    argv = ["--synthetic", "--top_k", "7", "--mem_every", "3", "--max_mid_term_frames", "4",
            "--min_mid_term_frames", "2", "--max_long_term_elements", "512",
            "--num_prototypes", "16", "--deep_update_every", "9", "--disable_long_term"]
    cfg = teval.make_config(teval.build_parser().parse_args(argv))
    assert (cfg.top_k, cfg.mem_every) == (7, 3)
    assert (cfg.max_mid_term_frames, cfg.min_mid_term_frames) == (4, 2)
    assert (cfg.max_long_term_elements, cfg.num_prototypes) == (512, 16)
    assert cfg.deep_update_every == 9 and not cfg.enable_long_term
    for a in (argv, ["--synthetic"]):
        assert dataclasses.asdict(teval.make_config(teval.build_parser().parse_args(a))) == \
            dataclasses.asdict(jeval.make_config(jeval.build_parser().parse_args(a)))
    d = teval.make_config(teval.build_parser().parse_args(["--synthetic"]))
    assert (d.top_k, d.mem_every, d.deep_update_every) == (30, 5, -1) and d.enable_long_term


def test_eval_xmem_davis_layout(tmp_path, ckpts):
    """A DAVIS checkout (JPEGImages/480p/<video>, PNG frames) with one seed
    annotation (tests/test_apps.py:672-705)."""
    root = tmp_path / "DAVIS"
    _write_video(root / "JPEGImages" / "480p" / "bear", root / "Annotations" / "480p" / "bear",
                 3, seed=1, masks=False)
    m = np.zeros((48, 64), np.uint8)
    m[12:36, 16:40] = 1
    _save_mask(root / "Annotations" / "480p" / "bear" / "00000.png", m)
    out = str(tmp_path / "out")
    assert teval.main(["--data_root", str(root), "--frames", "0", *TINY, "--ckpt", ckpts["npz"],
                       "--out", out], device="cpu") == 0
    assert sorted(os.listdir(os.path.join(out, "bear"))) == ["00001.png", "00002.png"]
    pred = _read(os.path.join(out, "bear", "00001.png"))
    assert pred.shape == (48, 64) and pred.max() <= 1


def test_eval_xmem_ytvos_first_appearance(tmp_path, ckpts, capsys):
    """YouTube-VOS: object 2 first annotated at frame 2 seeds the tracker
    mid-video through the multi-group memory (tests/test_apps.py:708-768)."""
    root = tmp_path / "ytvos"
    fdir, mdir = root / "JPEGImages" / "0a2f2bd294", root / "Annotations" / "0a2f2bd294"
    _write_video(fdir, mdir, 5, seed=2, masks=False)
    full = [0, 0, 0, 255, 0, 0, 0, 255, 0] + [0] * 759
    m0 = np.zeros((48, 64), np.uint8)
    m0[8:24, 8:28] = 1
    _save_mask(mdir / "00000.png", m0, full)
    m2 = np.zeros((48, 64), np.uint8)
    m2[28:44, 36:60] = 2
    _save_mask(mdir / "00002.png", m2, full)
    out = str(tmp_path / "out")
    argv = ["--data_root", str(root), "--frames", "0", *TINY, "--size", "-1",
            "--ckpt", ckpts["npz"], "--out", out]
    assert teval.main(argv, device="cpu") == 0
    assert "(2 annotation frames)" in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(out, "0a2f2bd294"))) == [f"{t:05d}.png"
                                                                    for t in range(1, 5)]
    pred2 = _read(os.path.join(out, "0a2f2bd294", "00002.png"))
    assert (pred2[30:42, 40:56] == 2).mean() > 0.5
    assert _read(os.path.join(out, "0a2f2bd294", "00004.png")).max() <= 2


def test_eval_xmem_refuses_jpeg_frames(tmp_path):
    """JPEG frames are read as ``cv2.imread`` reads them (the port once
    refused them): a video of .jpg frames gives the same masks and scores
    as the PNG files of their decoded pixels."""
    vdir = tmp_path / "jpg" / "vid0"
    _write_video(vdir / "frames", vdir / "masks", 3, ext=".jpg")
    pdir = tmp_path / "png" / "vid0"
    os.makedirs(pdir / "frames")
    for t in range(3):
        cv2.imwrite(str(pdir / "frames" / f"{t:05d}.png"),
                    cv2.imread(str(vdir / "frames" / f"{t:05d}.jpg")))
    os.symlink(vdir / "masks", pdir / "masks")
    outs = {}
    for kind in ("jpg", "png"):
        outs[kind] = str(tmp_path / f"out_{kind}")
        assert teval.main(["--data_root", str(tmp_path / kind), *TINY, "--save_scores",
                           "--out", outs[kind]], device="cpu") == 0
    names = sorted(os.listdir(os.path.join(outs["jpg"], "vid0")))
    assert names == sorted(os.listdir(os.path.join(outs["png"], "vid0")))
    assert "00001.png" in names and "00002.png" in names
    for n in names:
        a, b = (os.path.join(outs[k], "vid0", n) for k in ("jpg", "png"))
        if n.endswith(".png"):
            np.testing.assert_array_equal(_read(a), _read(b))
        else:
            np.testing.assert_array_equal(np.load(a), np.load(b))


def test_eval_apps_run_on_cuda_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teval.main(["--synthetic", *TINY, "--out", str(tmp_path / "e")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmerge.main(["--inputs", str(tmp_path), "--out", str(tmp_path / "m")])

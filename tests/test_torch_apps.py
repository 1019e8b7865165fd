"""The port's two headline apps end to end on the CPU.

- ``--synthetic``: held to the JAX package's committed goldens at
  tests/test_golden.py's tolerances: ``vis_repr --synthetic --step 0.015``
  against tests/golden/vis_repr.npz and ``vis_tracking --synthetic --frames
  2 --num_kypts 8 --iters 10`` against tests/golden/vis_tracking_fast.npz.
- The recorded-scene path: a drifting-sphere scene written to disk in the
  ``camera_{i}/{color,depth}`` layout, random tiny checkpoints written in
  the reference layouts and a vocab, behind the ``D3F_*`` variables. Both
  apps run through ``apps/_backends.py`` against the JAX apps on the same
  files: ``vis_repr`` at the goldens' tolerances, ``vis_tracking``'s staged
  loop (XMem propagation) at tests/test_torch_serving.py's tolerances for
  the same stages. Both packages' backends build DINOv2 in bfloat16; these
  cases run both in float32 (a backbone shim on each side), where the
  goldens' tolerances hold, and a bf16 case runs ``vis_repr`` as both
  backends build it, held to the DINOv2 bf16 budget on the features.
  ``--fused`` and ``--fused --segment 2`` are held to the port's staged
  loop at 1e-5.
"""

import functools
import os
import pickle

import numpy as np
import pytest
import torch

from tools.gen_golden import VIS_REPR_ARGS, VIS_TRACKING_FAST_ARGS
import d3fields_tpu.apps._backends as JB
from d3fields_tpu import config as jconfig
from d3fields_tpu.apps import vis_repr as jvis_repr
from d3fields_tpu.apps import vis_tracking as jvis_tracking
from d3fields_tpu.models import dinov2 as jd2
from d3fields_tpu.models.groundingdino import model as jgd
from d3fields_tpu.models.sam import model as jsam
from d3fields_tpu.utils import synthetic as jsyn
from d3fields_tpu_torch import config as tconfig
from d3fields_tpu_torch import serving
from d3fields_tpu_torch.apps import _backends as TB
from d3fields_tpu_torch.apps import vis_repr, vis_tracking
from d3fields_tpu_torch.models import dinov2 as td2
from d3fields_tpu_torch.models.groundingdino import model as tgd
from d3fields_tpu_torch.models.sam import model as tsam
from d3fields_tpu_torch.utils import io as tio
from d3fields_tpu_torch.utils import synthetic as tsyn

from test_torch_xmem import tiny_xmem

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The apps run ~10^6 small torch ops (vis_tracking's keypoint grid
    has 36M points). Where pytest-xdist runs several workers on the same
    cores, each worker's default thread pool spends that time waiting on
    the others; one thread per worker keeps the run short."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_vis_repr_reproduces_golden(tmp_path):
    dump = str(tmp_path / "arrays.npz")
    out = tmp_path / "out"
    assert vis_repr.main(VIS_REPR_ARGS + ["--out", str(out), "--dump_arrays", dump],
                         device="cpu") == 0
    got = np.load(dump)
    want = np.load(os.path.join(GOLDEN, "vis_repr.npz"))
    np.testing.assert_allclose(got["dist"], want["dist"], atol=1e-4)
    assert got["triangles"].shape == want["triangles"].shape
    np.testing.assert_array_equal(got["triangles"], want["triangles"])
    np.testing.assert_allclose(got["vertices"], want["vertices"], atol=1e-3)
    np.testing.assert_allclose(got["mask"], want["mask"], atol=1e-4)
    np.testing.assert_allclose(got["color"], want["color"], atol=1e-3)
    np.testing.assert_allclose(got["desc_pca"], want["desc_pca"], atol=1e-3)
    for name in ("instance_mesh.ply", "descriptor_mesh.ply", "color_mesh.ply"):
        assert (out / name).read_bytes()[:3] == b"ply"


def _tracking_outputs(out, frames):
    match, losses = [], []
    for t in range(frames):
        with open(os.path.join(out, f"match_pts_{t:06d}.pkl"), "rb") as f:
            match.append(np.stack(pickle.load(f)).astype(np.float32))
        with open(os.path.join(out, f"loss_hist_{t:06d}.pkl"), "rb") as f:
            losses.append(np.asarray(pickle.load(f), np.float32))
    with open(os.path.join(out, "src_feats.pkl"), "rb") as f:
        info = pickle.load(f)
    src_pts = np.stack([info[k]["src_pts"] for k in sorted(info)]).astype(np.float32)
    return np.stack(match), src_pts, np.stack(losses)


def test_vis_tracking_reproduces_fast_golden(tmp_path):
    """With two frames of host-visible lag (--pipeline_depth 2), which
    changes when the pickles are written and nothing else."""
    out = str(tmp_path / "track")
    assert vis_tracking.main(VIS_TRACKING_FAST_ARGS + ["--out", out, "--pipeline_depth", "2"],
                             device="cpu") == 0
    match, src_pts, losses = _tracking_outputs(out, 2)
    want = np.load(os.path.join(GOLDEN, "vis_tracking_fast.npz"))
    np.testing.assert_allclose(src_pts, want["src_pts"], atol=1e-6)
    np.testing.assert_allclose(match, want["match_pts"], atol=5e-4)
    np.testing.assert_allclose(losses, want["loss_history"], atol=1e-5)


# ---------------------------------------------------------------------------
# the recorded-scene path
# ---------------------------------------------------------------------------

LABELS = ["ball", "cube"]
FRAMES, VIEWS, HW = 6, 4, (96, 128)
# the synthetic scene's workspace (vis_repr.synthetic_inputs, SYNTHETIC_BOUNDARIES)
REPR_BOUNDS = ["--x_lower", "-0.3", "--x_upper", "0.5", "--y_lower", "-0.3",
               "--y_upper", "0.35", "--z_lower", "0.001", "--z_upper", "0.3"]
# a workspace around the two spheres over the 6 frames' drift: 3.9M keypoint
# candidates at select_keypoints' 2 mm (SYNTHETIC_BOUNDARIES' 36M take ~10 s)
TRACK_ARGS = ["--query_texts", *LABELS, "--query_thresholds", "0.5", "0.5",
              "--num_kypts", "8", "--iters", "10",
              "--x_lower", "-0.16", "--x_upper", "0.3", "--y_lower", "-0.16", "--y_upper", "0.2",
              "--z_lower", "0.001", "--z_upper", "0.2",
              "--kypts_z_lower", "0.001", "--kypts_z_upper", "0.2"]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", "ball", "cube", "mug", "red",
         "can", "shoe", "fork", "##s"]


def _scene(t):
    offs = np.array([[0.008 * t, 0.004 * t, 0.0], [-0.005 * t, 0.006 * t, 0.0]])
    return tsyn.render_sphere_scene(num_views=VIEWS, H=HW[0], W=HW[1], feat_dim=8,
                                    sphere_offsets=offs)


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """The scene, the checkpoints and the vocab on disk."""
    root = tmp_path_factory.mktemp("recorded")
    scene = str(root / "scene")
    for t in range(FRAMES):
        tio.save_frame(scene, t, _scene(t))
    dino = td2.init_params(td2.Dinov2Config.tiny_test(), device="cpu")
    hub = dict(dino.state_dict(), mask_token=torch.zeros(1, dino.cfg.hidden_size))
    xmem, _, xkw = tiny_xmem(seed=2)
    gdino = dict(jgd.build_random_hf(jgd.GroundingDinoConfig.tiny_test(), 0).state_dict())
    # the text features after the encoder scaled by 0.05, as chip_smoke.py
    # does: at huggingface's init scale the random contrastive logits
    # saturate the sigmoid and no box threshold separates the boxes
    last = "model.encoder.layers.1.text_enhancer_layer.layer_norm_after."
    for leaf in ("weight", "bias"):
        gdino[last + leaf] = gdino[last + leaf] * 0.05
    files = {
        "D3F_DINOV2_CKPT": (hub, "dinov2.pth"),
        "D3F_SAM_CKPT": (jsam.build_random_hf(jsam.SamConfig.tiny_test(), 0).state_dict(),
                         "sam.pth"),
        "D3F_GDINO_CKPT": (gdino, "gdino.pth"),
        "D3F_XMEM_CKPT": (xmem.state_dict(), "xmem.pth"),
    }
    env = {}
    for var, (sd, name) in files.items():
        env[var] = str(root / name)
        torch.save(dict(sd), env[var])
    env["D3F_BERT_VOCAB"] = str(root / "vocab.txt")
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return {"scene": scene, "env": env, "xmem_kw": dict(xkw, size=-1), "root": root}


class _Float32Backbone(jd2.Dinov2Backbone):
    """The JAX backbone in float32 (its app asks bfloat16)."""

    def __init__(self, params, cfg, compute_dtype="float32", *args, **kwargs):
        super().__init__(params, cfg, "float32", *args, **kwargs)


class _TorchFloat32Backbone(td2.Dinov2Backbone):
    """The port's backbone in float32 (its app asks bfloat16, as JAX's)."""

    def __init__(self, model, *, compute_dtype="float32", **kwargs):
        super().__init__(model, compute_dtype="float32", **kwargs)


@pytest.fixture
def recorded_env(recorded_env_bf16, monkeypatch):
    """``recorded_env_bf16`` with both packages' DINOv2 in float32."""
    monkeypatch.setattr(jd2, "Dinov2Backbone", _Float32Backbone)
    monkeypatch.setattr(td2, "Dinov2Backbone", _TorchFloat32Backbone)
    return recorded_env_bf16


@pytest.fixture
def recorded_env_bf16(recorded, monkeypatch):
    """``D3F_*`` pointed at the files, and the tiny configs in place of the
    production ones in both packages (test-side only)."""
    for var, path in recorded["env"].items():
        monkeypatch.setenv(var, path)
    monkeypatch.setenv("D3F_COMPILE_CACHE", "0")
    monkeypatch.setattr(td2.Dinov2Config, "vit_large", staticmethod(td2.Dinov2Config.tiny_test))
    monkeypatch.setattr(jd2.Dinov2Config, "vit_large", staticmethod(jd2.Dinov2Config.tiny_test))
    monkeypatch.setattr(tsam, "_ENCODER_WIDTHS", {32: tsam.SamConfig.tiny_test})
    monkeypatch.setattr(jsam, "_ENCODER_WIDTHS", {32: jsam.SamConfig.tiny_test})
    monkeypatch.setattr(tgd, "_TRUNKS", {8: ("tiny", tgd.GroundingDinoConfig.tiny_test)})
    monkeypatch.setattr(jgd, "_TRUNKS", {8: ("tiny", jgd.GroundingDinoConfig.tiny_test)})
    kw = recorded["xmem_kw"]
    monkeypatch.setattr(tconfig, "XMemConfig", functools.partial(tconfig.XMemConfig, **kw))
    monkeypatch.setattr(jconfig, "XMemConfig", functools.partial(jconfig.XMemConfig, **kw))
    return recorded


def _sphere_masks(monkeypatch):
    """The analytic sphere masks of frame 0 as both packages' mask backend,
    swapped in through ``_backends.build_mask_backend`` (the seam of
    tests/test_apps.py:858): random detector weights find no stable
    instances to track. After frame 0, XMem propagates."""
    scene0 = _scene(0)
    monkeypatch.setattr(TB, "build_mask_backend",
                        lambda *a, **k: tsyn.sphere_mask_backend(scene0, LABELS))
    monkeypatch.setattr(JB, "build_mask_backend",
                        lambda *a, **k: jsyn.sphere_mask_backend(scene0, LABELS))


def _box_threshold(scene):
    """A box threshold between two detection scores of the random detector
    on frame 0 that lie > 1e-3 apart, with 1-8 boxes above it: the JAX and
    the port's scores agree to 1e-4 (tests/test_torch_groundingdino.py)."""
    backend = TB.build_mask_backend(device="cpu")
    rgb = np.ascontiguousarray(tio.load_frame(scene, 0, VIEWS)["color"][..., ::-1])
    dets = backend.detector.predict_with_classes_batch(rgb, ["ball"], box_threshold=-1.0)
    conf = np.sort(np.concatenate([d.confidence for d in dets]))[::-1]
    k = 1 + int(np.argmax(conf[1:8] - conf[2:9]))  # the widest gap below the 2nd-8th
    assert conf[k] - conf[k + 1] > 1e-3, conf[:10]
    return (conf[k] + conf[k + 1]) / 2


def test_vis_repr_recorded_scene_matches_jax(tmp_path, recorded_env):
    scene = recorded_env["scene"]
    thr = _box_threshold(scene)
    argv = ["--data_path", scene, "--t", "0", "--query_texts", "ball", "--query_thresholds",
            str(thr), "--step", "0.015", *REPR_BOUNDS]
    got, want = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert vis_repr.main(argv + ["--out", str(tmp_path / "port"), "--dump_arrays", got],
                         device="cpu") == 0
    assert jvis_repr.main(argv + ["--out", str(tmp_path / "jax"), "--dump_arrays", want]) == 0
    got, want = np.load(got), np.load(want)
    np.testing.assert_allclose(got["dist"], want["dist"], atol=1e-4)
    np.testing.assert_array_equal(got["triangles"], want["triangles"])
    np.testing.assert_allclose(got["vertices"], want["vertices"], atol=1e-3)
    assert got["mask"].shape == want["mask"].shape
    np.testing.assert_allclose(got["mask"], want["mask"], atol=1e-4)
    np.testing.assert_allclose(got["color"], want["color"], atol=1e-3)
    np.testing.assert_allclose(got["desc_pca"], want["desc_pca"], atol=1e-3)


def test_vis_repr_recorded_scene_bf16_matches_jax(tmp_path, recorded_env_bf16, monkeypatch):
    """``vis_repr --data_path`` with the backends as both packages build
    them: DINOv2 in bf16. The descriptors each app computes are held to
    tests/test_dinov2.py:99-108's bf16 budget (patch-token cosine deficit
    below 1e-3) and come back f32; the field, mesh and masks, which the
    descriptors do not reach, at the goldens' tolerances. Colour and PCA
    descriptors are projections of the bf16 descriptors and are not held
    past their shapes."""
    scene = recorded_env_bf16["scene"]
    thr = _box_threshold(scene)
    feats = {"port": [], "jax": []}
    for key, module in (("port", td2), ("jax", jd2)):
        call = module.Dinov2Backbone.__call__

        def spy(self, *args, _call=call, _key=key, **kwargs):
            assert self.compute_dtype == "bfloat16"
            out = _call(self, *args, **kwargs)
            feats[_key].append(np.asarray(out))
            return out

        monkeypatch.setattr(module.Dinov2Backbone, "__call__", spy)
    argv = ["--data_path", scene, "--t", "0", "--query_texts", "ball", "--query_thresholds",
            str(thr), "--step", "0.015", *REPR_BOUNDS]
    got, want = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert vis_repr.main(argv + ["--out", str(tmp_path / "port"), "--dump_arrays", got],
                         device="cpu") == 0
    assert jvis_repr.main(argv + ["--out", str(tmp_path / "jax"), "--dump_arrays", want]) == 0
    (a,), (b,) = feats["port"], feats["jax"]
    assert a.dtype == np.float32 and a.shape == b.shape
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)
    assert (1 - cos).max() < 1e-3, (1 - cos).max()
    got, want = np.load(got), np.load(want)
    np.testing.assert_allclose(got["dist"], want["dist"], atol=1e-4)
    np.testing.assert_array_equal(got["triangles"], want["triangles"])
    np.testing.assert_allclose(got["vertices"], want["vertices"], atol=1e-3)
    np.testing.assert_allclose(got["mask"], want["mask"], atol=1e-4)
    for k in ("color", "desc_pca"):
        assert got[k].shape == want[k].shape and np.isfinite(got[k]).all(), k


def test_vis_repr_scene_resolves_under_data_root(tmp_path, monkeypatch):
    """``--scene mug --data_root R`` reads R/<the mug scene's directory>,
    with the scene table's query and threshold, as the JAX app does."""
    import d3fields_tpu.utils.io as jio

    class Read(Exception):
        pass

    seen = []

    def loader(path, t, num_cam):
        seen.append((path, t, num_cam))
        raise Read

    monkeypatch.setattr(tio, "load_frame", loader)
    monkeypatch.setattr(jio, "load_frame", loader)
    for app in (vis_repr, jvis_repr):
        with pytest.raises(Read):
            app.main(["--scene", "mug", "--data_root", str(tmp_path), "--t", "3"],
                     **({"device": "cpu"} if app is vis_repr else {}))
    want = (os.path.join(str(tmp_path), vis_repr.SCENES["mug"][0]), 3, 4)
    assert seen == [want, want]
    assert vis_repr.SCENES == jvis_repr.SCENES


def test_vis_tracking_recorded_staged_matches_jax(tmp_path, recorded_env, monkeypatch):
    """3 frames: consensus and XMem seeding on frame 0, propagation on
    frames 1-2, 10 Adam steps a frame; the port against the JAX app at
    tests/test_torch_serving.py's tolerances for the same stages."""
    _sphere_masks(monkeypatch)
    argv = ["--data_path", recorded_env["scene"], "--frames", "3", *TRACK_ARGS]
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert vis_tracking.main(argv + ["--out", port], device="cpu") == 0
    assert jvis_tracking.main(argv + ["--out", ref]) == 0
    (match, src, losses), (jmatch, jsrc, jlosses) = (_tracking_outputs(d, 3) for d in (port, ref))
    assert match.shape == jmatch.shape == (3, 2, 8, 3)
    np.testing.assert_allclose(src, jsrc, atol=5e-3)
    np.testing.assert_allclose(match, jmatch, atol=5e-3)
    np.testing.assert_allclose(losses, jlosses, rtol=5e-3, atol=5e-3)


def _device_resize_backbone(monkeypatch):
    """DINOv2 from the checkpoint behind a ``resize_mode='device'`` wrapper,
    the resize FusedFrameStep runs, so that the staged loop computes what
    the fused frames do."""
    build = TB.build_feature_backend

    def device_mode(*args, **kwargs):
        fb = build(*args, **kwargs)
        return td2.Dinov2Backbone(fb.model, compute_dtype=fb.compute_dtype,
                                  resize_mode="device", device=fb.device)

    monkeypatch.setattr(TB, "build_feature_backend", device_mode)


def test_vis_tracking_fused_and_segment_equal_the_staged_loop(tmp_path, recorded_env,
                                                              monkeypatch):
    """6 frames: the staged loop, --fused (frames 1-5 through
    FusedFrameStep.step) and --fused --segment 2 (two 2-frame segments,
    then the 1-frame tail through step), all equal at 1e-5."""
    _sphere_masks(monkeypatch)
    _device_resize_backbone(monkeypatch)
    calls = {"segment": [], "step": 0}
    step, step_segment = serving.FusedFrameStep.step, serving.FusedFrameStep.step_segment

    def counted_step(self, *args, **kwargs):
        calls["step"] += 1
        return step(self, *args, **kwargs)

    def counted_segment(self, frames, *args, **kwargs):
        calls["segment"].append(frames.shape[0])
        return step_segment(self, frames, *args, **kwargs)

    monkeypatch.setattr(serving.FusedFrameStep, "step", counted_step)
    monkeypatch.setattr(serving.FusedFrameStep, "step_segment", counted_segment)
    argv = ["--data_path", recorded_env["scene"], *TRACK_ARGS]
    outs = {}
    for name, extra in (("staged", []), ("fused", ["--fused"]),
                        ("segment", ["--fused", "--segment", "2", "--pipeline_depth", "2"])):
        before = (list(calls["segment"]), calls["step"])
        out = str(tmp_path / name)
        assert vis_tracking.main(argv + extra + ["--out", out], device="cpu") == 0
        outs[name] = _tracking_outputs(out, FRAMES)
        if name == "fused":
            assert calls["step"] - before[1] == FRAMES - 1 and calls["segment"] == before[0]
        if name == "segment":
            assert calls["segment"][len(before[0]):] == [2, 2]
            assert calls["step"] - before[1] == 1
    for name in ("fused", "segment"):
        for got, want in zip(outs[name], outs["staged"]):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    assert np.isfinite(outs["staged"][0]).all()


def test_vis_tracking_fused_rebuilds_the_backbone_for_device_resize(tmp_path, recorded_env_bf16,
                                                                    monkeypatch):
    """The loaded backbone resizes as Pillow does; --fused wraps the same
    model, in the same compute dtype (bf16, as the backend builds it), in a
    'device'-resize backbone for FusedFrameStep."""
    _sphere_masks(monkeypatch)
    seen = []
    init = serving.FusedFrameStep.__init__

    def spy(self, backbone, *args, **kwargs):
        seen.append((backbone, kwargs))
        init(self, backbone, *args, **kwargs)

    monkeypatch.setattr(serving.FusedFrameStep, "__init__", spy)
    out = str(tmp_path / "fused")
    argv = ["--data_path", recorded_env_bf16["scene"], "--frames", "2", "--fused", *TRACK_ARGS]
    assert vis_tracking.main(argv + ["--out", out], device="cpu") == 0
    (bb, kwargs), = seen
    assert bb.resize_mode == "device" and bb.pos_interpolate == "hub"
    assert bb.compute_dtype == "bfloat16"
    assert bb.model.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert kwargs["xmem_bgr_to_rgb"] is True
    assert np.isfinite(_tracking_outputs(out, 2)[0]).all()


SCENE = "<scene>"
REPR_ARGV = ["--data_path", SCENE, "--t", "0", "--query_texts", "ball", "--query_thresholds", "0.3"]


@pytest.mark.parametrize("app, argv, env, error, message", [
    # the JAX _backends' messages (d3fields_tpu/apps/_backends.py:81-106)
    (vis_repr, REPR_ARGV, (), FileNotFoundError, "DINOv2 checkpoint not found; set D3F_DINOV2"),
    (vis_repr, REPR_ARGV, ("D3F_DINOV2_CKPT", "D3F_GDINO_CKPT"), FileNotFoundError,
     "SAM/GroundingDINO checkpoints not found; set D3F_SAM_CKPT"),
    (vis_tracking, ["--data_path", SCENE], (), FileNotFoundError,
     "DINOv2 checkpoint not found"),
    # the JAX app's reasons (d3fields_tpu/apps/vis_tracking.py:143-152, 265-270)
    (vis_tracking, ["--data_path", SCENE, "--frames", "1", "--fused", *TRACK_ARGS],
     ("D3F_DINOV2_CKPT",), SystemExit, "--fused needs the XMem video tracker — set D3F_XMEM_CKPT"),
    (vis_tracking, ["--synthetic", "--fused"], (), SystemExit,
     "--fused requires the XMem video tracker"),
    (vis_tracking, ["--synthetic", "--fused", "--segment", "4"], (), SystemExit,
     "--fused requires the XMem video tracker"),
    (vis_tracking, ["--synthetic", "--segment", "4"], (), SystemExit, "add --fused"),
])
def test_unported_paths_exit_with_a_message(tmp_path, recorded_env, monkeypatch, app, argv,
                                            env, error, message):
    """Missing checkpoints, and the flag combinations the JAX app refuses.
    ``env`` lists the D3F_* variables left set."""
    for var in recorded_env["env"]:
        if var not in env:
            monkeypatch.delenv(var)
    if app is vis_tracking:
        _sphere_masks(monkeypatch)
    argv = [recorded_env["scene"] if a == SCENE else a for a in argv]
    with pytest.raises(error, match=message):
        app.main(argv + ["--out", str(tmp_path / "out")], device="cpu")


def test_apps_run_on_cuda_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vis_repr.main(VIS_REPR_ARGS + ["--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vis_tracking.main(VIS_TRACKING_FAST_ARGS + ["--out", str(tmp_path)])


# ---------------------------------------------------------------------------
# the apps' remaining host side: the tracking video and precompute_pca
# ---------------------------------------------------------------------------


def test_vis_tracking_writes_the_tracking_video(tmp_path, monkeypatch):
    """tracking.avi holds one frame per tracked frame, and frame t is the
    TrackVis mosaic of match_pts_<t>.pkl on frame t's colours (keypoints
    from a 1 cm grid here, where the app's 2 mm grid takes ~10 s)."""
    from d3fields_tpu_torch.track import keypoints as tkp
    from d3fields_tpu_torch.utils.avi import read_avi
    from d3fields_tpu_torch.utils.visualization import TrackVis

    select = tkp.select_keypoints
    monkeypatch.setattr(tkp, "select_keypoints",
                        lambda *a, **k: select(*a, **dict(k, res=0.01)))
    out = str(tmp_path / "track")
    assert vis_tracking.main(["--synthetic", "--frames", "3", "--num_kypts", "8",
                              "--iters", "5", "--out", out, "--pipeline_depth", "1"],
                             device="cpu") == 0
    video = read_avi(os.path.join(out, "tracking.avi"))
    assert video.shape == (3, 2 * 84, 2 * 112, 3)
    with open(os.path.join(out, "src_feats.pkl"), "rb") as f:
        info = pickle.load(f)
    frame0 = vis_tracking.synthetic_frame(0)
    vis = TrackVis(frame0["pose"], frame0["K"], str(tmp_path / "again"))
    for t in range(3):
        with open(os.path.join(out, f"match_pts_{t:06d}.pkl"), "rb") as f:
            pts = pickle.load(f)
        mosaic = vis.visualize_match_pts(pts, vis_tracking.synthetic_frame(t)["color"], info)
        np.testing.assert_array_equal(video[t], mosaic, err_msg=f"frame {t}")
    vis.close()


def test_precompute_pca_synthetic_matches_jax(tmp_path):
    from d3fields_tpu.apps import precompute_pca as jpca
    from d3fields_tpu.ops.pca import PCAParams as JPCAParams
    from d3fields_tpu_torch.apps import precompute_pca as tpca
    from d3fields_tpu_torch.ops.pca import PCAParams

    assert jpca.main(["--synthetic", "--out", str(tmp_path / "j.pkl")]) == 0
    assert tpca.main(["--synthetic", "--out", str(tmp_path / "t.pkl")], device="cpu") == 0
    got, want = PCAParams.load(str(tmp_path / "t.pkl")), JPCAParams.load(str(tmp_path / "j.pkl"))
    assert got.components.shape == (3, 64)
    np.testing.assert_allclose(got.components, want.components, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-6, atol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpca.main(["--synthetic", "--out", str(tmp_path / "c.pkl")])


def test_precompute_pca_images_matches_jax(tmp_path, recorded_env):
    """--images on two of the recorded colour PNGs with the tiny DINOv2
    checkpoint, against the JAX app's steps (cv2.imread, cv2.resize, its
    backbone at float32, fit_fg_pca: its main reshapes to 1,024 channels,
    which the tiny model has not). A JPEG input gives what the PNG of its
    ``cv2.imread`` pixels gives."""
    import cv2

    from d3fields_tpu.apps import precompute_pca as jpca
    from d3fields_tpu_torch.apps import precompute_pca as tpca
    from d3fields_tpu_torch.ops.pca import PCAParams

    images = [os.path.join(recorded_env["scene"], f"camera_{v}", "color", "0.png") for v in (0, 2)]
    ph, pw = 4, 5
    assert tpca.main(["--images", *images, "--patch_h", str(ph), "--patch_w", str(pw),
                      "--out", str(tmp_path / "t.pkl")], device="cpu") == 0
    got = PCAParams.load(str(tmp_path / "t.pkl"))
    imgs = np.stack([cv2.resize(cv2.imread(p), (14 * pw, 14 * ph)) for p in images])
    feats = np.asarray(JB.build_feature_backend()(imgs, patch_hw=(ph, pw)))
    want = jpca.fit_fg_pca(feats.reshape(-1, feats.shape[-1]), -15.0)
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.components, want.components, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.components @ got.components.T, np.eye(3), atol=1e-5)
    jpg, png = str(tmp_path / "a.jpg"), str(tmp_path / "a.png")
    cv2.imwrite(jpg, cv2.imread(images[0]))
    cv2.imwrite(png, cv2.imread(jpg))
    for path, name in ((jpg, "j.pkl"), (png, "p.pkl")):
        assert tpca.main(["--images", path, "--patch_h", str(ph), "--patch_w", str(pw),
                          "--out", str(tmp_path / name)], device="cpu") == 0
    from_jpg, from_png = (PCAParams.load(str(tmp_path / n)) for n in ("j.pkl", "p.pkl"))
    np.testing.assert_array_equal(from_jpg.mean, from_png.mean)
    np.testing.assert_array_equal(from_jpg.components, from_png.components)


# ---------------------------------------------------------------------------
# train_xmem: ports of tests/test_apps.py:145-181
# ---------------------------------------------------------------------------

TRAIN_TINY = ["--batch", "1", "--num_frames", "3", "--size", "48", "64", "--key_dim", "8",
              "--value_dim", "16", "--hidden_dim", "8"]


def test_train_xmem_synthetic(tmp_path):
    """Two synthetic steps with a checkpoint and a training image dump
    (tests/test_apps.py:145-160)."""
    from d3fields_tpu_torch.apps import train_xmem
    from d3fields_tpu_torch.utils.png import read_png

    out = str(tmp_path / "train")
    assert train_xmem.main(["--synthetic", "--steps", "2", *TRAIN_TINY, "--save_every", "2",
                            "--log_every", "1", "--dump_images_every", "2", "--out", out],
                           device="cpu") == 0
    assert {"ckpt_2.pt", "ckpt_final.pt", "train.jsonl"} <= set(os.listdir(out))
    dumps = os.listdir(os.path.join(out, "images"))
    assert dumps == ["0000002.png"]
    grid = read_png(os.path.join(out, "images", dumps[0]))
    assert grid.shape == (48, 3 * 64, 3)  # frame | ground truth | prediction
    ckpt = torch.load(os.path.join(out, "ckpt_final.pt"), weights_only=True)
    assert ckpt["it"] == 2


def test_train_xmem_staged_with_finetune_tail(tmp_path, capsys):
    """--stage presets drive the loop: 2 main steps + 1 finetune step
    (the low-augmentation tail, reference train.py:232-236), the final
    checkpoint at the combined total (tests/test_apps.py:163-181); a
    --resume of it with one more finetune step goes on from there."""
    from d3fields_tpu_torch.apps import train_xmem
    from d3fields_tpu_torch.models.xmem import trainer as TR

    out = str(tmp_path / "train")
    argv = ["--stage", "2", "--synthetic", "--num_ref_frames", "2", *TRAIN_TINY,
            "--save_every", "100", "--log_every", "1", "--out", out]
    assert train_xmem.main(argv + ["--steps", "2", "--finetune", "1"], device="cpu") == 0
    assert "it=2 entering finetune phase" in capsys.readouterr().out
    cfg = tconfig.XMemConfig(key_dim=8, value_dim=16, hidden_dim=8)
    state = TR.load_checkpoint(os.path.join(out, "ckpt_final.pt"), cfg, TR.make_optimizer(),
                               "cpu")
    assert state.it == 3  # steps + finetune
    final = os.path.join(out, "ckpt_final.pt")
    os.replace(final, os.path.join(out, "ckpt_3.pt"))
    assert train_xmem.main(argv + ["--steps", "2", "--finetune", "2", "--resume",
                                   os.path.join(out, "ckpt_3.pt")], device="cpu") == 0
    assert "resumed from" in capsys.readouterr().out
    assert torch.load(final, weights_only=True)["it"] == 4


# ---------------------------------------------------------------------------
# the interactive tools: click_track and interactive
# ---------------------------------------------------------------------------

# four clicks a group (two foreground, two background); object 2 enters at frame 3
CLICKS = "40,60;100,30;70,50,0;20,100,0|@3:120,90;110,70;30,20,0;140,10,0"
SAM_LOGIT_GAIN = 1e7  # the tiny random decoder's logits are ~1e-6
NEAR_TIE = 1e-3       # JAX's top two probabilities closer than this: rounding decides
MAX_NEAR_TIES = 1e-3  # the share of a frame's pixels that may differ (all near-ties)


def test_parse_clicks():
    from d3fields_tpu_torch.apps.click_track import parse_clicks

    groups = parse_clicks("120,80;200,150,0|@3:340.5,200")
    assert len(groups) == 2
    at, pts, lbls = groups[0]
    assert at == 0 and lbls.tolist() == [1, 0] and pts.dtype == np.float32
    np.testing.assert_allclose(pts, [[120, 80], [200, 150]])
    at1, pts1, lbls1 = groups[1]
    assert at1 == 3 and lbls1.tolist() == [1]
    np.testing.assert_allclose(pts1, [[340.5, 200]])
    for bad, msg in (("1,2,3,4", "bad click"), ("@3", "bad group"), ("1,2,5", "bad click label"),
                     ("", "no click groups")):
        with pytest.raises(ValueError, match=msg):
            parse_clicks(bad)


def _default_scale(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Convolutions at PyTorch's default scale, U(+-1/sqrt(fan_in)), drawn
    from a seeded generator: the JAX ``init_params`` scale of 0.1 saturates
    S2M's ResNet-50 and f-BRS's HRNet (every probability 0 or 1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                b = m.weight[0].numel() ** -0.5
                m.weight.uniform_(-b, b, generator=gen)
                if m.bias is not None:
                    m.bias.uniform_(-b, b, generator=gen)
    return model


@pytest.fixture(scope="module")
def interactive_ckpts(recorded):
    """SAM (the tiny recorded one, its mask logits scaled), f-BRS (HRNet
    width 6, the class head x10) and S2M state dicts in the reference
    layouts, written with torch.save, and the recorded XMem. The gains
    spread the untrained models' outputs, which otherwise leave most
    pixels' labels to rounding."""
    from d3fields_tpu_torch.models.fbrs import model as tfm
    from d3fields_tpu_torch.models.s2m import model as ts2m

    root = recorded["root"]
    paths = {k: str(root / f"{k}_interactive.pth") for k in ("sam", "fbrs", "s2m")}
    sd = torch.load(recorded["env"]["D3F_SAM_CKPT"])
    for k in list(sd):
        if "output_hypernetworks_mlps" in k and ".proj_out." in k:
            sd[k] = sd[k] * SAM_LOGIT_GAIN
    torch.save(sd, paths["sam"])
    paths["xmem"] = recorded["env"]["D3F_XMEM_CKPT"]
    fcfg = tfm.FbrsConfig(backbone=tfm.hrnet.HrnetConfig(width=6, ocr_width=8, small=True))
    fbrs = _default_scale(tfm.FbrsModel(fcfg, device="cpu"), 3)
    with torch.no_grad():
        for m in fbrs.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.reset_parameters()
        fbrs.feature_extractor.cls_head.weight.mul_(10.0)
    torch.save(fbrs.state_dict(), paths["fbrs"])
    torch.save(_default_scale(ts2m.init_params(device="cpu"), 4).state_dict(), paths["s2m"])
    return paths


def _near_tie_share(prob: np.ndarray) -> np.ndarray:
    top2 = np.sort(prob, axis=0)[-2:]
    return top2[1] - top2[0] < NEAR_TIE


def _hold_index_pngs(ours: str, ref: str, ties: dict) -> None:
    """Every index PNG of ``ref`` equal in ``ours`` but at pixels that
    ``ties`` marks for its frame (JAX's top two probabilities within
    NEAR_TIE), and at most MAX_NEAR_TIES of a frame's pixels different."""
    from PIL import Image

    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(ours)) and names
    for t, name in enumerate(names):
        a = np.array(Image.open(os.path.join(ours, name)))
        b = np.array(Image.open(os.path.join(ref, name)))
        tie = ties.get(t, np.zeros(b.shape, bool))
        np.testing.assert_array_equal(a[~tie], b[~tie], err_msg=name)
        assert (a != b).mean() <= MAX_NEAR_TIES, (name, (a != b).mean())


def test_click_track_synthetic_matches_jax(tmp_path, recorded_env, interactive_ckpts,
                                           monkeypatch):
    """``click_track --synthetic`` through both apps on the same SAM and
    XMem checkpoints, with two 4-click groups (the second entering at
    frame 3) and one refinement round."""
    from d3fields_tpu.apps import click_track as japp
    from d3fields_tpu.models.sam import predictor as jpredictor
    from d3fields_tpu.seg import video_tracker as jvt
    from d3fields_tpu_torch.apps import click_track as tapp

    ties, frame = {}, [0]
    orig_predict, orig_process = jpredictor.SamPredictor.predict_points, jvt.VideoMaskTracker.process

    def predict_points(self, *a, **k):
        masks, iou, low = orig_predict(self, *a, **k)
        best = int(np.argmax(iou[0]))
        logits = np.asarray(jpredictor._postprocess_jit(
            jnp_asarray(low[:, best:best + 1]), self.cfg.image_size, self._resized_hw,
            self._orig_hw))[0, 0]
        p = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
        ties[frame[0]] = ties.get(frame[0], False) | _near_tie_share(np.stack([p, 1 - p]))
        return masks, iou, low

    def process(self, rgb, mask=None, return_index=False):
        out = orig_process(self, rgb, mask, return_index)
        if mask is None:
            ties[frame[0]] = _near_tie_share(np.asarray(self.last_prob[0]))
        frame[0] += 1
        return out

    monkeypatch.setattr(jpredictor.SamPredictor, "predict_points", predict_points)
    monkeypatch.setattr(jvt.VideoMaskTracker, "process", process)
    argv = ["--synthetic", "--frames", "6", "--size", "-1", "--clicks", CLICKS, "--refine", "1",
            "--sam_ckpt", interactive_ckpts["sam"], "--xmem_ckpt", interactive_ckpts["xmem"],
            "--key_dim", "8", "--value_dim", "16", "--hidden_dim", "8"]
    assert tapp.main(argv + ["--out", str(tmp_path / "ours")], device="cpu") == 0
    assert japp.main(argv + ["--out", str(tmp_path / "ref")]) == 0
    assert sorted(ties) == list(range(6))
    _hold_index_pngs(str(tmp_path / "ours" / "synthetic_0"), str(tmp_path / "ref" / "synthetic_0"),
                     ties)
    from PIL import Image

    last = np.array(Image.open(str(tmp_path / "ours" / "synthetic_0" / "00005.png")))
    assert last.shape == (120, 160) and last.max() <= 2


def jnp_asarray(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


INTERACTIVE_SCRIPT = (
    "goto 0\n"
    "object 1\n"
    "free 1 10,10 20,20\n"
    "commit\n"
    "click 30 24 +        # f-BRS refinement of object 1\n"
    "click 44 30 -\n"
    "click 36 20 +\n"
    "undo\n"
    "commit\n"
    "scribble 1 12,12 18,18 30,14\n"
    "commit\n"
    "free 1 25,20 40,30\n"
    "commit\n"
    "propagate forward\n"
    "vis davis {out}/davis.png\n"
    "vis_target 1\n"
    "vis popup {out}/popup.png\n"
    "save\n"
)


def test_interactive_scripted_matches_jax(tmp_path, recorded_env, interactive_ckpts,
                                          monkeypatch):
    """``interactive --images`` through both apps on the same PNG frames and
    checkpoints: a free stroke, f-BRS clicks with undo, a scribble,
    forward propagation, overlays; then a second run that resumes from the
    saved masks and propagates backward."""
    from PIL import Image

    from d3fields_tpu.apps import interactive as japp
    from d3fields_tpu.interact import session as jsession
    from d3fields_tpu_torch.apps import interactive as tapp
    from d3fields_tpu_torch.utils.png import save_png

    src = tmp_path / "frames"
    src.mkdir()
    base = (np.random.RandomState(0).rand(48, 64, 3) * 255).astype(np.uint8)
    for t in range(3):
        save_png(str(src / f"{t:03d}.png"), np.roll(base, 3 * t, axis=1))
    ties = {}
    orig_finish, orig_step = jsession.InteractiveSession._finish_gesture, \
        jsession.InteractiveSession._xmem_step

    def finish(self):
        mask = orig_finish(self)
        ties[self.cursur] = _near_tie_share(self.current_prob)
        return mask

    def step(self, with_mask):
        prob = orig_step(self, with_mask)
        if not with_mask:
            ties[self.cursur] = _near_tie_share(prob)
        return prob

    monkeypatch.setattr(jsession.InteractiveSession, "_finish_gesture", finish)
    monkeypatch.setattr(jsession.InteractiveSession, "_xmem_step", step)
    ck = interactive_ckpts
    models = ["--xmem_ckpt", ck["xmem"], "--s2m_ckpt", ck["s2m"], "--fbrs_ckpt", ck["fbrs"],
              "--key_dim", "8", "--value_dim", "16", "--hidden_dim", "8", "--num_objects", "1",
              "--size", "-1"]
    for name, app, kw in (("ours", tapp, {"device": "cpu"}), ("ref", japp, {})):
        out = tmp_path / name
        out.mkdir()
        script = out / "script.txt"
        script.write_text(INTERACTIVE_SCRIPT.format(out=out))
        ws = str(out / "ws")
        assert app.main(["--images", str(src), "--workspace", ws, "--script", str(script)]
                        + models, **kw) == 0
        assert sorted(os.listdir(os.path.join(ws, "images"))) == [f"{t:03d}.png" for t in range(3)]
        if name == "ours":
            ties.clear()
    _hold_index_pngs(str(tmp_path / "ours" / "ws" / "masks"), str(tmp_path / "ref" / "ws" / "masks"),
                     ties)
    for mode in ("davis", "popup"):
        a = np.array(Image.open(str(tmp_path / "ours" / f"{mode}.png")))
        b = np.array(Image.open(str(tmp_path / "ref" / f"{mode}.png")))
        assert a.shape == b.shape == (48, 64, 3)
        assert (a != b).any(-1).mean() <= MAX_NEAR_TIES, mode
    for t in range(3):
        m = Image.open(str(tmp_path / "ours" / "ws" / "masks" / f"{t:03d}.png"))
        assert m.mode == "P" and np.array(m).max() == 1

    # resume: the saved masks seed the next run; propagate backward from the end
    ties.clear()
    for name, app, kw in (("ours", tapp, {"device": "cpu"}), ("ref", japp, {})):
        out = tmp_path / name
        (out / "script2.txt").write_text("goto 2\npropagate backward\nsave\n")
        assert app.main(["--workspace", str(out / "ws"), "--script", str(out / "script2.txt")]
                        + models, **kw) == 0
        if name == "ours":
            ties.clear()
    _hold_index_pngs(str(tmp_path / "ours" / "ws" / "masks"), str(tmp_path / "ref" / "ws" / "masks"),
                     ties)


def test_interactive_reads_only_what_it_can(tmp_path):
    """``--video`` takes the uncompressed AVI that ``TrackVis`` writes and
    raises on other files; a ``.bmp`` frame raises; ``vis`` writes PNG."""
    from d3fields_tpu_torch.apps import interactive as tapp
    from d3fields_tpu_torch.utils.avi import AviWriter

    frames = (np.random.RandomState(1).rand(3, 40, 60, 3) * 255).astype(np.uint8)
    with AviWriter(str(tmp_path / "clip.avi")) as w:
        for f in frames:
            w.write(f)
    ws, names, image_dir, _ = tapp.prepare_workspace(None, str(tmp_path / "clip.avi"),
                                                     str(tmp_path / "ws"), 30)
    assert names == [f"{t:07d}" for t in range(3)]
    get = tapp.frame_reader(image_dir, names)
    assert get(0).shape == (30, 45, 3)
    np.testing.assert_array_equal(
        get(2), tapp._short_side_resize(frames[2], 30)[..., ::-1])
    (tmp_path / "clip.mp4").write_bytes(b"\x00\x00\x00\x18ftypmp42")
    with pytest.raises(ValueError, match="uncompressed 24-bit AVI"):
        tapp.prepare_workspace(None, str(tmp_path / "clip.mp4"), str(tmp_path / "ws2"), -1)
    bmp = tmp_path / "bmp"
    bmp.mkdir()
    (bmp / "000.bmp").write_bytes(b"BM")
    with pytest.raises(ValueError, match=r"\.bmp frames are not read"):
        tapp.prepare_workspace(str(bmp), None, str(tmp_path / "ws3"), -1)

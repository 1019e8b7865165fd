"""Port parity: multi-device inference (d3fields_tpu_torch/parallel and the
four ``shard_views``) against d3fields_tpu's sharded functions.

The JAX side runs on the 8-device virtual CPU mesh that tests/conftest.py
forces; the port's meshes repeat the CPU device (``make_mesh(4,
devices=["cpu"] * 4)``), which runs the same split, copy and gather code
as a mesh of GPUs. Tolerances are tests/test_parallel_train.py's: the
field query's dist rtol 1e-5 / atol 1e-6 and descriptors rtol 1e-4 / atol
1e-5; DINOv2 rtol 1e-4 / atol 1e-5; XMem probabilities atol 2e-3 with
labels agreeing on > 99.5% of pixels; GroundingDINO boxes rtol 1e-5 /
atol 1e-4, confidences rtol 1e-5 / atol 1e-6, classes equal. The port
against itself, sharded and not, is held bit for bit where the per-view
arithmetic is unchanged (the field query) and at those tolerances where a
smaller batch may reorder a convolution's or a matmul's sums. The two
collectives run in 2 gloo processes, each under its own time limit.
"""

import os
import socket
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d3fields_tpu.config import XMemConfig as JXMemConfig
from d3fields_tpu.fields import fusion as jfusion
from d3fields_tpu.fields.state import state_from_obs as jstate_from_obs
from d3fields_tpu.models import dinov2 as jd2
from d3fields_tpu.models.groundingdino import detector as jdet
from d3fields_tpu.models.groundingdino import model as jgd
from d3fields_tpu.models.sam import model as jsam
from d3fields_tpu.models.sam.predictor import SamPredictor as JPredictor
from d3fields_tpu.models.xmem import core as JC
from d3fields_tpu.models.xmem import network as JN
from d3fields_tpu.ops.fps import fps_rad_np as jfps_rad_np
from d3fields_tpu.parallel import mesh as jmesh
from d3fields_tpu.parallel.sharded import sharded_batch_eval as jsharded_batch_eval
from d3fields_tpu_torch import Fusion
from d3fields_tpu_torch.config import XMemConfig
from d3fields_tpu_torch.fields import fusion as tfusion
from d3fields_tpu_torch.fields.state import state_from_obs as tstate_from_obs
from d3fields_tpu_torch.models import dinov2 as td2
from d3fields_tpu_torch.models.groundingdino import detector as tdet
from d3fields_tpu_torch.models.groundingdino import model as tgd
from d3fields_tpu_torch.models.sam import model as tsam
from d3fields_tpu_torch.models.sam.predictor import SamPredictor as TPredictor
from d3fields_tpu_torch.models.xmem import core as TC
from d3fields_tpu_torch.models.xmem import network as TN
from d3fields_tpu_torch.ops.fps import fps_rad_np
from d3fields_tpu_torch.parallel import (
    ViewShards, initialize_distributed, make_mesh, replicate, shard_leading,
    shard_leading_checked, sharded_batch_eval)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mesh(n=4):
    return make_mesh(n, devices=["cpu"] * n)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per pytest-xdist worker: the workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# mesh and placement
# ---------------------------------------------------------------------------

def test_make_mesh_shape_devices_and_no_cpu_fallback():
    mesh = make_mesh(2, devices=["cpu"] * 4)
    assert mesh.size == 2 and mesh.first == CPU
    assert mesh.devices == (CPU, CPU) and mesh.distinct_devices() == [CPU]
    assert make_mesh(devices=["cpu"] * 3).size == 3
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="needs 0 devices"):
        make_mesh(0, devices=["cpu"])
    # CUDA asked for (by default or by name) with too few visible: raise,
    # never a mesh of CPU devices
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(dp=visible + 1)
    with pytest.raises(RuntimeError):
        make_mesh(1, devices=[f"cuda:{visible}"])


def test_shard_replicate_and_gather():
    mesh = _mesh(4)
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    parts = shard_leading_checked(mesh, x)
    assert [tuple(p.shape) for p in parts] == [(2, 3)] * 4
    assert [tuple(p.shape) for p in shard_leading(mesh, x[:7])] == [(2, 3)] * 3 + [(1, 3)]
    with pytest.raises(ValueError, match="views count 7 not divisible by mesh axis 'dp' of size 4"):
        shard_leading_checked(mesh, x[:7])
    model = torch.nn.Linear(3, 2)
    reps = replicate(mesh, model)
    assert list(reps) == [CPU] and reps[CPU] is model  # a repeated device shares one copy
    st = tstate_from_obs({"depth": np.ones((2, 4, 5), np.float32),
                          "pose": np.zeros((2, 3, 4), np.float32),
                          "K": np.eye(3, dtype=np.float32)[None].repeat(2, 0)}, device="cpu")
    assert replicate(mesh, st)[CPU].depth.shape == (2, 4, 5)
    views = ViewShards(mesh, model)
    out = views.map(lambda m, d, a, b: (m(a), a + b), x, x)
    torch.testing.assert_close(out[0], model(torch.as_tensor(x)), rtol=0, atol=0)
    torch.testing.assert_close(out[1], torch.as_tensor(2 * x), rtol=0, atol=0)


def test_initialize_distributed_single_process_noop(monkeypatch):
    """tests/test_parallel_train.py:292-311: without an address or a
    launcher's environment of several processes, no process group starts."""
    for k in ("WORLD_SIZE", "RANK", "SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
              "SLURM_PROCID"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False
    monkeypatch.setenv("SLURM_JOB_ID", "12345")  # a bare sbatch/salloc shell
    assert initialize_distributed() is False
    monkeypatch.setenv("SLURM_STEP_NODELIST", "node01")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert initialize_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")  # torchrun with one process
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="num_processes"):
        initialize_distributed("localhost:1234", device="cpu")


# ---------------------------------------------------------------------------
# the field query split over devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def states(scene):
    kw = dict(dino_feats=scene["dino_feats"], mask=scene["mask"], mu=0.02)
    return jstate_from_obs(scene, **kw), tstate_from_obs(scene, **kw, device="cpu")


@pytest.mark.parametrize("fused, matmul_dtype", [
    (False, "float32"), (True, "float32"), (True, "bfloat16")])
def test_sharded_batch_eval_matches_jax_and_batch_eval(states, fused, matmul_dtype):
    """tests/test_parallel_train.py:22-58 and :353-372: 3000 points in
    tiles of 128 over 4 devices (padded to 3072) against the JAX sharded
    eval on 8 devices, and bit for bit against the port's own batch_eval;
    the bf16 route against batch_eval only (the JAX eval is f32 off a TPU)."""
    js, ts = states
    pts = np.random.RandomState(0).uniform(-0.4, 0.4, (3000, 3)).astype(np.float32)
    names = ("dino_feats", "mask")
    got = sharded_batch_eval(_mesh(4), ts, pts, names, tile=128, fused=fused,
                             matmul_dtype=matmul_dtype)
    ref = tfusion.batch_eval(ts, pts, names, tile=512, fused=fused, matmul_dtype=matmul_dtype)
    for k in ("dist", "valid_mask") + names:
        assert got[k].shape[0] == 3000 and got[k].device == CPU
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0, msg=k)
    if matmul_dtype == "bfloat16":
        return
    j = jsharded_batch_eval(jmesh.make_mesh(dp=8, tp=1), js, pts, names, tile=128,
                            use_pallas=fused)
    np.testing.assert_array_equal(_np(got["valid_mask"]), np.asarray(j["valid_mask"]))
    np.testing.assert_allclose(_np(got["dist"]), np.asarray(j["dist"]), rtol=1e-5, atol=1e-6)
    for k in names:
        np.testing.assert_allclose(_np(got[k]), np.asarray(j[k]), rtol=1e-4, atol=1e-5)


def test_sharded_batch_eval_one_device_and_edge_sizes(states):
    _, ts = states
    pts = np.random.RandomState(1).uniform(-0.4, 0.4, (37, 3)).astype(np.float32)
    ref = tfusion.batch_eval(ts, pts, ("dino_feats",), tile=16, fused=True)
    got = sharded_batch_eval(_mesh(1), ts, pts, ("dino_feats",), tile=16, fused=True)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)
    empty = sharded_batch_eval(_mesh(2), ts, np.zeros((0, 3), np.float32), ("dino_feats",),
                               tile=16)
    assert empty["dist"].shape == (0,) and empty["dino_feats"].shape == (0, 32)


# ---------------------------------------------------------------------------
# shard_views
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dinov2_pair():
    cfg = jd2.Dinov2Config.tiny_test()
    params = {k: np.asarray(v) for k, v in jd2.init_params(jax.random.PRNGKey(0), cfg).items()}
    port = td2.load_jax_params(td2.Dinov2(td2.Dinov2Config.tiny_test(), device="cpu"), params)
    return params, cfg, port


def test_dinov2_views_sharded_matches_jax_sharded(dinov2_pair):
    """tests/test_parallel_train.py:494-517: 8 views over 4 devices."""
    params, cfg, port = dinov2_pair
    imgs = np.random.RandomState(0).randint(0, 255, (8, 48, 64, 3), dtype=np.uint8)
    ref = jd2.Dinov2Backbone(params, cfg).shard_views(jmesh.make_mesh(dp=8, tp=1))(
        imgs, patch_hw=(4, 6))
    single = td2.Dinov2Backbone(port, device="cpu")(imgs, patch_hw=(4, 6))
    bb = td2.Dinov2Backbone(port, device="cpu").shard_views(_mesh(4))
    got = bb(imgs, patch_hw=(4, 6))
    assert got.device == CPU and tuple(got.shape) == (8, 4, 6, cfg.hidden_size)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(got), _np(single), rtol=1e-4, atol=1e-5)
    assert list(bb._pos_cache[4, 6]) == [CPU]
    with pytest.raises(ValueError, match="not divisible"):
        bb(imgs[:3], patch_hw=(4, 6))


def test_fusion_perception_step_sharded(scene, dinov2_pair):
    """tests/test_parallel_train.py:520-549: Fusion.update with the 4 DINOv2
    views split over 4 devices, then the field query split over them,
    against the JAX package's pipeline sharded the same way."""
    params, cfg, port = dinov2_pair
    obs = {k: scene[k] for k in ("color", "depth", "pose", "K")}
    pts = np.random.RandomState(2).uniform(-0.4, 0.4, (2000, 3)).astype(np.float32)
    jmesh4 = jmesh.make_mesh(dp=4, tp=1)
    jf = jfusion.Fusion(feature_backend=jd2.Dinov2Backbone(params, cfg).shard_views(jmesh4))
    ref = jsharded_batch_eval(jmesh4, jf.update(obs), pts, ("dino_feats",), tile=256)
    mesh = _mesh(4)
    tf = Fusion(feature_backend=td2.Dinov2Backbone(port, device="cpu").shard_views(mesh),
                device="cpu")
    got = sharded_batch_eval(mesh, tf.update(obs), pts, ("dino_feats",), tile=256)
    np.testing.assert_allclose(_np(got["dist"]), np.asarray(ref["dist"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(got["dino_feats"]), np.asarray(ref["dino_feats"]),
                               rtol=1e-4, atol=1e-5)


def _xmem_pair():
    """tests/test_parallel_train.py:446-491's config, with weights at
    PyTorch's default initialisation and random batch-norm statistics (as
    tests/test_torch_xmem.py draws them), carried to JAX by its converter.
    The JAX ``init_params`` weights at these widths drive the key
    encoder's shrinkage term to ~3.7e3, where a batch of one view and of
    four round the same convolution 1e-2 apart, and three frames amplify
    that to 3.8e-3 in the probabilities of the port's own sharded and
    unsharded cores (2.9e-3 between the JAX package's, the unsteadiness of
    its test): a measure of those weights, not of the split."""
    kw = dict(key_dim=8, value_dim=16, hidden_dim=8, top_k=5, mem_every=2,
              max_mid_term_frames=3, min_mid_term_frames=1, num_prototypes=4,
              max_long_term_elements=64, size=-1)
    jcfg, cfg = JXMemConfig(**kw), XMemConfig(**kw)
    model = TN.XMem(cfg, device="cpu")
    torch.manual_seed(0)
    rs = np.random.RandomState(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.reset_parameters()
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.as_tensor(rs.uniform(0.5, 1.5, m.num_features),
                                               dtype=torch.float32))
                m.bias.copy_(torch.as_tensor(0.1 * rs.randn(m.num_features),
                                             dtype=torch.float32))
                m.running_mean.copy_(torch.as_tensor(0.1 * rs.randn(m.num_features),
                                                     dtype=torch.float32))
                m.running_var.copy_(torch.as_tensor(rs.uniform(0.5, 1.5, m.num_features),
                                                    dtype=torch.float32))
    params = JN.convert_torch_state_dict(
        {k: v.detach().numpy() for k, v in model.eval().state_dict().items()}, jcfg)
    return params, jcfg, model, cfg


def test_xmem_views_sharded_matches_jax_sharded():
    """tests/test_parallel_train.py:446-491: 4 views over 4 devices, one
    view group each, 4 frames; then the memory survives a host round trip
    into an unsharded core and a re-sharded one."""
    params, jcfg, model, cfg = _xmem_pair()
    rs = np.random.RandomState(5)
    V, H, W = 4, 32, 32
    video = rs.rand(5, V, H, W, 3).astype(np.float32)
    m0 = (rs.rand(V, 2, H, W) > 0.6).astype(np.float32)
    jcore = JC.XMemCore(params, jcfg, num_views=V, num_objects=2, image_hw=(H, W))
    jcore = jcore.shard_views(jmesh.make_mesh(dp=4, tp=1))
    single = TC.XMemCore(model, cfg, V, 2, (H, W), device="cpu")
    core = TC.XMemCore(model, cfg, V, 2, (H, W), device="cpu").shard_views(_mesh(4))
    assert len(core.mems) == 4 and core.mems[0].wk.shape[0] == 1
    with pytest.raises(RuntimeError, match="core.mems"):
        core.mem  # noqa: B018 -- one group's accessor on four groups
    for t in range(4):
        mask = m0 if t == 0 else None
        ref = np.asarray(jcore.step(jnp.asarray(video[t]),
                                    None if mask is None else jnp.asarray(mask)))
        own = _np(single.step(video[t], mask))
        got = _np(core.step(video[t], mask))
        assert got.shape == (V, 3, H, W)
        for want in (ref, own):
            np.testing.assert_allclose(got, want, atol=2e-3, err_msg=f"frame {t}")
            assert (got.argmax(1) == want.argmax(1)).mean() > 0.995, f"frame {t}"
    assert core.mems[0].w_size == single.mem.w_size and core.curr_ti == single.curr_ti

    # the whole memory round-trips, into a core of either layout
    host = core.memory_to_host()
    assert host["wk"].shape[0] == V and host["w_size"] == single.mem.w_size
    for target in (TC.XMemCore(model, cfg, V, 2, (H, W), device="cpu"),
                   TC.XMemCore(model, cfg, V, 2, (H, W), device="cpu").shard_views(_mesh(2))):
        for c in (target, single):
            c.memory_from_host(host)
            c.curr_ti, c.last_mem_ti = core.curr_ti, core.last_mem_ti
        np.testing.assert_allclose(_np(target.step(video[4])), _np(single.step(video[4])),
                                   atol=2e-3)

    core.clear_memory()  # keeps the view groups
    assert len(core.mems) == 4 and core.mems[0].w_size == 0


def test_xmem_sharded_fusion_checkpoint_round_trips(tmp_path):
    """Fusion.save_state of a sharded tracker's memory, loaded into an
    unsharded one: the same memory, view for view."""
    from d3fields_tpu_torch.seg.video_tracker import VideoMaskTracker

    _, _, model, cfg = _xmem_pair()
    rs = np.random.RandomState(6)
    frames = (rs.rand(3, 4, 32, 32, 3) * 255).astype(np.uint8)
    mask = rs.randint(0, 3, (4, 32, 32))
    tr = VideoMaskTracker(model, cfg, 4, 2, (32, 32), size=-1, device="cpu")
    tr.core.shard_views(_mesh(2))
    tr.process(frames[0], mask)
    tr.process(frames[1])
    fus = Fusion(num_cam=4, video_tracker=tr, device="cpu")
    fus.save_state(str(tmp_path / "state.pkl"))
    back = Fusion(num_cam=4, video_tracker=VideoMaskTracker(model, cfg, 4, 2, (32, 32),
                                                            size=-1, device="cpu"),
                  device="cpu")
    back.load_state(str(tmp_path / "state.pkl"))
    want = tr.core.memory_to_host()
    got = back.video_tracker.core.memory_to_host()
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)
    nxt = rs.rand(4, 32, 32, 3).astype(np.float32)
    np.testing.assert_allclose(_np(back.video_tracker.core.step(nxt)), _np(tr.core.step(nxt)),
                               atol=2e-3)


def test_views_not_divisible_raise():
    _, _, model, cfg = _xmem_pair()
    with pytest.raises(ValueError, match="num_views=3 not divisible by mesh axis 'dp' of size 2"):
        TC.XMemCore(model, cfg, 3, 2, (32, 32), device="cpu").shard_views(_mesh(2))
    sam = TPredictor(tsam.Sam(tsam.SamConfig.tiny_test(), device="cpu"), device="cpu")
    sam.shard_views(_mesh(2))
    imgs = np.zeros((3, 16, 16, 3), np.uint8)
    with pytest.raises(ValueError, match="views count 3 not divisible"):
        sam.set_images(imgs)
    det = tdet.GroundingDinoDetector(tgd.GroundingDino(tgd.GroundingDinoConfig.tiny_test(),
                                                       device="cpu"),
                                     tokenize=_tok, short_side=32, max_side=48, device="cpu")
    det.shard_views(_mesh(2))
    with pytest.raises(ValueError, match="views count 3 not divisible"):
        det.predict_with_classes_batch(imgs, ["mug"], 0.1)


def _tok(text):
    # crc32, not hash(): str hashes are salted per process
    return [200 + zlib.crc32(w.encode()) % 1000 for w in text.split()]


@pytest.fixture(scope="module")
def gdino_pair():
    cfg = jgd.GroundingDinoConfig.tiny_test()
    sd = jgd.build_random_hf(cfg, seed=0).state_dict()
    jparams = jgd.convert_hf_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    port = tgd.GroundingDino(tgd.GroundingDinoConfig.tiny_test(), device="cpu")
    port.load_state_dict(sd, strict=True)
    return jparams, cfg, port.eval()


def test_gdino_views_sharded_matches_jax_shard_map(gdino_pair):
    """tests/test_parallel_train.py:552-587: 8 views, the JAX detector under
    shard_map over 8 devices with the interpret-mode Pallas gather, the
    port's over 4 devices (each forward launching deform_gather on its 2
    views); and the port sharded against itself unsharded."""
    jparams, cfg, port = gdino_pair
    imgs = np.random.RandomState(6).randint(0, 255, (8, 40, 48, 3), dtype=np.uint8)
    kw = dict(tokenize=_tok, short_side=32, max_side=48)
    det = jdet.GroundingDinoDetector(jparams, cfg, gather_impl="pallas_interpret", **kw)
    mesh8 = jmesh.make_mesh(dp=8, tp=1)
    with mesh8:
        ref = det.shard_views(mesh8).predict_with_classes_batch(imgs, ["mug", "pen"], 0.1)
    single = tdet.GroundingDinoDetector(port, device="cpu", **kw)
    sharded = tdet.GroundingDinoDetector(port, device="cpu", **kw).shard_views(_mesh(4))
    got = sharded.predict_with_classes_batch(imgs, ["mug", "pen"], 0.1)
    own = single.predict_with_classes_batch(imgs, ["mug", "pen"], 0.1)
    assert len(got) == len(ref) == 8 and sum(len(r.class_id) for r in ref) > 0
    for g, r, o in zip(got, ref, own):
        for want in (r, o):
            np.testing.assert_array_equal(g.class_id, want.class_id)
            np.testing.assert_allclose(g.xyxy, want.xyxy, rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(g.confidence, want.confidence, rtol=1e-5, atol=1e-6)
    ids = tdet.tokenize_classes(["mug", "pen"], _tok)[0]
    for a, b in zip(sharded.forward_views(imgs, ids), single.forward_views(imgs, ids)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def sam_pair():
    cfg = jsam.SamConfig.tiny_test()
    sd = jsam.build_random_hf(cfg, seed=0).state_dict()
    jparams = jsam.convert_hf_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    port = tsam.Sam(tsam.SamConfig.tiny_test(), device="cpu")
    port.load_state_dict(sd, strict=True)
    return jparams, cfg, port.eval()


def test_sam_views_sharded_matches_unsharded_and_jax_sharded(sam_pair):
    """4 views over 2 devices: each device encodes its 2 views and decodes
    their boxes (a view with none among them), against the unsharded port
    and the JAX predictor sharded over 4 devices, at
    tests/test_torch_sam.py's tolerances (iou rtol 1e-4 / atol 1e-5, masks
    equal up to knife-edge logits)."""
    jparams, cfg, port = sam_pair
    rs = np.random.RandomState(3)
    imgs = rs.randint(0, 255, (4, 48, 56, 3), dtype=np.uint8)
    boxes = [np.array([[4.0, 4.0, 30.0, 40.0], [10.0, 8.0, 44.0, 30.0]], np.float32),
             np.zeros((0, 4), np.float32),
             np.array([[2.0, 2.0, 20.0, 20.0]], np.float32),
             np.array([[6.0, 3.0, 50.0, 46.0], [1.0, 1.0, 10.0, 12.0]], np.float32)]
    one = TPredictor(port, device="cpu").set_images(imgs)
    single = one.predict_boxes_views(boxes)
    pred = TPredictor(port, device="cpu").shard_views(_mesh(2))
    got = pred.set_images(imgs).predict_boxes_views(boxes)
    assert isinstance(pred._image_embs, list) and len(pred._image_embs) == 2
    assert len(one._image_embs) == 1  # one group: the same code path
    np.testing.assert_allclose(_np(pred.image_embeddings()), _np(one.image_embeddings()),
                               rtol=1e-4, atol=1e-5)
    jm = jmesh.make_mesh(dp=4, tp=1)
    ref = JPredictor(jparams, cfg).shard_views(jm).set_images(imgs).predict_boxes_views(boxes)
    assert len(got) == 4
    for (m, i), (sm, si), (rm, ri) in zip(got, single, ref):
        assert m.dtype == torch.bool and m.shape == sm.shape and m.device == CPU
        torch.testing.assert_close(m, sm, rtol=0, atol=0)
        np.testing.assert_allclose(_np(i), _np(si), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(_np(i), np.asarray(ri), rtol=1e-4, atol=1e-5)
        if m.shape[0]:
            assert (_np(m) == np.asarray(rm)).mean() > 0.999
    # one image runs on the first device's replica, unsharded
    lm, _ = pred.set_image(imgs[0]).predict_boxes(boxes[0])
    assert (lm == single[0][0]).float().mean() > 0.999


# ---------------------------------------------------------------------------
# collectives over 2 gloo processes
# ---------------------------------------------------------------------------

RANK_SCRIPT = r"""
import os
import sys
import numpy as np
import torch
from d3fields_tpu_torch.parallel import all_gather_points, initialize_distributed, sync_batch_norm

addr, rank, data, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
assert initialize_distributed(addr, 2, rank, device="cpu")
d = np.load(data)
x = torch.tensor(d["x"][4 * rank:4 * rank + 4], requires_grad=True)
scale = torch.tensor(d["scale"], requires_grad=True)
bias = torch.tensor(d["bias"], requires_grad=True)
y, mean, var = sync_batch_norm(x, scale, bias)
(y * torch.tensor(d["g"][4 * rank:4 * rank + 4])).sum().backward()
pts = torch.tensor(d["pts"][3 * rank:3 * rank + 3], requires_grad=True)
gathered = all_gather_points(pts)
(gathered * torch.tensor(d["gp"])).sum().backward()
np.savez(out, y=y.detach().numpy(), mean=mean.detach().numpy(), var=var.detach().numpy(),
         gx=x.grad.numpy(), gscale=scale.grad.numpy(), gbias=bias.grad.numpy(),
         gathered=gathered.detach().numpy(), gpts=pts.grad.numpy())
torch.distributed.barrier()
torch.distributed.destroy_process_group()
# the group is gone with its threads, not held until the interpreter exits
# (where gloo's threads abort the process)
threads = [open(f"/proc/self/task/{t}/comm").read().strip() for t in os.listdir("/proc/self/task")]
assert not [t for t in threads if "gloo" in t], threads
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sync_batch_norm_and_all_gather_over_two_gloo_processes(tmp_path):
    """tests/test_parallel_train.py:40-58 across 2 processes: the global
    batch norm's output, moments and gradients (rtol 2e-4 / atol 2e-4),
    and the tiled all-gather with its gradient. Each rank runs under a
    60 s limit and is killed after, and leaves no gloo thread behind
    ``destroy_process_group``."""
    rs = np.random.RandomState(1)
    data = dict(x=rs.randn(8, 6, 6, 16).astype(np.float32),
                scale=(rs.rand(16) + 0.5).astype(np.float32),
                bias=rs.randn(16).astype(np.float32),
                g=rs.randn(8, 6, 6, 16).astype(np.float32),
                pts=rs.randn(6, 3).astype(np.float32), gp=rs.randn(6, 3).astype(np.float32))
    np.savez(tmp_path / "data.npz", **data)
    addr = f"localhost:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, addr, str(r),
                               str(tmp_path / "data.npz"), str(tmp_path / f"rank{r}.npz")],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        errs = [p.communicate(timeout=60)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert [p.returncode for p in procs] == [0, 0], errs
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]

    x = torch.tensor(data["x"], requires_grad=True)
    scale = torch.tensor(data["scale"], requires_grad=True)
    bias = torch.tensor(data["bias"], requires_grad=True)
    mean, var = x.mean(dim=(0, 1, 2)), x.var(dim=(0, 1, 2), unbiased=False)
    ref = (x - mean) / torch.sqrt(var + 1e-5) * scale + bias
    (ref * torch.tensor(data["g"])).sum().backward()
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]), _np(ref), **tol)
    np.testing.assert_allclose(np.concatenate([r["gx"] for r in ranks]), _np(x.grad), **tol)
    for r in ranks:
        np.testing.assert_allclose(r["mean"], _np(mean), **tol)
        np.testing.assert_allclose(r["var"], _np(var), **tol)
    # scale and bias are replicated: their gradient is the ranks' sum
    np.testing.assert_allclose(sum(r["gscale"] for r in ranks), _np(scale.grad), **tol)
    np.testing.assert_allclose(sum(r["gbias"] for r in ranks), _np(bias.grad), **tol)
    for r in ranks:
        np.testing.assert_array_equal(r["gathered"], data["pts"])
    # each rank's points feed both ranks' gathered sums: 2 x the weights
    np.testing.assert_allclose(np.concatenate([r["gpts"] for r in ranks]), 2 * data["gp"],
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# radius-terminated FPS
# ---------------------------------------------------------------------------

def test_fps_rad_np_matches_jax_and_covers():
    """The JAX function on the same seed (its start drawn from the global
    np.random state), and tests/test_ops.py:85-100's coverage property."""
    pcd = np.random.RandomState(0).rand(400, 3).astype(np.float32)
    r = 0.25
    np.random.seed(1)
    want = jfps_rad_np(pcd, r)
    np.random.seed(1)
    out = fps_rad_np(pcd, r)
    np.testing.assert_array_equal(out, want)
    d = np.linalg.norm(pcd[:, None] - out[None], axis=-1)
    assert d.min(axis=1).max() <= r + 1e-6
    dd = np.linalg.norm(out[:, None] - out[None], axis=-1)
    dd[np.eye(out.shape[0], dtype=bool)] = np.inf
    assert out.shape[0] > 2 and np.sort(dd.min(axis=1))[1:-1].min() > r - 1e-6

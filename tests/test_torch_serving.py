"""Port parity: the serving helpers, FusedFrameStep and the facade's XMem
branches of d3fields_tpu_torch against d3fields_tpu.

FusedFrameStep runs the same functions as the port's staged stages
(tracker.process -> backbone -> FieldState -> rigid_tracking_steps) in the
same order, so the two agree exactly on the CPU; against the JAX step
(tests/test_serving.py's tiny pipeline) the tolerances are
tests/test_serving.py:278-289's. The facade is held to the JAX ``Fusion``
on the synthetic two-sphere scene with a narrow XMem behind
``video_tracker_factory``: probabilities at 1e-4, labels equal off the
near-ties.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d3fields_tpu.config import Boundaries as JBoundaries
from d3fields_tpu.config import TrackingConfig as JTrackingConfig
from d3fields_tpu.config import XMemConfig as JXMemConfig
from d3fields_tpu.fields.fusion import Fusion as JFusion
from d3fields_tpu.models import dinov2 as jd2
from d3fields_tpu.seg.video_tracker import VideoMaskTracker as JVideoMaskTracker
from d3fields_tpu.serving import FusedFrameStep as JFusedFrameStep
from d3fields_tpu.utils import synthetic as jsyn
from d3fields_tpu_torch.config import Boundaries, TrackingConfig, XMemConfig
from d3fields_tpu_torch.fields.fusion import Fusion
from d3fields_tpu_torch.fields.state import FieldState
from d3fields_tpu_torch.models import dinov2 as td2
from d3fields_tpu_torch.seg.video_tracker import VideoMaskTracker
from d3fields_tpu_torch.serving import FusedFrameStep, host_prefetch, prefetch_to_device
from d3fields_tpu_torch.track.rigid import rigid_tracking_steps
from d3fields_tpu_torch.utils import synthetic as tsyn

from test_torch_xmem import tiny_xmem

CPU = torch.device("cpu")



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per pytest-xdist worker: the workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ---------------------------------------------------------------------------
# prefetch helpers (tests/test_serving.py:117-186)
# ---------------------------------------------------------------------------

def test_prefetch_to_device_order_and_types():
    frames = [{"img": np.full((2, 2), t, np.float32), "t": t, "x": torch.ones(1) * t}
              for t in range(5)]
    out = list(prefetch_to_device(iter(frames), size=2, device="cpu"))
    assert [f["t"] for f in out] == [0, 1, 2, 3, 4]
    for t, f in enumerate(out):
        assert isinstance(f["img"], torch.Tensor) and f["img"].device == CPU
        np.testing.assert_array_equal(f["img"].numpy(), t)
        assert float(f["x"]) == t


def test_prefetch_transform_and_short_streams():
    out = list(prefetch_to_device([np.ones(1)], size=4, device="cpu",
                                  transform=lambda x: x * 3))
    assert len(out) == 1
    np.testing.assert_array_equal(out[0].numpy(), 3)
    assert list(prefetch_to_device([], size=2, device="cpu")) == []
    with pytest.raises(ValueError):
        list(prefetch_to_device([], size=0, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            list(prefetch_to_device([np.ones(1)]))


def _no_prefetch_threads():
    return not [t for t in threading.enumerate() if t.name == "host_prefetch" and t.is_alive()]


def test_host_prefetch_order_and_overlap():
    produced = []

    def gen():
        for i in range(20):
            produced.append(i)
            yield i

    out = list(host_prefetch(gen(), size=3))
    assert out == list(range(20)) and produced == out
    assert _no_prefetch_threads()


def test_host_prefetch_propagates_producer_error():
    def gen():
        yield 1
        raise ValueError("decode failed")

    it = host_prefetch(gen(), size=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="decode failed"):
        list(it)


def test_host_prefetch_early_close_stops_producer():
    state = {"produced": 0}

    def gen():
        while True:
            state["produced"] += 1
            yield state["produced"]

    it = host_prefetch(gen(), size=2)
    assert next(it) == 1
    it.close()
    deadline = time.monotonic() + 5.0
    while not _no_prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert state["produced"] <= 8  # stopped near the queue bound
    assert _no_prefetch_threads()
    with pytest.raises(ValueError):
        host_prefetch([], size=0)


# ---------------------------------------------------------------------------
# FusedFrameStep (tests/test_serving.py:188-455)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipeline():
    """tests/test_serving.py:188-231's tiny pipeline in both packages: the
    same DINOv2 (JAX's parameters carried across) and XMem weights."""
    num_views, H, W, num_obj = 2, 40, 60, 2
    rs = np.random.RandomState(0)
    dcfg = jd2.Dinov2Config.tiny_test()
    dparams = jd2.init_params(jax.random.PRNGKey(0), dcfg)
    jbb = jd2.Dinov2Backbone(dparams, dcfg, resize_mode="device")
    bb = td2.Dinov2Backbone(
        td2.load_jax_params(td2.Dinov2(td2.Dinov2Config.tiny_test(), device="cpu"),
                            jax.tree.map(np.asarray, dparams)),
        resize_mode="device", device="cpu")
    model, jparams, kw = tiny_xmem()
    xcfg = dict(kw, size=-1)
    depth = (0.6 + 0.2 * rs.rand(num_views, H, W)).astype(np.float32)
    K = np.tile(np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32),
                (num_views, 1, 1))
    pose = np.stack([np.concatenate([np.eye(3, dtype=np.float32),
                                     np.array([[0.01 * v], [0.0], [0.7]], np.float32)], 1)
                     for v in range(num_views)])
    frames = rs.randint(0, 255, (3, num_views, H, W, 3), np.uint8)
    mask0 = np.zeros((num_views, H, W), np.uint8)
    mask0[:, 5:20, 10:30] = 1
    mask0[:, 25:38, 35:55] = 2
    return dict(
        bb=bb, jbb=jbb, depth=depth, pose=pose, K=K, frames=frames, mask0=mask0,
        kp=rs.uniform(-0.1, 0.1, (1, 16, 3)).astype(np.float32),
        lo=np.array([-0.5, -0.5, -0.5], np.float32), hi=np.array([0.5, 0.5, 0.5], np.float32),
        src=np.random.RandomState(7).randn(16, 64).astype(np.float32),
        make_tracker=lambda: VideoMaskTracker(model, XMemConfig(**xcfg), num_views, num_obj,
                                              (H, W), size=-1, device="cpu"),
        make_jtracker=lambda: JVideoMaskTracker(jparams, JXMemConfig(**xcfg), num_views,
                                                num_obj, (H, W), size=-1),
        model=model, xcfg=xcfg)


def _seeded(p, frames0=None, jax_side=False):
    tr = p["make_jtracker"]() if jax_side else p["make_tracker"]()
    tr.process(p["frames"][0] if frames0 is None else frames0, p["mask0"])
    return tr


def _fused(p, tracker, **kw):
    return FusedFrameStep(p["bb"], tracker, p["depth"], p["pose"], p["K"], p["lo"], p["hi"],
                          TrackingConfig(iters=5), **kw)


def _t(x):
    return torch.as_tensor(x)


def test_fused_frame_step_matches_the_staged_stages(pipeline):
    """The staged stages (tracker.process, the backbone, FieldState,
    rigid_tracking_steps) and FusedFrameStep agree exactly, over a normal
    and a memory frame (mem_every=2); the counters advance alike."""
    p = pipeline
    src, kp = _t(p["src"]), _t(p["kp"])
    lo, hi = _t(p["lo"]), _t(p["hi"])
    tr_ref = _seeded(p)
    ref = []
    for t in (1, 2):
        tr_ref.process(p["frames"][t])
        mask = tr_ref.last_prob[:, 1:].permute(0, 2, 3, 1)
        st = FieldState(depth=_t(p["depth"]), pose=_t(p["pose"]), K=_t(p["K"]),
                        dino_feats=p["bb"](p["frames"][t]).float(), mask=mask)
        ref.append({"mask": mask, **rigid_tracking_steps(st, src, kp, lo, hi,
                                                         TrackingConfig(iters=5))})
    tr = _seeded(p)
    fused = _fused(p, tr)
    for i, t in enumerate((1, 2)):
        out = fused.step(p["frames"][t], src, kp)
        for k in ("mask", "match_pts", "t", "log_r", "loss_history"):
            np.testing.assert_allclose(out[k].numpy(), ref[i][k].numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"frame {t} {k}")
    assert (tr.core.curr_ti, tr.core.last_mem_ti) == (tr_ref.core.curr_ti, tr_ref.core.last_mem_ti)
    assert tr.core.mem.w_size == tr_ref.core.mem.w_size == 2 * tr.core.mem.hw


def test_fused_frame_step_matches_jax(pipeline):
    """Against JAX's FusedFrameStep at tests/test_serving.py:278-289's
    tolerances (its executable may reassociate sums across the stages)."""
    p = pipeline
    jtr = _seeded(p, jax_side=True)
    jfused = JFusedFrameStep(p["jbb"], jtr, p["depth"], p["pose"], p["K"], p["lo"], p["hi"],
                             JTrackingConfig(iters=5))
    fused = _fused(p, _seeded(p))
    for t in (1, 2):
        ref = jfused.step(p["frames"][t], jnp.asarray(p["src"]), jnp.asarray(p["kp"]))
        out = fused.step(p["frames"][t], _t(p["src"]), _t(p["kp"]))
        m, rm = out["mask"].numpy(), np.asarray(ref["mask"])
        np.testing.assert_allclose(m, rm, atol=0.05)
        assert (m.argmax(-1) == rm.argmax(-1)).mean() > 0.995
        for k in ("match_pts", "t", "log_r"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=5e-3,
                                       err_msg=f"frame {t} {k}")
    assert fused.tracker.core.curr_ti == jtr.core.curr_ti
    assert fused.tracker.core.last_mem_ti == jtr.core.last_mem_ti


def test_step_segment_equals_chained_steps(pipeline):
    """step_segment runs the same frame body over T frames, frame t's
    points seeding frame t+1: identical to chaining step by hand."""
    p = pipeline
    f_ref = _fused(p, _seeded(p))
    ref, last = [], _t(p["kp"])
    for t in (1, 2):
        out = f_ref.step(p["frames"][t], _t(p["src"]), last)
        last = out["match_pts"]
        ref.append(out)
    fused = _fused(p, _seeded(p))
    outs = fused.step_segment(p["frames"][1:3], _t(p["src"]), _t(p["kp"]))
    assert fused.tracker.core.curr_ti == f_ref.tracker.core.curr_ti
    assert fused.tracker.core.last_mem_ti == f_ref.tracker.core.last_mem_ti
    for i in range(2):
        for k in ("match_pts", "t", "log_r", "loss_history", "mask"):
            assert torch.equal(outs[k][i], ref[i][k]), (i, k)


def test_fused_step_guards(pipeline):
    """An unseeded tracker, the Pillow-exact backbone and an explicit
    deep-update schedule are refused; a step that raises leaves the
    counters as they were."""
    p = pipeline
    with pytest.raises(RuntimeError, match="seed"):
        _fused(p, p["make_tracker"]()).step(p["frames"][0], _t(p["src"]), _t(p["kp"]))
    with pytest.raises(ValueError, match="resize_mode='device'"):
        FusedFrameStep(td2.Dinov2Backbone(p["bb"].model, device="cpu"), _seeded(p),
                       p["depth"], p["pose"], p["K"], p["lo"], p["hi"], TrackingConfig())
    unsync = VideoMaskTracker(p["model"], XMemConfig(**dict(p["xcfg"], deep_update_every=3)),
                              2, 2, (40, 60), size=-1, device="cpu")
    with pytest.raises(NotImplementedError, match="synchronized"):
        _fused(p, unsync)
    fused = _fused(p, _seeded(p))
    core = fused.tracker.core
    before = (core.curr_ti, core.last_mem_ti)
    with pytest.raises(RuntimeError):
        fused.step(p["frames"][1], torch.zeros(16, 3), _t(p["kp"]))  # wrong descriptor width
    assert (core.curr_ti, core.last_mem_ti) == before


def test_fused_step_honors_mu_and_4x4_pose(pipeline):
    """A non-default ``mu`` and (V, 4, 4) poses reach the step's FieldState
    as state_from_obs(mu=..., pose[:, :3]) would give them."""
    p = pipeline
    mu = 0.06
    pose44 = np.concatenate([p["pose"], np.tile(np.array([[[0, 0, 0, 1]]], np.float32),
                                                (p["pose"].shape[0], 1, 1))], axis=1)
    tr_ref = _seeded(p)
    tr_ref.process(p["frames"][1])
    st = FieldState(depth=_t(p["depth"]), pose=_t(p["pose"]), K=_t(p["K"]),
                    dino_feats=p["bb"](p["frames"][1]).float(),
                    mask=tr_ref.last_prob[:, 1:].permute(0, 2, 3, 1), mu=mu)
    ref = rigid_tracking_steps(st, _t(p["src"]), _t(p["kp"]), _t(p["lo"]), _t(p["hi"]),
                               TrackingConfig(iters=5))
    fused = FusedFrameStep(p["bb"], _seeded(p), p["depth"], pose44, p["K"], p["lo"], p["hi"],
                           TrackingConfig(iters=5), mu=mu)
    assert tuple(fused.pose.shape) == p["pose"].shape
    out = fused.step(p["frames"][1], _t(p["src"]), _t(p["kp"]))
    for k in ("match_pts", "t"):
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-6)


def test_fused_step_per_frame_depth_plumbs_through(pipeline):
    """A frame's own depth changes the field (and the tracked points) and
    not the XMem masks."""
    p = pipeline
    outs = [_fused(p, _seeded(p)).step(p["frames"][1], _t(p["src"]), _t(p["kp"]), depth=d)
            for d in (None, p["depth"] * 0.8)]
    assert torch.equal(outs[0]["mask"], outs[1]["mask"])
    assert float((outs[0]["match_pts"] - outs[1]["match_pts"]).abs().max()) > 1e-4


def test_fused_step_xmem_bgr_flip(pipeline):
    """xmem_bgr_to_rgb flips the XMem branch only: its masks equal a run fed
    pre-flipped frames, while DINOv2 sees the frames as they are."""
    p = pipeline
    flipped = p["frames"][..., ::-1].copy()
    out_a = _fused(p, _seeded(p, flipped[0])).step(flipped[1], _t(p["src"]), _t(p["kp"]))
    out_b = _fused(p, _seeded(p, flipped[0]), xmem_bgr_to_rgb=True).step(
        p["frames"][1], _t(p["src"]), _t(p["kp"]))
    assert torch.equal(out_a["mask"], out_b["mask"])
    assert float((out_a["match_pts"] - out_b["match_pts"]).abs().max()) > 1e-5


# ---------------------------------------------------------------------------
# the facade's XMem branches
# ---------------------------------------------------------------------------

LABELS = ["shoe", "shoe"]
BOUNDS = (-0.3, 0.6, -0.4, 0.4, 0.001, 0.4)  # vis_tracking --synthetic


def _scene(syn, t):
    offs = np.array([[0.008 * t, 0.004 * t, 0.0], [-0.005 * t, 0.006 * t, 0.0]])
    return syn.render_sphere_scene(num_views=4, H=96, W=128, feat_dim=16, sphere_offsets=offs)


def _facade(fusion_cls, syn, factory, device):
    scene0 = _scene(syn, 0)
    kw = {} if device is None else {"device": device}
    return fusion_cls(num_cam=4, mask_backend=syn.sphere_mask_backend(scene0, LABELS),
                      video_tracker_factory=factory, **kw)


def _frame(fusion, syn, t, boundaries):
    sc = _scene(syn, t)
    fusion.update({k: sc[k] for k in ("color", "depth", "pose", "K", "dino_feats")})
    return fusion.text_queries_for_inst_mask(["shoe"], [0.5], boundaries=boundaries)


@pytest.fixture(scope="module")
def xmem_tiny():
    return tiny_xmem(seed=2)


def _factories(xmem_tiny):
    model, jparams, kw = xmem_tiny
    cfg = dict(kw, size=-1)

    def port(num_views, num_objects, image_hw):
        return VideoMaskTracker(model, XMemConfig(**cfg), num_views, num_objects, image_hw,
                                size=-1, device="cpu")

    def jax_side(num_views, num_objects, image_hw):
        return JVideoMaskTracker(jparams, JXMemConfig(**cfg), num_views, num_objects,
                                 image_hw, size=-1)

    return port, jax_side


def _assert_tracked_alike(fus, jfus, index, jindex, labels, jlabels):
    assert labels == jlabels
    np.testing.assert_allclose(fus.video_tracker.last_prob.numpy(),
                               np.asarray(jfus.video_tracker.last_prob), atol=1e-4)
    top2 = np.sort(np.asarray(jfus.video_tracker.last_prob), axis=1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 2e-4
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(np.asarray(index)[sure], np.asarray(jindex)[sure])
    m, jm = fus.state.mask.numpy(), np.asarray(jfus.state.mask)
    np.testing.assert_array_equal(m.argmax(-1)[sure], jm.argmax(-1)[sure])


def test_text_queries_propagate_through_the_tracker_like_jax(xmem_tiny):
    """Consensus on frame 0 builds the tracker through the factory and
    seeds it; frames 1-2 propagate; clear_xmem_memory resets tracking, and
    the next frame seeds again from consensus."""
    port_factory, jax_factory = _factories(xmem_tiny)
    fus = _facade(Fusion, tsyn, port_factory, "cpu")
    jfus = _facade(JFusion, jsyn, jax_factory, None)
    b = Boundaries(*BOUNDS)
    for t in range(3):
        index, labels = _frame(fus, tsyn, t, b)
        jindex, jlabels = _frame(jfus, jsyn, t, JBoundaries(*BOUNDS))
        _assert_tracked_alike(fus, jfus, index, jindex, labels, jlabels)
    assert labels == ["background", "shoe", "shoe"]
    core = fus.video_tracker.core
    assert core.curr_ti == 2 and fus.video_tracker.num_objects == 2
    assert fus.state.mask.shape == (4, 96, 128, 3)

    fus.clear_xmem_memory()
    assert fus.consensus_mask_label == [] and not fus.video_tracker.first_mask_loaded
    assert core.curr_ti == -1 and core.mem.w_size == 0 and core.mem.l_size == 0
    fus.mask_backend = tsyn.sphere_mask_backend(_scene(tsyn, 3), LABELS)
    index, labels = _frame(fus, tsyn, 3, b)  # consensus again, then a fresh seed
    assert labels == ["background", "shoe", "shoe"] and core.curr_ti == 0
    assert core.mem.w_size == core.mem.hw
    overlay = fus.vis_curr_mask()
    assert overlay.shape == (4, 96, 128, 3) and overlay.dtype == np.uint8
    fus.close()
    assert fus.video_tracker is None and fus.state is None


def test_save_and_load_state_resume_tracking(tmp_path, xmem_tiny):
    """A session saved after frame 2 and loaded into a new facade (the
    tracker rebuilt through the factory) tracks frame 3 as the original."""
    port_factory, _ = _factories(xmem_tiny)
    b = Boundaries(*BOUNDS)
    fus = _facade(Fusion, tsyn, port_factory, "cpu")
    for t in range(3):
        _frame(fus, tsyn, t, b)
    path = str(tmp_path / "session.pkl")
    fus.save_state(path)
    back = Fusion(video_tracker_factory=port_factory, device="cpu")
    back.load_state(path)
    assert back.consensus_mask_label == fus.consensus_mask_label
    assert back.video_tracker.core.curr_ti == fus.video_tracker.core.curr_ti == 2
    assert back.video_tracker.core.mem.w_size == fus.video_tracker.core.mem.w_size
    assert torch.equal(back.state.mask, fus.state.mask)
    index, labels = _frame(fus, tsyn, 3, b)
    index_b, labels_b = _frame(back, tsyn, 3, b)
    assert labels == labels_b
    np.testing.assert_array_equal(index, index_b)
    assert torch.equal(back.video_tracker.last_prob, fus.video_tracker.last_prob)
    assert torch.equal(back.video_tracker.core.mem.wv, fus.video_tracker.core.mem.wv)
    with pytest.warns(UserWarning, match="no tracker is attached"):
        Fusion(device="cpu").load_state(path)

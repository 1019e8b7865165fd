"""Port parity: SO(3), FPS, keypoint selection, rigid tracking and the
frame loop of d3fields_tpu_torch against d3fields_tpu.

The same numpy inputs go through the JAX function and its PyTorch
counterpart on the CPU; gradients come from ``jax.grad`` and from torch
autograd. Tolerances: SO(3) and the rigid transform at 1e-6, the tracking
loss at 1e-6 and its gradients at rtol 1e-4 / atol 1e-6 (float32 sums over
the keypoints in another order), 10 Adam steps at the fast golden's
tolerances (loss history 1e-5, match points 5e-4), FPS indices and
keypoints identical, keypoint descriptors at 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d3fields_tpu.config import Boundaries as JBoundaries
from d3fields_tpu.config import TrackingConfig as JTrackingConfig
from d3fields_tpu.fields.state import state_from_obs as jstate_from_obs
from d3fields_tpu.ops import fps as jfps
from d3fields_tpu.ops import pointcloud_native as jpcn
from d3fields_tpu.ops import so3 as jso3
from d3fields_tpu.serving import AsyncFrameLoop as JAsyncFrameLoop
from d3fields_tpu.track import keypoints as jkp
from d3fields_tpu.track import rigid as jrigid
from d3fields_tpu_torch.config import Boundaries as TBoundaries
from d3fields_tpu_torch.config import TrackingConfig as TTrackingConfig
from d3fields_tpu_torch.fields.state import state_from_obs as tstate_from_obs
from d3fields_tpu_torch.ops import fps as tfps
from d3fields_tpu_torch.ops import pointcloud_native as tpcn
from d3fields_tpu_torch.ops import so3 as tso3
from d3fields_tpu_torch.serving import AsyncFrameLoop
from d3fields_tpu_torch.track import keypoints as tkp
from d3fields_tpu_torch.track import rigid as trigid
from d3fields_tpu_torch.utils import synthetic as tsyn

BOUNDS = (-0.3, 0.6, -0.4, 0.4, 0.001, 0.4)  # vis_tracking --synthetic
RES = 0.01  # keypoint grid step: 288,000 candidates


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Thousands of small torch ops: one thread per pytest-xdist worker
    keeps them from waiting on the other workers' thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_so3_exp_and_transform_match_jax():
    rs = np.random.RandomState(0)
    log_r = np.concatenate([np.zeros((1, 3)), 1e-5 * rs.randn(3, 3), rs.randn(6, 3)]
                           ).astype(np.float32)
    np.testing.assert_allclose(tso3.so3_exp(torch.as_tensor(log_r)).numpy(),
                               np.asarray(jso3.so3_exp(jnp.asarray(log_r))), rtol=1e-6, atol=1e-6)
    pts = rs.randn(10, 7, 3).astype(np.float32)
    t = rs.randn(10, 3).astype(np.float32)
    np.testing.assert_allclose(
        tso3.rigid_transform_points(*(torch.as_tensor(a) for a in (pts, log_r, t))).numpy(),
        np.asarray(jso3.rigid_transform_points(*(jnp.asarray(a) for a in (pts, log_r, t)))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("at", ["zero", "random"])
def test_so3_gradient_matches_jax_grad(at):
    rs = np.random.RandomState(1)
    pts = rs.randn(2, 5, 3).astype(np.float32)
    w = rs.randn(2, 5, 3).astype(np.float32)
    log_r = np.zeros((2, 3), np.float32) if at == "zero" else rs.randn(2, 3).astype(np.float32)
    t = np.zeros((2, 3), np.float32)

    def jloss(lr):
        return jnp.sum(jso3.rigid_transform_points(jnp.asarray(pts), lr, jnp.asarray(t))
                       * jnp.asarray(w))

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(log_r)))
    lr_t = torch.tensor(log_r, requires_grad=True)
    (tso3.rigid_transform_points(torch.as_tensor(pts), lr_t, torch.as_tensor(t))
     * torch.as_tensor(w)).sum().backward()
    assert np.all(np.isfinite(lr_t.grad.numpy()))
    np.testing.assert_allclose(lr_t.grad.numpy(), ref, rtol=1e-5, atol=1e-6)


def _frame(t, H=96, W=128):
    offs = np.array([[0.008 * t, 0.004 * t, 0.0], [-0.005 * t, 0.006 * t, 0.0]])
    sc = tsyn.render_sphere_scene(num_views=4, H=H, W=W, feat_dim=32, sphere_offsets=offs)
    sc["mask"] = np.concatenate([~sc["sphere_masks"].any(1)[..., None],
                                 np.moveaxis(sc["sphere_masks"], 1, -1)], -1).astype(np.float32)
    return sc


def _states(sc):
    kw = dict(dino_feats=sc["dino_feats"], mask=sc["mask"], mu=0.02)
    return jstate_from_obs(sc, **kw), tstate_from_obs(sc, **kw, device="cpu")


@pytest.fixture(scope="module")
def keypoints():
    """Keypoints of frame 0 by the JAX package, at a coarse grid."""
    js0, _ = _states(_frame(0))
    feats, pts, ids = jkp.select_keypoints(js0, ["background", "ball", "ball"],
                                           JBoundaries(*BOUNDS), 12, res=RES, init_idx=0)
    return np.concatenate(feats), np.stack(pts).astype(np.float32), ids


def test_select_keypoints_matches_jax():
    js0, ts0 = _states(_frame(0))
    labels = ["background", "ball", "ball"]
    for per_instance in (True, False):
        # a ragged last tile: 288,000 = 5 x 50,000 + 38,000
        jf, jp, ji = jkp.select_keypoints(js0, labels, JBoundaries(*BOUNDS), 12, res=RES,
                                          init_idx=0, per_instance=per_instance, tile=50000)
        tf, tp, ti = tkp.select_keypoints(ts0, labels, TBoundaries(*BOUNDS), 12, res=RES,
                                          init_idx=0, per_instance=per_instance, tile=50000)
        assert ti == ji and len(ti) == (2 if per_instance else 1)
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tf, jf):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # cloud sampling (select_features_from_pcd)
    cloud = np.random.RandomState(3).uniform(-0.2, 0.3, (3000, 3)).astype(np.float32)
    jf, jp, ji = jkp.select_keypoints(js0, labels, None, 8, pcd=cloud, init_idx=5)
    tf, tp, ti = tkp.select_keypoints(ts0, labels, None, 8, pcd=cloud, init_idx=5)
    assert ti == ji
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a, b)


def test_project_to_view_matches_jax():
    sc = _frame(0)
    pts = np.random.RandomState(2).uniform(-0.2, 0.2, (50, 3))
    np.testing.assert_array_equal(tkp.project_to_view(pts, sc["pose"][1], sc["K"][1]),
                                  jkp.project_to_view(pts, sc["pose"][1], sc["K"][1]))


@pytest.mark.parametrize("scale", [0.0, 0.01])
def test_tracking_loss_and_gradients_match_jax(keypoints, scale):
    src_feats, src_pts, _ = keypoints
    js1, ts1 = _states(_frame(1))
    rs = np.random.RandomState(4)
    p = {"t": (scale * rs.randn(2, 3)).astype(np.float32),
         "log_r": (scale * rs.randn(2, 3)).astype(np.float32)}
    jlo, jhi = jrigid.boundary_vectors(JBoundaries(*BOUNDS))
    cfg = JTrackingConfig(oob_weight=0.5)
    (jloss, jaux), jgrad = jax.value_and_grad(jrigid.tracking_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, js1, jnp.asarray(src_feats),
        jnp.asarray(src_pts), jlo, jhi, cfg)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tlo, thi = trigid.boundary_vectors(TBoundaries(*BOUNDS), "cpu")
    tloss, taux = trigid.tracking_loss(tp, ts1, torch.as_tensor(src_feats),
                                       torch.as_tensor(src_pts), tlo, thi,
                                       TTrackingConfig(oob_weight=0.5))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-6, atol=1e-6)
    for k in ("feat_loss", "dist_loss", "reg_loss", "oob_loss"):
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(taux["match_pts"].detach().numpy(), np.asarray(jaux["match_pts"]),
                               rtol=1e-6, atol=1e-6)
    for k in ("t", "log_r"):
        assert np.all(np.isfinite(tp[k].grad.numpy()))
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgrad[k]), rtol=1e-4, atol=1e-6)


def test_ten_adam_steps_match_jax(keypoints):
    src_feats, src_pts, _ = keypoints
    js1, ts1 = _states(_frame(1))
    info = {"a": {"src_feats": src_feats[:12]}, "b": {"src_feats": src_feats[12:]}}
    ref = jrigid.rigid_tracking(js1, info, list(src_pts), JBoundaries(*BOUNDS), 12,
                                JTrackingConfig(iters=10))
    got = trigid.rigid_tracking(ts1, info, list(src_pts), TBoundaries(*BOUNDS), 12,
                                TTrackingConfig(iters=10))
    assert got["loss_history"].shape == (10, 4)
    np.testing.assert_allclose(got["loss_history"], ref["loss_history"], atol=1e-5)
    np.testing.assert_allclose(np.stack(got["match_pts_list"]), np.stack(ref["match_pts_list"]),
                               atol=5e-4)
    for k in ("t", "log_r"):
        np.testing.assert_allclose(got[k], ref[k], atol=5e-4)


def test_optax_lr_factor_reproduces_optax_adam():
    """torch.optim.Adam with the factor takes optax.adam's steps on the
    same gradients (float32: within a few ulps over 20 steps)."""
    import optax

    rs = np.random.RandomState(0)
    A = rs.randn(6, 6).astype(np.float32)
    b = rs.randn(6).astype(np.float32)

    def grad(p):
        return (A @ p + b + 0.3 * np.sin(50 * p)).astype(np.float32)

    opt = optax.adam(0.01, b1=0.9, b2=0.999)
    p, st, ref = jnp.zeros(6), None, []
    st = opt.init(p)
    for _ in range(20):
        u, st = opt.update(jnp.asarray(grad(np.asarray(p))), st)
        p = optax.apply_updates(p, u)
        ref.append(np.asarray(p))
    t = torch.zeros(6, requires_grad=True)
    topt = torch.optim.Adam([t], lr=0.01, betas=trigid.BETAS, eps=1e-8)
    for step in range(1, 21):
        topt.param_groups[0]["lr"] = 0.01 * trigid.optax_lr_factor(step)
        t.grad = torch.as_tensor(grad(t.detach().numpy()))
        topt.step()
        np.testing.assert_allclose(t.detach().numpy(), ref[step - 1], rtol=0, atol=2e-7)


def test_fps_native_identical_and_device_fps_matches_host():
    rs = np.random.RandomState(0)
    pts = rs.standard_normal((500, 3)).astype(np.float32)
    for m, init in ((32, 7), (1, 0), (500, 3), (600, 0)):
        jp, ji = jpcn.fps_native(pts, m, init_idx=init)
        tp, ti = tpcn.fps_native(pts, m, init_idx=init)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tp, jp)
    s_np, idx_np, max_np = jfps.fps_np(pts, 32, init_idx=7)
    s_t, idx_t, max_t = tfps.fps(torch.as_tensor(pts), 32, init_idx=7)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_np))
    np.testing.assert_allclose(s_t.numpy(), s_np, rtol=1e-5, atol=1e-6)
    assert abs(float(max_t) - max_np) < 1e-5
    assert tfps.fps_np(pts, 32, init_idx=7)[1] == idx_np
    # invalid points are never picked
    pts[50:] += 100.0
    valid = torch.zeros(500, dtype=torch.bool)
    valid[:50] = True
    _, idx, _ = tfps.fps(torch.as_tensor(pts), 10, init_idx=0, valid=valid)
    assert int(idx.max()) < 50


def test_pointcloud_native_helpers_match_jax():
    rs = np.random.RandomState(1)
    pts = rs.uniform(-0.2, 0.2, (2000, 3)).astype(np.float32)
    pts[:5] += 3.0  # outliers
    np.testing.assert_array_equal(tpcn.voxel_downsample_indices(pts, 0.02),
                                  jpcn.voxel_downsample_indices(pts, 0.02))
    np.testing.assert_array_equal(tpcn.statistical_outlier_mask(pts, 5, 0.2),
                                  jpcn.statistical_outlier_mask(pts, 5, 0.2))


def _loop_run(cls, depth, frames, make):
    got, in_flight, drained = [], [], []
    loop = cls(lambda fid, out: got.append((fid, out)), depth=depth)
    for t, x in enumerate(frames):
        loop.submit(t, make(x))
        in_flight.append(loop.in_flight)
        drained.append(len(got))
    loop.flush()
    return got, in_flight, drained, loop.frames_consumed


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_async_frame_loop_orders_and_lags_as_jax(depth):
    frames = [np.random.RandomState(t).randn(4).astype(np.float32) for t in range(6)]
    jgot, jin, jdr, jn = _loop_run(JAsyncFrameLoop, depth, frames,
                                   lambda x: {"out": jnp.asarray(x) * 2, "tag": "f"})
    tgot, tin, tdr, tn = _loop_run(AsyncFrameLoop, depth, frames,
                                   lambda x: {"out": torch.as_tensor(x) * 2, "tag": "f",
                                              "pair": (torch.ones(1), 3)})
    assert (tin, tdr, tn) == (jin, jdr, jn)
    assert [f for f, _ in tgot] == [f for f, _ in jgot] == list(range(6))
    for (_, a), (_, b) in zip(tgot, jgot):
        assert isinstance(a["out"], np.ndarray) and a["tag"] == "f"
        np.testing.assert_array_equal(a["out"], b["out"])
        assert isinstance(a["pair"], tuple) and isinstance(a["pair"][0], np.ndarray)


def test_async_frame_loop_error_semantics():
    with pytest.raises(ValueError):
        AsyncFrameLoop(lambda *a: None, depth=-1)
    fail, seen = {"on": True}, []

    def consumer(fid, out):
        if fail["on"]:
            raise OSError("disk full")
        seen.append(fid)

    loop = AsyncFrameLoop(consumer, depth=1)
    loop.submit(0, torch.zeros(1))
    with pytest.raises(OSError):
        loop.submit(1, torch.zeros(1))
    assert loop.in_flight == 2  # nothing lost
    fail["on"] = False
    loop.flush()
    assert seen == [0, 1]

    seen2 = []
    with pytest.raises(RuntimeError):
        with AsyncFrameLoop(lambda fid, out: seen2.append(fid), depth=8) as lp:
            lp.submit(0, torch.zeros(1))
            raise RuntimeError("boom")
    assert seen2 == []  # no consumer work on the error path
    with AsyncFrameLoop(lambda fid, out: seen2.append(fid), depth=8) as lp:
        lp.submit(0, torch.zeros(1))
    assert seen2 == [0]

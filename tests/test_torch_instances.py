"""Port parity: cross-view instance association, the robot filter, the host
geometry helpers and the facade's text queries of d3fields_tpu_torch against
d3fields_tpu.

The same numpy inputs (the two-ball scene of tests/test_instances.py and the
synthetic scene of the apps) go through the JAX function and its PyTorch
counterpart on the CPU. Everything here is host numpy except the facade's
state, so the results must be identical; the helpers' floating outputs are
held at 1e-6.
"""

import dataclasses

import numpy as np
import pytest

from conftest import synthetic_scene
from d3fields_tpu.config import Boundaries as JBoundaries
from d3fields_tpu.config import InstanceConfig as JInstanceConfig
from d3fields_tpu.fields import geometry as jgeom
from d3fields_tpu.fields.fusion import Fusion as JFusion
from d3fields_tpu.seg import backends as jsegb
from d3fields_tpu.seg import instances as jsegi
from d3fields_tpu.utils import synthetic as jsyn
from d3fields_tpu_torch.config import Boundaries as TBoundaries
from d3fields_tpu_torch.config import InstanceConfig as TInstanceConfig
from d3fields_tpu_torch.fields import geometry as tgeom
from d3fields_tpu_torch.fields.fusion import Fusion as TFusion
from d3fields_tpu_torch.seg import backends as tsegb
from d3fields_tpu_torch.seg import instances as tsegi
from d3fields_tpu_torch.utils import synthetic as tsyn

BOUNDS = (-0.4, 0.4, -0.4, 0.4, -0.1, 0.4)  # tests/test_instances.py
SYN_BOUNDS = (-0.3, 0.5, -0.3, 0.35, 0.001, 0.3)  # vis_repr --synthetic


@pytest.fixture(scope="module")
def two_ball():
    return synthetic_scene(
        num_views=4, H=64, W=80,
        spheres=[(np.array([-0.10, 0.0, 0.06]), 0.09), (np.array([0.12, 0.05, 0.05]), 0.07)],
        ground=True,
    )


@pytest.fixture(scope="module")
def sphere_scene():
    return tsyn.render_sphere_scene(num_views=4, H=96, W=128, feat_dim=16)


def _views(segb, scene, labels=("ball", "ball"), drop=()):
    """Per-view ViewMasks from the analytic sphere masks (tests/test_instances.py)."""
    views = []
    V, S = scene["sphere_masks"].shape[:2]
    for v in range(V):
        ms, ls, cs = [], [], []
        for s in range(S):
            if (v, s) in drop:
                continue
            ms.append(scene["sphere_masks"][v, s])
            ls.append(labels[s])
            cs.append(0.8 + 0.05 * s + 0.01 * v)
        views.append(segb.with_background(np.stack(ms), ls, np.asarray(cs, np.float32)))
    return views


def _poses44(scene):
    pad = np.tile(np.array([[[0, 0, 0, 1.0]]], np.float32), (scene["pose"].shape[0], 1, 1))
    return np.concatenate([scene["pose"], pad], axis=1)


def test_synthetic_scene_is_the_jax_packages():
    a = jsyn.render_sphere_scene(num_views=3, H=40, W=56, feat_dim=8,
                                 sphere_offsets=np.array([[0.01, 0, 0], [0, 0.02, 0]]))
    b = tsyn.render_sphere_scene(num_views=3, H=40, W=56, feat_dim=8,
                                 sphere_offsets=np.array([[0.01, 0, 0], [0, 0.02, 0]]))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k])
    ja, tb = jsyn.sphere_mask_backend(a, ["x", "y"]), tsyn.sphere_mask_backend(b, ["x", "y"])
    for va, vb in zip(ja.per_view, tb.per_view):
        np.testing.assert_array_equal(vb.masks, va.masks)
        assert vb.labels == va.labels
        np.testing.assert_array_equal(vb.confidences, va.confidences)


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (5, 1), (2, 2), (13, 17), (48, 64)])
@pytest.mark.parametrize("kind", ["bool", "float"])
def test_erode_mask_matches_jax(shape, kind):
    rs = np.random.RandomState(shape[0] * 100 + shape[1])
    for density in (0.3, 0.8, 0.97, 1.0):
        m = rs.rand(*shape) < density
        if kind == "float":
            # values below 1/255 vanish in the uint8 cast, as in the reference
            m = m * rs.choice([0.002, 0.5, 1.0], size=shape)
        np.testing.assert_array_equal(tsegi.erode_mask(m), jsegi.erode_mask(m))


def test_voxel_hash_and_host_helpers_match_jax(two_ball):
    rs = np.random.RandomState(0)
    b = dict(zip(("x_lower", "x_upper", "y_lower", "y_upper", "z_lower", "z_upper"), BOUNDS))
    jv, tv = jgeom.VoxelHash.from_boundaries(b, 0.03), tgeom.VoxelHash.from_boundaries(b, 0.03)
    assert (tv.lower, tv.voxel_size, tv.dims) == (jv.lower, jv.voxel_size, jv.dims)
    pts = rs.uniform(-0.39, 0.39, (500, 3)).astype(np.float32)
    idx = jv.pcd_to_index(pts)
    np.testing.assert_array_equal(tv.pcd_to_index(pts), idx)
    np.testing.assert_array_equal(tv.index_to_voxel(idx), jv.index_to_voxel(idx))
    np.testing.assert_allclose(tv.index_to_pcd(idx), jv.index_to_pcd(idx), rtol=1e-6, atol=1e-6)

    sc = two_ball
    K, depth = sc["K"][0], sc["depth"][0]
    cam = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    mask = sc["sphere_masks"][0, 0]
    np.testing.assert_allclose(tgeom.depth_to_points_np(depth, mask, cam),
                               jgeom.depth_to_points_np(depth, mask, cam), rtol=1e-6, atol=1e-6)
    for masks in (None, sc["sphere_masks"][:, 1]):
        for bounds in (None, b):
            np.testing.assert_allclose(
                tgeom.aggregate_masked_points_np(sc["depth"], sc["K"], _poses44(sc), masks, bounds),
                jgeom.aggregate_masked_points_np(sc["depth"], sc["K"], _poses44(sc), masks, bounds),
                rtol=1e-6, atol=1e-6)
    cloud = jgeom.aggregate_masked_points_np(sc["depth"], sc["K"], _poses44(sc))
    np.testing.assert_allclose(tgeom.voxel_downsample_np(cloud, 0.01),
                               jgeom.voxel_downsample_np(cloud, 0.01), rtol=1e-6, atol=1e-6)


def test_backproject_depth_matches_jax(two_ball):
    import jax.numpy as jnp
    import torch

    d, K = two_ball["depth"][1], two_ball["K"][1]
    ref = np.asarray(jgeom.backproject_depth(jnp.asarray(d), jnp.asarray(K)))
    got = tgeom.backproject_depth(torch.as_tensor(d), torch.as_tensor(K)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def _association_cases(two_ball, sphere_scene):
    syn_labels = ("ball", "small ball")
    return {
        "two_ball": (two_ball, _views, ("ball", "ball"), ["ball"], BOUNDS, ()),
        "two_ball_missed": (two_ball, _views, ("ball", "ball"), ["ball"], BOUNDS,
                            {(2, 1)}),
        "two_ball_table": (two_ball, _views, ("ball", "table"), ["ball", "table"], BOUNDS, ()),
        "synthetic": (sphere_scene, _views, syn_labels, list(syn_labels), SYN_BOUNDS, ()),
    }


@pytest.mark.parametrize("association", ["voxel", "pcd"])
@pytest.mark.parametrize("case", ["two_ball", "two_ball_missed", "two_ball_table", "synthetic"])
def test_align_instance_masks_identical(two_ball, sphere_scene, association, case):
    scene, views_of, labels, queries, bounds, drop = \
        _association_cases(two_ball, sphere_scene)[case]
    out = []
    for segb, segi, B, IC in ((jsegb, jsegi, JBoundaries, JInstanceConfig),
                              (tsegb, tsegi, TBoundaries, TInstanceConfig)):
        views = views_of(segb, scene, labels, drop)
        out.append(segi.align_instance_masks(
            views, scene["depth"], scene["K"], _poses44(scene), queries, B(*bounds),
            IC(association=association)))
    (jm, jl, ji), (tm, tl, ti) = out
    assert tl == jl
    assert len(tl) >= 2 and tl[0] == "background"
    np.testing.assert_array_equal(tm, jm)
    assert [i.view_mask_idx for i in ti] == [i.view_mask_idx for i in ji]


def test_align_with_prev_mask_identical():
    rs = np.random.RandomState(1)
    prev = (rs.rand(3, 20, 24, 4) > 0.6).astype(np.float32)
    new = prev[..., [0, 2, 1, 3]].copy()
    new[:, :, :3] = 0  # a shifted, partly vanished frame
    new[1, ..., 3] = 0  # an object gone from one view
    np.testing.assert_array_equal(tsegi.align_with_prev_mask(new, prev),
                                  jsegi.align_with_prev_mask(new, prev))


def test_robot_pcd_filter_identical(two_ball):
    sc = two_ball
    robot = jgeom.aggregate_masked_points_np(sc["depth"][:1], sc["K"][:1], _poses44(sc)[:1],
                                             masks=sc["sphere_masks"][:1, 1])
    for v in range(2):
        args = (sc["depth"][v], sc["K"][v], _poses44(sc)[v], robot)
        jvm = jsegb.filter_masks_by_robot_pcd(_views(jsegb, sc)[v], *args)
        tvm = tsegb.filter_masks_by_robot_pcd(_views(tsegb, sc)[v], *args)
        assert tvm.labels == jvm.labels
        np.testing.assert_array_equal(tvm.masks, jvm.masks)
        np.testing.assert_array_equal(tvm.confidences, jvm.confidences)
    m = sc["sphere_masks"][0, 1]
    np.testing.assert_array_equal(
        tsegb.rm_mask_close_to_pcd(sc["depth"][0], m, robot, sc["K"][0], _poses44(sc)[0]),
        jsegb.rm_mask_close_to_pcd(sc["depth"][0], m, robot, sc["K"][0], _poses44(sc)[0]))


def _frame(t):
    """Frame t of a two-sphere video; the spheres drift and the second one
    leaves view 3's mask at t=2 (a missed detection)."""
    offs = np.array([[0.01 * t, 0.005 * t, 0.0], [-0.006 * t, 0.008 * t, 0.0]])
    sc = tsyn.render_sphere_scene(num_views=4, H=72, W=96, feat_dim=8, sphere_offsets=offs)
    if t == 2:
        sc["sphere_masks"][3, 1] = False
    return sc


def test_facade_text_queries_over_frames_identical():
    """Three frames of the re-detection path: frame 0 runs the consensus,
    frames 1-2 re-detect and relabel by overlap with the previous masks."""
    labels = ["ball", "ball"]
    bounds = (-0.3, 0.5, -0.3, 0.35, 0.001, 0.3)
    jf = JFusion(num_cam=4, mask_backend=jsegb.PrecomputedMaskBackend([]))
    tf = TFusion(num_cam=4, mask_backend=tsegb.PrecomputedMaskBackend([]), device="cpu")
    for t in range(3):
        sc = _frame(t)
        obs = {k: sc[k] for k in ("color", "depth", "pose", "K", "dino_feats")}
        got = []
        for fus, syn, B in ((jf, jsyn, JBoundaries), (tf, tsyn, TBoundaries)):
            fus.mask_backend.per_view = syn.sphere_mask_backend(sc, labels).per_view
            fus.mask_backend.reset()
            fus.update(obs)
            got.append(fus.text_queries_for_inst_mask(["ball"], [0.5], boundaries=B(*bounds)))
        (jm, jl), (tm, tl) = got
        assert tl == jl == jf.consensus_mask_label == tf.consensus_mask_label
        np.testing.assert_array_equal(np.asarray(tm), np.asarray(jm))
        np.testing.assert_array_equal(tf.state.mask.numpy(), np.asarray(jf.state.mask))
        assert tf.semantic_label == jf.semantic_label
        assert tf.get_inst_num() == jf.get_inst_num() == len(jl)
    B_j, B_t = JBoundaries(*bounds), TBoundaries(*bounds)
    np.testing.assert_allclose(tf.extract_masked_pcd([1], B_t), jf.extract_masked_pcd([1], B_j),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tf.get_query_obj_pcd(B_t), jf.get_query_obj_pcd(B_j),
                               rtol=1e-6, atol=1e-6)


def test_facade_robot_filter_and_pcd_association_identical(two_ball):
    sc = two_ball
    robot = jgeom.aggregate_masked_points_np(sc["depth"][:1], sc["K"][:1], _poses44(sc)[:1],
                                             masks=sc["sphere_masks"][:1, 1])
    out = []
    for F, segb, IC, B, kw in ((JFusion, jsegb, JInstanceConfig, JBoundaries, {}),
                               (TFusion, tsegb, TInstanceConfig, TBoundaries,
                                {"device": "cpu"})):
        import d3fields_tpu.config as jc
        import d3fields_tpu_torch.config as tc

        cfg_mod = jc if F is JFusion else tc
        cfg = dataclasses.replace(cfg_mod.D3FieldsConfig(), instances=IC(association="pcd"))
        fus = F(config=cfg, mask_backend=segb.PrecomputedMaskBackend(_views(segb, sc)), **kw)
        fus.update(sc)
        out.append(fus.text_queries_for_inst_mask_no_track(["ball"], [0.5], B(*BOUNDS),
                                                           robot_pcd=robot))
    (jm, jl), (tm, tl) = out
    assert tl == jl
    np.testing.assert_array_equal(np.asarray(tm), np.asarray(jm))

"""Port parity: the field core of d3fields_tpu_torch against d3fields_tpu.

The same numpy inputs go through the JAX function and its PyTorch
counterpart on the CPU. The JAX Pallas kernel runs in interpret mode, as
the JAX package's own tests run it. Tolerances are those of
tests/test_geometry.py, tests/test_kernels.py and tests/test_fusion.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d3fields_tpu.fields import fusion as jfusion
from d3fields_tpu.fields import geometry as jgeom
from d3fields_tpu.fields import kernels as jkernels
from d3fields_tpu.fields.state import state_from_obs as jstate_from_obs
from d3fields_tpu_torch.fields import fusion as tfusion
from d3fields_tpu_torch.fields import geometry as tgeom
from d3fields_tpu_torch.fields import kernels as tkernels
from d3fields_tpu_torch.fields.state import state_from_obs as tstate_from_obs

MU = 0.02
NAMES = ("dino_feats", "mask", "color_tensor")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def qpts():
    rs = np.random.RandomState(7)
    sphere = rs.randn(400, 3)
    sphere /= np.linalg.norm(sphere, axis=1, keepdims=True)
    near = np.array([0, 0, 0.06]) + sphere * (0.12 + rs.uniform(-0.03, 0.03, (400, 1)))
    far = rs.uniform(-2, 2, (100, 3))
    return np.concatenate([near, far], axis=0).astype(np.float32)


@pytest.fixture(scope="module")
def states(scene):
    kw = dict(dino_feats=scene["dino_feats"], mask=scene["mask"], mu=MU)
    return jstate_from_obs(scene, **kw), tstate_from_obs(scene, **kw, device="cpu")


def _adversarial_xy():
    """tests/test_kernels.py:116-121: pixel centres, half-pixel boundaries,
    the border, just outside and far outside a 48x64 image."""
    xs = np.array([0.0, 1.0, 0.5, 31.5, 62.999, 63.0, -0.4, -0.6, 63.4,
                   63.6, -50.0, 200.0, 17.25, 17.75], np.float32)
    ys = np.array([0.0, 2.0, 0.5, 23.5, 46.999, 47.0, -0.4, -0.6, 47.4,
                   47.6, -9.0, 100.0, 31.25, 0.0], np.float32)
    return np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)


def _scene_xy(scene, qpts):
    xy, _, _ = jgeom.project_points(
        jnp.asarray(qpts), jnp.asarray(scene["pose"]), jnp.asarray(scene["K"]))
    return np.array(xy)[0]


def test_project_points_matches_jax(scene, qpts):
    pts = np.concatenate([qpts, np.random.RandomState(1).uniform(-0.5, 0.5, (2000, 3))
                          .astype(np.float32)])
    j = jgeom.project_points(jnp.asarray(pts), jnp.asarray(scene["pose"]),
                             jnp.asarray(scene["K"]))
    t = tgeom.project_points(torch.as_tensor(pts), torch.as_tensor(scene["pose"]),
                             torch.as_tensor(scene["K"]))
    np.testing.assert_allclose(_np(t[0]), np.asarray(j[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(_np(t[1]), np.asarray(j[1]))
    np.testing.assert_allclose(_np(t[2]), np.asarray(j[2]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("coords", ["scene", "adversarial"])
def test_samplers_match_jax(scene, qpts, rng, coords):
    H, W = 48, 64
    xy = _scene_xy(scene, qpts) if coords == "scene" else _adversarial_xy()
    img = rng.standard_normal((H, W, 3)).astype(np.float32)
    patch = rng.standard_normal((4, 6, 5)).astype(np.float32)
    for m in (img, patch):
        for jfn, tfn in ((jgeom.sample_map_bilinear, tgeom.sample_map_bilinear),
                         (jgeom.sample_map_nearest, tgeom.sample_map_nearest)):
            j = jfn(jnp.asarray(m), jnp.asarray(xy), (H, W))
            t = tfn(torch.as_tensor(m), torch.as_tensor(xy), (H, W))
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-5, atol=1e-6)
        j_idx, j_w = jgeom.bilinear_taps(jnp.asarray(xy), (H, W), m.shape[:2])
        t_idx, t_w = tgeom.bilinear_taps(torch.as_tensor(xy), (H, W), m.shape[:2])
        assert t_idx.dtype == torch.int32
        np.testing.assert_array_equal(_np(t_idx), np.asarray(j_idx))
        np.testing.assert_allclose(_np(t_w), np.asarray(j_w), rtol=1e-5, atol=1e-6)


def test_codecs_and_grid_match_jax(rng):
    inst = rng.integers(0, 4, size=(5, 7)).astype(np.int32)
    oh = tgeom.instance_to_onehot(torch.as_tensor(inst), 4)
    np.testing.assert_array_equal(_np(oh), np.asarray(jgeom.instance_to_onehot(jnp.asarray(inst), 4)))
    np.testing.assert_array_equal(_np(tgeom.onehot_to_instance(oh.float())), inst.astype(np.uint8))
    b = dict(x_lower=-0.1, x_upper=0.1, y_lower=-0.2, y_upper=0.0, z_lower=0.0, z_upper=0.05)
    for a, e in zip(tgeom.create_grid(b, 0.02), jgeom.create_grid(b, 0.02)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(e))


@pytest.mark.parametrize("V, h, w, C", [
    pytest.param(3, 6, 8, 130, id="3"),
    pytest.param(1, 6, 8, 130, id="1"),
    # a patch grid too large for the kernel's shared-memory slices (P = 4,800)
    pytest.param(4, 60, 80, 12, id="large_grid"),
])
def test_fused_weighted_interp_plain_matches_pallas(rng, V, h, w, C):
    """tests/test_kernels.py:27-48's shapes: taps fall outside the map."""
    N = 77
    H, W = 48, 64
    feats = rng.standard_normal((V, h * w, C)).astype(np.float32)
    xy = rng.uniform(-5, 70, size=(V, N, 2)).astype(np.float32)
    vw = rng.uniform(0, 1, size=(V, N)).astype(np.float32)
    idx, tw = jax.vmap(lambda p: jgeom.bilinear_taps(p, (H, W), (h, w)))(jnp.asarray(xy))
    tw = tw * jnp.asarray(vw)[..., None]
    ref = jkernels.fused_weighted_interp(
        jnp.asarray(feats), idx, tw, point_tile=32, interpret=True, matmul_dtype="float32")
    before = tkernels.fused_weighted_interp.launches
    out = tkernels.fused_weighted_interp(
        torch.as_tensor(feats), torch.as_tensor(np.array(idx)), torch.as_tensor(np.array(tw)))
    assert tkernels.fused_weighted_interp.launches == before  # the CPU runs no kernel
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-4, atol=1e-5)


def _cos_deficit(a, b, keep):
    a, b = a[keep], b[keep]
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)
    return float((1.0 - cos).max())


@pytest.mark.parametrize("V, h, w, C", [
    pytest.param(3, 6, 8, 130, id="3"),
    pytest.param(1, 6, 8, 130, id="1"),
    pytest.param(4, 60, 80, 12, id="large_grid"),
])
def test_fused_weighted_interp_bf16_plain_matches_pallas_bf16(rng, V, h, w, C):
    """matmul_dtype='bfloat16' (the JAX kernel's default on a TPU,
    kernels.py:121-165): the table and the tap weights rounded to bf16,
    their products summed in f32. A product of two bf16 values is exact in
    f32, so only the order of the f32 sums differs: rtol 1e-5 / atol 1e-6.
    Rounding the table alone gives another function."""
    N = 77
    H, W = 48, 64
    feats = rng.standard_normal((V, h * w, C)).astype(np.float32)
    xy = rng.uniform(-5, 70, size=(V, N, 2)).astype(np.float32)
    vw = rng.uniform(0, 1, size=(V, N)).astype(np.float32)
    idx, tw = jax.vmap(lambda p: jgeom.bilinear_taps(p, (H, W), (h, w)))(jnp.asarray(xy))
    tw = tw * jnp.asarray(vw)[..., None]
    ref = np.asarray(jkernels.fused_weighted_interp(
        jnp.asarray(feats), idx, tw, point_tile=32, interpret=True, matmul_dtype="bfloat16"))
    f, i, w_ = torch.as_tensor(feats), torch.as_tensor(np.array(idx)), torch.as_tensor(np.array(tw))
    before = (tkernels.fused_weighted_interp.launches, tkernels.fused_weighted_interp.launches_bf16)
    out = tkernels.fused_weighted_interp(f, i, w_, "bfloat16")
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), ref, rtol=1e-5, atol=1e-6)
    # a bf16 table in is the same function
    np.testing.assert_array_equal(_np(tkernels.fused_weighted_interp(f.bfloat16(), i, w_,
                                                                     "bfloat16")), _np(out))
    assert (tkernels.fused_weighted_interp.launches,
            tkernels.fused_weighted_interp.launches_bf16) == before  # the CPU runs no kernel
    table_only = tkernels.fused_weighted_interp_plain(f.bfloat16().float(), i, w_)
    assert float((table_only - out).abs().max()) > 0


def test_fused_weighted_interp_bf16_within_the_cosine_budget(rng):
    """tests/test_kernels.py:69-93: the bf16 route's descriptors stay within
    1 - cos < 1e-3 of the f32 route's at the field query's widths."""
    V, h, w, C = 4, 24, 32, 1024
    H, W = 240, 320
    N = 513
    feats = torch.as_tensor(rng.standard_normal((V, h * w, C)).astype(np.float32))
    xy = torch.as_tensor(rng.uniform(0, 300, size=(V, N, 2)).astype(np.float32))
    vw = torch.as_tensor(rng.uniform(0, 1, size=(V, N)).astype(np.float32))
    idx, tw = tgeom.bilinear_taps(xy, (H, W), (h, w))
    tw = (tw * vw[..., None]).contiguous()
    hi = _np(tkernels.fused_weighted_interp(feats, idx, tw))
    lo = _np(tkernels.fused_weighted_interp(feats, idx, tw, "bfloat16"))
    assert _cos_deficit(hi, lo, np.linalg.norm(hi, axis=-1) > 1e-3) < 1e-3


def test_batch_eval_bf16_route_within_budget_of_jax(states, qpts):
    """The slice as a whole: ``batch_eval(fused=True, matmul_dtype=
    'bfloat16')`` against the JAX package's batch_eval (f32 off a TPU).
    Only the descriptors pass through the bf16 route: dist, valid_mask and
    the full-resolution mask at tests/test_fusion.py's tolerances, the
    descriptors at 1 - cos < 1e-3."""
    js, ts = states
    names = ("dino_feats", "mask")
    j = jfusion.batch_eval(js, qpts, names, tile=128)
    t = tfusion.batch_eval(ts, qpts, names, tile=128, fused=True, matmul_dtype="bfloat16")
    _assert_field_close(t, j, ("mask",))
    got, want = _np(t["dino_feats"]), np.asarray(j["dino_feats"])
    assert _cos_deficit(got, want, np.linalg.norm(want, axis=-1) > 1e-3) < 1e-3
    assert np.abs(got - want).max() > 0  # rounded, not the f32 route


def test_batch_eval_rounds_the_patch_maps_once(states, qpts):
    """The bf16 route's table is rounded once per batch_eval call
    (``round_patch_maps``), not at each tile's launch: the same outputs,
    bit for bit, as each tile's query rounding the f32 table itself. Only
    the patch-grid map is rounded; the full-resolution mask and every map
    at f32 stay as they are."""
    _, ts = states
    names = ("dino_feats", "mask")
    rounded = tkernels.round_patch_maps(ts, names, "bfloat16")
    assert rounded.dino_feats.dtype == torch.bfloat16 and rounded.mask is ts.mask
    assert tkernels.round_patch_maps(ts, names, "float32") is ts
    assert tkernels.round_patch_maps(rounded, names, "bfloat16") is rounded
    got = tfusion.batch_eval(ts, qpts, names, tile=128, fused=True, matmul_dtype="bfloat16")
    pts = torch.as_tensor(qpts)
    for s in range(0, len(qpts), 128):
        want = tkernels.eval_field_fused(ts, pts[s:s + 128], names, "bfloat16")
        for k, v in want.items():
            torch.testing.assert_close(got[k][s:s + 128], v, rtol=0, atol=0, msg=k)


def test_matmul_dtype_must_be_f32_or_bf16(states, qpts):
    _, ts = states
    feats, idx, w = torch.zeros(1, 4, 8), torch.zeros(1, 2, 4, dtype=torch.int32), \
        torch.zeros(1, 2, 4)
    for bad in ("float16", "fp32", None):
        with pytest.raises(ValueError, match="matmul_dtype"):
            tkernels.fused_weighted_interp(feats, idx, w, bad)
        with pytest.raises(ValueError, match="matmul_dtype"):
            tkernels.fused_weighted_interp_plain(feats, idx, w, bad)
    with pytest.raises(ValueError, match="matmul_dtype"):
        tkernels.eval_field_fused(ts, torch.as_tensor(qpts[:8]), ("dino_feats",), "float16")
    with pytest.raises(ValueError, match="fused"):
        tfusion.batch_eval(ts, qpts[:8], ("dino_feats",), matmul_dtype="bfloat16")


def test_fused_weighted_interp_out_of_range_taps_contribute_nothing():
    feats = torch.arange(12, dtype=torch.float32).reshape(1, 3, 4)
    idx = torch.tensor([[[0, 2, 3, -1]]], dtype=torch.int32)
    w = torch.tensor([[[1.0, 2.0, 5.0, 7.0]]])
    out = tkernels.fused_weighted_interp(feats, idx, w)
    np.testing.assert_array_equal(_np(out), _np(feats[0, 0] + 2 * feats[0, 2])[None])


@pytest.mark.parametrize("V, P, C, expected", [
    (4, 24 * 32, 1024, 16),  # the field query: 192 KB slices, one block per SM
    (4, 30 * 40, 256, 8),  # 16-channel slices would take 300 KB
    (4, 48 * 64, 1024, 0),  # only 4-channel slices would fit: slower than direct
    (4, 60 * 80, 1024, 0),  # no slice fits: the direct route
    (3, 48, 130, 0),  # C % 4 != 0: the direct route
    (2, 48, 8, 8),  # no slice is wider than C
    (1, 48, 4, 0),  # no slice is as narrow as C
    (1, 3632, 16, 16),  # 232,448 B: the most one block may use
    (1, 3633, 16, 8),
])
def test_slice_channels_picks_the_widest_slice_that_fits(V, P, C, expected):
    assert tkernels.slice_channels(V, P, C) == expected
    if expected:
        assert V * P * expected * 4 <= tkernels.SMEM_PER_BLOCK


@pytest.mark.parametrize("V, P, C, expected", [
    (4, 24 * 32, 1024, 32),  # the field query: 32-channel (64-byte) rows, 192 KB
    (4, 30 * 40, 1024, 16),  # 32-channel slices would take 300 KB
    (4, 60 * 80, 1024, 0),  # no slice fits: the direct route
    (3, 48, 132, 0),  # C % 8 != 0: a row is not whole 16-byte chunks
    (3, 48, 136, 32),  # a ragged last slice of 8 channels
    (2, 48, 16, 16),  # no slice is wider than C
    (1, 48, 8, 0),  # no slice is as narrow as C
    (1, 3632, 32, 32),  # 232,448 B: the most one block may use
    (1, 3633, 32, 16),
])
def test_slice_channels_bf16_table(V, P, C, expected):
    assert tkernels.slice_channels(V, P, C, torch.bfloat16) == expected
    if expected:
        assert V * P * expected * 2 <= tkernels.SMEM_PER_BLOCK


def test_fused_weighted_interp_rejects_what_the_kernel_does_not_take():
    feats = torch.zeros(2, 5, 4)
    idx = torch.zeros(2, 3, 4, dtype=torch.int32)
    w = torch.zeros(2, 3, 4)
    with pytest.raises(TypeError):
        tkernels.fused_weighted_interp(feats.double(), idx, w)
    with pytest.raises(TypeError):
        tkernels.fused_weighted_interp(feats, idx.long(), w)
    with pytest.raises(ValueError):
        tkernels.fused_weighted_interp(feats, idx[:1], w)
    with pytest.raises(ValueError):
        tkernels.fused_weighted_interp(feats[0], idx, w)


def _assert_field_close(t, j, names):
    np.testing.assert_array_equal(_np(t["valid_mask"]), np.asarray(j["valid_mask"]))
    np.testing.assert_allclose(_np(t["dist"]), np.asarray(j["dist"]), rtol=1e-5, atol=1e-6)
    for k in names:
        np.testing.assert_allclose(_np(t[k]), np.asarray(j[k]), rtol=1e-4, atol=1e-5)


def test_eval_field_matches_jax(states, qpts):
    js, ts = states
    j = jfusion.eval_field_jit(js, jnp.asarray(qpts), NAMES)
    t = tfusion.eval_field(ts, torch.as_tensor(qpts), NAMES)
    _assert_field_close(t, j, NAMES)


def test_eval_field_fused_matches_jax(states, qpts):
    js, ts = states
    names = ("dino_feats", "mask")
    j = jkernels.eval_field_fused(js, jnp.asarray(qpts), names)
    t = tkernels.eval_field_fused(ts, torch.as_tensor(qpts), names)
    _assert_field_close(t, j, names)


def test_eval_dist_matches_jax(states, qpts):
    js, ts = states
    j = jfusion.eval_dist_jit(js, jnp.asarray(qpts))
    t = tfusion.eval_dist(ts, torch.as_tensor(qpts))
    np.testing.assert_array_equal(_np(t["valid_mask"]), np.asarray(j["valid_mask"]))
    np.testing.assert_allclose(_np(t["dist"]), np.asarray(j["dist"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_batch_eval_matches_jax(states, qpts, fused):
    js, ts = states
    big = np.tile(qpts, (3, 1))  # 1500 pts over tiles of 512: several tiles + a ragged tail
    names = ("dino_feats", "mask")
    j = jfusion.batch_eval(js, big, names, tile=512)
    t = tfusion.batch_eval(ts, big, names, tile=512, fused=fused)
    assert t["dist"].shape == (big.shape[0],) and t["valid_mask"].dtype == torch.bool
    _assert_field_close(t, j, names)


def test_batch_eval_edge_sizes(states):
    _, ts = states
    for n in (0, 1, 7):
        out = tfusion.batch_eval(ts, np.zeros((n, 3), np.float32), ("dino_feats", "mask"),
                                 tile=4, fused=True)
        assert out["dist"].shape == (n,)
        assert out["dino_feats"].shape == (n, ts.dino_feats.shape[-1])
        assert out["mask"].shape == (n, ts.mask.shape[-1])


def test_eval_field_differentiable(states, qpts):
    _, ts = states
    p = torch.as_tensor(qpts[:64]).clone().requires_grad_(True)
    o = tfusion.eval_field(ts, p, ("dino_feats",))
    (o["dino_feats"].pow(2).sum() + o["dist"].clamp(0.0, 1.0).sum()).backward()
    assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0


def test_single_view_state(scene):
    one = {k: scene[k][:1] for k in ("color", "depth", "pose", "K", "dino_feats", "mask")}
    kw = dict(dino_feats=one["dino_feats"], mask=one["mask"], mu=MU)
    js, ts = jstate_from_obs(one, **kw), tstate_from_obs(one, **kw, device="cpu")
    pts = np.random.RandomState(0).uniform(-0.3, 0.3, (50, 3)).astype(np.float32)
    j = jfusion.eval_field(js, jnp.asarray(pts), ("dino_feats", "mask"))
    t = tkernels.eval_field_fused(ts, torch.as_tensor(pts), ("dino_feats", "mask"))
    _assert_field_close(t, j, ("dino_feats", "mask"))


def test_entry_points_raise_without_a_gpu(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from d3fields_tpu_torch import Fusion
    from d3fields_tpu_torch.models import dinov2

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Fusion()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstate_from_obs(scene)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dinov2.init_params(dinov2.Dinov2Config.tiny_test())
    model = dinov2.init_params(dinov2.Dinov2Config.tiny_test(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dinov2.Dinov2Backbone(model)
    assert Fusion(device="cpu").device.type == "cpu"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("V, h, w, C, N", [
    (3, 6, 8, 130, 77),  # C % 4 != 0: direct route
    (1, 6, 8, 130, 77),
    (4, 6, 8, 1024, 4096),  # 16-channel slices
    (3, 6, 8, 132, 300),  # a ragged last slice
    (4, 24, 32, 1024, 4096),  # the field query's table
    (4, 30, 40, 64, 2000),  # 8-channel slices
    (4, 30, 40, 12, 2000),  # 8-channel slices, a ragged last slice
    (4, 60, 80, 64, 2000),  # no slice fits: direct route
])
def test_fused_weighted_interp_kernel_matches_plain(cuda, V, h, w, C, N):
    rng = np.random.default_rng(0)
    H, W = 48, 64
    feats = torch.as_tensor(rng.standard_normal((V, h * w, C)).astype(np.float32), device=cuda)
    xy = torch.as_tensor(rng.uniform(-5, 70, size=(V, N, 2)).astype(np.float32), device=cuda)
    vw = torch.as_tensor(rng.uniform(0, 1, size=(V, N)).astype(np.float32), device=cuda)
    idx, tw = tgeom.bilinear_taps(xy, (H, W), (h, w))
    tw = (tw * vw[..., None]).contiguous()
    before = tkernels.fused_weighted_interp.launches
    out = tkernels.fused_weighted_interp(feats, idx, tw)
    torch.cuda.synchronize()
    assert tkernels.fused_weighted_interp.launches == before + 1
    ref = tkernels.fused_weighted_interp_plain(feats, idx, tw)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("V, h, w, C, N", [
    (3, 6, 8, 130, 77),  # C % 8 != 0: the direct route
    (3, 6, 8, 136, 77),  # 32-channel slices, a ragged last one
    (4, 24, 32, 1024, 4096),  # the field query's table: 32-channel slices
    (4, 30, 40, 1024, 4096),  # 16-channel slices
])
def test_fused_weighted_interp_bf16_kernel_matches_plain(cuda, V, h, w, C, N):
    rng = np.random.default_rng(1)
    H, W = 48, 64
    feats = torch.as_tensor(rng.standard_normal((V, h * w, C)).astype(np.float32), device=cuda)
    xy = torch.as_tensor(rng.uniform(-5, 70, size=(V, N, 2)).astype(np.float32), device=cuda)
    vw = torch.as_tensor(rng.uniform(0, 1, size=(V, N)).astype(np.float32), device=cuda)
    idx, tw = tgeom.bilinear_taps(xy, (H, W), (h, w))
    tw = (tw * vw[..., None]).contiguous()
    before = tkernels.fused_weighted_interp.launches_bf16
    out = tkernels.fused_weighted_interp(feats.bfloat16(), idx, tw, "bfloat16")
    torch.cuda.synchronize()
    assert tkernels.fused_weighted_interp.launches_bf16 == before + 1
    ref = tkernels.fused_weighted_interp_plain(feats.bfloat16(), idx, tw, "bfloat16")
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-4, atol=1e-5)

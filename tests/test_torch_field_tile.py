"""The field query's tile kernel (``csrc/field_tile.cu`` through
``fields/kernels.py::field_tile``) and the dispatch around it.

On the CPU: every tile takes the plain chain and launches nothing, the
descriptor kernel's ``out=`` argument, the tile kernel's limits, the build
wave. On the card (marked ``cuda``, skipped elsewhere): the tile kernel
against the plain chain run on the CPU, its outputs in place, its
counters, and the raise on a query beyond its limits. This file
imports no JAX, so that the card tests run on a machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_field_tile.py``.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from d3fields_tpu_torch import _build, native_build
from d3fields_tpu_torch.fields import fusion, kernels
from d3fields_tpu_torch.fields.state import state_from_obs
from d3fields_tpu_torch.utils import synthetic as tsyn
from d3fields_tpu_torch.utils.profiling import tracer

MU = 0.02
H, W, C = 48, 64, 64
NAMES = [(), ("dino_feats",), ("dino_feats", "mask", "color_tensor")]
EDGE_PX = 1e-3  # points this close to a nearest-pixel edge may pick either pixel


def make_scene(views: int = 4) -> dict:
    sc = tsyn.render_sphere_scene(num_views=4, H=H, W=W, feat_dim=C, focal=52.0)
    sc["mask"] = np.concatenate([~sc["sphere_masks"].any(1)[..., None],
                                 np.moveaxis(sc["sphere_masks"], 1, -1)], -1).astype(np.float32)
    # random descriptors of both signs: their sums cancel, as DINOv2's do
    sc["dino_feats"] = np.random.RandomState(3).standard_normal(
        sc["dino_feats"].shape).astype(np.float32)
    return {k: v[:views] for k, v in sc.items()}


def state_of(sc, device="cpu", dtype=torch.float32):
    return state_from_obs(sc, dino_feats=sc["dino_feats"], mask=sc["mask"], mu=MU, dtype=dtype,
                          device=device)


def awkward_points(sc) -> np.ndarray:
    """Points near the spheres and uniform in the workspace, and the
    awkward ones: behind view 0's camera, on its focal plane (|z| < 1e-4),
    outside every image, and under the ground (no view valid)."""
    rs = np.random.RandomState(5)
    pose = sc["pose"][0].astype(np.float64)
    R, t = pose[:, :3], pose[:, 3]
    centre = -R.T @ t
    d = rs.randn(300, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    near = np.array([0.0, 0.0, 0.06]) + d * (0.12 + rs.uniform(-0.03, 0.03, (300, 1)))
    box = rs.uniform([-0.3, -0.4, 0.0], [0.6, 0.4, 0.4], (600, 3))
    behind = centre - R[2] * rs.uniform(0.05, 0.5, (40, 1)) + rs.uniform(-0.1, 0.1, (40, 3))
    focal_plane = centre + R[0] * rs.uniform(-0.3, 0.3, (20, 1)) + R[1] * rs.uniform(
        -0.3, 0.3, (20, 1))
    outside = rs.uniform(8.0, 12.0, (20, 3)) * rs.choice([-1, 1], (20, 3))
    under = rs.uniform([-0.2, -0.2, -0.6], [0.2, 0.2, -0.3], (40, 3))
    pts = np.concatenate([near, box, behind, focal_plane, outside, under]).astype(np.float32)
    return pts[rs.permutation(len(pts))]


def near_an_edge(sc, pts) -> np.ndarray:
    """Points that a last-bit change of the projection may move across a
    nearest-pixel edge or the validity threshold, in any view (float64)."""
    p = np.concatenate([pts.astype(np.float64), np.ones((len(pts), 1))], 1)
    edge = np.zeros(len(pts), bool)
    for v in range(sc["pose"].shape[0]):
        cam = p @ (sc["K"][v].astype(np.float64) @ sc["pose"][v].astype(np.float64)).T
        z = np.where(np.abs(cam[:, 2]) < 1e-4, 1e-3, cam[:, 2])
        for u in (cam[:, 0] / z, cam[:, 1] / z):
            edge |= np.abs(u - np.floor(u) - 0.5) < EDGE_PX
        edge |= np.abs(np.abs(cam[:, 2]) - 1e-4) < 1e-7
        ix = np.clip(np.rint(cam[:, 0] / z), 0, W - 1).astype(int)
        iy = np.clip(np.rint(cam[:, 1] / z), 0, H - 1).astype(int)
        raw = sc["depth"][v][iy, ix] - z
        edge |= np.abs(raw + MU) < 1e-5
    return edge


def row_rel(got, want) -> float:
    """The largest relative L2 error of a row."""
    a, b = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.linalg.norm(a - b, axis=-1)
                  / np.maximum(np.linalg.norm(b, axis=-1), 1e-30)).max(initial=0.0))


def cos_deficit(a, b) -> float:
    """The largest ``1 - cos`` of a row pair among rows of weight."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    keep = np.linalg.norm(b, axis=-1) > 1e-3
    a, b = a[keep], b[keep]
    cos = (a * b).sum(-1) / np.maximum(np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1),
                                       1e-30)
    return float((1 - cos).max(initial=0.0))


def host(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


def tiles_counted(tr) -> tuple:
    """(fused, plain) tiles the tracer counted (on the card it counts host
    syncs and allocations besides)."""
    c = tr.summary()["counters"]
    return c.get("query_tiles_fused", 0), c.get("query_tiles_plain", 0)


@pytest.fixture
def on():
    tracer.reset()
    tracer.enable()
    try:
        yield tracer
    finally:
        tracer.disable()
        tracer.reset()


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["eval_field_fused", "batch_eval"])
def test_cpu_tiles_take_the_plain_chain_and_launch_nothing(on, entry):
    sc = make_scene()
    st = state_of(sc)
    pts = awkward_points(sc)[:700]
    launches = (kernels.field_tile.launches, kernels.fused_weighted_interp.launches)
    names = ("dino_feats", "mask")
    if entry == "batch_eval":
        got = fusion.batch_eval(st, pts, names, tile=256, fused=True)
        tiles = 3
    else:
        got = kernels.eval_field_fused(st, torch.as_tensor(pts), names)
        tiles = 1
    assert tiles_counted(on) == (0, tiles)
    assert (kernels.field_tile.launches, kernels.fused_weighted_interp.launches) == launches
    spans = on.summary()["spans"]
    assert "fields.prep" not in spans and spans["fields.distance"]["count"] == tiles
    want = fusion.eval_field(st, torch.as_tensor(pts), names)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-6, msg=k)


def test_float64_state_takes_the_plain_chain(on):
    sc = make_scene()
    st = state_of(sc, dtype=torch.float64)
    pts = torch.as_tensor(awkward_points(sc)[:200], dtype=torch.float64)
    got = kernels.eval_field_fused(st, pts, ("mask",))
    assert got["dist"].dtype == got["mask"].dtype == torch.float64
    assert tiles_counted(on) == (0, 1)
    want = fusion.eval_field(st, pts, ("mask",))
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_eval_field_fused_writes_into_the_given_outputs():
    sc = make_scene()
    st = state_of(sc)
    pts = torch.as_tensor(awkward_points(sc)[:100])
    names = ("dino_feats", "mask")
    big = {"dist": torch.full((130,), 7.0), "valid_mask": torch.zeros(130, dtype=torch.bool),
           "dino_feats": torch.full((130, C), 7.0), "mask": torch.full((130, 3), 7.0)}
    dst = {k: v[20:120] for k, v in big.items()}
    got = kernels.eval_field_fused(st, pts, names, out=dst)
    assert got is dst
    want = kernels.eval_field_fused(st, pts, names)
    for k, v in want.items():
        torch.testing.assert_close(big[k][20:120], v, rtol=0, atol=0, msg=k)
        if k != "valid_mask":
            assert (big[k][:20] == 7).all() and (big[k][120:] == 7).all()


def test_fused_weighted_interp_writes_into_out_on_the_plain_path():
    rng = np.random.default_rng(0)
    feats = torch.as_tensor(rng.standard_normal((3, 12, 8)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(-2, 14, (3, 50, 4)).astype(np.int32))
    w = torch.as_tensor(rng.uniform(0, 1, (3, 50, 4)).astype(np.float32))
    for dt in ("float32", "bfloat16"):
        buf = torch.full((60, 8), 7.0)
        got = kernels.fused_weighted_interp(feats, idx, w, dt, out=buf[5:55])
        assert got.data_ptr() == buf[5:55].data_ptr()
        torch.testing.assert_close(buf[5:55], kernels.fused_weighted_interp(feats, idx, w, dt),
                                   rtol=0, atol=0)
        assert (buf[:5] == 7).all() and (buf[55:] == 7).all()


@pytest.mark.parametrize("bad, error", [
    (lambda: torch.zeros(50, 9), ValueError),  # shape
    (lambda: torch.zeros(50, 8, dtype=torch.float64), TypeError),
    (lambda: torch.zeros(8, 50).t(), ValueError),  # not contiguous
])
def test_fused_weighted_interp_rejects_a_wrong_out(bad, error):
    feats, idx, w = torch.zeros(2, 5, 8), torch.zeros(2, 50, 4, dtype=torch.int32), \
        torch.zeros(2, 50, 4)
    with pytest.raises(error):
        kernels.fused_weighted_interp(feats, idx, w, out=bad())


def _nine_views(st):
    return st.replace(**{f: getattr(st, f)[[0, 1, 2, 3, 0, 1, 2, 3, 0]]
                         for f in ("depth", "pose", "K", "dino_feats", "mask")})


REFUSALS = {
    "taken": (lambda st, pts: (st, pts, st.feature_maps(NAMES[-1])), None),
    "float64": (lambda st, pts: (st.replace(depth=st.depth.double()), pts, {}), "float32"),
    "nine_views": (lambda st, pts: (_nine_views(st), pts, {}), "at most 8 views"),
    "five_maps": (lambda st, pts: (st, pts, {f"m{i}": st.mask for i in range(5)}),
                  "at most 4 full-resolution maps"),
    "two_grids": (lambda st, pts: (st, pts, {"a": st.dino_feats, "b": st.dino_feats[:, :3, :4]}),
                  "one patch grid"),
    "gradient": (lambda st, pts: (st, pts.clone().requires_grad_(), {}), "no backward"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_tile_kernel_refusal_names_the_limit(case):
    """What the card raises on: the tile kernel's limits, each named."""
    sc = make_scene()
    make, want = REFUSALS[case]
    got = kernels._tile_kernel_refusal(*make(state_of(sc), torch.zeros(5, 3)))
    if want is None:
        assert got is None
    else:
        assert want in got, got


def test_field_tile_rejects_what_the_kernel_does_not_take():
    sc = make_scene()
    st = state_of(sc)
    pts = torch.zeros(10, 3)
    out = {"dist": torch.empty(10), "valid_mask": torch.empty(10, dtype=torch.bool)}
    idx, tw = torch.zeros(4, 10, 4, dtype=torch.int32), torch.zeros(4, 10, 4)
    with pytest.raises(ValueError, match="both"):
        kernels.field_tile(st, pts, out, {}, idx, None)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.field_tile(st, pts, {**out, "dist": torch.empty(10, dtype=torch.float64)}, {})
    with pytest.raises(ValueError, match="contiguous"):
        kernels.field_tile(st, pts, out, {}, idx[:, :5], tw[:, :5])
    with pytest.raises(ValueError, match="at most"):
        kernels.field_tile(st, pts, out, {f"m{i}": st.mask for i in range(5)})


def test_load_builds_the_query_kernels_in_one_wave(monkeypatch):
    built = []
    monkeypatch.setattr(native_build, "_libs", {})
    monkeypatch.setattr(native_build, "build", lambda srcs, flags: built.append(
        tuple(os.path.basename(s)[:-len(".cu")] for s in srcs)))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: path)
    for name in ("field_tile", "fused_interp", "deform_gather"):
        _build.load(name, lambda lib: None)
    assert built == [("fused_interp", "field_tile"), ("fused_interp", "field_tile"),
                     ("deform_gather", "sam_attention")]
    # every CUDA source is in one wave
    assert sorted(_build.SOURCES) == sorted(
        f[:-len(".cu")] for f in os.listdir(_build.CSRC) if f.endswith(".cu"))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("views", [1, 4])
@pytest.mark.parametrize("names", NAMES)
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_tile_kernel_matches_the_plain_chain_on_the_cpu(cuda, on, views, names, matmul_dtype):
    sc = make_scene(views)
    pts = awkward_points(sc)  # 1,020 points: 3 tiles of 256 and a ragged last one of 252
    tile = 256
    edge = near_an_edge(sc, pts)
    fused0, desc0 = kernels.field_tile.launches, kernels.fused_weighted_interp.launches
    got = host(fusion.batch_eval(state_of(sc, cuda), pts, names, tile=tile, fused=True,
                                 matmul_dtype=matmul_dtype))
    torch.cuda.synchronize()
    tiles = -(-len(pts) // tile)
    assert tiles_counted(on) == (tiles, 0)
    assert kernels.field_tile.launches == fused0 + tiles
    assert kernels.fused_weighted_interp.launches == desc0 + tiles * ("dino_feats" in names)
    want = host(fusion.batch_eval(state_of(sc), pts, names, tile=tile, fused=True,
                                  matmul_dtype=matmul_dtype))
    keep = ~edge
    assert edge.mean() < 0.05
    np.testing.assert_array_equal(got["valid_mask"][keep], want["valid_mask"][keep])
    assert want["valid_mask"].any() and not want["valid_mask"].all()
    np.testing.assert_allclose(got["dist"][keep], want["dist"][keep], rtol=0, atol=1e-6)
    for k in names:
        if k == "dino_feats" and matmul_dtype == "bfloat16":
            assert cos_deficit(got[k][keep], want[k][keep]) < 1e-3, k
        else:
            assert row_rel(got[k][keep], want[k][keep]) < 1e-5, k
        assert (got[k][~got["valid_mask"]] == 0).all(), k


@pytest.mark.cuda
def test_tile_kernel_full_resolution_maps_of_any_width(cuda, on):
    """Descriptors at the image's own size (64 channels, no patch grid) and
    a 6-channel mask: the kernel's channel loop past its first chunk of 4,
    and a tile with no taps for the descriptor kernel."""
    sc = make_scene()
    rs = np.random.RandomState(9)
    sc["dino_feats"] = rs.standard_normal((4, H, W, C)).astype(np.float32)
    sc["mask"] = np.concatenate([sc["mask"], rs.rand(4, H, W, 3).astype(np.float32)], -1)
    pts = awkward_points(sc)
    keep = ~near_an_edge(sc, pts)
    names = NAMES[-1]
    desc0 = kernels.fused_weighted_interp.launches
    got = host(fusion.batch_eval(state_of(sc, cuda), pts, names, tile=400, fused=True))
    assert tiles_counted(on) == (3, 0) and kernels.fused_weighted_interp.launches == desc0
    want = host(fusion.batch_eval(state_of(sc), pts, names, tile=400, fused=True))
    np.testing.assert_array_equal(got["valid_mask"][keep], want["valid_mask"][keep])
    np.testing.assert_allclose(got["dist"][keep], want["dist"][keep], rtol=0, atol=1e-6)
    for k in names:
        assert got[k].shape == want[k].shape
        assert row_rel(got[k][keep], want[k][keep]) < 1e-5, k


@pytest.mark.cuda
def test_tile_kernel_one_point(cuda, on):
    sc = make_scene()
    pts = np.array([[0.0, 0.0, 0.18]], np.float32)  # on top of the sphere, seen by every view
    names = NAMES[-1]
    got = host(kernels.eval_field_fused(state_of(sc, cuda), torch.as_tensor(pts, device=cuda),
                                        names))
    want = host(kernels.eval_field_fused(state_of(sc), torch.as_tensor(pts), names))
    assert tiles_counted(on) == (1, 1)
    assert got["valid_mask"][0] and want["valid_mask"][0]
    np.testing.assert_allclose(got["dist"], want["dist"], rtol=0, atol=1e-6)
    for k in names:
        assert row_rel(got[k], want[k]) < 1e-5, k


@pytest.mark.cuda
def test_tile_kernel_writes_in_place(cuda, on):
    sc = make_scene()
    st = state_of(sc, cuda)
    pts = torch.as_tensor(awkward_points(sc)[:500], device=cuda)
    names = NAMES[-1]
    big = {"dist": torch.full((700,), 7.0, device=cuda),
           "valid_mask": torch.zeros(700, dtype=torch.bool, device=cuda),
           **{k: torch.full((700, m.shape[-1]), 7.0, device=cuda)
              for k, m in st.feature_maps(names).items()}}
    dst = {k: v[100:600] for k, v in big.items()}
    ptrs = {k: v.data_ptr() for k, v in dst.items()}
    got = kernels.eval_field_fused(st, pts, names, out=dst)
    torch.cuda.synchronize()
    assert got is dst and {k: v.data_ptr() for k, v in got.items()} == ptrs
    want = kernels.eval_field_fused(st, pts, names)
    for k, v in want.items():
        torch.testing.assert_close(big[k][100:600], v, rtol=0, atol=0, msg=k)
        if k != "valid_mask":
            assert (big[k][:100] == 7).all() and (big[k][600:] == 7).all(), k
    assert tiles_counted(on) == (2, 0)


@pytest.mark.cuda
def test_descriptor_kernel_rejects_a_misaligned_out(cuda):
    rng = np.random.default_rng(2)
    feats = torch.as_tensor(rng.standard_normal((4, 48, 64)).astype(np.float32), device=cuda)
    idx = torch.as_tensor(rng.integers(-2, 50, (4, 300, 4)).astype(np.int32), device=cuda)
    w = torch.as_tensor(rng.uniform(0, 1, (4, 300, 4)).astype(np.float32), device=cuda)
    want = kernels.fused_weighted_interp(feats, idx, w)
    flat = torch.full((300 * 64 + 1,), 7.0, device=cuda)
    aligned = flat[:300 * 64].view(300, 64)
    assert kernels.fused_weighted_interp(feats, idx, w, out=aligned) is aligned
    torch.testing.assert_close(aligned, want, rtol=0, atol=0)
    shifted = flat[1:].view(300, 64)  # 4 bytes past a 16-byte boundary
    launches = kernels.fused_weighted_interp.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.fused_weighted_interp(feats, idx, w, out=shifted)
    assert kernels.fused_weighted_interp.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float64", "nine_views", "two_grids", "gradient"])
def test_a_query_beyond_the_tile_kernel_raises_on_the_card(cuda, on, case):
    sc = make_scene()
    st = state_of(sc, cuda, torch.float64 if case == "float64" else torch.float32)
    pts = torch.as_tensor(awkward_points(sc)[:300], device=cuda, dtype=st.depth.dtype)
    names = ("mask",)
    if case == "nine_views":
        st = _nine_views(st)
    elif case == "two_grids":
        st = st.replace(color=st.dino_feats[:, :3, :4].contiguous())
        names = ("dino_feats", "color_tensor")
    elif case == "gradient":
        pts.requires_grad_()
    before = (kernels.field_tile.launches, kernels.fused_weighted_interp.launches)
    with pytest.raises(ValueError, match="tile kernel does not take"):
        kernels.eval_field_fused(st, pts, names)
    if case == "float64":
        with pytest.raises(ValueError, match="tile kernel does not take"):
            fusion.batch_eval(st, pts.cpu().numpy(), names, tile=128, fused=True)
    assert (kernels.field_tile.launches, kernels.fused_weighted_interp.launches) == before
    assert tiles_counted(on) == (0, 0)

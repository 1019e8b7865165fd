"""Port parity: the mesh layer and PCA of d3fields_tpu_torch against
d3fields_tpu.

The same numpy inputs go through the JAX function and its PyTorch
counterpart on the CPU. Smoothing at rtol/atol 1e-6 with identical signs;
marching tetrahedra, extracted meshes, colours and PLY bytes identical;
the PCA fit identical and its transform at 1e-6. matplotlib, which the
port does not use, is imported here only as the colour tables' oracle.
"""

import matplotlib
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from d3fields_tpu.config import Boundaries
from d3fields_tpu.fields.geometry import create_grid
from d3fields_tpu.mesh import _native as j_native
from d3fields_tpu.mesh import extract as jextract
from d3fields_tpu.mesh import smoothing as jsmoothing
from d3fields_tpu.ops import pca as jpca
from d3fields_tpu_torch.mesh import _native as t_native
from d3fields_tpu_torch.mesh import extract as textract
from d3fields_tpu_torch.mesh import smoothing as tsmoothing
from d3fields_tpu_torch.ops import pca as tpca


def _volumes():
    """A sphere's signed distance, a noisy blob and the reference's dist
    contract (clamped to +-mu, 1e3 where unobserved)."""
    xs = np.linspace(-1, 1, 28, dtype=np.float32)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    r = np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
    rs = np.random.RandomState(3)
    blob = (r - 0.5 + 0.15 * rs.standard_normal(r.shape)).astype(np.float32)
    dist = np.clip(r - 0.4, -0.02, 0.02).astype(np.float32)
    dist[r < 0.1] = 1e3
    return {"sphere": (r - 0.3).astype(np.float32), "blob": blob, "dist_contract": dist}


VOLUMES = _volumes()


@pytest.mark.parametrize("name", list(VOLUMES))
@pytest.mark.parametrize("iters", [1, 20])
def test_smooth_volume_matches_jax(name, iters):
    vol = VOLUMES[name]
    ref = np.asarray(jsmoothing.smooth_volume(jnp.asarray(vol), iters=iters))
    got = tsmoothing.smooth_volume(torch.as_tensor(vol), iters=iters).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.sign(got), np.sign(ref))
    np.testing.assert_array_equal(got > 0, vol > 0.5)


@pytest.mark.parametrize("name", list(VOLUMES))
def test_marching_tetrahedra_identical(name):
    jv, jt = j_native.marching_tetrahedra(VOLUMES[name], 0.0)
    tv, tt = t_native.marching_tetrahedra(VOLUMES[name], 0.0)
    assert tv.shape[0] > 0
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("smooth", [True, False])
def test_extract_mesh_identical(smooth):
    b = Boundaries(-0.3, 0.3, -0.3, 0.3, -0.3, 0.3)
    grid, shape = create_grid(b, 0.02)
    r = np.linalg.norm(grid, axis=1)
    dist = np.clip(r - 0.15, -0.02, 0.02).astype(np.float32)
    dist[r < 0.05] = 1e3
    jv, jt = jextract.extract_mesh(grid, dist, shape, smooth=smooth, smooth_iters=10)
    tv, tt = textract.extract_mesh(grid, torch.as_tensor(dist), shape, smooth=smooth,
                                   smooth_iters=10)
    assert tv.shape[0] > 50
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)
    # a numpy volume is smoothed on the device asked for
    nv, nt = textract.extract_mesh(grid, dist, shape, smooth=smooth, smooth_iters=10,
                                   device="cpu")
    np.testing.assert_array_equal(nv, jv)
    np.testing.assert_array_equal(nt, jt)


@pytest.mark.parametrize("cmap", ["jet", "viridis"])
def test_colormaps_match_matplotlib(cmap):
    v = np.concatenate([[0.0, 1.0, 0.5, 1.0 / 256, 255.0 / 256, 1 - 1e-12, -0.2, 1.7, np.nan],
                        np.random.RandomState(0).rand(991)])
    assert v.shape == (1000,)
    want = (matplotlib.colormaps[cmap](v) * 255).astype(np.uint8)
    np.testing.assert_array_equal(textract.colormap_rgba(v, cmap), want)


@pytest.fixture(scope="module")
def mesh_inputs():
    verts, tris = j_native.marching_tetrahedra(VOLUMES["sphere"], 0.0)
    rs = np.random.RandomState(5)
    n = verts.shape[0]
    return {
        "verts": verts, "tris": tris,
        "masks": rs.rand(n, 3).astype(np.float32),
        "feats": rs.standard_normal((n, 32)).astype(np.float32),
        "colors": rs.rand(n, 3).astype(np.float32),
        "pca_fit": rs.standard_normal((200, 32)).astype(np.float32),
    }


def _meshes(mod, pca_cls, x, to):
    pca = pca_cls.fit(x["pca_fit"], 3)
    v, t = x["verts"], x["tris"]
    return (mod.create_mask_meshes(v, t, to(x["masks"]))
            + [mod.create_instance_mask_mesh(v, t, to(x["masks"])),
               mod.create_descriptor_mesh(v, t, to(x["feats"]), to(x["masks"]), pca),
               mod.create_color_mesh(v, t, to(x["colors"]))])


def test_colourisers_and_export_ply_bytes_identical(tmp_path, mesh_inputs):
    jm = _meshes(jextract, jpca.PCAParams, mesh_inputs, lambda a: a)
    tm = _meshes(textract, tpca.PCAParams, mesh_inputs, torch.as_tensor)
    assert len(jm) == len(tm) == 6
    for i, (a, b) in enumerate(zip(jm, tm)):
        np.testing.assert_array_equal(b.vertex_colors, a.vertex_colors)
        pa, pb = tmp_path / f"j{i}.ply", tmp_path / f"t{i}.ply"
        a.export_ply(str(pa))
        b.export_ply(str(pb))
        assert pa.read_bytes() == pb.read_bytes()
    # a mesh without colours
    plain = [mod.TriMesh(mesh_inputs["verts"], mesh_inputs["tris"]) for mod in (jextract, textract)]
    for mesh, name in zip(plain, ("j", "t")):
        mesh.export_ply(str(tmp_path / f"{name}_plain.ply"))
    assert (tmp_path / "j_plain.ply").read_bytes() == (tmp_path / "t_plain.ply").read_bytes()


def test_pca_fit_identical_and_transform_matches_jax():
    rs = np.random.RandomState(2)
    X = (rs.standard_normal((500, 64)) * np.linspace(3, 0.1, 64)).astype(np.float32)
    jp, tp = jpca.PCAParams.fit(X, 3), tpca.PCAParams.fit(X, 3)
    np.testing.assert_array_equal(tp.components, jp.components)
    np.testing.assert_array_equal(tp.mean, jp.mean)
    feats = rs.standard_normal((300, 64)).astype(np.float32)
    ref = np.asarray(jpca.pca_transform(jnp.asarray(feats), jp))
    got = tpca.pca_transform(torch.as_tensor(feats), tp).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_pca_save_load_and_sklearn(tmp_path):
    from sklearn.decomposition import PCA

    X = np.random.RandomState(4).standard_normal((100, 16)).astype(np.float32)
    p = tpca.PCAParams.fit(X, 3)
    p.save(str(tmp_path / "p.pkl"))
    q = tpca.PCAParams.load(str(tmp_path / "p.pkl"))
    np.testing.assert_array_equal(q.components, p.components)
    sk = tpca.PCAParams.from_sklearn(PCA(3).fit(X))
    np.testing.assert_allclose(np.abs(sk.components), np.abs(p.components), atol=1e-4)

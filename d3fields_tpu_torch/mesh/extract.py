"""Mesh extraction and colourisation.

Counterpart of ``d3fields_tpu/mesh/extract.py``, the reference's mesh layer
(``fusion.py:1313-1416``) without trimesh, PyMCubes, Open3D or matplotlib:

- :func:`extract_mesh`: smoothing on the device + marching tetrahedra
  (native C++) + the reference's vertex -> grid snap (``fusion.py:1325-1329``:
  vertices truncated to integer grid indices and mapped through the flat
  grid).
- colourisers producing :class:`TriMesh` (a numpy dataclass with PLY/OBJ
  export) for per-query masks (viridis), the instance argmax (jet), PCA
  descriptors (background grey 0.8) and RGB colours.

The jet and viridis colours are 256-entry tables copied from matplotlib
(RGB of ``Colormap._lut`` times 255, truncated to uint8), indexed as
``Colormap.__call__`` indexes floats, so the meshes' colours are the JAX
package's to the byte.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from d3fields_tpu_torch.fields.geometry import onehot_to_instance
from d3fields_tpu_torch.mesh import _native, smoothing
from d3fields_tpu_torch.ops.pca import PCAParams, pca_transform
from d3fields_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TriMesh:
    """Minimal triangle mesh container (replaces the trimesh dependency)."""

    vertices: np.ndarray            # (NV, 3) float
    faces: np.ndarray               # (NT, 3) int
    vertex_colors: Optional[np.ndarray] = None  # (NV, 4) uint8 RGBA

    def export_ply(self, path: str) -> None:
        nv, nf = self.vertices.shape[0], self.faces.shape[0]
        has_color = self.vertex_colors is not None
        with open(path, "wb") as f:
            header = ["ply", "format binary_little_endian 1.0", f"element vertex {nv}",
                      "property float x", "property float y", "property float z"]
            if has_color:
                header += ["property uchar red", "property uchar green",
                           "property uchar blue", "property uchar alpha"]
            header += [f"element face {nf}", "property list uchar int vertex_indices",
                       "end_header"]
            f.write(("\n".join(header) + "\n").encode())
            if has_color:
                vdt = np.dtype([("xyz", np.float32, 3), ("rgba", np.uint8, 4)])
                buf = np.empty(nv, vdt)
                buf["xyz"] = self.vertices.astype(np.float32)
                buf["rgba"] = self.vertex_colors.astype(np.uint8)
            else:
                buf = self.vertices.astype("<f4")
            f.write(buf.tobytes())
            fdt = np.dtype([("n", np.uint8), ("idx", np.int32, 3)])
            fbuf = np.empty(nf, fdt)
            fbuf["n"] = 3
            fbuf["idx"] = self.faces.astype(np.int32)
            f.write(fbuf.tobytes())

    def export_obj(self, path: str) -> None:
        with open(path, "w") as f:
            for i, v in enumerate(self.vertices):
                if self.vertex_colors is not None:
                    c = self.vertex_colors[i][:3] / 255.0
                    f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
                else:
                    f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for t in self.faces:
                f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")


def extract_mesh(
    grid_pts: np.ndarray,
    dist,
    grid_shape: Tuple[int, int, int],
    *,
    smooth: bool = True,
    smooth_iters: int = 20,
    iso: float = 0.0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Distance volume -> (world vertices, triangles).

    Mirrors ``Fusion.extract_mesh`` (``fusion.py:1313-1330``): the smoothed
    volume's iso-surface vertices are truncated to integer grid indices and
    mapped back to world coordinates through the flat grid. ``dist`` is a
    tensor (smoothed on its device) or a numpy array (smoothed on
    ``device``, CUDA by default).
    """
    if isinstance(dist, torch.Tensor):
        vol = dist.to(torch.float32).reshape(grid_shape)
    else:
        vol = torch.as_tensor(np.asarray(dist, np.float32).reshape(grid_shape),
                              device=resolve_device(device))
    if smooth:
        vol = smoothing.smooth_volume(vol, iters=smooth_iters)
    verts, tris = _native.marching_tetrahedra(vol.cpu().numpy(), iso)
    if verts.shape[0] == 0:
        return np.zeros((0, 3), np.float32), tris
    vi = verts.astype(np.int32)
    flat = np.ravel_multi_index(
        (vi[:, 0], vi[:, 1], vi[:, 2]), grid_shape, mode="clip"
    )
    world = np.asarray(grid_pts)[flat]
    return world, tris


# RGB rows of matplotlib's 256-entry 'jet' and 'viridis' lookup tables,
# times 255 and truncated to uint8, as hex
_TABLES = {
    "jet": (
        "00007f00008400008800008d00009100009600009a00009f0000a30000a80000ac0000b10000b60000ba0000bf0000c3"
        "0000c80000cc0000d10000d50000da0000de0000e30000e80000ec0000f10000f50000fa0000fe0000ff0000ff0000ff"
        "0000ff0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff0030ff0034ff0038ff003cff"
        "0040ff0044ff0048ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff007cff"
        "0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8ff00acff00b0ff00b4ff00b8ff00bcff"
        "00c0ff00c4ff00c8ff00ccff00d0ff00d4ff00d8ff00dcfe00e0fa00e4f702e8f405ecf108f0ed0cf4ea0ff8e712fce4"
        "15ffe118ffdd1cffda1fffd722ffd425ffd029ffcd2cffca2fffc732ffc336ffc039ffbd3cffba3fffb742ffb346ffb0"
        "49ffad4cffaa4fffa653ffa356ffa059ff9d5cff9a5fff9663ff9366ff9069ff8d6cff8970ff8673ff8376ff8079ff7d"
        "7cff7980ff7683ff7386ff7089ff6c8dff6990ff6693ff6396ff5f9aff5c9dff59a0ff56a3ff53a6ff4faaff4cadff49"
        "b0ff46b3ff42b7ff3fbaff3cbdff39c0ff36c3ff32c7ff2fcaff2ccdff29d0ff25d4ff22d7ff1fdaff1cddff18e0ff15"
        "e4ff12e7ff0feaff0cedff08f1fc05f4f802f7f400faf000feed00ffe900ffe500ffe200ffde00ffda00ffd700ffd300"
        "ffcf00ffcb00ffc800ffc400ffc000ffbd00ffb900ffb500ffb100ffae00ffaa00ffa600ffa300ff9f00ff9b00ff9800"
        "ff9400ff9000ff8c00ff8900ff8500ff8100ff7e00ff7a00ff7600ff7300ff6f00ff6b00ff6700ff6400ff6000ff5c00"
        "ff5900ff5500ff5100ff4d00ff4a00ff4600ff4200ff3f00ff3b00ff3700ff3400ff3000ff2c00ff2800ff2500ff2100"
        "ff1d00ff1a00ff1600fe1200fa0f00f50b00f10700ec0300e80000e30000de0000da0000d50000d10000cc0000c80000"
        "c30000bf0000ba0000b60000b10000ac0000a80000a300009f00009a00009600009100008d00008800008400007f0000"
    ),
    "viridis": (
        "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163471265471466471567471669"
        "47186a48196b481a6c481c6e481d6f481e70482071482172482273482374472575472676472777472878472a79472b7a"
        "472c7b462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
        "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c893c4d8a3c4e8a3b508a3b518a"
        "3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d"
        "32628d32638d31648d31658d31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
        "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e277d8e277e8e267f8e26808e"
        "26818e25828e25838d24848d24858d24868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c"
        "20908c20918c1f928c1f938b1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
        "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad80"
        "28ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
        "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
        "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d05279d1517cd24f7ed24e81d34c"
        "83d34b86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32"
        "addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
        "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51ef6e61ff8e621fae622fde724"
    ),
}
COLORMAPS = {name: np.frombuffer(bytes.fromhex(h), np.uint8).reshape(256, 3)
             for name, h in _TABLES.items()}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def colormap_rgba(values: np.ndarray, cmap_name: str) -> np.ndarray:
    """Map scalars in [0, 1] to (N, 4) RGBA uint8 as matplotlib's
    ``(cmap(v) * 255).astype(np.uint8)`` does: index ``int(v * 256)``,
    clipped to [0, 255] (below 0 takes the first colour, 1 and above the
    last); NaN maps to (0, 0, 0, 0)."""
    v = np.asarray(values, np.float64)
    bad = np.isnan(v)
    idx = np.clip(np.where(bad, 0.0, v) * 256, 0, 255).astype(np.int64)
    rgba = np.concatenate([COLORMAPS[cmap_name][idx],
                           np.full(idx.shape + (1,), 255, np.uint8)], axis=-1)
    rgba[bad] = 0
    return rgba


def _colormap_colors(values: np.ndarray, cmap_name: str) -> np.ndarray:
    """Min-max normalise scalars, then colour them (stand-in for
    ``trimesh.visual.interpolate``)."""
    v = np.asarray(values, np.float64)
    rng = v.max() - v.min()
    if rng > 0:
        v = (v - v.min()) / rng
    return colormap_rgba(v, cmap_name)


def create_mask_meshes(vertices, triangles, query_masks) -> list:
    """Per-query-channel viridis meshes (``create_mask_mesh``, fusion.py:1332-1346)."""
    query_masks = _host(query_masks)
    out = []
    for i in range(query_masks.shape[1]):
        colors = _colormap_colors(query_masks[:, i], "viridis")
        out.append(TriMesh(np.asarray(vertices), np.asarray(triangles)[..., ::-1], colors))
    return out


def create_instance_mask_mesh(vertices, triangles, mask) -> TriMesh:
    """Instance argmax coloured with jet (``create_instance_mask_mesh``,
    fusion.py:1348-1375)."""
    mask = _host(mask)
    num_instances = mask.shape[1]
    inst = onehot_to_instance(mask).astype(np.float64) / num_instances
    colors = _colormap_colors(inst, "jet")
    return TriMesh(np.asarray(vertices), np.asarray(triangles)[..., ::-1], colors)


def create_descriptor_mesh(
    vertices, triangles, features, mask, pca: PCAParams, mask_out_bg: bool = True
) -> TriMesh:
    """PCA(3)-projected descriptors as RGB; background (instance 0) grey 0.8
    (``create_descriptor_mesh``, fusion.py:1392-1416). Colours follow the
    reference's BGR->RGB flip on the projected channels. ``features`` is
    projected on its device when it is a tensor."""
    if not isinstance(features, torch.Tensor):
        features = torch.as_tensor(np.asarray(features))
    proj = _host(pca_transform(features, pca))
    rgb = np.zeros((proj.shape[0], 3))
    for i in range(proj.shape[1]):
        lo, hi = proj[:, i].min(), proj[:, i].max()
        rgb[:, i] = (proj[:, i] - lo) / (hi - lo + 1e-12)
    if mask_out_bg and mask is not None:
        bg = onehot_to_instance(_host(mask)) == 0
        rgb[bg] = 0.8
    rgb = rgb[..., ::-1]
    rgba = np.concatenate(
        [(rgb * 255).astype(np.uint8), np.full((rgb.shape[0], 1), 255, np.uint8)], axis=1
    )
    return TriMesh(np.asarray(vertices), np.asarray(triangles)[..., ::-1], rgba)


def create_color_mesh(vertices, triangles, colors_bgr) -> TriMesh:
    """Observed-colour mesh; input colours are BGR in [0,1] as stored in the
    state (``create_color_mesh``, fusion.py:1408-1416)."""
    c = _host(colors_bgr)[..., ::-1]
    rgba = np.concatenate(
        [(c * 255).astype(np.uint8), np.full((c.shape[0], 1), 255, np.uint8)], axis=1
    )
    return TriMesh(np.asarray(vertices), np.asarray(triangles)[..., ::-1], rgba)

"""Representation demo: fused field -> meshes (the reference's headline app).

Counterpart of ``d3fields_tpu/apps/vis_repr.py``, with the same flags.
Meshes are written as PLY files:

  python -m d3fields_tpu_torch.apps.vis_repr --scene mug --data_root data \\
      --pca_path pca_model/mug.pkl --out out/mug
  python -m d3fields_tpu_torch.apps.vis_repr --data_path data/<scene> \\
      --query_texts mug --query_thresholds 0.3
  python -m d3fields_tpu_torch.apps.vis_repr --synthetic --out out/demo

A recorded scene is read with ``utils.io.load_frame`` and its backends
(DINOv2, GroundingDINO + SAM) are built from the ``D3F_*`` checkpoint files
by ``apps/_backends.py``. Pipeline (reference ``vis_repr.py:57-126``):
load frame -> Fusion.update -> text_queries_for_inst_mask_no_track ->
dense-grid batch_eval -> smoothing + marching tetrahedra -> vertex
batch_eval (dino/mask/colour) -> instance / descriptor / colour meshes. It
runs on CUDA unless ``main`` is given another ``device``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from d3fields_tpu_torch.config import Boundaries

# reference scene table (vis_repr.py:16-31)
SCENES = {
    "mug": ("2023-09-15-13-21-56-171587", ["mug"], [0.3]),
    "fork": ("2023-09-15-14-15-01-238216", ["fork"], [0.25]),
    "shoe": ("2023-09-11-14-15-50-607452", ["shoe"], [0.5]),
}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", choices=sorted(SCENES), default=None)
    p.add_argument("--data_path", default=None, help="explicit scene dir")
    p.add_argument("--data_root", default="data")
    p.add_argument("--pca_path", default=None)
    p.add_argument("--query_texts", nargs="+", default=None)
    p.add_argument("--query_thresholds", nargs="+", type=float, default=None)
    p.add_argument("--num_cam", type=int, default=4)
    p.add_argument("--t", type=int, default=50)
    p.add_argument("--step", type=float, default=0.004)
    for axis, lo, hi in (("x", -0.4, 0.4), ("y", -0.4, 0.3), ("z", -0.2, 0.02)):
        p.add_argument(f"--{axis}_lower", type=float, default=lo)
        p.add_argument(f"--{axis}_upper", type=float, default=hi)
    p.add_argument("--synthetic", action="store_true",
                   help="checkpoint-free analytic demo scene")
    p.add_argument("--feat_dim", type=int, default=64,
                   help="synthetic descriptor dimensionality (use 1024 to "
                        "pair the synthetic scene with the reference's "
                        "fitted pca_model/*.pkl pickles)")
    p.add_argument("--out", default="out/vis_repr")
    p.add_argument("--dump_arrays", default=None,
                   help="also np.savez the numeric intermediates (grid dist "
                        "field, mesh vertices/triangles, per-vertex "
                        "mask/color/PCA-descriptor values)")
    return p


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(fusion, obs, queries, thresholds, boundaries, step, out, pca_path=None,
        dump=None) -> dict:
    """The app's pipeline on one observation, written to ``out``.

    Returns the consensus labels, the grid query (tensors on the fusion's
    device), the mesh (numpy vertices and triangles), the vertex query, the
    PCA of the descriptor mesh and the host seconds of each stage ('update_masks', 'grid_query',
    'extract_mesh', 'vertex_query', 'meshes'), each read after the device
    has finished the stage.
    """
    from d3fields_tpu_torch.fields.geometry import create_grid
    from d3fields_tpu_torch.mesh.extract import (
        create_color_mesh, create_descriptor_mesh, create_instance_mask_mesh, extract_mesh,
    )
    from d3fields_tpu_torch.ops.pca import PCAParams, pca_transform

    os.makedirs(out, exist_ok=True)
    seconds = {}
    clock = [time.perf_counter()]

    def lap(stage):
        _synchronize(fusion.device)
        now = time.perf_counter()
        seconds[stage] = now - clock[0]
        clock[0] = now

    fusion.update(obs)
    fusion.text_queries_for_inst_mask_no_track(queries, thresholds, boundaries=boundaries)
    lap("update_masks")
    print(f"[vis_repr] update+masks: {seconds['update_masks']:.2f}s; "
          f"consensus labels: {fusion.consensus_mask_label}")

    grid, grid_shape = create_grid(boundaries, step)
    grid_out = fusion.batch_eval(grid.astype(np.float32), ())
    lap("grid_query")
    vertices, triangles = extract_mesh(grid, grid_out["dist"], grid_shape)
    lap("extract_mesh")
    print(f"[vis_repr] grid query ({grid.shape[0]} pts) + marching tetrahedra "
          f"({vertices.shape[0]} verts): "
          f"{seconds['grid_query'] + seconds['extract_mesh']:.2f}s")
    if vertices.shape[0] == 0:
        raise SystemExit("empty mesh: no surface crossed the iso level")

    vout = fusion.batch_eval(vertices.astype(np.float32), ("dino_feats", "mask", "color_tensor"))
    lap("vertex_query")

    inst_mesh = create_instance_mask_mesh(vertices, triangles, vout["mask"])
    inst_mesh.export_ply(os.path.join(out, "instance_mesh.ply"))
    if pca_path:
        pca = PCAParams.load(pca_path)
    else:
        pca = PCAParams.fit(vout["dino_feats"].cpu().numpy(), 3)
    desc_mesh = create_descriptor_mesh(vertices, triangles, vout["dino_feats"], vout["mask"], pca)
    desc_mesh.export_ply(os.path.join(out, "descriptor_mesh.ply"))
    color_mesh = create_color_mesh(vertices, triangles, vout["color_tensor"])
    color_mesh.export_ply(os.path.join(out, "color_mesh.ply"))
    lap("meshes")
    if dump:
        np.savez_compressed(
            dump,
            dist=grid_out["dist"].cpu().numpy().astype(np.float32),
            vertices=vertices.astype(np.float32),
            triangles=triangles.astype(np.int32),
            mask=vout["mask"].cpu().numpy().astype(np.float32),
            color=vout["color_tensor"].cpu().numpy().astype(np.float32),
            desc_pca=pca_transform(vout["dino_feats"], pca).cpu().numpy().astype(np.float32),
        )
        print(f"[vis_repr] dumped numeric intermediates to {dump}")
    print(f"[vis_repr] wrote instance/descriptor/color meshes to {out}")
    return {"labels": list(fusion.consensus_mask_label), "grid": grid_out,
            "vertices": vertices, "triangles": triangles, "vertex_query": vout,
            "pca": pca, "seconds": seconds}


def synthetic_inputs(num_cam: int = 4, feat_dim: int = 64, queries=None, thresholds=None):
    """The ``--synthetic`` scene: (obs, queries, thresholds, boundaries,
    mask backend) for :func:`run`."""
    from d3fields_tpu_torch.utils.synthetic import render_sphere_scene, sphere_mask_backend

    queries = queries or ["ball", "small ball"]
    thresholds = thresholds or [0.3] * len(queries)
    scene = render_sphere_scene(num_views=num_cam, feat_dim=feat_dim)
    obs = {k: scene[k] for k in ("color", "depth", "pose", "K", "dino_feats")}
    boundaries = Boundaries(-0.3, 0.5, -0.3, 0.35, 0.001, 0.3)
    return obs, queries, thresholds, boundaries, sphere_mask_backend(scene, queries)


def main(argv=None, *, device=None):
    """The CLI. ``device`` defaults to CUDA and raises when no GPU is visible."""
    args = build_parser().parse_args(argv)
    from d3fields_tpu_torch.fields.fusion import Fusion

    if args.synthetic:
        obs, queries, thresholds, boundaries, backend = synthetic_inputs(
            args.num_cam, args.feat_dim, args.query_texts, args.query_thresholds)
        fusion = Fusion(num_cam=args.num_cam, mask_backend=backend, device=device)
    else:
        from d3fields_tpu_torch.apps._backends import build_real_backends
        from d3fields_tpu_torch.utils.io import load_frame

        boundaries = Boundaries(
            x_lower=args.x_lower, x_upper=args.x_upper,
            y_lower=args.y_lower, y_upper=args.y_upper,
            z_lower=args.z_lower, z_upper=args.z_upper,
        )
        if args.scene:
            sub, queries, thresholds = SCENES[args.scene]
            data_path = args.data_path or os.path.join(args.data_root, sub)
        else:
            data_path = args.data_path
            queries, thresholds = args.query_texts, args.query_thresholds
            if not (data_path and queries and thresholds):
                raise SystemExit(
                    "need --scene, or --data_path + --query_texts + "
                    "--query_thresholds, or --synthetic"
                )
        obs = load_frame(data_path, args.t, args.num_cam)
        feature_backend, mask_backend = build_real_backends(device=device)
        fusion = Fusion(num_cam=args.num_cam, feature_backend=feature_backend,
                        mask_backend=mask_backend, device=device)
    run(fusion, obs, queries, thresholds, boundaries, args.step, args.out,
        pca_path=args.pca_path, dump=args.dump_arrays)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Fit the descriptor-colouring PCA from clean object images.

Counterpart of ``d3fields_tpu/apps/precompute_pca.py`` (reference
``scripts/precompute_pca.py``): DINOv2 patch tokens of a few object images
-> PCA(3) -> foreground = tokens whose component 0 is <= the threshold
(``precompute_pca.py:76``) -> PCA(3) refit on the foreground -> a pickled
:class:`d3fields_tpu_torch.ops.pca.PCAParams`:

  python -m d3fields_tpu_torch.apps.precompute_pca --images a.png b.png \\
      --out pca_model/mug.pkl
  python -m d3fields_tpu_torch.apps.precompute_pca --synthetic --out out/pca.pkl

Images are PNG or JPEG files, read as ``cv2.imread`` reads them
(``utils/png.py::imread_color``, ``utils/jpeg.py``) and resized as
``cv2.resize`` does (``models/resize.py::linear_resize_u8``). DINOv2 is
built from ``D3F_DINOV2_CKPT`` by ``apps/_backends.py`` on ``device``
(CUDA unless ``main`` is given another).
"""

from __future__ import annotations

import argparse

import numpy as np

from d3fields_tpu_torch.ops.pca import PCAParams


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", nargs="+", default=None)
    p.add_argument("--patch_h", type=int, default=75)
    p.add_argument("--patch_w", type=int, default=75)
    p.add_argument("--fg_threshold", type=float, default=-15.0,
                   help="component-0 split (reference precompute_pca.py:76)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out", required=True)
    return p


def fit_fg_pca(features: np.ndarray, fg_threshold: float) -> PCAParams:
    """features (N, D) -> PCA refit on the tokens whose first full-PCA
    component is <= fg_threshold (the background lies above it)."""
    full = PCAParams.fit(features, 3)
    comp0 = (features - full.mean) @ full.components[0]
    fg = comp0 <= fg_threshold
    if not fg.any():
        fg = np.ones(features.shape[0], bool)
    return PCAParams.fit(features[fg], 3)


def main(argv=None, *, device=None):
    """The CLI. ``device`` defaults to CUDA and raises when no GPU is visible."""
    from d3fields_tpu_torch.utils.device import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    if args.synthetic:
        rs = np.random.RandomState(0)
        feats = rs.randn(4 * 100, 64).astype(np.float32)
    else:
        import torch

        from d3fields_tpu_torch.apps._backends import build_feature_backend
        from d3fields_tpu_torch.models.resize import linear_resize_u8
        from d3fields_tpu_torch.utils.png import imread_color

        if not args.images:
            raise SystemExit("--images (PNG or JPEG files) or --synthetic is required")
        backend = build_feature_backend(device=device)
        size = (14 * args.patch_h, 14 * args.patch_w)
        imgs = np.stack([linear_resize_u8(imread_color(p), size) for p in args.images])
        with torch.no_grad():
            feats = backend(imgs, patch_hw=(args.patch_h, args.patch_w))
        feats = feats.reshape(-1, feats.shape[-1]).cpu().numpy()
    params = fit_fg_pca(feats, args.fg_threshold)
    params.save(args.out)
    print(f"[precompute_pca] saved PCA({params.components.shape}) -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

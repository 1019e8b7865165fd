"""PCA descriptor projection (sklearn-compatible fit, device transform).

Counterpart of ``d3fields_tpu/ops/pca.py``. The reference fits a
3-component sklearn PCA offline (``scripts/precompute_pca.py:76-96``) and
applies ``pca.transform`` when colouring descriptor meshes
(``fusion.py:1389-1394``). The fit stays on the host in numpy; the
transform is a matmul on the features' device.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class PCAParams:
    components: np.ndarray  # (k, D)
    mean: np.ndarray        # (D,)

    @staticmethod
    def fit(X: np.ndarray, n_components: int = 3) -> "PCAParams":
        """SVD fit matching ``sklearn.decomposition.PCA`` (full SVD, sign
        convention: largest-|loading| element of each component positive)."""
        mean = X.mean(axis=0)
        Xc = X - mean
        _, _, Vt = np.linalg.svd(Xc, full_matrices=False)
        comps = Vt[:n_components]
        # sklearn's svd_flip: sign from the max-abs element of each row of Vt
        signs = np.sign(comps[np.arange(comps.shape[0]), np.abs(comps).argmax(axis=1)])
        comps = comps * signs[:, None]
        return PCAParams(components=comps.astype(X.dtype), mean=mean.astype(X.dtype))

    @staticmethod
    def from_sklearn(pca) -> "PCAParams":
        """Adopt a fitted sklearn PCA (including the reference's pickles:
        sklearn PCA objects with (3, 1024) components, ``pca_model/*.pkl``)."""
        return PCAParams(
            components=np.asarray(pca.components_),
            mean=np.asarray(pca.mean_),
        )

    @staticmethod
    def load(path: str) -> "PCAParams":
        with open(path, "rb") as f:
            obj = pickle.load(f)
        if isinstance(obj, PCAParams):
            return obj
        return PCAParams.from_sklearn(obj)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)


def pca_transform(feats: Tensor, params: PCAParams) -> Tensor:
    """(N, D) -> (N, k) on the features' device."""
    comps = torch.as_tensor(params.components).to(device=feats.device, dtype=feats.dtype)
    mean = torch.as_tensor(params.mean).to(device=feats.device, dtype=feats.dtype)
    return (feats - mean) @ comps.T

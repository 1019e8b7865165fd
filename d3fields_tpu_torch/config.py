"""Unified typed configuration tree.

The reference scatters configuration over three mechanisms (module constants
in ``vis_repr.py:16-51``, argparse in ``vis_repr_custom.py:113-129``, and
hardcoded hyperparameters inside ``Fusion`` — mu ``fusion.py:208``, xmem dict
``fusion.py:263-280``, chunk size ``fusion.py:527``). Here everything lives in
one hashable dataclass tree. A copy of ``d3fields_tpu/config.py`` with the
same field names, so one config file serves both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Boundaries:
    """Axis-aligned workspace bounds in meters.

    Defaults match the reference demo table exactly (``vis_repr.py:38-44``:
    x in [-0.4, 0.4], y in [-0.4, 0.3], z in [-0.2, 0.02] — the tabletop
    scenes look down at objects below the camera plane)."""

    x_lower: float = -0.4
    x_upper: float = 0.4
    y_lower: float = -0.4
    y_upper: float = 0.3
    z_lower: float = -0.2
    z_upper: float = 0.02

    @property
    def lower(self) -> Tuple[float, float, float]:
        return (self.x_lower, self.y_lower, self.z_lower)

    @property
    def upper(self) -> Tuple[float, float, float]:
        return (self.x_upper, self.y_upper, self.z_upper)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "Boundaries":
        return Boundaries(**{k: float(v) for k, v in d.items()})


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Field-fusion hyperparameters (reference ``fusion.py:202-303``)."""

    mu: float = 0.02                 # truncation band in meters (fusion.py:208)
    query_tile: int = 32768          # points per eval tile (replaces 60k chunk, fusion.py:527)
    use_pallas: bool = True          # take the fused kernel path (name kept for config-file compatibility)


@dataclasses.dataclass(frozen=True)
class InstanceConfig:
    """Cross-view instance-consistency knobs (reference ``fusion.py:1068-1098``)."""

    association: str = "voxel"       # 'voxel' (what the reference invokes, fusion.py:1090) or 'pcd' (fusion.py:743-792)
    voxel_size: float = 0.03         # association voxel size (fusion.py:1078)
    iou_threshold: float = 0.005     # pcd-variant point match distance in meters (fusion.py:724-741)
    vox_merge_iou: float = 0.20      # voxel-set merge threshold (fusion.py:824)
    pcd_merge_iou: float = 0.25      # pcd-variant merge IoU cutoff (fusion.py:765)
    min_points: int = 1              # drop instances with fewer voxels (reference deletes only empty ones, fusion.py:1040-1044)
    pcd_min_points: int = 10         # pcd-variant small-instance cutoff (fusion.py:929,965)
    background_labels: Tuple[str, ...] = ("table",)  # fusion.py:1030


@dataclasses.dataclass(frozen=True)
class XMemConfig:
    """Video-object-segmentation memory configuration (reference ``fusion.py:263-280``)."""

    key_dim: int = 64
    value_dim: int = 512
    hidden_dim: int = 64
    top_k: int = 30
    mem_every: int = 5
    deep_update_every: int = -1
    max_mid_term_frames: int = 10
    min_mid_term_frames: int = 5
    num_prototypes: int = 128
    max_long_term_elements: int = 10000
    enable_long_term: bool = True
    enable_long_term_count_usage: bool = True
    size: int = 480                  # resize short side for processing
    # dtype of the CNN encoders/decoder inside the propagation step
    # ("float32" | "bfloat16"); the memory and its attention always run f32
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Rigid keypoint tracking (reference ``fusion.py:1608-1685``)."""

    lr: float = 0.01
    iters: int = 100
    reg_weight: float = 1.0
    dist_weight: float = 100.0
    oob_weight: float = 0.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Marching-cubes extraction (reference ``fusion.py:1313-1330``)."""

    step: float = 0.004              # grid step in meters (vis_repr.py:88)
    smooth: bool = True              # constrained-smoothing before MC (mcubes.smooth parity)
    iso: float = 0.0


@dataclasses.dataclass(frozen=True)
class D3FieldsConfig:
    """Top-level config for the whole pipeline."""

    fusion: FusionConfig = dataclasses.field(default_factory=FusionConfig)
    instances: InstanceConfig = dataclasses.field(default_factory=InstanceConfig)
    xmem: XMemConfig = dataclasses.field(default_factory=XMemConfig)
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    boundaries: Boundaries = dataclasses.field(default_factory=Boundaries)
    # OPT-IN determinism: when set, Fusion construction seeds the host
    # python/numpy RNGs (FPS random starts, reference set_seed
    # my_utils.py:222). None (default) leaves the process-global RNGs
    # alone — reseeding them implicitly would hijack callers' randomness.
    seed: Optional[int] = None


# ---------------------------------------------------------------------------
# serialization (the unified replacement for the reference's three config
# mechanisms, SURVEY section 5)
# ---------------------------------------------------------------------------

def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> "D3FieldsConfig":
    kwargs = {}
    sub = {
        f.name: f.default_factory
        for f in dataclasses.fields(D3FieldsConfig)
        if f.default_factory is not dataclasses.MISSING
        and dataclasses.is_dataclass(f.default_factory)
    }
    for k, v in d.items():
        if k in sub and isinstance(v, dict):
            v = {kk: tuple(vv) if isinstance(vv, list) else vv
                 for kk, vv in v.items()}
            kwargs[k] = sub[k](**v)
        else:
            kwargs[k] = v
    return D3FieldsConfig(**kwargs)


def save_config(cfg, path: str) -> None:
    import json

    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2)


def load_config(path: str) -> "D3FieldsConfig":
    import json

    with open(path) as f:
        return config_from_dict(json.load(f))

"""The field core: multi-view fusion queries in PyTorch.

Counterpart of ``d3fields_tpu/fields/fusion.py:47-298``:

- ``eval_field(state, pts, return_names)`` fuses projection, visibility,
  truncated distance and weighted multi-view feature interpolation. The
  per-view contributions are summed one view at a time, so nothing of size
  (V, N, C) is held. It is plain torch, so autograd differentiates it.
- ``batch_eval`` streams any number of points through fixed-size tiles
  into outputs it allocates once.
- ``Fusion`` is the facade: ``update`` ingests an observation (and runs the
  feature backend), ``batch_eval`` answers queries.

The weighting matches the reference (``fusion.py:343-388``): validity
``(inter_depth>0) & in_front & (dist>-mu)``, weight
``exp(clamp(mu-|dist|, max=0)/mu)`` from the unclamped distance, distance
clamped to ±mu and averaged over the valid views, invalid points set to
1e3, features fused as ``sum(f * valid * w) / (count(valid) + 1e-6)``:
the denominator is the count of valid views, not the weight sum.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from d3fields_tpu_torch.config import Boundaries, D3FieldsConfig
from d3fields_tpu_torch.fields import geometry, kernels
from d3fields_tpu_torch.fields.state import FieldState, state_from_obs
from d3fields_tpu_torch.utils.device import resolve_device
from d3fields_tpu_torch.utils.profiling import tracer
from d3fields_tpu_torch.utils.seeding import set_seed

Tensor = torch.Tensor

INVALID_DIST = 1e3
_EPS = 1e-6


# ---------------------------------------------------------------------------
# Core eval
# ---------------------------------------------------------------------------

def _distance_terms(state: FieldState, pts: Tensor):
    """Shared projection + depth-visibility computation.

    Returns (xy, dist_raw, in_front, inter_depth, pts_depth).
    """
    xy, in_front, pts_depth = geometry.project_points(pts, state.pose, state.K)
    inter_depth = geometry.interpolate_maps(
        state.depth[..., None], xy, state.image_hw, mode="nearest"
    )[..., 0]  # (V, N)
    return xy, inter_depth - pts_depth, in_front, inter_depth, pts_depth


def _fused_distance(state: FieldState, pts: Tensor):
    """The distance half of a field query, shared by ``eval_field`` and
    ``kernels.eval_field_fused``.

    Returns (xy (V, N, 2), outputs {'dist', 'valid_mask'}, vw (V, N) the
    per-view feature weight, denom (N,) the count of valid views,
    all_invalid (N,)).
    """
    mu = state.mu
    with tracer.span("fields.distance"):
        xy, dist_raw, in_front, inter_depth, _ = _distance_terms(state, pts)
        dist_valid = (inter_depth > 0.0) & in_front & (dist_raw > -mu)
        weight = torch.exp(torch.clamp(mu - torch.abs(dist_raw), max=0.0) / mu)
        dist = torch.clamp(dist_raw, -mu, mu)

        vf = dist_valid.to(pts.dtype)
        denom = vf.sum(dim=0)
        dist_fused = (dist * vf).sum(dim=0) / (denom + _EPS)
        all_invalid = denom == 0
        dist_fused = torch.where(all_invalid, torch.full_like(dist_fused, INVALID_DIST),
                                 dist_fused)
        outputs = {"dist": dist_fused, "valid_mask": torch.logical_not(all_invalid)}
        return xy, outputs, vf * weight, denom, all_invalid


def _bilinear_views(m: Tensor, xy: Tensor, vw: Tensor, image_hw) -> Tensor:
    """``sum_v bilinear(m[v], xy[v]) * vw[v]``, one view at a time: (N, C)."""
    acc = None
    with tracer.span("fields.bilinear"):
        for v in range(m.shape[0]):
            contrib = geometry.sample_map_bilinear(m[v], xy[v], image_hw) * vw[v][:, None]
            acc = contrib if acc is None else acc + contrib
    return acc


def _normalise(acc: Tensor, denom: Tensor, all_invalid: Tensor) -> Tensor:
    val = acc / (denom[:, None] + _EPS)
    return torch.where(all_invalid[:, None], torch.zeros_like(val), val)


def eval_field(
    state: FieldState,
    pts: Tensor,
    return_names: Tuple[str, ...] = ("dino_feats", "mask"),
) -> Dict[str, Tensor]:
    """Query the fused field at (N, 3) world points.

    Returns 'dist' (N,), 'valid_mask' (N,) bool, and one (N, C) tensor per
    requested name in {'dino_feats', 'mask', 'color_tensor'}. Semantics
    mirror the reference ``Fusion.eval`` (``fusion.py:305-394``).
    """
    xy, outputs, vw, denom, all_invalid = _fused_distance(state, pts)
    if return_names:
        maps = state.feature_maps(tuple(return_names))
        for name in return_names:
            acc = _bilinear_views(maps[name], xy, vw, state.image_hw)
            outputs[name] = _normalise(acc, denom, all_invalid)
    return outputs


def eval_dist(state: FieldState, pts: Tensor) -> Dict[str, Tensor]:
    """Unclamped distance query for grasp planners.

    Mirrors the reference ``Fusion.eval_dist`` (``fusion.py:396-436``): no
    ±mu clamp, no 1e3 sentinel, validity is ``(inter_depth>0) & in_front``.
    """
    _, dist_raw, in_front, inter_depth, _ = _distance_terms(state, pts)
    vf = ((inter_depth > 0.0) & in_front).to(pts.dtype)
    denom = vf.sum(dim=0)
    return {"dist": (dist_raw * vf).sum(dim=0) / (denom + _EPS), "valid_mask": denom > 0}


# ---------------------------------------------------------------------------
# Streaming batch eval
# ---------------------------------------------------------------------------

def batch_eval(
    state: FieldState,
    pts,
    return_names: Tuple[str, ...] = ("dino_feats", "mask"),
    *,
    tile: int = 32768,
    fused: bool = False,
    matmul_dtype: str = "float32",
) -> Dict[str, Tensor]:
    """Evaluate the field over any number of points, ``tile`` at a time.

    Replaces the reference's 60k-chunk host loop (``Fusion.batch_eval``,
    ``fusion.py:526-545``). Outputs are allocated once at full size and each
    tile is written into its slice; the ragged last tile is just shorter.
    ``fused=True`` queries through :func:`kernels.eval_field_fused` (on the
    card two CUDA launches a tile, writing into the output slices) at
    ``matmul_dtype`` ('float32', or 'bfloat16' for the kernel's bf16
    route), ``fused=False`` through :func:`eval_field` (f32 only). Runs
    without autograd: differentiate :func:`eval_field` instead.
    """
    if not fused and matmul_dtype != "float32":
        raise ValueError("matmul_dtype applies to the fused query only (fused=True)")
    with tracer.span("fields.query", memory=True):
        pts = torch.as_tensor(pts).to(device=state.device, dtype=state.depth.dtype)
        n = pts.shape[0]
        names = tuple(return_names)
        maps = state.feature_maps(names) if names else {}
        dev, dt = state.device, pts.dtype
        out = {"dist": torch.empty(n, dtype=dt, device=dev),
               "valid_mask": torch.empty(n, dtype=torch.bool, device=dev)}
        for name in names:
            out[name] = torch.empty((n, maps[name].shape[-1]), dtype=dt, device=dev)
        if fused:
            # the bf16 route's tables rounded once, not at every tile's launch
            state = kernels.round_patch_maps(state, names, matmul_dtype)

            def query(st, p, nm, dst):
                kernels.eval_field_fused(st, p, nm, matmul_dtype, out=dst)
        else:
            def query(st, p, nm, dst):
                for k, v in eval_field(st, p, nm).items():
                    dst[k].copy_(v)
        with torch.no_grad():
            for s in range(0, n, tile):
                with tracer.span("fields.tile"):
                    query(state, pts[s:s + tile], names,
                          {k: v[s:s + tile] for k, v in out.items()})
        return out


# ---------------------------------------------------------------------------
# Host orchestration facade
# ---------------------------------------------------------------------------

class Fusion:
    """Facade mirroring the reference ``Fusion`` class API.

    Holds the configuration, optional feature and mask backends, the XMem
    video tracker, the device and the current :class:`FieldState`; the math
    is in the functions above and in the ``seg``, ``mesh`` and ``track``
    modules. Not ported yet: ``select_features_rand_v2``.
    """

    def __init__(
        self,
        num_cam: Optional[int] = None,
        config: Optional[D3FieldsConfig] = None,
        feature_backend=None,
        mask_backend=None,
        video_tracker=None,
        video_tracker_factory=None,
        *,
        device=None,
    ):
        """``video_tracker_factory(num_views, num_objects, image_hw)`` is
        called on the first tracked frame, once consensus has given the
        object count, and returns a
        :class:`~d3fields_tpu_torch.seg.video_tracker.VideoMaskTracker`.
        ``device`` defaults to CUDA and raises when no GPU is visible."""
        self.device = resolve_device(device)
        self.config = config or D3FieldsConfig()
        if self.config.seed is not None:
            # opt-in determinism of the host RNGs
            set_seed(self.config.seed)
        self.num_cam = num_cam
        self.feature_backend = feature_backend
        self.mask_backend = mask_backend
        self.video_tracker = video_tracker
        self.video_tracker_factory = video_tracker_factory
        self.state: Optional[FieldState] = None
        self.curr_obs: dict = {}
        self.consensus_mask_label: list = []
        self.semantic_label: list = []
        self.view_masks: list = []
        self.instances_info: list = []

    # -- ingestion ---------------------------------------------------------
    def update(self, obs: dict) -> FieldState:
        """Ingest a reference-style obs dict and extract features.

        Mirrors ``Fusion.update`` (``fusion.py:686-714``): stores colour /
        depth / pose / K and fills per-view DINOv2 patch descriptors from the
        feature backend on a (H//10, W//10) patch grid.
        """
        with tracer.span("fields.update", memory=True):
            self.num_cam = obs["color"].shape[0]
            dino_feats = obs.get("dino_feats")
            if dino_feats is None and self.feature_backend is not None:
                H, W = obs["color"].shape[1:3]
                with tracer.span("fields.update.features"):
                    dino_feats = self.feature_backend(obs["color"], patch_hw=(H // 10, W // 10))
            mask = obs.get("mask")
            if mask is None and self.state is not None:
                mask = self.state.mask  # carry tracked masks across frames
            with tracer.span("fields.update.ingest"):
                self.state = state_from_obs(
                    obs, dino_feats=dino_feats, mask=mask, mu=self.config.fusion.mu,
                    device=self.device,
                )
            self.curr_obs = dict(obs)
            return self.state

    def set_mask(self, mask) -> FieldState:
        """Attach (V, H, W, NI) instance-mask probabilities to the state."""
        self.state = self.state.replace(
            mask=torch.as_tensor(mask).to(device=self.device, dtype=self.state.depth.dtype))
        return self.state

    # -- queries -----------------------------------------------------------
    def _require_state(self):
        if self.state is None:
            raise RuntimeError("call update() before querying the field")

    def _pts(self, pts) -> Tensor:
        return torch.as_tensor(pts).to(device=self.device, dtype=self.state.depth.dtype)

    def eval(self, pts, return_names=("dino_feats", "mask")):
        self._require_state()
        return eval_field(self.state, self._pts(pts), tuple(return_names))

    def eval_dist(self, pts):
        self._require_state()
        return eval_dist(self.state, self._pts(pts))

    def batch_eval(self, pts, return_names=("dino_feats", "mask")):
        self._require_state()
        return batch_eval(
            self.state,
            pts,
            tuple(return_names),
            tile=self.config.fusion.query_tile,
            fused=self.config.fusion.use_pallas,
        )

    def batch_eval_np(self, pts, return_names=("dino_feats", "mask")):
        out = self.batch_eval(pts, return_names)
        return {k: v.cpu().numpy() for k, v in out.items()}

    # -- open-text instance masks -----------------------------------------
    def _poses44(self) -> np.ndarray:
        pose = self.state.pose.cpu().numpy()
        pad = np.tile(np.array([[[0.0, 0.0, 0.0, 1.0]]], pose.dtype), (pose.shape[0], 1, 1))
        return np.concatenate([pose, pad], axis=1)

    def _boundaries(self, boundaries) -> Boundaries:
        if boundaries is None:
            return self.config.boundaries
        if isinstance(boundaries, Boundaries):
            return boundaries
        return Boundaries.from_dict(boundaries)

    def text_queries_for_inst_mask_no_track(
        self,
        queries,
        thresholds,
        boundaries=None,
        expected_labels=None,
        robot_pcd=None,
    ):
        """Open-text per-view masks + cross-view consensus, single frame.

        Mirrors ``Fusion.text_queries_for_inst_mask_no_track``
        (``fusion.py:1112-1171``): per-view mask backend -> optional robot
        filter -> voxel-IoU consensus -> one-hot 'mask' in the state.
        Returns (index masks (V, H, W) uint8, consensus labels).
        """
        from d3fields_tpu_torch.seg import backends as segb
        from d3fields_tpu_torch.seg import instances as segi

        self._require_state()
        if self.mask_backend is None:
            raise RuntimeError("no mask backend configured")
        boundaries = self._boundaries(boundaries)
        color = self.curr_obs["color"]
        depth = self.state.depth.cpu().numpy()
        Ks = self.state.K.cpu().numpy()
        poses44 = self._poses44()

        # backends take RGB; obs colour is BGR (the reference's cv2
        # convention, converted inside its model wrappers)
        rgb = np.ascontiguousarray(color[..., ::-1])
        if hasattr(self.mask_backend, "segment_views"):
            # batched backend: one detector pass over all views
            views = self.mask_backend.segment_views(rgb, queries, thresholds)
        else:
            views = [self.mask_backend.segment(rgb[i], queries, thresholds)
                     for i in range(self.num_cam)]
        if robot_pcd is not None:
            views = [segb.filter_masks_by_robot_pcd(vm, depth[i], Ks[i], poses44[i], robot_pcd)
                     for i, vm in enumerate(views)]
        self.view_masks = views
        _, idx = np.unique(views[0].labels, return_index=True)
        self.semantic_label = list(np.array(views[0].labels)[np.sort(idx)])

        index_masks, labels, insts = segi.align_instance_masks(
            views, depth, Ks, poses44, queries, boundaries,
            self.config.instances, expected_labels,
        )
        self.consensus_mask_label = labels
        self.instances_info = insts
        self.set_mask(geometry.instance_to_onehot(index_masks, len(labels)).astype(np.float32))
        return index_masks, labels

    def text_queries_for_inst_mask(
        self,
        queries,
        thresholds,
        boundaries=None,
        expected_labels=None,
        robot_pcd=None,
    ):
        """Tracked masks (``Fusion.text_queries_for_inst_mask``,
        ``fusion.py:1173-1256``): consensus on the first frame, video
        propagation after it.

        Propagation uses the ``video_tracker`` (built from
        ``video_tracker_factory`` once the object count is known): it is
        seeded with the consensus masks on the first frame and propagates
        them on later frames. Without one, the mask backend runs again on
        later frames and the new channels are relabelled by their largest
        pixel overlap with the previous frame's masks (the reference's
        ``align_with_prev_mask``, ``fusion.py:1100-1110``), so instance
        identities stay stable.
        """
        from d3fields_tpu_torch.seg.instances import align_with_prev_mask

        if not self.consensus_mask_label:
            index_masks, labels = self.text_queries_for_inst_mask_no_track(
                queries, thresholds, boundaries, expected_labels, robot_pcd)
            if (self.video_tracker is None and self.video_tracker_factory is not None
                    and len(labels) > 1):  # nothing to track on background alone
                self.video_tracker = self.video_tracker_factory(
                    num_views=self.num_cam, num_objects=len(labels) - 1,
                    image_hw=self.curr_obs["color"].shape[1:3])
            if self.video_tracker is not None:
                # the tracker takes RGB; obs colour is BGR
                self.set_mask(self.video_tracker.process(
                    self.curr_obs["color"][..., ::-1], index_masks.astype(np.uint8)))
            return index_masks, labels
        if self.video_tracker is not None:
            onehot = self.video_tracker.process(self.curr_obs["color"][..., ::-1], None)
            self.set_mask(onehot)
            return geometry.onehot_to_instance(onehot), self.consensus_mask_label
        prev_labels = list(self.consensus_mask_label)
        prev_mask = self.state.mask.cpu().numpy() if self.state.mask is not None else None
        index_masks, labels = self.text_queries_for_inst_mask_no_track(
            queries, thresholds, boundaries, expected_labels or prev_labels, robot_pcd)
        if prev_mask is not None and len(labels) == len(prev_labels):
            new_mask = self.state.mask.cpu().numpy()
            if new_mask.shape == prev_mask.shape:
                aligned = align_with_prev_mask(new_mask, prev_mask)
                self.set_mask(aligned)
                self.consensus_mask_label = prev_labels
                return geometry.onehot_to_instance(aligned), prev_labels
        return index_masks, labels

    def clear_xmem_memory(self):
        """Reset video tracking (``Fusion.clear_xmem_memory``,
        ``fusion.py:1699-1702``)."""
        self.consensus_mask_label = []
        if self.video_tracker is not None:
            self.video_tracker.clear_memory()

    def get_inst_num(self) -> int:
        """Number of consensus instances including background
        (``fusion.py:1258-1260``)."""
        return len(self.consensus_mask_label)

    def extract_masked_pcd(self, inst_idx_ls, boundaries=None) -> np.ndarray:
        """World points under selected instances' (eroded) consensus masks,
        aggregated over views (``fusion.py:1262-1280``)."""
        from d3fields_tpu_torch.seg.instances import erode_mask

        self._require_state()
        boundaries = self._boundaries(boundaries)
        mask = self.state.mask.cpu().numpy()
        sel = np.zeros(mask.shape[:3], bool)
        for idx in inst_idx_ls:
            sel |= mask[..., idx].astype(bool)
        sel = np.stack([erode_mask(sel[i]) for i in range(sel.shape[0])])
        return geometry.aggregate_masked_points_np(
            self.state.depth.cpu().numpy(), self.state.K.cpu().numpy(), self._poses44(),
            masks=sel, boundaries=boundaries,
        )

    def get_query_obj_pcd(self, boundaries=None) -> np.ndarray:
        """All non-background instance points (``fusion.py:1297-1311``)."""
        return self.extract_masked_pcd(list(range(1, self.get_inst_num())), boundaries)

    # -- reference-API conveniences -----------------------------------------
    def extract_mesh(self, init_grid, out, grid_shape):
        """(vertices, triangles) from a grid query result
        (``Fusion.extract_mesh``, ``fusion.py:1313-1330``)."""
        from d3fields_tpu_torch.mesh.extract import extract_mesh

        return extract_mesh(np.asarray(init_grid), out["dist"], grid_shape,
                            smooth=self.config.mesh.smooth, iso=self.config.mesh.iso,
                            device=self.device)

    def create_instance_mask_mesh(self, vertices, triangles, out):
        from d3fields_tpu_torch.mesh.extract import create_instance_mask_mesh

        return [create_instance_mask_mesh(vertices, triangles, out["mask"])]

    def create_descriptor_mesh(self, vertices, triangles, out, pca_info, mask_out_bg=True):
        from d3fields_tpu_torch.mesh.extract import create_descriptor_mesh
        from d3fields_tpu_torch.ops.pca import PCAParams

        pca = pca_info["pca"] if isinstance(pca_info, dict) else pca_info
        if not isinstance(pca, PCAParams):
            pca = PCAParams.from_sklearn(pca)
        return create_descriptor_mesh(vertices, triangles, out["dino_feats"], out.get("mask"),
                                      pca, mask_out_bg=mask_out_bg)

    def create_color_mesh(self, vertices, triangles, out):
        from d3fields_tpu_torch.mesh.extract import create_color_mesh

        return create_color_mesh(vertices, triangles, out["color_tensor"])

    def _keypoint_dict(self, feats, pts, ids) -> dict:
        return {f"{self.consensus_mask_label[i]}_{i}": {"src_feats": f, "src_pts": p}
                for f, p, i in zip(feats, pts, ids)}

    def select_features_rand(self, boundaries, N, per_instance=False, res=0.001, init_idx=-1):
        """Reference keypoint-selection API (``fusion.py:1418-1481``):
        returns {instance_name: {'src_feats', 'src_pts'}} keyed by consensus
        label with duplicate suffixes."""
        from d3fields_tpu_torch.track.keypoints import select_keypoints

        self._require_state()
        return self._keypoint_dict(*select_keypoints(
            self.state, self.consensus_mask_label, self._boundaries(boundaries), N,
            res=res, per_instance=per_instance, init_idx=init_idx))

    def select_features_from_pcd(self, pcd, N, per_instance=False, init_idx=-1):
        """Cloud-sampled variant (``fusion.py:1483-1540``)."""
        from d3fields_tpu_torch.track.keypoints import select_keypoints

        self._require_state()
        return self._keypoint_dict(*select_keypoints(
            self.state, self.consensus_mask_label, self.config.boundaries, N,
            per_instance=per_instance, init_idx=init_idx, pcd=pcd))

    def select_features_rand_v2(self, boundaries, N, per_instance=False, num_per_cam=None):
        """Depth-backprojection keypoint variant (``select_features_rand_v2``,
        ``fusion.py:1543-1606``): ``num_per_cam`` per view, by default
        ``N // num_cam``. ``boundaries`` is unused, as in the reference."""
        from d3fields_tpu_torch.track.keypoints import select_keypoints_from_depth

        self._require_state()
        per_cam = num_per_cam or max(1, N // max(self.num_cam, 1))
        return self._keypoint_dict(*select_keypoints_from_depth(
            self.state, self.consensus_mask_label, per_cam, per_instance=per_instance))

    def rigid_tracking(self, src_feat_info, last_match_pts_list, boundaries, rand_ptcl_num):
        """Reference signature (``fusion.py:1608-1685``)."""
        from d3fields_tpu_torch.track.rigid import rigid_tracking

        self._require_state()
        return rigid_tracking(self.state, src_feat_info, last_match_pts_list,
                              self._boundaries(boundaries), rand_ptcl_num,
                              self.config.tracking)

    def close(self):
        """Drop the backends, the tracker and the state (``Fusion.close``,
        ``fusion.py:1704-1712``)."""
        self.feature_backend = None
        self.mask_backend = None
        self.video_tracker = None
        self.state = None
        self.curr_obs = {}

    def vis_curr_mask(self) -> np.ndarray:
        """Jet-blended per-view instance overlay (``fusion.py:1687-1697``),
        returned as (V, H, W, 3) uint8 instead of shown in a window."""
        from d3fields_tpu_torch.utils.visualization import blend_instance_mask

        self._require_state()
        idx = geometry.onehot_to_instance(self.state.mask.cpu().numpy())
        color = self.curr_obs["color"]
        return np.stack([blend_instance_mask(color[v], idx[v]) for v in range(self.num_cam)])

    # -- pipeline-state checkpoint ------------------------------------------
    def save_state(self, path: str) -> None:
        """Pickle the runtime state: the field state, the consensus labels
        and the video tracker's memory and counters."""
        import os
        import pickle

        st = self.state
        blob = {
            "state": None if st is None else {
                k: getattr(st, k).cpu().numpy()
                for k in ("depth", "pose", "K", "dino_feats", "color", "mask")
                if getattr(st, k) is not None},
            "mu": None if st is None else st.mu,
            "consensus_mask_label": self.consensus_mask_label,
            "semantic_label": self.semantic_label,
            "num_cam": self.num_cam,
            "curr_obs_color": self.curr_obs.get("color"),
        }
        if self.video_tracker is not None:
            core = self.video_tracker.core
            blob["tracker"] = {
                "mem": core.memory_to_host(),
                "curr_ti": core.curr_ti,
                "last_mem_ti": core.last_mem_ti,
                "last_deep_update_ti": getattr(core, "last_deep_update_ti", None),
                "first_mask_loaded": self.video_tracker.first_mask_loaded,
                # so that load_state can rebuild the tracker through
                # video_tracker_factory
                "spec": {"num_views": self.num_cam,
                         "num_objects": self.video_tracker.num_objects,
                         "image_hw": tuple(self.video_tracker.image_hw),
                         "multi_group": core.multi_group},
            }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(blob, f)

    def load_state(self, path: str) -> None:
        """Restore what :meth:`save_state` wrote (a file this program wrote:
        unpickling runs code)."""
        import pickle
        import warnings

        with open(path, "rb") as f:
            blob = pickle.load(f)
        if blob["state"] is not None:
            d = {k: torch.as_tensor(v).to(self.device) for k, v in blob["state"].items()}
            self.state = FieldState(mu=blob["mu"], **d)
        self.consensus_mask_label = blob["consensus_mask_label"]
        self.semantic_label = blob["semantic_label"]
        self.num_cam = blob.get("num_cam") or (
            None if self.state is None else self.state.num_views)
        if blob.get("curr_obs_color") is not None:
            self.curr_obs["color"] = blob["curr_obs_color"]
        t = blob.get("tracker")
        if t is None:
            return
        spec = t["spec"]
        if self.video_tracker is None and self.video_tracker_factory is not None:
            self.video_tracker = self.video_tracker_factory(
                spec["num_views"], spec["num_objects"], tuple(spec["image_hw"]))
        if self.video_tracker is None:
            warnings.warn(
                "load_state: the checkpoint holds video-tracker memory but no tracker "
                "is attached and no video_tracker_factory is configured; tracking "
                "will re-seed instead of resuming", stacklevel=2)
            return
        core = self.video_tracker.core
        if spec["multi_group"] != core.multi_group:
            warnings.warn(
                f"load_state: the checkpoint's tracker had multi_group={spec['multi_group']}, "
                f"the attached one has {core.multi_group}", stacklevel=2)
        core.memory_from_host(t["mem"])
        core.curr_ti = t["curr_ti"]
        core.last_mem_ti = t["last_mem_ti"]
        if t["last_deep_update_ti"] is not None:
            core.last_deep_update_ti = t["last_deep_update_ti"]
        self.video_tracker.first_mask_loaded = t["first_mask_loaded"]

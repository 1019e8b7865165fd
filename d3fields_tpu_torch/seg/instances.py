"""Cross-view instance association and consensus masks (host-side numpy).

Counterpart of ``d3fields_tpu/seg/instances.py``, the reference's L3 layer
(``fusion.py:716-1110``): per-view open-text masks are associated across
cameras by voxel-set IoU (or by point-cloud IoU, ``InstanceConfig.
association == "pcd"``), conflicting voxels resolved by view count and
confidence, instances reordered to query order, and per-view index masks
rewritten to the consensus numbering. Branchy, data-dependent and tiny
beside the field core, so it stays on the host.

Deviations from the reference, as in the JAX package (documented bugfixes):
- duplicate indices in the deletion list are collapsed to a set before
  deletion: the reference's ``sorted(to_delete, reverse=True)`` deletes a
  shifted neighbour when an index appears twice (``fusion.py:1040-1041``);
- a non-first-view background mask with ZERO overlap against every existing
  background instance is dropped: the reference merges it into
  ``instances_info[-1]`` (``max_iou_idx`` still -1, ``fusion.py:836-849``).
  Sub-threshold but nonzero overlaps merge into the best background match
  exactly like the reference.

:func:`erode_mask` is the reference's OpenCV erosion (2x2 here) written in numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from d3fields_tpu_torch.config import Boundaries, InstanceConfig
from d3fields_tpu_torch.fields.geometry import (
    VoxelHash,
    aggregate_masked_points_np,
    voxel_downsample_np,
)


@dataclasses.dataclass
class ViewMasks:
    """Per-view open-text segmentation output (grounded-SAM contract,
    ``utils/grounded_sam.py:404-442``): mask 0 is the background complement."""

    masks: np.ndarray           # (num_inst, H, W) bool
    labels: List[str]           # len num_inst, labels[0] == 'background'
    confidences: np.ndarray     # (num_inst,)


@dataclasses.dataclass
class Instance:
    label: str
    vox_idx: np.ndarray                  # unique voxel flat indices
    conf_per_vox: Dict[int, List[float]]  # voxel -> per-view confidences
    view_mask_idx: Dict[int, int]        # view index -> mask index in that view


def pcd_iou(pcd_1: np.ndarray, pcd_2: np.ndarray, threshold: float):
    """Bi-directional coverage IoU between point clouds
    (``Fusion.pcd_iou``, ``fusion.py:724-741``). ``threshold`` is the point
    MATCH DISTANCE in meters (the reference's ``self.iou_threshold``), not
    an IoU cutoff. Empty inputs return zero IoU (the reference would
    crash; callers drop empty instances downstream)."""
    n1, n2 = pcd_1.shape[0], pcd_2.shape[0]
    if n1 == 0 or n2 == 0:
        e = np.zeros((0,), np.int64)
        return 0.0, 0.0, 0.0, e, e, e, e
    dist = np.linalg.norm(pcd_1[:, None] - pcd_2[None], axis=-1)
    d12, i12 = dist.min(axis=1), dist.argmin(axis=1)
    d21, i21 = dist.min(axis=0), dist.argmin(axis=0)
    iou = ((d12 < threshold).sum() + (d21 < threshold).sum()) / (n1 + n2)
    return (
        iou,
        (d12 < threshold).sum() / n1,
        (d21 < threshold).sum() / n2,
        np.where(d12 < threshold)[0],
        np.where(d21 < threshold)[0],
        i12,
        i21,
    )


def vox_idx_iou(a: np.ndarray, b: np.ndarray) -> Tuple[float, float, float]:
    """Set IoU over voxel indices (``Fusion.vox_idx_iou``, ``fusion.py:794-799``).

    NOTE the secondary ratios are |A|/|A∪B| and |B|/|A∪B| — NOT the
    containment ratios ``pcd_iou`` uses. This intentionally matches the
    reference's voxel variant, whose filter relies on these size-vs-union
    ratios; with disjoint sets the >0.5 trigger fires but the per-voxel
    arbitration is then a no-op (no shared voxels), same as the reference.
    """
    sa, sb = set(a.tolist()), set(b.tolist())
    union = len(sa | sb)
    if union == 0:
        return 0.0, 0.0, 0.0
    return len(sa & sb) / union, len(sa) / union, len(sb) / union


def erode_mask(mask: np.ndarray, size: int = 2) -> np.ndarray:
    """OpenCV's erosion of ``(mask * 255).astype(np.uint8)`` by a ``size`` x
    ``size`` kernel of ones, as a bool mask of what stays above 0.

    The reference erodes with a 2x2 kernel before backprojection
    (``extract_masked_pcd_in_views``, ``fusion.py:1295``) and with a 15x15
    one before depth keypoints (``select_features_rand_v2``). The anchor is
    the kernel's (size // 2, size // 2) element, so ``out[y, x] =
    min(m[y - a:y - a + size, x - a:x - a + size])`` with ``a = size // 2``,
    and a pixel outside the image counts as set (OpenCV's erosion border
    value is the type's maximum).
    """
    m = (np.asarray(mask) * 255).astype(np.uint8) > 0
    a = size // 2
    unset = np.pad(~m, ((a, size - 1 - a), (a, size - 1 - a)))
    # windowed count of unset pixels through an integral image
    c = np.pad(unset.astype(np.int32).cumsum(0).cumsum(1), ((1, 0), (1, 0)))
    H, W = m.shape
    win = c[size:size + H, size:size + W] - c[:H, size:size + W] - c[size:size + H, :W] + c[:H, :W]
    return win == 0


def masked_view_points(
    depth: np.ndarray,
    K: np.ndarray,
    pose44: np.ndarray,
    mask: np.ndarray,
    boundaries: Boundaries,
) -> np.ndarray:
    """Backproject one view's (eroded) mask into bounded world points."""
    return aggregate_masked_points_np(
        depth[None], K[None], pose44[None], masks=erode_mask(mask)[None],
        boundaries=boundaries,
    )


def merge_view(
    instances: List[Instance],
    view_idx: int,
    view: ViewMasks,
    depth: np.ndarray,
    K: np.ndarray,
    pose44: np.ndarray,
    vh: VoxelHash,
    boundaries: Boundaries,
    cfg: InstanceConfig,
) -> List[Instance]:
    """Greedy label+IoU association of one view's masks into the instance
    list (``merge_instances_from_new_view_vox_ver``, ``fusion.py:801-849``)."""
    assert view.labels[0] == "background"
    for j, label in enumerate(view.labels):
        pts = masked_view_points(depth, K, pose44, view.masks[j], boundaries)
        if pts.shape[0] == 0:
            idx_j = np.zeros((0,), np.int64)
        else:
            idx_j = vh.pcd_to_index(pts)
        conf = float(view.confidences[j])

        best_iou, best_k = 0.0, -1
        for k, inst in enumerate(instances):
            if inst.label != label:
                continue
            iou = vox_idx_iou(idx_j, inst.vox_idx)[0]
            if iou > best_iou:
                best_iou, best_k = iou, k

        def merge_into(k):
            inst = instances[k]
            already_contributed = view_idx in inst.view_mask_idx
            inst.vox_idx = np.unique(np.concatenate([inst.vox_idx, idx_j]))
            if not already_contributed:
                for v in set(idx_j.tolist()):
                    inst.conf_per_vox.setdefault(v, []).append(conf)
            inst.view_mask_idx[view_idx] = j

        if best_iou > cfg.vox_merge_iou:
            merge_into(best_k)
        elif label != "background" or view_idx == 0:
            uniq = np.unique(idx_j)
            instances.append(
                Instance(
                    label=label,
                    vox_idx=uniq,
                    conf_per_vox={int(v): [conf] for v in uniq},
                    view_mask_idx={view_idx: j},
                )
            )
        elif best_k >= 0:
            # reference fusion.py:828-849: a non-first-view background mask
            # is never a new instance — it merges into the best background
            # match even below the IoU threshold (its voxels and view vote
            # still count in the filter stage's arbitration)
            merge_into(best_k)
        # else: no background instance overlaps at all. The reference
        # indexes instances_info[max_iou_idx] with max_iou_idx == -1 here,
        # silently polluting whatever instance was appended LAST with
        # background voxels — deliberate deviation: drop the mask instead.
    return instances


def filter_instances(
    instances: List[Instance], cfg: InstanceConfig
) -> List[Instance]:
    """Resolve overlapping instances and drop background/tiny ones
    (``filter_instances_vox_ver``, ``fusion.py:975-1046``)."""
    to_delete: set = set()
    for i, inst_i in enumerate(instances):
        if i in to_delete:
            continue
        for j in range(i + 1, len(instances)):
            if j in to_delete:
                continue
            inst_j = instances[j]
            iou, iou_1, iou_2 = vox_idx_iou(inst_i.vox_idx, inst_j.vox_idx)
            if iou > 0.25 or iou_1 > 0.5 or iou_2 > 0.5:
                # per-voxel arbitration: more contributing views wins; ties by
                # mean confidence
                del_i, del_j = [], []
                for v, confs_i in inst_i.conf_per_vox.items():
                    confs_j = inst_j.conf_per_vox.get(v)
                    if confs_j is None:
                        continue
                    if len(confs_i) < len(confs_j) or (
                        len(confs_i) == len(confs_j)
                        and np.mean(confs_i) < np.mean(confs_j)
                    ):
                        del_i.append(v)
                for v, confs_j in inst_j.conf_per_vox.items():
                    confs_i = inst_i.conf_per_vox.get(v)
                    if confs_i is None:
                        continue
                    if len(confs_j) < len(confs_i) or (
                        len(confs_j) == len(confs_i)
                        and np.mean(confs_j) < np.mean(confs_i)
                    ):
                        del_j.append(v)
                _remove_voxels(inst_i, del_i)
                _remove_voxels(inst_j, del_j)
            if inst_i.vox_idx.shape[0] < 1:
                to_delete.add(i)
            if inst_j.vox_idx.shape[0] < 1:
                to_delete.add(j)

    for i, inst in enumerate(instances):
        if i in to_delete:
            continue
        if inst.label in cfg.background_labels:
            to_delete.add(i)
        elif inst.vox_idx.shape[0] < max(1, cfg.min_points):
            to_delete.add(i)

    # The 'background' instance anchors mask channel 0; dropping it (e.g.
    # when the table lies outside the workspace bounds and its voxel set is
    # empty) would alias instance 0 with unassigned pixels. The reference
    # has this failure mode (fusion.py:1040-1044 deletes empty instances
    # unconditionally); we keep background alive regardless.
    for i, inst in enumerate(instances):
        if inst.label == "background":
            to_delete.discard(i)

    return [inst for i, inst in enumerate(instances) if i not in to_delete]


def _remove_voxels(inst: Instance, voxels: Sequence[int]) -> None:
    if not voxels:
        return
    rm = set(voxels)
    for v in voxels:
        inst.conf_per_vox.pop(v, None)
    inst.vox_idx = np.array(
        [v for v in inst.vox_idx.tolist() if v not in rm], dtype=np.int64
    )


# ---------------------------------------------------------------------------
# pcd-variant association (the reference's alternative to the voxel path)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PcdInstance:
    """Point-cloud-backed instance: per-view downsampled points and a
    single confidence per contributing view (the reference's
    ``instances_info`` dicts in ``merge_instances_from_new_view``,
    ``fusion.py:743-792``)."""

    label: str
    pcd: Dict[int, np.ndarray]      # view index -> (N, 3) world points
    conf: Dict[int, float]          # view index -> mask confidence
    view_mask_idx: Dict[int, int]   # view index -> mask index in that view

    def all_points(self, exclude_view: Optional[int] = None) -> np.ndarray:
        parts = [p for v, p in self.pcd.items() if v != exclude_view]
        if not parts:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(parts, axis=0)

    def point_confs(self) -> np.ndarray:
        parts = [
            np.full(p.shape[0], self.conf[v], np.float32)
            for v, p in self.pcd.items()
        ]
        if not parts:
            return np.zeros((0,), np.float32)
        return np.concatenate(parts)


def merge_view_pcd(
    instances: List[PcdInstance],
    view_idx: int,
    view: ViewMasks,
    depth: np.ndarray,
    K: np.ndarray,
    pose44: np.ndarray,
    boundaries: Boundaries,
    cfg: InstanceConfig,
) -> List[PcdInstance]:
    """Greedy label+pcd-IoU association of one view's masks
    (``merge_instances_from_new_view``, ``fusion.py:743-792``). Masked
    points are voxel-downsampled at 0.01 m like the reference's
    ``extract_masked_pcd_in_views(downsample=True)``
    (``draw_utils.py:398-403``)."""
    assert view.labels[0] == "background"
    for j, label in enumerate(view.labels):
        pts = masked_view_points(depth, K, pose44, view.masks[j], boundaries)
        pts = voxel_downsample_np(pts.astype(np.float32), 0.01)
        conf = float(view.confidences[j])

        best_iou, best_k = 0.0, -1
        for k, inst in enumerate(instances):
            if inst.label != label:
                continue
            iou = pcd_iou(pts, inst.all_points(), cfg.iou_threshold)[0]
            if iou > best_iou:
                best_iou, best_k = iou, k

        if best_iou <= cfg.pcd_merge_iou and (
            label != "background" or view_idx == 0
        ):
            instances.append(PcdInstance(
                label=label, pcd={view_idx: pts}, conf={view_idx: conf},
                view_mask_idx={view_idx: j},
            ))
        elif best_k >= 0:
            # Below-threshold background masks merge into the best
            # background match like the voxel path (same deviation from the
            # reference's max_iou_idx == -1 indexing bug, fusion.py:776).
            inst = instances[best_k]
            if view_idx in inst.pcd:
                # this view already contributed a mask: keep whichever has
                # the higher IoU against the OTHER views' points
                # (fusion.py:777-787)
                other = inst.all_points(exclude_view=view_idx)
                if other.shape[0] > 0:
                    curr_iou = pcd_iou(pts, other, cfg.iou_threshold)[0]
                    prev_iou = pcd_iou(pts, inst.pcd[view_idx],
                                       cfg.iou_threshold)[0]
                    if curr_iou <= prev_iou:
                        continue
            inst.pcd[view_idx] = pts
            inst.conf[view_idx] = conf
            inst.view_mask_idx[view_idx] = j
        # else: no same-label instance exists at all -> drop the mask
    return instances


def del_partial_pcd(inst: PcdInstance, pcd_idx: np.ndarray) -> PcdInstance:
    """Delete points addressed by indices into the concatenated per-view
    cloud (``Fusion.del_partial_pcd``, ``fusion.py:851-861``)."""
    start = 0
    for v in list(inst.pcd.keys()):
        end = start + inst.pcd[v].shape[0]
        in_view = pcd_idx[(pcd_idx >= start) & (pcd_idx < end)] - start
        inst.pcd[v] = np.delete(inst.pcd[v], in_view, axis=0)
        start = end
    return inst


def filter_instances_pcd(
    instances: List[PcdInstance], num_cams: int, cfg: InstanceConfig
) -> List[PcdInstance]:
    """Overlap resolution + background/small filtering for the pcd variant
    (``Fusion.filter_instances``, ``fusion.py:866-974``). Same
    duplicate-deletion bugfix as the voxel path (set, not list)."""
    to_delete: set = set()
    for i, inst_i in enumerate(instances):
        if i in to_delete:
            continue
        for j in range(i + 1, len(instances)):
            if j in to_delete:
                continue
            inst_j = instances[j]
            pcd_i, conf_i = inst_i.all_points(), inst_i.point_confs()
            pcd_j, conf_j = inst_j.all_points(), inst_j.point_confs()
            # the reference hard-codes the 5 mm match distance here
            # (fusion.py:884), independent of self.iou_threshold
            iou, iou_1, iou_2, ov1, ov2, m12, m21 = pcd_iou(
                pcd_i, pcd_j, threshold=0.005
            )
            if iou > 0.25:
                nv_i, nv_j = len(inst_i.view_mask_idx), len(inst_j.view_mask_idx)
                if nv_i > nv_j:
                    to_delete.add(j)
                elif nv_j > nv_i:
                    to_delete.add(i)
                else:
                    # per-point arbitration by confidence (fusion.py:916-926)
                    del_i = ov1[conf_i[ov1] < conf_j[m12[ov1]]]
                    del_j = ov2[conf_j[ov2] < conf_i[m21[ov2]]]
                    del_partial_pcd(inst_i, del_i)
                    del_partial_pcd(inst_j, del_j)
            elif iou_1 > 0.5:  # instance_i mostly inside instance_j
                nv_i, nv_j = len(inst_i.view_mask_idx), len(inst_j.view_mask_idx)
                if (inst_j.label == "background" and nv_i < num_cams // 2) or (
                    inst_j.label != "background" and nv_i < nv_j // 2
                ):
                    to_delete.add(i)
                else:
                    del_partial_pcd(inst_j, ov2)
            elif iou_2 > 0.5:  # instance_j mostly inside instance_i
                nv_i, nv_j = len(inst_i.view_mask_idx), len(inst_j.view_mask_idx)
                if (inst_i.label == "background" and nv_j < num_cams // 2) or (
                    inst_i.label != "background" and nv_j < nv_i // 2
                ):
                    to_delete.add(j)
                else:
                    del_partial_pcd(inst_i, ov1)
            if inst_i.all_points().shape[0] < cfg.pcd_min_points:
                to_delete.add(i)
            if inst_j.all_points().shape[0] < cfg.pcd_min_points:
                to_delete.add(j)

    for i, inst in enumerate(instances):
        if i in to_delete:
            continue
        if inst.label in cfg.background_labels:
            to_delete.add(i)
        elif inst.all_points().shape[0] < cfg.pcd_min_points:
            to_delete.add(i)

    # keep the channel-0 background anchor alive (same deviation as the
    # voxel path; see filter_instances above)
    for i, inst in enumerate(instances):
        if inst.label == "background":
            to_delete.discard(i)

    return [inst for i, inst in enumerate(instances) if i not in to_delete]


def reorder_instances(
    instances: List[Instance], query_texts: Sequence[str]
) -> List[Instance]:
    """Stable reorder to ['background'] + query order
    (``reorder_instances``, ``fusion.py:1048-1055``)."""
    out = []
    for q in ["background"] + list(query_texts):
        out.extend([inst for inst in instances if inst.label == q])
    return out


def rewrite_index_masks(
    instances: List[Instance], views: List[ViewMasks], image_hw: Tuple[int, int]
) -> np.ndarray:
    """Per-view uint8 instance-index masks from the consensus numbering
    (``swap_instance_mask``, ``fusion.py:1057-1066``)."""
    V = len(views)
    H, W = image_hw
    out = np.zeros((V, H, W), np.uint8)
    for v in range(V):
        for inst_idx, inst in enumerate(instances):
            j = inst.view_mask_idx.get(v)
            if j is None:
                continue
            out[v][views[v].masks[j]] = inst_idx
    return out


def align_instance_masks(
    views: List[ViewMasks],
    depths: np.ndarray,
    Ks: np.ndarray,
    poses44: np.ndarray,
    queries: Sequence[str],
    boundaries: Boundaries,
    cfg: Optional[InstanceConfig] = None,
    expected_labels: Optional[Sequence[str]] = None,
) -> Tuple[np.ndarray, List[str], List[Instance]]:
    """Full consensus pipeline (``align_instance_mask_v3``, ``fusion.py:1068-1098``).

    ``cfg.association`` selects the voxel-set variant (the one the
    reference invokes at ``fusion.py:1090``) or the pcd variant
    (``fusion.py:743-792,866-974``). Returns (index_masks (V, H, W) uint8,
    consensus labels, instances).
    """
    cfg = cfg or InstanceConfig()
    if cfg.association == "pcd":
        instances: List[PcdInstance] = []
        for v, view in enumerate(views):
            instances = merge_view_pcd(
                instances, v, view, depths[v], Ks[v], poses44[v], boundaries,
                cfg,
            )
        instances = filter_instances_pcd(instances, len(views), cfg)
        instances = reorder_instances(instances, queries)
        index_masks = rewrite_index_masks(instances, views, depths.shape[1:])
        labels = [inst.label for inst in instances]
        if expected_labels is not None and labels != list(expected_labels):
            print(f"consensus mask label {labels} != expected "
                  f"{list(expected_labels)}")
        return index_masks, labels, instances
    vh = VoxelHash.from_boundaries(boundaries, cfg.voxel_size)
    instances: List[Instance] = []
    for v, view in enumerate(views):
        instances = merge_view(
            instances, v, view, depths[v], Ks[v], poses44[v], vh, boundaries, cfg
        )
    instances = filter_instances(instances, cfg)
    instances = reorder_instances(instances, queries)
    index_masks = rewrite_index_masks(instances, views, depths.shape[1:])
    labels = [inst.label for inst in instances]
    if expected_labels is not None and labels != list(expected_labels):
        print(f"consensus mask label {labels} != expected {list(expected_labels)}")
    return index_masks, labels, instances


def align_with_prev_mask(new_onehot: np.ndarray,
                         prev_onehot: np.ndarray) -> np.ndarray:
    """Relabel a new one-hot mask by max pixel intersection with the
    previous frame's mask, per view (``align_with_prev_mask``,
    ``fusion.py:1100-1110``): output channel j of view v is the new channel
    with the largest overlap against previous channel j.
    """
    out = np.zeros_like(new_onehot)
    V, _, _, NI = new_onehot.shape
    for v in range(V):
        prev = (prev_onehot[v] > 0.5).astype(np.int64)   # (H, W, NI)
        new = (new_onehot[v] > 0.5).astype(np.int64)
        inter = np.einsum("hwj,hwk->jk", prev, new)      # (NI_prev, NI_new)
        best = inter.argmax(axis=1)
        # a vanished object (all-zero row) argmaxes to channel 0 and would
        # copy the whole BACKGROUND into the object slot (the reference has
        # this bug in its unused path, fusion.py:1106-1109); keep the
        # object's own new channel instead
        best = np.where(inter.max(axis=1) > 0, best, np.arange(NI))
        out[v] = new_onehot[v][..., best]
    return out

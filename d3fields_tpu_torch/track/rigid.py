"""Gradient-based rigid keypoint tracking.

Counterpart of ``d3fields_tpu/track/rigid.py``, the reference's
``Fusion.rigid_tracking`` (``fusion.py:1608-1685``): per-instance SE(3)
motion (translation t, axis-angle log_r) is optimized with Adam against

  loss = mean(|feat(x) - src_feat| * valid)
       + dist_w * mean(clamp(dist(x), min=0))
       + reg_w * (|t|_F + |log_r|_F)
       (+ oob_w * out-of-bounds hinge, weight 0 in the reference)

with gradients from torch autograd through the differentiable field query
``fusion.eval_field``. The JAX package's ``lax.scan`` over optimizer steps
is a plain loop here (:func:`rigid_tracking_steps`), on the state's device
with no host synchronisation inside it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from d3fields_tpu_torch.config import TrackingConfig
from d3fields_tpu_torch.fields.fusion import eval_field
from d3fields_tpu_torch.fields.state import FieldState
from d3fields_tpu_torch.ops.so3 import rigid_transform_points
from d3fields_tpu_torch.utils.profiling import tracer

Tensor = torch.Tensor


def _safe_norm(x: Tensor, dim=None, eps: float = 1e-12) -> Tensor:
    """L2 norm with a zero gradient at 0, as the JAX package writes it
    (``torch.linalg.norm``'s gradient at 0 differs)."""
    if dim is None:
        return torch.sqrt(torch.sum(x * x) + eps)
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


def tracking_loss(
    params: Dict[str, Tensor],
    state: FieldState,
    src_feats: Tensor,
    last_pts: Tensor,
    bounds_lo: Tensor,
    bounds_hi: Tensor,
    cfg: TrackingConfig,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Loss over all instances; returns (scalar, aux dict)."""
    curr = rigid_transform_points(last_pts, params["log_r"], params["t"])
    flat = curr.reshape(-1, 3)
    out = eval_field(state, flat, ("dino_feats",))
    valid = out["valid_mask"].to(flat.dtype)
    feat_loss = torch.mean(_safe_norm(out["dino_feats"] - src_feats, dim=-1) * valid)
    dist = out["dist"] * valid
    dist_loss = cfg.dist_weight * torch.mean(torch.clamp(dist, min=0.0))
    reg_loss = cfg.reg_weight * (_safe_norm(params["t"]) + _safe_norm(params["log_r"]))
    oob = (
        torch.clamp(flat - bounds_hi, min=0.0).sum(-1)
        + torch.clamp(bounds_lo - flat, min=0.0).sum(-1)
    )
    oob_loss = cfg.oob_weight * torch.mean(oob)
    loss = feat_loss + dist_loss + reg_loss + oob_loss
    aux = {
        "feat_loss": feat_loss,
        "dist_loss": dist_loss,
        "reg_loss": reg_loss,
        "oob_loss": oob_loss,
        "match_pts": curr,
    }
    return loss, aux


BETAS = (0.9, 0.999)


def optax_lr_factor(step: int) -> float:
    """The factor that turns ``torch.optim.Adam``'s update at ``step``
    (1-based) into ``optax.adam``'s, which the JAX package and its goldens
    use. Both divide by the bias corrections ``1 - beta**step``, but optax
    takes them in float32 and torch in float64. At step 1 that makes
    optax's update smaller by 6.7e-6 of itself; without the factor, the
    10-step loss history of ``vis_tracking``'s fast golden differs by 3e-5
    on a CPU, three times its tolerance. The factor is exact up to the
    eps term of the denominator."""
    b1, b2 = BETAS
    f32 = np.float32
    bc1 = float(f32(1) - np.power(f32(b1), f32(step)))
    bc2 = float(f32(1) - np.power(f32(b2), f32(step)))
    return (1 - b1 ** step) / bc1 * ((bc2 / (1 - b2 ** step)) ** 0.5)


def rigid_tracking_steps(
    state: FieldState,
    src_feats: Tensor,
    last_pts: Tensor,
    bounds_lo: Tensor,
    bounds_hi: Tensor,
    cfg: TrackingConfig,
) -> Dict[str, Tensor]:
    """``cfg.iters`` Adam steps from t = log_r = 0; the counterpart of the
    JAX package's ``rigid_tracking_jit``, with its signature.

    Each step records its forward's points and params before the update:
    the reference returns the last iteration's forward, i.e. the params
    after ``iters - 1`` updates (``fusion.py:1643-1665``). Returns
    'match_pts' (I, P, 3), 't' and 'log_r' (I, 3) and 'loss_history'
    (iters, 4): feat/dist/reg/oob, all tensors on the state's device.
    """
    num_inst = last_pts.shape[0]
    t = torch.zeros((num_inst, 3), dtype=last_pts.dtype, device=last_pts.device,
                    requires_grad=True)
    log_r = torch.zeros_like(t, requires_grad=True)
    params = {"t": t, "log_r": log_r}
    opt = torch.optim.Adam([t, log_r], lr=cfg.lr, betas=BETAS, eps=1e-8)
    losses, match, last = [], None, None
    with tracer.span("track.rigid"):
        for step in range(1, cfg.iters + 1):
            with tracer.span("track.step"):
                opt.param_groups[0]["lr"] = cfg.lr * optax_lr_factor(step)
                opt.zero_grad(set_to_none=True)
                loss, aux = tracking_loss(params, state, src_feats, last_pts, bounds_lo,
                                          bounds_hi, cfg)
                loss.backward()
                losses.append(torch.stack([aux["feat_loss"], aux["dist_loss"],
                                           aux["reg_loss"], aux["oob_loss"]]).detach())
                match = aux["match_pts"].detach()
                last = (t.detach().clone(), log_r.detach().clone())
                opt.step()
    return {
        "match_pts": match,
        "t": last[0],
        "log_r": last[1],
        "loss_history": torch.stack(losses),
    }


def boundary_vectors(boundaries, device) -> Tuple[Tensor, Tensor]:
    """Boundaries (config object or dict) -> (lo, hi) float32 vectors on
    ``device`` in the axis order :func:`rigid_tracking_steps` expects."""
    b = boundaries.as_dict() if hasattr(boundaries, "as_dict") else boundaries
    lo = torch.tensor([b["x_lower"], b["y_lower"], b["z_lower"]], dtype=torch.float32,
                      device=device)
    hi = torch.tensor([b["x_upper"], b["y_upper"], b["z_upper"]], dtype=torch.float32,
                      device=device)
    return lo, hi


def stack_keypoints(src_feats_list, src_pts_list, device) -> Tuple[Tensor, Tensor]:
    """Per-instance keypoint lists -> the :func:`rigid_tracking_steps`
    layout on ``device``: (sum_P, D) concatenated source features and
    (I, P, 3) stacked float32 points (all instances must share P)."""
    feats = torch.as_tensor(np.concatenate([np.asarray(f) for f in src_feats_list], axis=0))
    pts = torch.as_tensor(np.stack([np.asarray(p) for p in src_pts_list]).astype(np.float32))
    return feats.to(device), pts.to(device)


def rigid_tracking(
    state: FieldState,
    src_feat_info: Dict[str, Dict],
    last_match_pts_list,
    boundaries,
    rand_ptcl_num: int,
    cfg: TrackingConfig = TrackingConfig(),
) -> Dict:
    """Reference-compatible wrapper (``fusion.py:1608-1685`` contract):
    ``src_feat_info`` maps instance name -> {'src_feats': (P, D)};
    ``last_match_pts_list`` is a list of (P, 3) arrays; returns
    {'match_pts_list': list of (P, 3) numpy arrays, 't', 'log_r',
    'loss_history'}.
    """
    src_feats, last = stack_keypoints(
        [src_feat_info[k]["src_feats"] for k in src_feat_info],
        last_match_pts_list, state.device,
    )
    if last.shape[1] != rand_ptcl_num:
        raise ValueError(f"{last.shape[1]} points per instance, expected {rand_ptcl_num}")
    lo, hi = boundary_vectors(boundaries, state.device)
    out = rigid_tracking_steps(state, src_feats, last, lo, hi, cfg)
    match = out["match_pts"].cpu().numpy()
    return {
        "match_pts_list": [match[i] for i in range(match.shape[0])],
        "t": out["t"].cpu().numpy(),
        "log_r": out["log_r"].cpu().numpy(),
        "loss_history": out["loss_history"].cpu().numpy(),
    }

"""The f-BRS click predictor and controller: the reference GUI's click pipeline.

Counterpart of ``d3fields_tpu/models/fbrs/predictor.py`` (the reference's
``fbrs/inference``: ``predictors/base.py``, ``predictors/brs.py``
``HRNetFeatureBRSPredictor`` with insertion 'A', the f-BRS-B mode the GUI
configures, ``fbrs_controller.py:20``; the zoom-in, flip and sigmoid
transforms; the clicker; ``InteractiveController`` / ``FBRSController``).

f-BRS ("backpropagating refinement") fits a per-channel (scale, bias) of
the cached HRNet features, so each L-BFGS evaluation re-runs only the OCR
head. :func:`brs_loss` is that loss as a torch function of the (scale,
bias) vector, the one leaf with a gradient; each evaluation takes its value
and gradient from one ``torch.autograd.grad`` and copies them, with the
early-stop statistics, to the host in one transfer, where scipy's
``fmin_l_bfgs_b`` drives the search as in the reference
(``brs_functors.py:42-80``). That copy is a host sync per evaluation, as
in the reference; :attr:`FbrsPredictor.evaluations` counts them per click.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from d3fields_tpu_torch.models.fbrs.hrnet import resize_ac
from d3fields_tpu_torch.models.fbrs.model import FbrsModel
from d3fields_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Click:
    is_positive: bool
    coords: Tuple[float, float]  # (y, x)


class Clicker:
    """Click history with undo (``inference/clicker.py:10-107``, the subset
    without ground truth that the GUI uses)."""

    def __init__(self):
        self.clicks_list: List[Click] = []

    def add_click(self, click: Click):
        self.clicks_list.append(click)

    def get_clicks(self, clicks_limit: Optional[int] = None) -> List[Click]:
        return self.clicks_list[:clicks_limit]

    def reset_clicks(self):
        self.clicks_list = []

    def get_state(self) -> List[Click]:
        return list(self.clicks_list)

    def set_state(self, state: List[Click]):
        self.clicks_list = list(state)

    def __len__(self):
        return len(self.clicks_list)


# ---------------------------------------------------------------------------
# zoom-in (transforms/zoom_in.py)
# ---------------------------------------------------------------------------

def _bbox_from_mask(mask: np.ndarray) -> Tuple[int, int, int, int]:
    rows, cols = np.any(mask, axis=1), np.any(mask, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return rmin, rmax, cmin, cmax


def _expand_bbox(bbox, ratio, min_size):
    rmin, rmax, cmin, cmax = bbox
    rc, cc = 0.5 * (rmin + rmax), 0.5 * (cmin + cmax)
    h = max(ratio * (rmax - rmin + 1), min_size)
    w = max(ratio * (cmax - cmin + 1), min_size)
    return (int(round(rc - 0.5 * h)), int(round(rc + 0.5 * h)),
            int(round(cc - 0.5 * w)), int(round(cc + 0.5 * w)))


def _clamp_bbox(bbox, rmin, rmax, cmin, cmax):
    return (max(bbox[0], rmin), min(bbox[1], rmax), max(bbox[2], cmin), min(bbox[3], cmax))


def _bbox_iou(b1, b2):
    h = min(b1[1], b2[1]) - max(b1[0], b2[0]) + 1
    w = min(b1[3], b2[3]) - max(b1[2], b2[2]) + 1
    if h <= 0 or w <= 0:
        return 0.0
    a1 = (b1[1] - b1[0] + 1) * (b1[3] - b1[2] + 1)
    a2 = (b2[1] - b2[0] + 1) * (b2[3] - b2[2] + 1)
    return h * w / (a1 + a2 - h * w)


class ZoomIn:
    """Crop-and-refine around the current object (``zoom_in.py:9-160``):
    once the clicks exceed ``skip_clicks`` and a mask exists, the network
    runs on the expanded tight crop resized so that its long side is
    ``target_size``; predictions are pasted back into the full frame."""

    def __init__(self, target_size=480, skip_clicks=1, expansion_ratio=1.4, min_crop_size=200,
                 recompute_thresh_iou=0.5, prob_thresh=0.5):
        self.target_size = target_size
        self.skip_clicks = skip_clicks
        self.expansion_ratio = expansion_ratio
        self.min_crop_size = min_crop_size
        self.recompute_thresh_iou = recompute_thresh_iou
        self.prob_thresh = prob_thresh
        self.reset()

    def reset(self):
        self._input_hw = None
        self._object_roi = None
        self._prev_probs = None   # numpy (1, H, W)
        self._roi_image = None
        self.image_changed = False

    def transform(self, image: Tensor, clicks: List[Click]):
        """image (1, 3, H, W) -> (the image the network sees, its clicks)."""
        self.image_changed = False
        if len(clicks) <= self.skip_clicks:
            return image, clicks
        self._input_hw = tuple(image.shape[-2:])
        roi = None
        if self._prev_probs is not None:
            mask = self._prev_probs[0] > self.prob_thresh
            for c in clicks:
                if c.is_positive:
                    mask[int(c.coords[0]), int(c.coords[1])] = True
            if mask.any():
                bbox = _expand_bbox(_bbox_from_mask(mask), self.expansion_ratio,
                                    self.min_crop_size)
                H, W = mask.shape
                roi = _clamp_bbox(bbox, 0, H - 1, 0, W - 1)
        if roi is None:
            return image, clicks
        if (self._object_roi is None or not self._clicks_inside(self._object_roi, clicks)
                or _bbox_iou(roi, self._object_roi) < self.recompute_thresh_iou):
            self._object_roi = roi
            rmin, rmax, cmin, cmax = roi
            crop = image[:, :, rmin:rmax + 1, cmin:cmax + 1]
            scale = self.target_size / max(crop.shape[2], crop.shape[3])
            size = (int(round(crop.shape[2] * scale)), int(round(crop.shape[3] * scale)))
            self._roi_image = resize_ac(crop, size)
            self.image_changed = True
        return self._roi_image, self._transform_clicks(clicks)

    @staticmethod
    def _clicks_inside(roi, clicks):
        return all(roi[0] <= c.coords[0] < roi[1] and roi[2] <= c.coords[1] < roi[3]
                   for c in clicks if c.is_positive)

    def _transform_clicks(self, clicks):
        rmin, rmax, cmin, cmax = self._object_roi
        ch, cw = self._roi_image.shape[-2:]
        return [Click(c.is_positive, (ch * (c.coords[0] - rmin) / (rmax - rmin + 1),
                                      cw * (c.coords[1] - cmin) / (cmax - cmin + 1)))
                for c in clicks]

    def inv_transform(self, prob: np.ndarray) -> np.ndarray:
        """(1, h, w) roi probabilities -> full-frame ones (pasted into zeros)."""
        if self._object_roi is None:
            self._prev_probs = prob
            return prob
        rmin, rmax, cmin, cmax = self._object_roi
        up = resize_ac(torch.from_numpy(np.ascontiguousarray(prob))[None],
                       (rmax - rmin + 1, cmax - cmin + 1))[0]
        full = np.zeros((1,) + tuple(self._input_hw), np.float32)
        full[:, rmin:rmax + 1, cmin:cmax + 1] = up.numpy()
        self._prev_probs = full
        return full

    def check_possible_recalculation(self) -> bool:
        if self._prev_probs is None or self._object_roi is not None or self.skip_clicks > 0:
            return False
        mask = self._prev_probs[0] > self.prob_thresh
        if not mask.any():
            return False
        H, W = mask.shape
        roi = _clamp_bbox(_expand_bbox(_bbox_from_mask(mask), self.expansion_ratio,
                                       self.min_crop_size), 0, H - 1, 0, W - 1)
        return _bbox_iou(roi, (0, H - 1, 0, W - 1)) < 0.5

    def get_state(self):
        return (self._input_hw, self._object_roi, self._prev_probs, self._roi_image,
                self.image_changed)

    def set_state(self, state):
        (self._input_hw, self._object_roi, self._prev_probs, self._roi_image,
         self.image_changed) = state


# ---------------------------------------------------------------------------
# predictor
# ---------------------------------------------------------------------------

def _points_array(clicks: List[Click], limit: int) -> np.ndarray:
    """(1, 2n, 2) reference click layout (``base.py:76-96``)."""
    clicks = clicks[:limit]
    pos = [c.coords for c in clicks if c.is_positive]
    neg = [c.coords for c in clicks if not c.is_positive]
    n = max(1, len(pos), len(neg))
    pos = pos + [(-1.0, -1.0)] * (n - len(pos))
    neg = neg + [(-1.0, -1.0)] * (n - len(neg))
    return np.asarray([pos + neg], np.float32)


def _click_masks(clicks: List[Click], hw, radius=1):
    """3x3 positive and negative click stamps (``brs.py:24-44``)."""
    H, W = hw
    pos = np.zeros((1, H, W), np.float32)
    neg = np.zeros((1, H, W), np.float32)
    for c in clicks:
        y, x = int(round(c.coords[0])), int(round(c.coords[1]))
        tgt = pos if c.is_positive else neg
        tgt[0, max(y - radius, 0):y + radius + 1, max(x - radius, 0):x + radius + 1] = 1.0
    return pos, neg


def brs_loss(model: FbrsModel, feats: Tensor, sb: Tensor, pos: Tensor, neg: Tensor,
             out_hw: Tuple[int, int], reg_weight: float = 1e-3, reg_bias_weight: float = 10.0):
    """The f-BRS-B loss of the (scale, bias) vector ``sb`` (2C,) over every
    (possibly flipped) batch row with its own click stamps ``pos``/``neg``
    (B, H, W): the reference's ``BRSMaskLoss`` with ``flip_average=False``
    (``brs_losses.py:6-26``) plus the L2 regulariser. Returns (loss,
    logits (B, H, W), probabilities, max |positive residual|, max
    |negative residual|)."""
    scale, bias = sb.chunk(2)
    reg = reg_weight * ((scale ** 2).sum() + reg_bias_weight * (bias ** 2).sum())
    mod = feats * (1.0 + scale)[None, :, None, None] + bias[None, :, None, None]
    logits = model.head_from_feats(mod, out_hw)[:, 0]
    prob = torch.sigmoid(logits)
    pos_diff = (1.0 - prob) * pos
    neg_diff = prob * neg
    eps = 1e-5
    loss = ((pos_diff ** 2).sum() / (pos.sum() + eps)
            + (neg_diff ** 2).sum() / (neg.sum() + eps) + reg)
    return loss, logits, prob, pos_diff.abs().amax(), neg_diff.abs().amax()


class FbrsPredictor:
    """f-BRS-B prediction over the cached HRNet features (``brs.py:141-231``).

    ``brs=False`` gives the NoBRS predictor (a plain forward).
    ``with_flip`` doubles the batch with a mirrored copy and averages the
    logits at the end (``AddHorizontalFlip``). Each click's L-BFGS-B search
    fits a per-channel (scale, bias) of the cached features."""

    def __init__(self, model: FbrsModel, *, brs=True, with_flip=True,
                 zoom_in: Optional[ZoomIn] = None, net_clicks_limit=8,
                 optimize_after_n_clicks=1, prob_thresh=0.5, reg_weight=1e-3,
                 reg_bias_weight=10.0, min_iou_diff=1e-3, maxfun=20, device=None):
        """``model`` moves to ``device`` (CUDA unless the caller names
        another)."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.cfg = model.cfg
        self.brs = brs
        self.with_flip = with_flip
        self.zoom_in = zoom_in
        self.net_clicks_limit = net_clicks_limit
        self.optimize_after_n_clicks = optimize_after_n_clicks
        self.prob_thresh = prob_thresh
        self.reg_weight = reg_weight
        self.reg_bias_weight = reg_bias_weight
        self.min_iou_diff = min_iou_diff
        self.maxfun = maxfun
        self.num_channels = self.cfg.backbone.feats_channels
        self._image = None
        self.opt_data = None
        self.input_data = None
        self.evaluations = 0  # L-BFGS evaluations of the last prediction

    def set_input_image(self, image: np.ndarray):
        """image (H, W, 3) float32, normalised as the GUI feeds it
        (``fbrs_controller.py:36-40``)."""
        if self.zoom_in is not None:
            self.zoom_in.reset()
        img = torch.as_tensor(np.asarray(image, np.float32), device=self.device)
        self._image = img.permute(2, 0, 1)[None].contiguous()
        self.opt_data = None
        self.input_data = None

    def get_prediction(self, clicker: Clicker) -> np.ndarray:
        """The (H, W) probabilities for the clicker's clicks."""
        clicks = clicker.get_clicks()
        image, tclicks, changed = self._image, clicks, False
        if self.zoom_in is not None:
            image, tclicks = self.zoom_in.transform(image, clicks)
            changed = self.zoom_in.image_changed
        prob = self._predict(image, tclicks, changed)
        if self.zoom_in is not None:
            prob = self.zoom_in.inv_transform(prob)
            if self.zoom_in.check_possible_recalculation():
                return self.get_prediction(clicker)
        return prob[0]

    def val_grad(self, sb, pos: Tensor, neg: Tensor, out_hw):
        """(loss, gradient wrt ``sb``, logits, probabilities, max |positive
        residual|, max |negative residual|) at ``sb`` over the cached
        features: one ``torch.autograd.grad``."""
        x = torch.as_tensor(np.asarray(sb, np.float32), device=self.device).requires_grad_(True)
        with torch.enable_grad():
            loss, logits, prob, fpos, fneg = brs_loss(
                self.model, self.input_data, x, pos, neg, tuple(out_hw), self.reg_weight,
                self.reg_bias_weight)
            (grad,) = torch.autograd.grad(loss, x)
        return loss.detach(), grad, logits.detach(), prob.detach(), fpos.detach(), fneg.detach()

    @torch.no_grad()
    def _predict(self, image: Tensor, clicks: List[Click], image_changed: bool) -> np.ndarray:
        """(1, h, w) probabilities at ``image``'s resolution."""
        hw = tuple(image.shape[-2:])
        pts = _points_array(clicks, self.net_clicks_limit)
        if self.with_flip:
            flipped = pts.copy()
            valid = flipped.max(axis=-1) >= 0
            flipped[..., 1] = np.where(valid, hw[1] - 1 - flipped[..., 1], flipped[..., 1])
            pts = np.concatenate([pts, flipped], axis=0)
            image = torch.cat([image, image.flip(-1)], dim=0)
        pts_t = torch.as_tensor(pts, device=self.device)
        self.evaluations = 0
        if not self.brs:
            return self._finalize(self.model(image, pts_t)[:, 0])

        pos, neg = _click_masks(clicks, hw)
        if self.with_flip:  # each flipped row gets mirrored click stamps
            pos = np.concatenate([pos, pos[:, :, ::-1]], axis=0)
            neg = np.concatenate([neg, neg[:, :, ::-1]], axis=0)
        if self.opt_data is None:
            self.opt_data = np.zeros((2 * self.num_channels,), np.float32)
        if (len(clicks) <= self.net_clicks_limit or image_changed or self.input_data is None
                or tuple(self.input_data.shape[-2:]) != (hw[0] // 4, hw[1] // 4)):
            self.input_data = self.model.backbone_feats(image, pts_t)
        pos_t = torch.as_tensor(pos, device=self.device)
        neg_t = torch.as_tensor(neg, device=self.device)
        best = {"loss": None, "logits": None}
        last_mask = [None]

        def fun(x):
            self.evaluations += 1
            loss, grad, logits, prob, fpos, fneg = self.val_grad(x, pos_t, neg_t, hw)
            cur = prob > self.prob_thresh
            if last_mask[0] is not None:
                inter = (cur & last_mask[0]).sum(dim=(1, 2))
                union = (cur | last_mask[0]).sum(dim=(1, 2))
            else:
                inter = union = torch.zeros(cur.shape[0], dtype=torch.int64, device=self.device)
            # one copy to the host: loss, residual maxima, IoU counts, gradient
            host = torch.cat([torch.stack([loss, fpos, fneg]).double(), inter.double(),
                              union.double(), grad.double()]).cpu().numpy()
            n = cur.shape[0]
            f, fpos, fneg = (float(v) for v in host[:3])
            inter, union, g = host[3:3 + n], host[3 + n:3 + 2 * n], host[3 + 2 * n:]
            if best["loss"] is None or f < best["loss"]:
                best["loss"], best["logits"] = f, logits
            # the reference's early stops (brs_functors.py:63-74)
            if fpos < 1 - self.prob_thresh and fneg < self.prob_thresh:
                return f, np.zeros_like(x)
            if last_mask[0] is not None and self.min_iou_diff > 0:
                # per-row IoU with the previous step, mean over rows
                ious = inter[union > 0] / union[union > 0]
                if ious.size and ious.mean() > 1 - self.min_iou_diff:
                    return f, np.zeros_like(x)
            last_mask[0] = cur
            return f, g

        if len(clicks) > self.optimize_after_n_clicks:
            from scipy.optimize import fmin_l_bfgs_b

            x, _, _ = fmin_l_bfgs_b(fun, self.opt_data.astype(np.float64), m=20, factr=0,
                                    pgtol=1e-8, maxfun=self.maxfun, maxiter=2 * self.maxfun)
            self.opt_data = x.astype(np.float32)
        if best["logits"] is not None:
            logits = best["logits"]
        else:
            logits = self.val_grad(self.opt_data, pos_t, neg_t, hw)[2]
        return self._finalize(logits)

    def _finalize(self, logits: Tensor) -> np.ndarray:
        """Flip-average the logits, then the sigmoid: the reference's
        inverse-transform order (reversed [zoom, sigmoid, flip],
        ``base.py:46-49``)."""
        if self.with_flip:
            logits = 0.5 * (logits[:1] + logits[1:2].flip(-1))
        return torch.sigmoid(logits).cpu().numpy()

    def get_states(self):
        zoom = self.zoom_in.get_state() if self.zoom_in is not None else None
        return {"opt_data": None if self.opt_data is None else self.opt_data.copy(),
                "zoom": zoom}

    def set_states(self, states):
        self.opt_data = states["opt_data"]
        if self.zoom_in is not None:
            self.zoom_in.set_state(states["zoom"])


class FBRSController:
    """The click controller with undo, the GUI's click backend
    (``fbrs_controller.py`` + ``fbrs/controller.py``): anchor an image, feed
    (x, y, positive) clicks, get thresholded masks back."""

    def __init__(self, model: FbrsModel, *, brs=True, with_flip=True, target_size=480,
                 prob_thresh=0.5, device=None):
        self.predictor = FbrsPredictor(
            model, brs=brs, with_flip=with_flip,
            zoom_in=ZoomIn(target_size=target_size, skip_clicks=1, expansion_ratio=1.4),
            prob_thresh=prob_thresh, device=device)
        self.prob_thresh = prob_thresh
        self.clicker = Clicker()
        self.states: list = []
        self.probs_history: list = []
        self.anchored = False

    def unanchor(self):
        self.anchored = False

    def interact(self, image: np.ndarray, x: float, y: float, is_positive: bool) -> np.ndarray:
        """(H, W, 3) normalised image + one click -> (H, W) bool mask."""
        if not self.anchored:
            self.predictor.set_input_image(image)
            self.clicker.reset_clicks()
            self.states = []
            self.probs_history = []
            self.anchored = True
        self.states.append({"clicker": self.clicker.get_state(),
                            "predictor": self.predictor.get_states()})
        self.clicker.add_click(Click(is_positive, (y, x)))
        prob = self.predictor.get_prediction(self.clicker)
        self.probs_history.append(prob)
        return prob > self.prob_thresh

    def undo(self) -> Optional[np.ndarray]:
        if not self.states:
            return None
        st = self.states.pop()
        self.clicker.set_state(st["clicker"])
        self.predictor.set_states(st["predictor"])
        self.probs_history.pop()
        if not self.probs_history:
            return None
        return self.probs_history[-1] > self.prob_thresh

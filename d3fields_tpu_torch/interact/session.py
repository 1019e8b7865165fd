"""Headless interactive VOS session — the Qt GUI's function, no widgets.

Counterpart of ``d3fields_tpu/interact/session.py``, a rebuild of the
reference's interactive annotation loop
(``XMem/inference/interact/gui.py:45-933`` + ``interaction.py:1-252``):
the user marks an object on any frame with clicks (f-BRS), scribbles
(S2M) or free painting, commits the mask, and XMem propagates it forward
or backward through the video. The Qt event loop becomes an explicit
method-call API (`InteractiveSession`); everything numeric matches the
reference flow:

- interactions produce a ``(K+1, H, W)`` probability map via the same
  soft-aggregation (``aggregate_wbg``, ``interaction.py:35-50``);
- a commit adopts the interacted probabilities as the frame's state
  (``gui.py:615-617,758-763``);
- propagation seeds XMem memory with the committed probabilities at the
  cursor frame, then steps frame-by-frame to either end of the video,
  writing each predicted mask back to the store
  (``gui.py:573-610``).

The XMem step is the port's `XMemCore` with ``num_views=1``; frames are
padded to multiples of 16 as the session pads them, and the probabilities
unpadded and copied to the host each frame. Strokes are drawn by
:func:`~d3fields_tpu_torch.utils.visualization.draw_line` (``cv2.line``,
pixel for pixel) and a layer of another size is resized by
:func:`~d3fields_tpu_torch.utils.visualization.resize_area_u8`
(``cv2.resize`` with ``INTER_AREA``, which may enlarge).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from d3fields_tpu_torch.config import XMemConfig
from d3fields_tpu_torch.interact import overlays as ov
from d3fields_tpu_torch.models.common import IMAGENET_MEAN, IMAGENET_STD
from d3fields_tpu_torch.models.xmem.core import XMemCore
from d3fields_tpu_torch.utils.device import resolve_device
from d3fields_tpu_torch.utils.visualization import (
    draw_line, resize_area_u8, save_index_mask_png,
)

Point = Tuple[float, float]


def aggregate_wbg(prob: np.ndarray, keep_bg: bool = False,
                  hard: bool = False) -> np.ndarray:
    """Soft-aggregate per-object probabilities ``(K, H, W)`` into a
    normalized distribution, deriving background as the product of
    complements (``interaction.py:35-50``). ``hard`` sharpens with the
    reference's x1000 logit temperature."""
    prob = np.asarray(prob, np.float32)
    bg = np.prod(1.0 - prob, axis=0, keepdims=True)
    new_prob = np.clip(np.concatenate([bg, prob], axis=0), 1e-7, 1 - 1e-7)
    logits = np.log(new_prob / (1.0 - new_prob))
    if hard:
        logits *= 1000.0
    logits -= logits.max(axis=0, keepdims=True)
    e = np.exp(logits)
    out = e / e.sum(axis=0, keepdims=True)
    return out if keep_bg else out[1:]


def _one_hot(mask: np.ndarray, num_classes: int) -> np.ndarray:
    """Index mask (H, W) -> one-hot (num_classes, H, W) float32
    (``interactive_utils.py:22-24``)."""
    return (np.arange(num_classes, dtype=np.int64)[:, None, None]
            == mask[None].astype(np.int64)).astype(np.float32)


def _draw_path(canvas: np.ndarray, points: Sequence[Point], value: int,
               thickness: int) -> np.ndarray:
    """Rasterize a polyline of (x, y) points onto an index map — the
    drag trail the GUI accumulates across mouse-motion events
    (``interaction.py:91-99,153-162``), as ``cv2.line`` draws it."""
    pts = [(int(round(x)), int(round(y))) for x, y in points]
    if len(pts) == 1:
        # a single click in free/scribble mode still leaves a dot (the
        # GUI only draws from the second point; a lone point is the
        # degenerate zero-length line)
        pts = pts * 2
    for p0, p1 in zip(pts[:-1], pts[1:]):
        canvas = draw_line(canvas, p0, p1, value, thickness)
    return canvas


class Interaction:
    """One annotation gesture on one frame (``interaction.py:53-66``).
    ``predict()`` returns the interacted ``(K+1, H, W)`` probabilities."""

    def predict(self) -> np.ndarray:
        raise NotImplementedError


class FreeInteraction(Interaction):
    """Direct index painting (``interaction.py:69-132``): strokes write
    object ids (0 erases) into a copy of the frame's index mask."""

    def __init__(self, prev_mask: np.ndarray, num_objects: int,
                 size: int = 3):
        self.K = num_objects
        self.size = size
        self.drawn_map = np.asarray(prev_mask, np.uint8).copy()

    def push_path(self, points: Sequence[Point], obj: int) -> None:
        if not 0 <= obj <= self.K:
            raise ValueError(f"object id {obj} out of range 0..{self.K}")
        self.drawn_map = _draw_path(self.drawn_map, points, obj, self.size)

    def predict(self) -> np.ndarray:
        return _one_hot(self.drawn_map, self.K + 1)


class ScribbleInteraction(Interaction):
    """Scribble-to-mask (``interaction.py:134-196``): strokes accumulate
    on a 255-initialized scribble map; ``predict`` runs the S2M network
    per object and hard-aggregates."""

    IGNORE = 255

    def __init__(self, image: np.ndarray, prev_mask: np.ndarray,
                 controller, num_objects: int, size: int = 3):
        self.image = image                       # (H, W, 3) normalized
        self.prev_mask = np.asarray(prev_mask, np.uint8)
        self.controller = controller
        self.K = num_objects
        self.size = size
        self.drawn_map = np.full(prev_mask.shape, self.IGNORE, np.uint8)

    def push_path(self, points: Sequence[Point], obj: int) -> None:
        if not 0 <= obj <= self.K:
            raise ValueError(f"object id {obj} out of range 0..{self.K}")
        self.drawn_map = _draw_path(self.drawn_map, points, obj, self.size)

    def predict(self) -> np.ndarray:
        prob = self.controller.interact(self.image, self.prev_mask,
                                        self.drawn_map)     # (K, H, W)
        return aggregate_wbg(prob, keep_bg=True, hard=True)


class ClickInteraction(Interaction):
    """f-BRS click refinement of ONE target object
    (``interaction.py:199-252``): each click re-predicts that object's
    mask; other objects keep their (0.9-clamped) previous probabilities
    so the interacted object can overwrite them."""

    def __init__(self, image: np.ndarray, prev_prob: np.ndarray,
                 controller, tar_obj: int):
        self.image = image                       # (H, W, 3) normalized
        self.prev_prob = np.asarray(prev_prob, np.float32)  # (K+1, H, W)
        self.controller = controller
        self.tar_obj = tar_obj
        self.obj_mask: Optional[np.ndarray] = None

    def push_click(self, x: float, y: float, positive: bool) -> None:
        self.obj_mask = self.controller.interact(self.image, x, y, positive)

    def predict(self) -> np.ndarray:
        out = np.clip(self.prev_prob.copy(), None, 0.9)
        if self.obj_mask is not None:
            out[self.tar_obj] = self.obj_mask.astype(np.float32)
        return aggregate_wbg(out[1:], keep_bg=True, hard=True)


class InteractiveSession:
    """The GUI's annotate-commit-propagate state machine, headless.

    Frames are uint8 RGB ``(T, H, W, 3)`` (or a ``t -> frame`` getter
    plus ``num_frames``). Per-frame index masks live in an in-memory
    store (the GUI's ``ResourceManager`` mask dir); ``save_masks``
    writes them out as DAVIS-paletted PNGs.

    The three interaction modes follow ``gui.py:692-794``: starting a
    gesture of a different kind (or switching the click target object)
    completes the previous interaction; each gesture updates
    ``interacted_prob``; ``commit`` adopts it
    (``gui.py:615-617,758-763``).
    """

    def __init__(self, frames: Union[np.ndarray, Callable[[int], np.ndarray]],
                 num_objects: int,
                 xmem_model=None, xmem_cfg: Optional[XMemConfig] = None,
                 s2m_controller=None, fbrs_controller=None,
                 num_frames: Optional[int] = None,
                 brush_size: int = 3, *, device=None):
        """``xmem_model`` is the port's ``XMem`` module, moved to ``device``
        (CUDA unless the caller names another)."""
        if callable(frames):
            if num_frames is None:
                raise ValueError("num_frames required with a frame getter")
            self._get_frame = frames
            self.num_frames = num_frames
            probe = np.asarray(frames(0))
        else:
            frames = np.asarray(frames)
            self._get_frame = lambda t: frames[t]
            self.num_frames = len(frames)
            probe = frames[0]
        if probe.dtype != np.uint8 or probe.ndim != 3:
            raise ValueError("frames must be (H, W, 3) uint8 RGB")
        self.height, self.width = probe.shape[:2]
        self.num_objects = num_objects
        self.s2m_controller = s2m_controller
        self.fbrs_controller = fbrs_controller
        self.brush_size = brush_size

        # every frame padded to /16 alike (the reference pads inside
        # InferenceCore)
        ph = (self.height + 15) // 16 * 16 - self.height
        pw = (self.width + 15) // 16 * 16 - self.width
        self._pads = (ph // 2, (ph + 1) // 2, pw // 2, (pw + 1) // 2)
        self.device = resolve_device(device)
        self.xmem: Optional[XMemCore] = None
        if xmem_model is not None:
            cfg = xmem_cfg or XMemConfig(mem_every=10, top_k=30)
            self.xmem = XMemCore(
                xmem_model, cfg, num_views=1, num_objects=num_objects,
                image_hw=(self.height + ph, self.width + pw), device=self.device,
            )

        # viewer state (gui.py:300-310,692-706,901-931)
        self.vis_target_objects = list(range(1, num_objects + 1))
        self.overlay_layer: Optional[np.ndarray] = None

        self.masks = np.zeros((self.num_frames, self.height, self.width),
                              np.uint8)
        self._mask_known = np.zeros(self.num_frames, bool)
        self.cursur = 0
        self.current_object = 1
        self.interaction: Optional[Interaction] = None
        self.interacted_prob: Optional[np.ndarray] = None
        self._load_frame_state()

    # -- frame state (gui.py:378-395) ------------------------------------
    def _load_frame_state(self) -> None:
        self.current_image = np.asarray(self._get_frame(self.cursur))
        self._image_norm = (
            self.current_image.astype(np.float32) / 255.0 - IMAGENET_MEAN
        ) / IMAGENET_STD
        self.current_mask = self.masks[self.cursur].copy()
        self.current_prob: Optional[np.ndarray] = None

    def _prob(self) -> np.ndarray:
        """Lazy one-hot of the current mask (``gui.py:390-395``)."""
        if self.current_prob is None:
            self.current_prob = _one_hot(self.current_mask,
                                         self.num_objects + 1)
        return self.current_prob

    # -- navigation (gui.py:521-532,619-627) -----------------------------
    def goto(self, t: int) -> None:
        if not 0 <= t < self.num_frames:
            raise IndexError(f"frame {t} out of range")
        self.reset_this_interaction()
        self.cursur = t
        self._load_frame_state()

    def next_frame(self) -> None:
        self.goto(min(self.cursur + 1, self.num_frames - 1))

    def prev_frame(self) -> None:
        self.goto(max(self.cursur - 1, 0))

    def set_object(self, k: int) -> None:
        """Switch the click-interaction target (``gui.py:670-680``)."""
        if not 1 <= k <= self.num_objects:
            raise ValueError(f"object id {k} out of range")
        if k != self.current_object and self.fbrs_controller is not None:
            self.fbrs_controller.unanchor()
        self.current_object = k

    def reset_this_interaction(self) -> None:
        """Drop the uncommitted interaction (``gui.py:506-511``)."""
        self.interacted_prob = None
        self.interaction = None
        if self.fbrs_controller is not None:
            self.fbrs_controller.unanchor()

    # -- gestures (gui.py:692-794) ---------------------------------------
    def click(self, x: float, y: float, positive: bool = True) -> np.ndarray:
        """One f-BRS click on the current object; returns the updated
        index mask preview."""
        if self.fbrs_controller is None:
            raise RuntimeError("no fbrs controller configured")
        if (not isinstance(self.interaction, ClickInteraction)
                or self.interaction.tar_obj != self.current_object):
            self.fbrs_controller.unanchor()
            self.interaction = ClickInteraction(
                self._image_norm, self._prob(), self.fbrs_controller,
                self.current_object,
            )
        self.interaction.push_click(x, y, positive)
        return self._finish_gesture()

    def scribble(self, points: Sequence[Point],
                 obj: Optional[int] = None) -> np.ndarray:
        """One scribble stroke (S2M); ``obj=0`` marks background."""
        if self.s2m_controller is None:
            raise RuntimeError("no s2m controller configured")
        if not isinstance(self.interaction, ScribbleInteraction):
            self.interaction = ScribbleInteraction(
                self._image_norm, self.current_mask, self.s2m_controller,
                self.num_objects,
            )
        self.interaction.push_path(
            points, self.current_object if obj is None else obj)
        return self._finish_gesture()

    def free_draw(self, points: Sequence[Point],
                  obj: Optional[int] = None) -> np.ndarray:
        """One free-paint stroke writing indices directly."""
        if not isinstance(self.interaction, FreeInteraction):
            self.interaction = FreeInteraction(
                self.current_mask, self.num_objects, size=self.brush_size)
        self.interaction.push_path(
            points, self.current_object if obj is None else obj)
        return self._finish_gesture()

    def _finish_gesture(self) -> np.ndarray:
        """Every gesture immediately adopts the interacted probabilities
        as the frame's state and stores the mask — the GUI does this on
        every mouse release (``gui.py:758-770``); 'commit' only completes
        the interaction object."""
        self.interacted_prob = self.interaction.predict()
        self.current_prob = self.interacted_prob
        self.current_mask = np.argmax(self.interacted_prob,
                                      axis=0).astype(np.uint8)
        self._store_mask()
        return self.current_mask

    # -- commit / reset (gui.py:615-617,643-650) ---------------------------
    def commit(self) -> np.ndarray:
        """Complete the open interaction (``gui.py:615-617,765-768``): the
        next gesture starts a fresh interaction against the now-current
        state. Returns the frame's mask."""
        self.interacted_prob = None
        self.interaction = None
        return self.current_mask

    def import_mask(self, mask: np.ndarray) -> None:
        """Adopt an externally produced index mask for the current frame
        (``gui.py:873-899``)."""
        mask = np.asarray(mask, np.uint8)
        if mask.shape != (self.height, self.width):
            raise ValueError("mask shape mismatch")
        if mask.max() > self.num_objects:
            raise ValueError("mask contains ids beyond num_objects")
        self.current_mask = mask.copy()
        self.current_prob = None
        self._store_mask()

    def reset_mask(self) -> None:
        """Clear the current frame's mask (``gui.py:643-650``)."""
        self.current_mask.fill(0)
        self.current_prob = None
        self._store_mask()
        self.reset_this_interaction()

    def _store_mask(self) -> None:
        self.masks[self.cursur] = self.current_mask
        self._mask_known[self.cursur] = True

    # -- propagation (gui.py:544-610) -------------------------------------
    def _pad_hw(self, a: np.ndarray, axes: Tuple[int, int]) -> np.ndarray:
        lh, uh, lw, uw = self._pads
        pads = [(0, 0)] * a.ndim
        pads[axes[0]] = (lh, uh)
        pads[axes[1]] = (lw, uw)
        return np.pad(a, pads)

    def _unpad_hw(self, a: np.ndarray) -> np.ndarray:
        lh, uh, lw, uw = self._pads
        return a[..., lh:a.shape[-2] - uh, lw:a.shape[-1] - uw]

    def _xmem_step(self, with_mask: bool) -> np.ndarray:
        img = self._pad_hw(self._image_norm, (0, 1))[None]      # (1,H,W,3)
        if with_mask:
            mp = self._pad_hw(self._prob()[1:], (1, 2))[None]   # (1,O,H,W)
            prob = self.xmem.step(img, mp)
        else:
            prob = self.xmem.step(img)
        return self._unpad_hw(prob[0].cpu().numpy())            # (O+1,H,W)

    def propagate(self, forward: bool = True,
                  max_frames: Optional[int] = None,
                  on_frame: Optional[Callable[[int, np.ndarray], None]]
                  = None) -> List[int]:
        """Seed XMem with the current frame's committed probabilities and
        propagate to the video end (``gui.py:544-610``). Returns the list
        of frames written. ``max_frames`` is the pause button;
        ``on_frame(t, mask)`` observes each prediction."""
        if self.xmem is None:
            raise RuntimeError("no XMem model configured")
        self.current_prob = self._xmem_step(with_mask=True)
        self.current_mask = np.argmax(self.current_prob,
                                      axis=0).astype(np.uint8)
        self.reset_this_interaction()

        written: List[int] = []
        step = 1 if forward else -1
        while max_frames is None or len(written) < max_frames:
            nxt = self.cursur + step
            if not 0 <= nxt < self.num_frames:
                break
            self.cursur = nxt
            self._load_frame_state()
            self.current_prob = self._xmem_step(with_mask=False)
            self.current_mask = np.argmax(self.current_prob,
                                          axis=0).astype(np.uint8)
            self._store_mask()
            written.append(self.cursur)
            if on_frame is not None:
                on_frame(self.cursur, self.current_mask)
            if self.cursur in (0, self.num_frames - 1):
                break
        return written

    def clear_memory(self) -> None:
        """Reset XMem's spatiotemporal memory (``gui.py:862-866``)."""
        if self.xmem is not None:
            self.xmem.clear_memory()

    # -- viewer (gui.py:397-460,513-515,692-706,901-931) -------------------
    def toggle_vis_target(self, k: int) -> None:
        """Mid-click toggle of an object in/out of the visualization
        target set (``gui.py:696-706``)."""
        if k in self.vis_target_objects:
            self.vis_target_objects.remove(k)
        else:
            self.vis_target_objects.append(k)

    def set_layer(self, rgba: np.ndarray) -> None:
        """Install the RGBA layer for 'layered' mode
        (``gui.py:901-931``)."""
        rgba = np.asarray(rgba)
        if rgba.ndim != 3 or rgba.shape[2] != 4:
            raise ValueError("layer must be (H, W, 4) RGBA")
        if rgba.shape[:2] != (self.height, self.width):
            rgba = resize_area_u8(rgba.astype(np.uint8),
                                  (self.height, self.width))
        self.overlay_layer = rgba

    def visualize(self, mode: str = "davis", soft: bool = False
                  ) -> np.ndarray:
        """Compose the current frame's overlay — the viewer image
        (``gui.py:397-399`` hard path; ``gui.py:436-448`` soft path used
        while probabilities are live)."""
        if soft and self.current_prob is not None:
            layer01 = (None if self.overlay_layer is None
                       else self.overlay_layer.astype(np.float32) / 255.0)
            return ov.get_visualization_soft(
                mode, self.current_image.astype(np.float32) / 255.0,
                self.current_prob, layer01, self.vis_target_objects)
        return ov.get_visualization(mode, self.current_image,
                                    self.current_mask, self.overlay_layer,
                                    self.vis_target_objects)

    # -- output (resource_manager.py save_mask + gui.py:517-519) ----------
    def save_masks(self, out_dir: str,
                   names: Optional[Sequence[str]] = None) -> List[str]:
        """Write every known mask as a DAVIS-paletted PNG."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for t in range(self.num_frames):
            if not self._mask_known[t]:
                continue
            name = names[t] if names is not None else f"{t:07d}.png"
            p = os.path.join(out_dir, os.path.splitext(name)[0] + ".png")
            save_index_mask_png(p, self.masks[t])
            paths.append(p)
        return paths

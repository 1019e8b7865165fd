"""Serving: overlap device work with host I/O, and the per-frame step.

Counterpart of ``d3fields_tpu/serving.py``. The reference's per-frame
loops are synchronous: every frame runs ``update -> text_queries ->
rigid_tracking`` and blocks on the GPU result before touching the next
frame (``vis_tracking.py:70-138``). PyTorch launches CUDA work
asynchronously, so the card can already run frame ``t+1`` while the host
writes frame ``t``'s pickles:

- :class:`AsyncFrameLoop` defers each frame's fetch by ``depth`` frames;
  ``depth=0`` is the reference's synchronous loop. Results are identical
  either way: only when the host copy happens changes.
- :func:`host_prefetch` produces items in a background thread;
  :func:`prefetch_to_device` stages upcoming frames on the device.
- :class:`FusedFrameStep` runs a whole tracking frame (DINOv2 -> XMem
  propagation -> field -> rigid tracking) as one function that makes no
  host sync, so the host can queue frame ``t+1`` while the card runs
  frame ``t``.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from d3fields_tpu_torch.fields.state import FieldState
from d3fields_tpu_torch.models.dinov2 import _extract_patch_features
from d3fields_tpu_torch.models.xmem.core import propagate_step_views
from d3fields_tpu_torch.seg.video_tracker import prep_frames, upsample_probs
from d3fields_tpu_torch.track.rigid import rigid_tracking_steps
from d3fields_tpu_torch.utils.device import resolve_device

__all__ = ["AsyncFrameLoop", "FusedFrameStep", "host_prefetch", "prefetch_to_device"]


def _fetch(tree: Any) -> Any:
    """Tensors -> host numpy arrays (one blocking copy each), through
    dicts, lists and tuples; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _fetch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fetch(v) for v in tree)
    return tree


class AsyncFrameLoop:
    """Deferred-fetch frame pipeline.

    ``submit(frame_id, outputs)`` enqueues a frame's *device* outputs
    (tensors in any nesting of dicts, lists and tuples; other leaves
    pass through). Once more than ``depth``
    frames are in flight, the oldest is fetched to host numpy and handed
    to ``consumer(frame_id, host_outputs)``. ``flush()`` drains the
    queue; the loop is also a context manager that flushes on exit.

    The producer must NOT host-sync inside its own frame step for the
    overlap to materialize — keep the per-frame chain on the device (e.g.
    ``rigid_tracking_steps`` instead of the numpy-returning wrapper) and
    let this loop do the only fetch.

    ``depth`` is the host-visible latency in frames. Device memory holds
    ``depth + 1`` frames of outputs; keep outputs small (match points,
    masks) rather than full feature volumes when deep pipelines are used.
    """

    def __init__(self, consumer: Callable[[Any, Any], None], depth: int = 1):
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        self._consumer = consumer
        self._depth = depth
        self._q: collections.deque = collections.deque()
        self.frames_consumed = 0

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def in_flight(self) -> int:
        return len(self._q)

    def submit(self, frame_id: Any, outputs: Any) -> None:
        self._q.append((frame_id, outputs))
        while len(self._q) > self._depth:
            self._drain_one()

    def _drain_one(self) -> None:
        # pop only AFTER the consumer returns: a transient consumer error
        # (e.g. ENOSPC mid-pickle) leaves the frame queued, so a caller
        # that handles the error can flush() again without losing it
        frame_id, outputs = self._q[0]
        self._consumer(frame_id, _fetch(outputs))
        self._q.popleft()
        self.frames_consumed += 1

    def flush(self) -> None:
        while self._q:
            self._drain_one()

    def __enter__(self) -> "AsyncFrameLoop":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # don't mask an in-flight exception with consumer work on partial
        # results; drain only on clean exit
        if exc_type is None:
            self.flush()


def host_prefetch(items: Iterable[Any], size: int = 2) -> Iterator[Any]:
    """Produce ``items`` in a background thread through a bounded queue, up
    to ``size`` items ahead of the consumer.

    Order is kept; a producer exception re-raises at the consumer's next
    pull; closing the iterator early (``.close()``, or dropping it) stops
    the producer thread instead of leaving it blocked on a full queue. The
    thread starts at the call, not at the first pull.
    """
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    end = object()
    err: list = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in items:
                if not put(item):
                    return
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            put(end)

    threading.Thread(target=worker, daemon=True, name="host_prefetch").start()
    return _PrefetchIter(q, stop, end, err)


class _PrefetchIter:
    """Consumer side of :func:`host_prefetch`: an iterator object (not a
    generator), so the producer stops on every way of abandoning it."""

    def __init__(self, q, stop, end, err):
        self._q, self._stop, self._end, self._err = q, stop, end, err

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is self._end:
            self._stop.set()
            if self._err:
                raise self._err[0]
            raise StopIteration
        return item

    def close(self):
        self._stop.set()

    def __del__(self):
        self._stop.set()


def _to_device(tree: Any, device: torch.device) -> Any:
    """numpy arrays and tensors -> tensors on ``device`` (copied without
    waiting, from pinned memory when the device is a GPU), through dicts,
    lists and tuples; other leaves pass through."""
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, torch.Tensor):
        if device.type == "cuda" and tree.device.type == "cpu":
            tree = tree.pin_memory()
        return tree.to(device, non_blocking=True)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


def prefetch_to_device(frames: Iterable[Any], size: int = 2, device=None,
                       transform: Optional[Callable[[Any], Any]] = None) -> Iterator[Any]:
    """Yield frames with up to ``size`` of them staged on ``device`` ahead of
    use (CUDA by default; raises without a GPU unless given another device).

    ``transform`` (on the host, e.g. decode or normalise) runs before the
    copy; numpy arrays and tensors go to the device, other leaves pass
    through. The copy of frame ``t+size`` is issued while frame ``t``
    computes."""
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    dev = resolve_device(device)

    def stage(f: Any) -> Any:
        return _to_device(transform(f) if transform is not None else f, dev)

    it = iter(frames)
    buf = collections.deque(stage(f) for f in itertools.islice(it, size))
    end = object()
    while buf:
        out = buf.popleft()
        nxt = next(it, end)
        if nxt is not end:
            buf.append(stage(nxt))
        yield out


# ---------------------------------------------------------------------------
# the fused per-frame serving step
# ---------------------------------------------------------------------------

class FusedFrameStep:
    """The per-frame serving step of the tracking pipeline.

    Wraps a :class:`~d3fields_tpu_torch.models.dinov2.Dinov2Backbone`, a
    :class:`~d3fields_tpu_torch.seg.video_tracker.VideoMaskTracker` (whose
    ``core`` holds the XMem memory and frame counters), the fixed camera
    geometry and a :class:`~d3fields_tpu_torch.config.TrackingConfig`.
    ``step(images_u8, ...)`` returns device tensors (match_pts, t, log_r,
    loss_history, mask) and makes no host sync when its inputs are on the
    device (stage them with :func:`prefetch_to_device`): pair it with
    :class:`AsyncFrameLoop`, whose fetch is then the only sync.

    The tracker must be seeded (first frame through ``tracker.process(rgb,
    mask)``); this step covers the propagation frames that follow. It runs
    the same functions as the staged ``update -> text_queries ->
    rigid_tracking_steps`` loop, in the same order.
    """

    def __init__(self, backbone, tracker, depth, pose, K, bounds_lo, bounds_hi,
                 tracking_cfg, patch_hw=None, xmem_bgr_to_rgb=False, mu=0.02):
        """``pose``/``K`` are the fixed calibrated rig; ``pose`` may be
        (V, 4, 4) or (V, 3, 4) and is cut to (V, 3, 4) as ``state_from_obs``
        does. ``depth`` is the default depth map: RGB-D serving passes each
        frame's depth to :meth:`step` / :meth:`step_segment`. ``mu`` is the
        field's truncation band: pass the ``FusionConfig.mu`` of the staged
        loop. ``xmem_bgr_to_rgb=True`` when frames arrive BGR while the
        tracker was seeded with RGB. Runs on the tracker's device."""
        # DINOv2 must resize on the device as the staged backbone does: the
        # Pillow-exact path resizes uint8 before the model and would give
        # other features than a 'device' backbone of the staged loop
        if getattr(backbone, "resize_mode", "device") != "device":
            raise ValueError(
                "FusedFrameStep needs Dinov2Backbone(resize_mode='device'): the step "
                "resizes DINOv2's input on the device with the antialiased bilinear "
                "filter, not with the Pillow-exact resampler ('pil')")
        if not tracker.core.deep_update_sync:
            raise NotImplementedError(
                "FusedFrameStep supports the synchronized deep-update schedule only "
                "(XMemConfig.deep_update_every < 0, the d3fields configuration, "
                "reference fusion.py:272); use VideoMaskTracker for explicit schedules")
        self.bb = backbone
        self.tracker = tracker
        self.device = tracker.device
        if backbone.device != self.device:
            raise ValueError(f"backbone on {backbone.device}, tracker on {self.device}")

        def put(x):  # numpy arrays or tensors
            return torch.as_tensor(x, dtype=torch.float32).to(self.device).contiguous()

        self.depth = put(depth)
        pose = put(pose)
        self.pose = pose[:, :3, :].contiguous() if pose.shape[-2:] == (4, 4) else pose
        self.K = put(K)
        self.mu = float(mu)
        self.lo = put(bounds_lo)
        self.hi = put(bounds_hi)
        self.tcfg = tracking_cfg
        self.patch_hw = patch_hw
        self.xmem_bgr_to_rgb = bool(xmem_bgr_to_rgb)

    def _tensor(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    def _frame(self, images_u8, depth, src_feats, last_pts, is_mem_frame: bool) -> dict:
        """One tracking frame (JAX ``serving.py:237-289``): DINOv2 features ->
        XMem propagation through :class:`VideoMaskTracker`'s own pre- and
        post-processing -> the field -> ``rigid_tracking_steps``. Makes no
        host sync when its inputs are on the device; writes the tracker's
        memory in place."""
        tracker, core = self.tracker, self.tracker.core
        H, W = images_u8.shape[1:3]
        ph, pw = self.patch_hw or (H // 10, W // 10)
        P = self.bb.cfg.patch_size
        with torch.no_grad():
            feats = _extract_patch_features(self.bb.model, images_u8,
                                            self.bb.interpolated_pos_embed(ph, pw),
                                            (ph * P, pw * P))
        # frames may come BGR (the reference's cv2 convention) while the
        # tracker was seeded with RGB (Fusion flips before process): flip the
        # XMem branch only; DINOv2 gets the frames as they are, as in
        # Fusion.update
        imf = prep_frames(images_u8.flip(-1) if self.xmem_bgr_to_rgb else images_u8,
                          tracker.resized_hw, tracker.pad_spec)
        prob = propagate_step_views(core.model, core.mem, imf, is_mem_frame, sync=True)
        mask = upsample_probs(prob, tracker.pad_spec, (H, W))[:, 1:].permute(0, 2, 3, 1)
        st = FieldState(depth=depth, pose=self.pose, K=self.K, dino_feats=feats.float(),
                        mask=mask, mu=self.mu)
        tr = rigid_tracking_steps(st, src_feats, last_pts, self.lo, self.hi, self.tcfg)
        return {"match_pts": tr["match_pts"], "t": tr["t"], "log_r": tr["log_r"],
                "loss_history": tr["loss_history"], "mask": mask}

    def _schedule(self, num_frames: int):
        """The memory-frame flags of the next ``num_frames`` propagation
        frames and the counters after them (``XMemCore.step``'s rule),
        without touching the core."""
        core = self.tracker.core
        flags, ti, last_mem = [], core.curr_ti, core.last_mem_ti
        for _ in range(num_frames):
            ti += 1
            flags.append(ti - last_mem >= core.cfg.mem_every)
            if flags[-1]:
                last_mem = ti
        return flags, ti, last_mem

    def step(self, images_u8, src_feats, last_pts, depth=None) -> dict:
        """images_u8 (V, H, W, 3); src_feats (I*P, D); last_pts (I, P, 3);
        ``depth`` (V, H, W) this frame's depth (default: the init-time
        depth). Returns the frame's outputs as device tensors.

        The counters advance only after the frame has been issued, so a
        raise leaves the schedule as it was; a failure inside the XMem step
        may have written the memory, so re-seed the tracker after one."""
        if not self.tracker.first_mask_loaded:
            raise RuntimeError("seed the tracker first (process with mask)")
        (is_mem,), ti, last_mem = self._schedule(1)
        out = self._frame(self._tensor(images_u8),
                          self.depth if depth is None else self._tensor(depth).float(),
                          src_feats, last_pts, is_mem)
        core = self.tracker.core
        core.curr_ti, core.last_mem_ti = ti, last_mem
        return out

    def step_segment(self, frames_u8, src_feats, last_pts, depths=None) -> dict:
        """T frames (frames_u8 (T, V, H, W, 3), ``depths`` (T, V, H, W) or
        the init-time depth) through the same frame body, frame t's tracked
        points seeding frame t+1, as chaining :meth:`step` by hand. Returns
        the per-frame outputs stacked on a leading T axis."""
        if not self.tracker.first_mask_loaded:
            raise RuntimeError("seed the tracker first (process with mask)")
        flags, ti, last_mem = self._schedule(frames_u8.shape[0])
        frames_u8 = self._tensor(frames_u8)
        depths = None if depths is None else self._tensor(depths).float()
        outs, last = [], last_pts
        for t, is_mem in enumerate(flags):
            out = self._frame(frames_u8[t], self.depth if depths is None else depths[t],
                              src_feats, last, is_mem)
            last = out["match_pts"]
            outs.append(out)
        core = self.tracker.core
        core.curr_ti, core.last_mem_ti = ti, last_mem
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

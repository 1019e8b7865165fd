"""XMem inference stepper over all views at once.

Counterpart of ``d3fields_tpu/models/xmem/core.py`` (the reference's
``XMem/inference/inference_core.py:8-107``) for the d3fields usage: every
object is seeded with a mask on frame 0 and propagated afterwards. The
reference keeps one InferenceCore per camera; here the views are the CNN
batch axis and the memory attention is batched over the per-view memories.

Frame schedule (host counters, ``inference_core.py:50-56``). Synchronized
deep updates (``deep_update_every = -1``, the d3fields configuration):
  is_mem_frame = (ti - last_mem_ti >= mem_every) or mask_given
  is_deep_update = is_mem_frame; the decoder GRU updates the hidden on the
  other frames.
Unsynchronized (``deep_update_every > 0``): the decoder GRU updates the
hidden every frame, and a memory frame also adopts the value encoder's
reinforced hidden once ti - last_deep_update_ti >= deep_update_every.

The networks run in the dtype of the model's weights: ``XMemConfig.
compute_dtype`` 'bfloat16' makes :class:`XMemCore` round a copy of them to
bf16 once, at construction (JAX ``core.py:300-317``). The key encoder, the
decoder and the value encoder then take bf16 images, hidden states and
readouts; the memory keeps f32 keys, values and hidden states, the memory
read takes f32 queries, and the probabilities come back f32. Nothing here
records autograd.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from d3fields_tpu_torch.config import XMemConfig
from d3fields_tpu_torch.models.common import cast_copy, torch_dtype
from d3fields_tpu_torch.models.xmem import blocks as B
from d3fields_tpu_torch.models.xmem import memory as M
from d3fields_tpu_torch.models.xmem.network import XMem
from d3fields_tpu_torch.parallel.mesh import ViewShards
from d3fields_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


def _flatten_key(key: Tensor, shrinkage: Optional[Tensor], selection: Optional[Tensor]):
    """(V, C, h, w) maps -> the memory layout (V, C, h*w) / (V, h*w)."""
    k = key.flatten(2)
    s = shrinkage.flatten(1) if shrinkage is not None else None
    e = selection.flatten(2) if selection is not None else None
    return k, s, e


def _nchw(images: Tensor, dtype: torch.dtype) -> Tensor:
    """(V, H, W, 3) -> (V, 3, H, W) in the networks' dtype."""
    return images.permute(0, 3, 1, 2).to(dtype).contiguous()


def _dtype(model: XMem) -> torch.dtype:
    """The dtype the networks compute in: their weights'."""
    return model.key_proj.key_proj.weight.dtype


def _values(value: Tensor) -> Tensor:
    """(V, O, CV, h, w) -> (V, O, CV, h*w)."""
    return value.flatten(3)


@torch.no_grad()
def seed_step_views(model: XMem, mem: M.XMemMemory, images: Tensor, mask_prob: Tensor) -> Tensor:
    """Frame 0: seed every view's memory from the given masks
    (``inference_core.py:75-105`` with a mask).

    images (V, H, W, 3) normalised, H and W multiples of 16; mask_prob
    (V, O, H, W) in [0, 1], no background. Returns the probabilities with
    background (V, O+1, H, W); writes the memory in place."""
    dt = _dtype(model)
    img = _nchw(images, dt)
    key, shrinkage, selection, f16, _, _ = model.encode_key(img)
    prob = B.soft_aggregate(mask_prob, dim=1)
    value, hidden = model.encode_value(img, f16, mem.hidden.to(dt), prob[:, 1:].to(dt),
                                       is_deep_update=True)
    mem.hidden = hidden.float()
    k, s, e = _flatten_key(key, shrinkage, selection)
    M.add_memory(mem, k, s, _values(value), e)
    return prob


@torch.no_grad()
def propagate_step_views(model: XMem, mem: M.XMemMemory, images: Tensor, is_mem_frame: bool,
                         sync: bool = True, is_deep_update: Optional[bool] = None) -> Tensor:
    """A frame with no mask: read the memory, segment, and on a memory frame
    write this frame into the memory (``inference_core.py:50-107``).

    ``sync`` is the deep-update schedule: True = ``deep_update_every=-1``
    (deep updates ride memory frames); False = an explicit period, where the
    decoder GRU updates the hidden every frame and ``is_deep_update``
    says whether a memory frame also adopts the value encoder's reinforced
    hidden. Returns (V, O+1, H, W); writes the memory in place."""
    dt = _dtype(model)
    img = _nchw(images, dt)
    key, shrinkage, selection, f16, f8, f4 = model.encode_key(img)
    qk, _, qe = _flatten_key(key, None, selection)
    readout = M.match_memory(mem, qk.float(), qe.float())
    V, O, CV = readout.shape[:3]
    readout = readout.reshape(V, O, CV, key.shape[2], key.shape[3])
    # the decoder's hidden is used on normal frames, and on every frame
    # without sync
    dec_hidden, _, prob = model.segment(
        f16, f8, f4, mem.hidden.to(dt), readout.to(dt),
        h_out=(not sync) or (not is_mem_frame),
        obj_active=mem.active if mem.multi_group else None)
    if not sync:
        # adopted before the value encoder runs (inference_core.py:70-71,97-99)
        mem.hidden = dec_hidden.float()
    if is_mem_frame:
        value, hidden = model.encode_value(img, f16, mem.hidden.to(dt), prob[:, 1:].to(dt),
                                           is_deep_update=True)
        if sync or is_deep_update:
            mem.hidden = hidden.float()
        k, s, e = _flatten_key(key, shrinkage, selection)
        M.add_memory(mem, k, s, _values(value), e)
    elif sync:
        mem.hidden = dec_hidden.float()
    return prob


@torch.no_grad()
def reseed_step_views(model: XMem, mem: M.XMemMemory, images: Tensor, mask_prob: Tensor,
                      provided: Tensor, adopt_deep: Optional[bool] = None,
                      sync: bool = True) -> Tensor:
    """A frame with masks in multi-group mode: frame-0 seeding and
    mid-video object entry through one function
    (``inference_core.py:75-105``).

    mask_prob (V, O, H, W): the channels flagged by ``provided`` (O,) bool
    hold the given masks; the other active objects keep their predicted
    probabilities (zeroed inside the given masks' regions); inactive
    objects read 0. Entering objects start from a zero hidden state.
    ``adopt_deep`` (default True) says whether the value encoder's
    reinforced hidden replaces the current one: False on an unsynchronized
    schedule that has not elapsed (``inference_core.py:51-55``)."""
    dt = _dtype(model)
    img = _nchw(images, dt)
    key, shrinkage, selection, f16, f8, f4 = model.encode_key(img)
    qk, _, qe = _flatten_key(key, None, selection)
    readout = M.match_memory(mem, qk.float(), qe.float(), count_usage=False)
    V, O, CV = readout.shape[:3]
    readout = readout.reshape(V, O, CV, key.shape[2], key.shape[3])
    # without sync a mask-given frame that segments also adopts the
    # decoder's hidden for the active objects (inference_core.py:56,70-71)
    dec_hidden, _, prob_pred = model.segment(f16, f8, f4, mem.hidden.to(dt), readout.to(dt),
                                             h_out=not sync, obj_active=mem.active)
    zero = torch.zeros((), device=img.device)
    active = mem.active                                        # (V, O)
    provided = provided.to(img.device).expand_as(active)
    pred = torch.where(active[..., None, None], prob_pred[:, 1:], zero)
    mask_regions = torch.where(provided[..., None, None], mask_prob, zero).sum(dim=1) > 0.5
    pred = torch.where(mask_regions[:, None], zero, pred)
    merged = torch.where(provided[..., None, None], mask_prob.float(), pred)
    prob = B.soft_aggregate(merged, dim=1)

    entering = provided & ~active
    if sync:
        base_hidden = mem.hidden
    else:
        # the reference segments (and adopts the decoder's hidden) only
        # when some active object is not provided (inference_core.py:49)
        need_seg = torch.any(active & ~provided, dim=1)        # (V,)
        base_hidden = torch.where(need_seg[:, None, None, None, None], dec_hidden.float(),
                                  mem.hidden)
    hidden0 = torch.where((entering | ~active)[..., None, None, None], zero, base_hidden)
    M.activate_objects(mem, provided)
    value, hidden = model.encode_value(img, f16, hidden0.to(dt), prob[:, 1:].to(dt),
                                       is_deep_update=True)
    mem.hidden = hidden.float() if adopt_deep is None or adopt_deep else hidden0
    k, s, e = _flatten_key(key, shrinkage, selection)
    M.add_memory(mem, k, s, _values(value), e)
    return prob


class XMemCore:
    """Frame counters and the per-view memory of every camera (the
    reference keeps a list of per-camera cores, ``fusion.py:282-302``).

    The views form one group per device of its :class:`ViewShards` (one
    group until :meth:`shard_views`): ``mems`` holds each group's memory,
    on its device, and :meth:`memory_to_host` / :meth:`memory_from_host`
    carry the whole memory."""

    def __init__(self, model: XMem, cfg: XMemConfig, num_views: int, num_objects: int,
                 image_hw: Tuple[int, int], multi_group: bool = False, *, device=None):
        """``multi_group=True`` preallocates ``num_objects`` slots of which
        any subset may be seeded by a mask-given step: objects may enter
        mid-video. ``device`` defaults to CUDA and raises when no GPU is
        visible; the model is moved there. ``cfg.compute_dtype`` 'bfloat16'
        runs the networks on a copy of the model's weights rounded to bf16
        here, once; the memory stays f32."""
        H, W = image_hw
        if H % 16 or W % 16:
            raise ValueError("image must be pre-padded to multiples of 16")
        self.device = resolve_device(device)
        self.model = cast_copy(model.to(self.device).eval(), torch_dtype(cfg.compute_dtype))
        # deep_update_every < 0: deep updates ride memory frames (the
        # d3fields configuration); >= 0: an explicit schedule
        self.deep_update_sync = cfg.deep_update_every < 0
        self.multi_group = multi_group
        self.cfg = cfg
        self.num_views = num_views
        self.num_objects = num_objects
        self.image_hw = image_hw
        self._views = ViewShards.on(self.device, self.model)
        self.device = self._views.first
        self.clear_memory()

    def shard_views(self, mesh) -> "XMemCore":
        """Split the views over ``mesh`` (JAX ``core.py:324-354``): the
        networks are replicated on each device of the mesh, each device
        keeps the memory of its group of ``num_views / size`` views and
        steps them, and the probabilities come back in view order on the
        mesh's first device, which becomes this core's device. XMem has no
        cross-view term, so each group consolidates on its own, in step
        with the others. Clears the memory."""
        if self.num_views % mesh.size:
            raise ValueError(f"num_views={self.num_views} not divisible by mesh axis "
                             f"'dp' of size {mesh.size}")
        self._views = ViewShards(mesh, self.model)
        self.device = mesh.first
        self.model = self._views.replicas[self.device]
        self.clear_memory()
        return self

    @property
    def mem(self) -> M.XMemMemory:
        """The memory of all views, where they form one group."""
        if len(self.mems) != 1:
            raise RuntimeError(f"the views form {len(self.mems)} groups: read core.mems")
        return self.mems[0]

    def clear_memory(self):
        """Reset the tracking state (reference ``clear_memory``,
        ``inference_core.py:22-27``)."""
        H, W = self.image_hw
        self.mems = [M.init_memory(self.cfg, self.num_views // self._views.size,
                                   self.num_objects, (H // 16, W // 16),
                                   multi_group=self.multi_group, device=d)
                     for d in self._views.devices]
        self.curr_ti = -1
        self.last_mem_ti = 0
        if not self.deep_update_sync:
            self.last_deep_update_ti = -self.cfg.deep_update_every

    def memory_to_host(self) -> dict:
        """The whole memory as :func:`memory.memory_to_host` gives it (the
        groups joined along the view axis), for a checkpoint that
        :meth:`memory_from_host` restores into a core of the same views,
        sharded or not."""
        parts = [M.memory_to_host(m) for m in self.mems]
        out = {}
        for k, v in parts[0].items():
            if k in M.TENSOR_FIELDS:
                out[k] = np.concatenate([p[k] for p in parts])
            else:
                if any(p[k] != v for p in parts):
                    raise RuntimeError(f"the view groups' memories disagree on {k}")
                out[k] = v
        return out

    def memory_from_host(self, d: dict) -> None:
        """Restore what :meth:`memory_to_host` gave, split over this core's
        view groups."""
        n = self._views.size
        split = {k: np.array_split(v, n) for k, v in d.items() if k in M.TENSOR_FIELDS}
        self.mems = [M.memory_from_host({k: split[k][i] if k in split else v
                                         for k, v in d.items()}, dev)
                     for i, dev in enumerate(self._views.devices)]

    def _tensor(self, x) -> Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device, torch.float32)

    def run_step(self, fn, per_view, *rest) -> Tensor:
        """``fn(model, mem, *per_view, *rest)`` on each view group's device,
        with its memory and its chunk of each ``per_view`` tensor; the
        probabilities joined on the core's device."""
        v = self._views
        chunks = [v.split(x) for x in per_view]
        return v.gather([fn(v.replicas[d], mem, *cs, *rest)
                         for d, mem, *cs in zip(v.devices, self.mems, *chunks)])

    def step(self, images, mask_prob=None, provided=None) -> Tensor:
        """images (V, H, W, 3) normalised; mask_prob (V, O, H, W) on
        mask-given frames, None otherwise. Returns the probabilities with
        background (V, O+1, H, W) on the core's device.

        In multi-group mode a mask may come on any frame; ``provided`` (O,)
        bool says which channels it seeds (default: the channels with a
        nonzero mask in any view)."""
        self.curr_ti += 1
        images = self._tensor(images)
        if mask_prob is not None:
            mask_prob = self._tensor(mask_prob)
            # a mask-given frame is a memory frame; on an unsynchronized
            # schedule the deep update fires only once it has elapsed
            # (always at t=0)
            deep_fires = self.deep_update_sync or (
                self.curr_ti - self.last_deep_update_ti >= self.cfg.deep_update_every)
            if self.multi_group:
                if provided is None:
                    provided = mask_prob.amax(dim=(0, 2, 3)) > 0
                provided = torch.as_tensor(provided).to(self.device, torch.bool)
                prob = self.run_step(reseed_step_views, (images, mask_prob), provided,
                                 None if self.deep_update_sync else deep_fires,
                                 self.deep_update_sync)
            else:
                prob = self.run_step(seed_step_views, (images, mask_prob))
            self.last_mem_ti = self.curr_ti
            if not self.deep_update_sync and deep_fires:
                self.last_deep_update_ti = self.curr_ti
            return prob
        if self.curr_ti == 0:
            raise ValueError("first frame must provide masks")
        is_mem_frame = (self.curr_ti - self.last_mem_ti) >= self.cfg.mem_every
        is_deep_update = None
        if not self.deep_update_sync:
            # a scheduled deep update takes effect on a memory frame only
            is_deep_update = (self.curr_ti - self.last_deep_update_ti
                              >= self.cfg.deep_update_every)
        prob = self.run_step(propagate_step_views, (images,), is_mem_frame,
                         self.deep_update_sync, is_deep_update)
        if is_mem_frame:
            self.last_mem_ti = self.curr_ti
            if not self.deep_update_sync and is_deep_update:
                self.last_deep_update_ti = self.curr_ti
        return prob

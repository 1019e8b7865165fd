"""XMem's three-tier memory over all views, in preallocated buffers.

Counterpart of ``d3fields_tpu/models/xmem/memory.py`` (the reference's
``XMem/inference/kv_memory_store.py:36-156`` and
``memory_manager.py:57-284``). Every buffer has a leading view axis and is
preallocated to its hard capacity, as in the JAX package:

- working memory holds ``max_mid_term_frames * HW`` elements; it
  consolidates the moment it is full, after which ``min_mid_term_frames *
  HW`` remain (frame 0 plus the newest ``min_mt - 1`` frames);
- long-term memory holds ``max_long_term_elements``; consolidation appends
  the ``num_prototypes`` most used candidates as prototypes, and eviction
  keeps the ``max_long - num_prototypes`` most used.

The sizes ``w_size`` and ``l_size`` are host integers: they follow from the
frame schedule alone, and every view's memory has the same sizes. So the
structural events (consolidate, evict, FIFO drop) are Python branches, the
attention reads only the filled slots, and a frame makes no host sync.
New elements are written in place.

Attention is the reference's anisotropic L2 similarity with shrinkage and
selection (``memory_util.py:7-40``) and a top-k softmax
(``memory_util.py:42-66``) through ``torch.topk``: the JAX package's
``topk_softmax_exact``. Ties among the usage values (many candidates sit at
usage 0) go to the lowest index, as ``lax.top_k`` breaks them, through a
stable descending sort. Multi-group memory (objects entering mid-video,
``multi_group=True``) follows the JAX package's semantics, per-object entry
offsets and long-term visibility bits included.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from d3fields_tpu_torch.config import XMemConfig
from d3fields_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor

_NEG_INF = -1e30
_LIFE0 = 1e-7  # the life count of a new element (the reference's 1e-7)


@dataclasses.dataclass
class XMemMemory:
    """Working and long-term stores and the per-object hidden state of every
    view. Shapes (V views, CK key dim, CV value dim, O objects, Wc/Lc
    capacities, (h, w) the key grid):
      wk, we (V, CK, Wc); ws, w_use, w_life (V, Wc); wv (V, O, CV, Wc);
      lk (V, CK, Lc); ls, l_use, l_life (V, Lc); lv (V, O, CV, Lc);
      hidden (V, O, CH, h, w).
    Multi-group bookkeeping: w_entry (V, O) the first working slot object o
    may attend, active (V, O) seeded objects, l_vis (V, O, Lc) whether
    object o's values informed long-term slot j.
    """

    wk: Tensor
    ws: Tensor
    we: Tensor
    wv: Tensor
    w_use: Tensor
    w_life: Tensor
    lk: Tensor
    ls: Tensor
    lv: Tensor
    l_use: Tensor
    l_life: Tensor
    hidden: Tensor
    w_entry: Tensor
    active: Tensor
    l_vis: Tensor
    w_size: int = 0
    l_size: int = 0
    hw: int = 0
    top_k: int = 30
    min_elements: int = 0
    num_prototypes: int = 128
    long_term: bool = True
    multi_group: bool = False

    @property
    def work_capacity(self) -> int:
        return self.wk.shape[-1]

    @property
    def long_capacity(self) -> int:
        return self.lk.shape[-1]


TENSOR_FIELDS = ("wk", "ws", "we", "wv", "w_use", "w_life", "lk", "ls", "lv", "l_use",
                  "l_life", "hidden", "w_entry", "active", "l_vis")


def init_memory(cfg: XMemConfig, num_views: int, num_objects: int, key_hw: Tuple[int, int],
                *, multi_group: bool = False, device=None) -> XMemMemory:
    """Empty stores for ``num_views`` views on an (h, w) key grid (1/16 of
    the padded input), on ``device`` (CUDA by default).

    ``cfg.enable_long_term=False`` is the reference's ``--disable_long_term``
    mode: no consolidation; past the working capacity the oldest frame but
    the first is dropped (the JAX package's documented deviation)."""
    if not cfg.enable_long_term and cfg.max_mid_term_frames < 2:
        raise ValueError(
            "enable_long_term=False needs max_mid_term_frames >= 2: the bounded "
            "working memory keeps the permanent first frame plus at least the "
            "newest frame")
    dev = resolve_device(device)
    h, w = key_hw
    hw = h * w
    wc = cfg.max_mid_term_frames * hw
    lc = cfg.max_long_term_elements if cfg.enable_long_term else 1
    V, O = num_views, num_objects
    ck, cv, ch = cfg.key_dim, cfg.value_dim, cfg.hidden_dim

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return XMemMemory(
        wk=z(V, ck, wc), ws=z(V, wc), we=z(V, ck, wc), wv=z(V, O, cv, wc),
        w_use=z(V, wc), w_life=torch.full((V, wc), _LIFE0, device=dev),
        lk=z(V, ck, lc), ls=z(V, lc), lv=z(V, O, cv, lc),
        l_use=z(V, lc), l_life=torch.full((V, lc), _LIFE0, device=dev),
        hidden=z(V, O, ch, h, w),
        # until an object is activated it may attend nothing
        w_entry=torch.full((V, O), wc, dtype=torch.int64, device=dev),
        active=torch.zeros((V, O), dtype=torch.bool, device=dev),
        l_vis=torch.zeros((V, O, lc), dtype=torch.bool, device=dev),
        hw=hw, top_k=cfg.top_k, min_elements=cfg.min_mid_term_frames * hw,
        # consolidation picks prototypes from the wc - min_elements
        # candidates; clamp for tiny key grids
        num_prototypes=min(cfg.num_prototypes, wc - cfg.min_mid_term_frames * hw),
        long_term=cfg.enable_long_term, multi_group=multi_group,
    )


def memory_to_host(mem: XMemMemory) -> Dict:
    """The memory as a dict of numpy arrays and host values (for pickling)."""
    return {f.name: (getattr(mem, f.name).cpu().numpy() if f.name in TENSOR_FIELDS
                     else getattr(mem, f.name)) for f in dataclasses.fields(mem)}


def memory_from_host(d: Dict, device) -> XMemMemory:
    """The inverse of :func:`memory_to_host`, with the tensors on ``device``."""
    dev = resolve_device(device)
    return XMemMemory(**{k: (torch.as_tensor(v).to(dev) if k in TENSOR_FIELDS else v)
                         for k, v in d.items()})


def activate_objects(mem: XMemMemory, new_objects: Tensor) -> None:
    """Mark ``new_objects`` ((O,) or (V, O) bool) as entering now: their
    visibility starts at the next written slot (``kv_memory_store.py:58-79``)."""
    entering = new_objects & ~mem.active
    mem.w_entry = torch.where(entering, torch.full_like(mem.w_entry, mem.w_size), mem.w_entry)
    mem.active = mem.active | new_objects


# ---------------------------------------------------------------------------
# similarity / affinity (reference memory_util.py)
# ---------------------------------------------------------------------------

def similarity(mk: Tensor, ms: Optional[Tensor], qk: Tensor, qe: Optional[Tensor]) -> Tensor:
    """Anisotropic L2 similarity (``memory_util.py:7-40``), batched over
    leading dims: mk (..., CK, L), ms (..., L) or None, qk (..., CK, N),
    qe (..., CK, N) or None -> (..., L, N). The JAX package's form:
    -mk².qe + 2mk.(qk*qe) as one product of depth 2·CK."""
    ck = mk.shape[-2]
    if qe is not None:
        m2 = torch.cat([-torch.square(mk), 2.0 * mk], dim=-2)  # (..., 2CK, L)
        q2 = torch.cat([qe, qk * qe], dim=-2)                   # (..., 2CK, N)
        b_sq = torch.sum(qe * torch.square(qk), dim=-2)          # (..., N)
        sim = torch.matmul(m2.transpose(-1, -2), q2) - b_sq[..., None, :]
    else:
        a_sq = torch.sum(torch.square(mk), dim=-2)
        sim = -a_sq[..., :, None] + 2.0 * torch.matmul(mk.transpose(-1, -2), qk)
    if ms is not None:
        sim = sim * ms[..., :, None]
    return sim / float(np.sqrt(ck))


def topk_softmax(sim: Tensor, top_k: int, *, return_usage: bool = False):
    """Top-k sparse softmax over the memory axis (``memory_util.py:42-66``):
    sim (..., L, N) -> the dense affinity with only each query's top-k
    entries nonzero, and optionally the usage (..., L), the affinity's
    row sums. Entries masked to -1e30 get weight 0 even where a query has
    fewer than k valid entries."""
    k = min(top_k, sim.shape[-2])
    vals, idx = torch.topk(sim, k, dim=-2)                  # sorted, max first
    vals = torch.exp(vals - vals[..., :1, :])
    vals = vals / vals.sum(dim=-2, keepdim=True)
    affinity = torch.zeros_like(sim).scatter_(-2, idx, vals)
    if return_usage:
        return affinity, affinity.sum(dim=-1)
    return affinity


def softmax_full(sim: Tensor) -> Tensor:
    """Plain softmax over the memory axis (consolidation potentiation)."""
    return torch.softmax(sim, dim=-2)


def _topk_lowest_index(x: Tensor, k: int) -> Tensor:
    """Indices of the ``k`` largest entries of the last dim, largest first,
    ties at the lowest index (``lax.top_k``'s order; ``torch.topk`` promises
    no order on ties)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _take_last(x: Tensor, idx: Tensor) -> Tensor:
    """``x[..., idx[v]]`` per view: x (V, ..., L), idx (V, K)."""
    shape = (idx.shape[0],) + (1,) * (x.dim() - 2) + (idx.shape[-1],)
    return torch.gather(x, -1, idx.reshape(shape).expand(tuple(x.shape[:-1]) + (idx.shape[-1],)))


# ---------------------------------------------------------------------------
# match / readout
# ---------------------------------------------------------------------------

def _readout(mem: XMemMemory, affinity: Tensor) -> Tensor:
    """values @ affinity over the filled [long-term, working] slots.
    affinity (V, L, N) shared by the objects, or (V, O, L, N) per object.
    Returns (V, O, CV, N)."""
    l, w = mem.l_size, mem.w_size
    V, O, CV = mem.wv.shape[:3]
    lv, wv = mem.lv[..., :l], mem.wv[..., :w]
    if affinity.dim() == 3:
        out = torch.matmul(wv.reshape(V, O * CV, w), affinity[:, l:])
        if l:
            out = out + torch.matmul(lv.reshape(V, O * CV, l), affinity[:, :l])
        return out.reshape(V, O, CV, -1)
    out = torch.matmul(wv, affinity[:, :, l:])
    if l:
        out = out + torch.matmul(lv, affinity[:, :, :l])
    return out


def _count_usage(mem: XMemMemory, usage: Tensor) -> None:
    """Usage accounting (``kv_memory_store.update_usage``): +usage and life
    +1 on the filled slots. usage (V, l_size + w_size)."""
    l, w = mem.l_size, mem.w_size
    mem.l_use[:, :l] += usage[:, :l]
    mem.l_life[:, :l] += 1.0
    mem.w_use[:, :w] += usage[:, l:]
    mem.w_life[:, :w] += 1.0


def match_memory(mem: XMemMemory, qk: Tensor, qe: Optional[Tensor], *,
                 count_usage: bool = True) -> Tensor:
    """Attention over [long-term, working] memory (``memory_manager.py:57-150``).

    qk/qe (V, CK, N) query keys/selection. Returns the readout (V, O, CV, N)
    and, with ``count_usage``, adds this frame's usage to the memory."""
    l, w = mem.l_size, mem.w_size
    keys = torch.cat([mem.lk[..., :l], mem.wk[..., :w]], dim=-1)
    shr = torch.cat([mem.ls[..., :l], mem.ws[..., :w]], dim=-1)
    sim = similarity(keys, shr, qk, qe)  # (V, L, N)
    if mem.multi_group:
        return _match_memory_multi_group(mem, sim, count_usage)
    affinity, usage = topk_softmax(sim, mem.top_k, return_usage=True)
    readout = _readout(mem, affinity)
    if count_usage:
        _count_usage(mem, usage)
    return readout


def _match_memory_multi_group(mem: XMemMemory, sim: Tensor, count_usage: bool) -> Tensor:
    """Per-object affinity over each object's visible slots: the long-term
    slots its values informed and the working slots written since it entered
    (the reference's per-group softmax, ``memory_manager.py:120-135``).
    An object with no visible slot reads zeros. Usage counts each group
    (objects sharing an entry) once (``memory_manager.py:136-145``), and only
    with long-term memory on."""
    l, w = mem.l_size, mem.w_size
    slot = torch.arange(w, device=sim.device)
    vis = torch.cat([mem.l_vis[..., :l], slot >= mem.w_entry[..., None]], dim=-1)  # (V, O, L)
    any_vis = vis.any(dim=-1)                                                      # (V, O)
    neg = torch.full_like(sim, _NEG_INF)[:, None]
    sim_o = torch.where(vis[..., None], sim[:, None], neg)
    # an object with nothing visible would softmax over all -inf: feed it
    # the global similarity and zero its readout after
    sim_o = torch.where(any_vis[..., None, None], sim_o, sim[:, None])
    affinity = topk_softmax(sim_o, mem.top_k)                                      # (V, O, L, N)
    readout = torch.where(any_vis[..., None, None], _readout(mem, affinity),
                          torch.zeros((), device=sim.device))
    if not (mem.long_term and count_usage):
        return readout
    aff_sums = torch.where(any_vis[..., None], affinity.sum(dim=-1),
                           torch.zeros((), device=sim.device))
    same = mem.w_entry[:, :, None] == mem.w_entry[:, None, :]
    group_size = torch.sum(same & mem.active[:, None, :], dim=-1)
    weight = torch.where(mem.active, 1.0 / torch.clamp(group_size, min=1).to(sim.dtype),
                         torch.zeros((), device=sim.device))
    _count_usage(mem, torch.einsum("vo,vol->vl", weight, aff_sums))
    return readout


# ---------------------------------------------------------------------------
# add + consolidation + eviction
# ---------------------------------------------------------------------------

def _working(mem: XMemMemory):
    return (mem.wk, mem.ws, mem.we, mem.wv, mem.w_use, mem.w_life)


def _consolidate(mem: XMemMemory) -> None:
    """Working -> long-term compression; runs when the working memory is
    full (``memory_manager.py:211-284``). Candidates are everything between
    frame 0 and the newest ``min_mt - 1`` frames; the ``num_prototypes``
    most used become long-term elements through an affinity-weighted
    readout; the candidates leave the working memory."""
    hw, wc, minw, P = mem.hw, mem.work_capacity, mem.min_elements, mem.num_prototypes
    cand_lo, cand_hi = hw, wc - minw + hw
    n_cand = cand_hi - cand_lo
    V, O, CV = mem.wv.shape[:3]
    cand_k = mem.wk[..., cand_lo:cand_hi]
    cand_s = mem.ws[..., cand_lo:cand_hi]
    cand_e = mem.we[..., cand_lo:cand_hi]
    cand_v = mem.wv[..., cand_lo:cand_hi]
    cand_usage = (mem.w_use / mem.w_life)[..., cand_lo:cand_hi]

    proto_idx = _topk_lowest_index(cand_usage, P)               # (V, P)
    proto_k = _take_last(cand_k, proto_idx)
    proto_e = _take_last(cand_e, proto_idx)
    # potentiation: full softmax over the candidates
    sim = similarity(cand_k, cand_s, proto_k, proto_e)            # (V, n_cand, P)
    aff = softmax_full(sim)
    proto_s = torch.matmul(cand_s[:, None, :], aff)[:, 0]         # (V, P)
    if mem.multi_group:
        # each object's prototype values read only its visible candidates
        abs_slot = cand_lo + torch.arange(n_cand, device=aff.device)
        vis = abs_slot >= mem.w_entry[..., None]                   # (V, O, n_cand)
        any_vis = vis.any(dim=-1)
        sim = sim[:, None]
        sim_o = torch.where(vis[..., None], sim, torch.full_like(sim, _NEG_INF))
        sim_o = torch.where(any_vis[..., None, None], sim_o, sim)
        proto_v = torch.where(any_vis[..., None, None],
                              torch.matmul(cand_v, softmax_full(sim_o)),
                              torch.zeros((), device=aff.device))
        vis_new = mem.active & (mem.w_entry < cand_hi)             # (V, O)
    else:
        proto_v = torch.matmul(cand_v.reshape(V, O * CV, n_cand), aff).reshape(V, O, CV, P)

    # drop the candidates: keep [0, hw) and move the tail after it
    tail = minw - hw
    for buf in _working(mem):
        buf[..., hw:hw + tail] = buf[..., cand_hi:cand_hi + tail].clone()
    mem.w_size = minw
    if mem.multi_group:
        # entries past the candidates slide left with the tail; entries
        # inside them clamp to the tail start; inactive objects keep the
        # see-nothing sentinel
        e = mem.w_entry
        moved = torch.where(e >= cand_hi, e - n_cand,
                            torch.where(e >= cand_lo, torch.full_like(e, hw), e))
        mem.w_entry = torch.where(mem.active, moved, e)

    # append the prototypes (the eviction before consolidation made room)
    l0 = mem.l_size
    mem.lk[..., l0:l0 + P] = proto_k
    mem.ls[..., l0:l0 + P] = proto_s
    mem.lv[..., l0:l0 + P] = proto_v
    mem.l_use[..., l0:l0 + P] = 0.0
    mem.l_life[..., l0:l0 + P] = _LIFE0
    mem.l_size = l0 + P
    if mem.multi_group:
        mem.l_vis[..., l0:l0 + P] = vis_new[..., None]


def _evict_long_term(mem: XMemMemory) -> None:
    """Keep the ``long_capacity - num_prototypes`` most used long-term
    elements, in their temporal order (``kv_memory_store.py:135-156``)."""
    lc = mem.long_capacity
    keep = lc - mem.num_prototypes
    valid = torch.arange(lc, device=mem.lk.device) < mem.l_size
    usage = torch.where(valid, mem.l_use / mem.l_life, torch.full_like(mem.l_use, -np.inf))
    keep_idx = torch.sort(_topk_lowest_index(usage, keep), dim=-1).values
    for buf, fill in ((mem.lk, 0.0), (mem.ls, 0.0), (mem.lv, 0.0), (mem.l_use, 0.0),
                      (mem.l_life, _LIFE0)) + (((mem.l_vis, False),) if mem.multi_group else ()):
        buf[..., :keep] = _take_last(buf, keep_idx)
        buf[..., keep:] = fill
    mem.l_size = min(mem.l_size, keep)


def add_memory(mem: XMemMemory, key: Tensor, shrinkage: Tensor, value: Tensor,
               selection: Optional[Tensor]) -> None:
    """Append one frame's HW elements and consolidate when full
    (``memory_manager.py:152-189``; eviction precedes consolidation so the
    prototypes always fit). key (V, CK, HW), shrinkage (V, HW), value
    (V, O, CV, HW), selection (V, CK, HW) or None."""
    hw = mem.hw
    if not mem.long_term and mem.w_size >= mem.work_capacity:
        # --disable_long_term: FIFO-drop the oldest frame but the first
        # before appending
        _fifo_drop_second_frame(mem)
    s = mem.w_size
    mem.wk[..., s:s + hw] = key
    mem.ws[..., s:s + hw] = shrinkage
    mem.we[..., s:s + hw] = 0.0 if selection is None else selection
    mem.wv[..., s:s + hw] = value
    mem.w_use[..., s:s + hw] = 0.0
    mem.w_life[..., s:s + hw] = _LIFE0
    mem.w_size = s + hw
    if mem.long_term and mem.w_size >= mem.work_capacity:
        if mem.l_size >= mem.long_capacity - mem.num_prototypes:
            _evict_long_term(mem)
        _consolidate(mem)


def _fifo_drop_second_frame(mem: XMemMemory) -> None:
    """Drop the oldest frame but the first: keep [0, hw) and shift
    [2hw, wc) left by one frame."""
    hw, wc = mem.hw, mem.work_capacity
    tail = wc - 2 * hw
    for buf in _working(mem):
        buf[..., hw:hw + tail] = buf[..., 2 * hw:2 * hw + tail].clone()
    e = mem.w_entry
    mem.w_entry = torch.where(mem.active & (e > hw), torch.clamp(e - hw, min=hw), e)
    mem.w_size -= hw

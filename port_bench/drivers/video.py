"""Video traffic: a closed loop of one client sending a video's next frame
and waiting for its index mask, as XMem's evaluation propagates a video.

A request is one frame: a (H, W, 3) uint8 RGB frame in host memory goes to
``VideoMaskTracker.process`` (one view), and the (H, W) index mask comes
back on the host, where ``process(..., return_index=True)`` ends. A
video's first frame goes in with its index mask and starts a new tracker,
as ``apps/eval_xmem.py::run_single`` does for each video. The window
alternates between the set-up's videos, each from its first frame.

The driver wraps the program's calls in the harness's probe: the key
encoder (``encode_key``) as ``xmem_key``, ``match_memory`` as
``xmem_read``, the decoder (``segment``) as ``xmem_decode``, and the value
encoder with ``add_memory`` (a memory frame) as ``xmem_memorize``. The
program's tracer (``utils/profiling.py::tracer``) is on only while the
harness's traced part is, and its counters come back from
:meth:`Cell.record`.

The check holds the timed path's answers to the plain reference
(``reference/xmem.py``) in the configuration's precision: the sampled
frames and the last frame of the window's first whole video, each against
the reference's replay of its video from the first frame
(:func:`readings`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from port_bench import costs, costs_xmem, weights_xmem
from port_bench.drivers import common
from port_bench.harness import check
from port_bench.reference import xmem as ref_xmem
from port_bench.videos import Video

COMPARED = ("prob_abs", "label_mismatch_share", "readout_rel", "read_elements")


def _tracer():
    from d3fields_tpu_torch.utils.profiling import tracer

    return tracer


def _memory_module():
    from d3fields_tpu_torch.models.xmem import memory

    return memory


def render_videos(ctx):
    """The traffic's videos of the run: [(frames (T, H, W, 3), mask0 (H, W))]."""
    v, tr = ctx.config["video"], ctx.traffic
    return [Video(ctx.seed, i, v["height"], v["width"], v["objects"], tr["frames"],
                  tr["video"]).render_all() for i in range(tr["videos"])]


def padded_hw(config: dict):
    v = config["video"]
    return -(-v["height"] // 16) * 16, -(-v["width"] // 16) * 16


class Cell:
    def __init__(self, ctx):
        self.ctx, self.probe = ctx, ctx.probe
        self.cfg = ctx.config
        self.T = int(ctx.traffic["frames"])
        self.samples: Dict[int, dict] = {}
        self.last: Optional[dict] = None
        self.failed = 0
        self.tracker = None
        self.timed = False        # set-up done: the frames count
        self.flops, self.consolidations = [], []
        self._video_cons = 0      # consolidations of the current video
        self.traced = 0
        self._tracing = False
        self._req = {}
        self._memorize = None
        self._saved = None
        self.last_readings = {}

    # -- set-up ---------------------------------------------------------------
    def xmem_config(self):
        from d3fields_tpu_torch.config import XMemConfig

        return XMemConfig(**self.cfg["xmem"], compute_dtype=self.cfg["compute_dtype"])

    def setup(self) -> None:
        from d3fields_tpu_torch.models.xmem.network import XMem
        from d3fields_tpu_torch.utils.convert import audit_state_dict

        ctx = self.ctx
        lap = common.Laps(ctx)
        common.set_matmul_precision(self.cfg)
        self.videos = render_videos(ctx)
        lap("inputs_s")
        self.xcfg = self.xmem_config()
        model = XMem(self.xcfg, device=ctx.device)
        sd = weights_xmem.xmem_weights(self.cfg["xmem"], ctx.seed, ctx.device)
        model.load_state_dict(audit_state_dict(model, sd, "xmem"), strict=True)
        self.model = model.eval()
        del sd
        lap("program_s")
        self._wrap_memory()
        self.k = 0
        for _ in range(self.T):
            self.step(None)
        lap("warmup_s")
        self.setup_laps = lap.laps
        self.k, self.timed = 0, True

    def _wrap_memory(self) -> None:
        """``match_memory`` and ``add_memory`` inside the probe's spans; the
        read's answer and its size kept for a sampled frame."""
        M, probe, req = _memory_module(), self.probe, self._req
        match, add = M.match_memory, M.add_memory
        self._saved = (match, add)

        def match_memory(mem, *args, **kwargs):
            req["read_elements"] = mem.l_size + mem.w_size
            with probe("xmem_read"):
                out = match(mem, *args, **kwargs)
            if req.get("keep"):
                req["readout"] = out
            return out

        def add_memory(*args, **kwargs):
            try:
                return add(*args, **kwargs)
            finally:
                if self._memorize is not None:
                    self._memorize.__exit__(None, None, None)
                    self._memorize = None

        M.match_memory, M.add_memory = match_memory, add_memory

    def _wrap_model(self, model) -> None:
        """The tracker's own copy of the networks: the key encoder, the
        decoder and the value encoder inside the probe's spans (the value
        encoder's closed at the end of ``add_memory``)."""
        probe, cls = self.probe, type(model)
        encode_key, segment, encode_value = (cls.encode_key.__get__(model),
                                             cls.segment.__get__(model),
                                             cls.encode_value.__get__(model))

        def key(*args, **kwargs):
            with probe("xmem_key"):
                return encode_key(*args, **kwargs)

        def decode(*args, **kwargs):
            with probe("xmem_decode"):
                return segment(*args, **kwargs)

        def value(*args, **kwargs):
            self._memorize = probe("xmem_memorize")
            self._memorize.__enter__()
            return encode_value(*args, **kwargs)

        model.encode_key, model.segment, model.encode_value = key, decode, value

    def _switch_tracer(self) -> bool:
        """The program's tracer on while the harness traces, off otherwise."""
        traced = self.probe.spans is not None or self.probe.annotate
        tracer = _tracer()
        if traced and not tracer.on:
            tracer.reset()
            tracer.enable()
            self._tracing = True
        elif not traced and self._tracing:
            tracer.disable()
            self._tracing = False
        return traced and self._tracing

    # -- the request ------------------------------------------------------------
    def step(self, slot) -> float:
        from d3fields_tpu_torch.seg.video_tracker import VideoMaskTracker

        k = self.k
        self.k += 1
        v, t = (k // self.T) % len(self.videos), k % self.T
        frames, mask0 = self.videos[v]
        self.traced += self._switch_tracer()
        self._req.clear()
        self._req["keep"] = slot is not None or (
            self.timed and t == self.T - 1 and self.last is None)
        if t == 0:
            self.tracker = None
            self.tracker = VideoMaskTracker(self.model, self.xcfg, 1, self.cfg["video"]["objects"],
                                            frames.shape[1:3], size=self.xcfg.size,
                                            device=self.ctx.device)
            self._wrap_model(self.tracker.core.model)
            self._video_cons = 0
        mem = self.tracker.core.mem
        w_before = mem.w_size
        if t == 0:
            index = self.tracker.process(frames[t][None], mask0[None], return_index=True)
        else:
            index = self.tracker.process(frames[t][None], return_index=True)
        core = self.tracker.core
        is_mem = core.last_mem_ti == core.curr_ti
        # a memory frame adds a frame's elements unless the working memory consolidated
        self._video_cons += is_mem and mem.w_size != w_before + mem.hw
        if self.timed:
            H, W = padded_hw(self.cfg)
            self.flops.append(costs_xmem.frame_flops(
                self.cfg["xmem"], H, W, self.cfg["video"]["objects"], t == 0, is_mem,
                self._req.get("read_elements", 0)))
            if t == self.T - 1:
                self.consolidations.append(self._video_cons)
        if self._req["keep"]:
            sample = {"video": v, "t": t, "prob": self.tracker.last_prob[0],
                      "index": index[0], "readout": self._req.get("readout"),
                      "read_elements": self._req.get("read_elements", 0)}
            if slot is not None:
                self.samples[slot] = sample
            if t == self.T - 1 and self.last is None and self.timed:
                self.last = sample
        return 1.0

    def held_bytes(self) -> int:
        storages = {}
        for s in self.compared():
            for x in (s["prob"], s["readout"]):
                if x is not None and x.is_cuda:
                    storages[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
        return sum(storages.values())

    def record(self) -> dict:
        rec = {"flops_per_step": float(np.mean(self.flops)) if self.flops else 0.0,
               "peak_flops": costs.PEAK_FLOPS[self.cfg["compute_dtype"]],
               "traced_requests": self.traced}
        if self._tracing:
            tracer = _tracer()
            rec["program_counters"] = tracer.summary()["counters"]
            tracer.disable()
            self._tracing = False
        return rec

    def release(self) -> None:
        if self._tracing:
            _tracer().disable()
            self._tracing = False
        if self._saved is not None:
            M = _memory_module()
            M.match_memory, M.add_memory = self._saved
            self._saved = None
        self.tracker = self.model = None
        common.free_device(self.ctx.device)

    # -- the check --------------------------------------------------------------
    def compared(self):
        """The sampled frames and the window's last frame of a whole video."""
        return list(self.samples.values()) + ([self.last] if self.last else [])

    def check(self) -> dict:
        ctx, lim = self.ctx, self.ctx.limits
        P = common.reference_mode(ctx)
        worst = reference_readings(self.cfg, ctx.seed, ctx.device, self.videos, self.compared(),
                                   lim["margins"], P)
        for r in worst.pop("each"):
            self.failed += any(r[k] > lim[k] for k in COMPARED)
        self.last_readings = worst
        checks = {k: check(worst.get(k, float("inf")), lim[k]) for k in COMPARED}
        checks["samples"] = check(len(self.samples), lim["samples"], "min")
        checks["consolidations"] = check(min(self.consolidations, default=0),
                                         lim["consolidations"], "min")
        return checks


# ---------------------------------------------------------------------------
# The compared numbers
# ---------------------------------------------------------------------------

def readings(prog: dict, ref: dict, margins: dict) -> dict:
    """The compared numbers of one frame. ``prog``: the program's ``prob``
    (O+1, H, W), ``index`` (H, W) uint8, ``readout`` (1, O, CV, h*w) or
    None, ``read_elements``; ``ref``: the reference's ``prob``, ``readout``
    (O, CV, h*w) or None and ``read_elements`` at the same frame.

    ``prob_abs``: the largest probability error of any pixel and channel.
    ``label_mismatch_share``: the share of pixels whose label differs from
    the reference's argmax, among those whose reference top-two margin is
    at least ``label_margin``. ``readout_rel``: the largest relative L2
    error of an object's memory readout. ``read_elements``: the difference
    in the number of memory elements the read attended."""
    p_ref = ref["prob"].float()
    p_prog = prog["prob"].to(p_ref.device).float()
    top2 = p_ref.topk(2, dim=0).values
    clear = (top2[0] - top2[1]) >= margins["label_margin"]
    labels = torch.as_tensor(np.asarray(prog["index"]), device=p_ref.device).long()
    mismatch = (labels != p_ref.argmax(0)) & clear
    out = {"prob_abs": float((p_prog - p_ref).abs().max()),
           "label_mismatch_share": float(mismatch.sum()) / max(int(clear.sum()), 1),
           "readout_rel": 0.0,
           "read_elements": abs(int(prog["read_elements"]) - int(ref["read_elements"]))}
    if ref["readout"] is not None:
        a = prog["readout"].reshape(ref["readout"].shape).to(p_ref.device).double()
        b = ref["readout"].double()
        out["readout_rel"] = float(((a - b).flatten(1).norm(dim=1)
                                    / b.flatten(1).norm(dim=1).clamp(min=1e-30)).max())
    return out


def reference_readings(config: dict, seed: int, device, videos, compared, margins: dict,
                       P) -> dict:
    """The worst of each compared number over ``compared`` (frames with
    ``video``, ``t`` and the program's answers), each video replayed by the
    reference once through its last compared frame; ``each``: every
    frame's readings."""
    w = weights_xmem.xmem_weights(config["xmem"], seed, device)
    worst, each = {}, []
    for v in sorted({s["video"] for s in compared}):
        frames, mask0 = videos[v]
        mine = [s for s in compared if s["video"] == v]
        ref = ref_xmem.replay(w, lambda t: frames[t], mask0, config["xmem"],
                              config["video"]["objects"], P,
                              [s["t"] for s in mine], device)
        for s in mine:
            r = readings(s, ref[s["t"]], margins)
            each.append(r)
            for key, val in r.items():
                worst[key] = max(worst.get(key, 0), val)
        del ref
        common.free_device(device)
    return {**worst, "each": each}

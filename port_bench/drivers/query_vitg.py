"""Field-query traffic on DINOv2 ViT-g/14 with registers: ``drivers/query.py``'s
closed loop, with the configuration's backbone.

The program's ``Dinov2Backbone`` is built from a ``Dinov2Config`` that
names the configuration's feed-forward kind, register count and
positional interpolation, over ``weights_vitg.py``'s weights; the check
holds its descriptors and answers to ``reference/dinov2_vitg.py``;
``flops_per_step`` is ``costs_vitg.py``'s. The rest (the rig, the points,
``Fusion.update`` and the bf16 fused query, the compared numbers) is
``drivers/query.py``'s.

While the harness traces, the program's tracer is on and its counters come
back from :meth:`Cell.record`; while the profile records, each transformer
block runs inside a ``pb.dinov2`` range and its feed-forward inside
``pb.dinov2_ffn`` (the harness charges a device op to the range opened
last before its launch, so each block reopens ``dinov2`` after the last
feed-forward's range closed). The host-clock ``dinov2`` span is the
query driver's, not cut by the feed-forward's ranges.
"""

from __future__ import annotations

import torch

from port_bench import costs_vitg, weights_vitg
from port_bench.drivers import common, query
from port_bench.harness import check
from port_bench.reference import dinov2_vitg as ref_vitg
from port_bench.rig import query_points

MODEL_KEYS = ("hidden_size", "num_layers", "num_heads", "mlp_ratio", "patch_size", "image_size",
              "ffn", "num_register_tokens", "interpolate_antialias", "interpolate_offset")


def _tracer():
    from d3fields_tpu_torch.utils.profiling import tracer

    return tracer


def program_backbone(ctx):
    """The program's ``Dinov2Backbone`` of the configuration's model over
    the benchmark's weights, in its compute dtype, inside the ``dinov2``
    span."""
    from d3fields_tpu_torch.models import dinov2

    m = ctx.config["model"]
    cfg = dinov2.Dinov2Config(**{k: m[k] for k in MODEL_KEYS})
    if cfg.ffn_hidden != m["ffn_hidden"]:
        raise ValueError(f"the program's feed-forward is {cfg.ffn_hidden} wide, the "
                         f"configuration's {m['ffn_hidden']}")
    model = dinov2.Dinov2(cfg, device=ctx.device)
    model.load_state_dict(weights_vitg.vitg_weights(m, ctx.seed, ctx.device))
    return common.SpannedBackbone(
        dinov2.Dinov2Backbone(model.eval(), compute_dtype=ctx.config["compute_dtype"],
                              device=ctx.device), ctx.probe)


def _ranged(fn, name: str):
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return call


class Cell(query.Cell):
    def __init__(self, ctx):
        super().__init__(ctx)
        self._tracing = False
        self._ranged = False
        self.traced = 0

    def setup(self) -> None:
        from d3fields_tpu_torch import D3FieldsConfig, Fusion, FusionConfig

        ctx = self.ctx
        lap = common.Laps(ctx)
        common.set_matmul_precision(ctx.config)
        backbone = program_backbone(ctx)
        self.blocks = list(backbone.backbone.model.blocks)
        lap("program_s")
        self.rig = common.make_rig(ctx)
        self.frames = self.rig.frame_pool()
        self.points = query_points(ctx.seed, self.tr["points"], self.tr["point_sets"],
                                   self.tr["box"])
        lap("inputs_s")
        self.fus = Fusion(config=D3FieldsConfig(fusion=FusionConfig(
            mu=ctx.config["rig"]["mu"], query_tile=self.tr["tile"])),
            feature_backend=backbone, device=ctx.device)
        self.k = 0
        for _ in range(self.tr["warmup_requests"]):
            self.step(None)
        lap("warmup_s")
        self.setup_laps = lap.laps
        self.min_launches = None

    def _switch(self) -> bool:
        """The program's tracer on while the harness traces, the blocks'
        profile ranges while the profile records; off otherwise."""
        traced = self.probe.spans is not None or self.probe.annotate
        tracer = _tracer()
        if traced and not tracer.on:
            tracer.reset()
            tracer.enable()
            self._tracing = True
        elif not traced and self._tracing:
            tracer.disable()
            self._tracing = False
        if self.probe.annotate != self._ranged:
            for blk in self.blocks:
                if self.probe.annotate:
                    blk.forward = _ranged(type(blk).forward.__get__(blk), "pb.dinov2")
                    blk.mlp.forward = _ranged(type(blk.mlp).forward.__get__(blk.mlp),
                                              "pb.dinov2_ffn")
                else:
                    del blk.forward, blk.mlp.forward
            self._ranged = self.probe.annotate
        return traced and self._tracing

    def step(self, slot) -> float:
        self.traced += self._switch()
        return super().step(slot)

    def record(self) -> dict:
        c, r = self.ctx.config, self.ctx.config["rig"]
        rec = super().record()
        channels = c["model"]["hidden_size"] + (1 + r["spheres"]) * ("mask" in self.names)
        rec["flops_per_step"] = costs_vitg.query_flops(c["model"], r, self.tr["points"], channels)
        rec["traced_requests"] = self.traced
        if self._tracing:
            rec["program_counters"] = _tracer().summary()["counters"]
            _tracer().disable()
            self._tracing = False
        return rec

    def release(self) -> None:
        if self._tracing:
            _tracer().disable()
            self._tracing = False
        self.blocks = []
        super().release()

    def reference_descriptors(self, w: dict, frame: dict, P):
        r = self.ctx.config["rig"]
        return ref_vitg.descriptors(w, frame["color"], self.ctx.config["model"], r["patch_hw"], P)

    def check(self) -> dict:
        ctx = self.ctx
        P = common.reference_mode(ctx)
        w = weights_vitg.vitg_weights(ctx.config["model"], ctx.seed, ctx.device)
        worst = {}
        with torch.no_grad():
            for pos, pset, desc, out in self.samples.values():
                desc_ref = self.reference_descriptors(w, self.frames[pos], P)
                r = self.readings(desc, out, pos, pset, desc_ref, P)
                bad = [k for k, v in r.items() if k in ctx.limits and v > ctx.limits[k]]
                self.failed += bool(bad)
                for k, v in r.items():
                    worst[k] = max(worst.get(k, 0), v)
        self.last_readings = worst
        lim = ctx.limits
        checks = {k: check(worst.get(k, float("inf")), lim[k])
                  for k in ("desc_rel", "feat_rel", "dist_abs", "mask_abs", "valid_mismatch")}
        checks["samples"] = check(len(self.samples), lim["samples"], "min")
        checks["kernel_launches"] = check(self.min_launches or 0, 1, "min")
        return checks

"""Field-query traffic: a closed loop of one client sending a new 4-view
observation, then one query of many points, waiting for the answers.

A request hands the program an observation (colour, depth, cameras and
instance masks, numpy, as a rig's host gives it), which ``Fusion.update``
ingests and runs DINOv2 on, then queries the field at the request's points:
through the facade ``Fusion.batch_eval`` where the configuration queries in
float32, or through ``fields.fusion.batch_eval(..., fused=True,
matmul_dtype=...)``, the entry of the kernel's bf16-table route, which the
facade does not offer. The answers stay on the device; the request ends in
a synchronise.
"""

from __future__ import annotations

import torch

from port_bench import costs, weights
from port_bench.drivers import common
from port_bench.harness import check
from port_bench.reference import field
from port_bench.rig import query_points


class Cell:
    def __init__(self, ctx):
        self.ctx, self.probe = ctx, ctx.probe
        self.tr = ctx.traffic
        self.names = tuple(self.tr["return_names"])
        self.samples = {}
        self.failed = 0
        self.min_launches = None

    def setup(self) -> None:
        from d3fields_tpu_torch import D3FieldsConfig, Fusion, FusionConfig

        ctx = self.ctx
        lap = common.Laps(ctx)
        common.set_matmul_precision(ctx.config)
        self.rig = common.make_rig(ctx)
        self.frames = self.rig.frame_pool()
        self.points = query_points(ctx.seed, self.tr["points"], self.tr["point_sets"],
                                   self.tr["box"])
        lap("inputs_s")
        self.fus = Fusion(config=D3FieldsConfig(fusion=FusionConfig(
            mu=ctx.config["rig"]["mu"], query_tile=self.tr["tile"])),
            feature_backend=common.program_backbone(ctx), device=ctx.device)
        lap("program_s")
        self.k = 0
        for _ in range(self.tr["warmup_requests"]):
            self.step(None)
        lap("warmup_s")
        self.setup_laps = lap.laps
        self.min_launches = None

    def _query(self, pts):
        dtype = self.ctx.config["query_matmul_dtype"]
        if dtype == "float32":
            return self.fus.batch_eval(pts, self.names)
        from d3fields_tpu_torch.fields.fusion import batch_eval

        return batch_eval(self.fus.state, pts, self.names, tile=self.tr["tile"], fused=True,
                          matmul_dtype=dtype)

    def _launches(self) -> int:
        from d3fields_tpu_torch.fields import kernels

        fn = kernels.fused_weighted_interp
        bf16 = self.ctx.config["query_matmul_dtype"] == "bfloat16"
        return fn.launches_bf16 if bf16 else fn.launches

    def step(self, slot) -> float:
        pos = self.rig.position(self.k)
        pset = self.k % len(self.points)
        self.k += 1
        before = self._launches()
        self.fus.update(common.observation(self.frames[pos]))
        with self.probe("batch_eval"):
            out = self._query(self.points[pset])
        self.probe.sync()
        launched = self._launches() - before
        self.min_launches = launched if self.min_launches is None else \
            min(self.min_launches, launched)
        if slot is not None:
            self.samples[slot] = (pos, pset, self.fus.state.dino_feats, out)
        return float(self.tr["points"])

    def held_bytes(self) -> int:
        """The card's bytes of the sampled answers kept for the check (not
        the sampled descriptors, which the program's state may still hold)."""
        storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                    for _, _, _, out in self.samples.values() for t in out.values()}
        return sum(storages.values())

    def record(self) -> dict:
        c, r = self.ctx.config, self.ctx.config["rig"]
        V, (ph, pw) = r["views"], r["patch_hw"]
        channels = c["model"]["hidden_size"] + (1 + r["spheres"]) * ("mask" in self.names)
        return {
            "flops_per_step": costs.query_flops(c["model"], r, self.tr["points"], channels),
            "peak_flops": costs.PEAK_FLOPS[c["compute_dtype"]],
            "kernel_tile": {"views": V, "rows": ph * pw, "channels": c["model"]["hidden_size"],
                            "points": min(self.tr["tile"], self.tr["points"]),
                            "itemsize": 2 if c["query_matmul_dtype"] == "bfloat16" else 4},
        }

    def release(self) -> None:
        self.fus = None
        common.free_device(self.ctx.device)

    def readings(self, desc: torch.Tensor, out: dict, pos: int, pset: int, desc_ref, P) -> dict:
        """The compared numbers of one request's answers against the reference."""
        frame = self.frames[pos]
        obs = common.obs_tensors(frame, self.ctx.device)
        pts = self.points[pset]
        block = self.tr["check_block"]
        r = {"desc_rel": common.token_rel(desc, desc_ref), "feat_rel": 0.0, "dist_abs": 0.0,
             "mask_abs": 0.0, "valid_mismatch": 0, "ambiguous": 0}
        for s in range(0, pts.shape[0], block):
            p = torch.as_tensor(pts[s:s + block], device=self.ctx.device)
            ref = field.query(obs, desc_ref, p, self.ctx.config["rig"]["mu"], P, self.names)
            keep = ~ref["ambiguous"]
            got = {k: v[s:s + block] for k, v in out.items()}
            r["ambiguous"] += int(ref["ambiguous"].sum())
            r["valid_mismatch"] += int((got["valid_mask"] != ref["valid_mask"])[keep].sum())
            r["dist_abs"] = max(r["dist_abs"], float(
                (got["dist"].double() - ref["dist"].double())[keep].abs().max()))
            if "mask" in self.names:
                r["mask_abs"] = max(r["mask_abs"], float(
                    (got["mask"].double() - ref["mask"].double())[keep].abs().max()))
            r["feat_rel"] = max(r["feat_rel"], common.row_rel(got["dino_feats"],
                                                             ref["dino_feats"], keep))
        r["ambiguous_share"] = r.pop("ambiguous") / pts.shape[0]
        return r

    def check(self) -> dict:
        ctx = self.ctx
        P = common.reference_mode(ctx)
        w = weights.dinov2_weights(ctx.config["model"], ctx.seed, ctx.device)
        worst = {}
        with torch.no_grad():
            for pos, pset, desc, out in self.samples.values():
                desc_ref = common.reference_descriptors(ctx, w, self.frames[pos], P)
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

"""Open-text segmentation traffic: a closed loop of one client sending a new
4-view observation and the query texts, waiting for every view's masks.

A request hands ``GroundedSAMBackend.segment_views`` the rig's next colour
images (uint8, numpy, as a rig's host gives them) and the configuration's
queries; it runs one GroundingDINO forward over the views, one SAM encode
of the rig and one SAM decode of every view's boxes, and ends when every
view's ``ViewMasks`` is on the host, the path's own end.

The driver wraps the program's three stage calls in the harness's probe:
``predict_with_classes_batch`` as ``gdino``, ``set_images`` as
``sam_encode``, and ``predict_boxes_views`` with the masks' trip to the
host (to the end of ``segment_views``) as ``sam_decode``. The program's
tracer (``utils/profiling.py::tracer``) is on only while the harness's
traced part is (the probe's spans or its profiler ranges), never in an
untraced run, and its counters come back from :meth:`Cell.record`.

The check holds what the timed path produced for the sampled requests to
the plain reference (``reference/``) on the same images and weights, stage
by stage, the reference taking the program's discrete choices: the query
selection's top proposals, the detected boxes as SAM's prompts, the
multimask output SAM kept (:func:`readings`).
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import numpy as np
import torch

from port_bench import costs, costs_segment, weights_segment
from port_bench.drivers import common
from port_bench.harness import check
from port_bench.reference import gdino as ref_gdino
from port_bench.reference import sam as ref_sam
from port_bench.reference import segment as ref_segment

Tensor = torch.Tensor
COMPARED = ("emb_rel", "det_conf_abs", "det_box_px", "det_unmatched", "iou_abs",
            "mask_mismatch_share")


def program_configs(config: dict):
    """The program's ``GroundingDinoConfig`` and ``SamConfig`` of the
    configuration's ``gdino`` and ``sam``."""
    from d3fields_tpu_torch.models.groundingdino import bert, swin
    from d3fields_tpu_torch.models.groundingdino import model as gd
    from d3fields_tpu_torch.models.sam import model as sm

    def tuples(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    g = dict(config["gdino"])
    sw, tx = swin.SwinConfig(**tuples(g.pop("swin"))), bert.BertConfig(**g.pop("text"))
    for k in ("short_side", "max_side"):
        g.pop(k)
    return gd.GroundingDinoConfig(swin=sw, text=tx, **g), sm.SamConfig(**tuples(config["sam"]))


def pick_box_threshold(detector, rigs, queries, lo: int, hi: int):
    """The box threshold that leaves ``lo``-``hi`` boxes in the most views of
    all the rigs (ties: the mean count nearest sqrt(lo * hi)), midway
    between that score and the next: ``chip_smoke.py::pick_box_threshold``'s
    rule, whose 4-16 window takes the mean nearest 8, put after one more:
    first the most rigs with at least ``lo`` boxes over their views, so
    that every request decodes some (the cell's ``sam_boxes``). The counts
    are read from one detector forward per rig, every query less those the
    program's duplicate removal drops (a box goes where a more confident
    one overlaps it at IoU above 0.9, so the boxes kept above a threshold
    are those kept of all). Returns the threshold and the boxes it leaves
    per view of each rig."""
    from d3fields_tpu_torch.models.groundingdino.detector import tokenize_classes

    ids, _ = tokenize_classes(list(queries), detector.tokenize)
    confs = []
    for rig in rigs:
        logits, boxes = detector.forward_views(rig, ids)
        scores = torch.sigmoid(logits).amax(-1).cpu().numpy()
        boxes = boxes.cpu().numpy()
        for v in range(len(scores)):
            keep = ref_segment.dedup_keep(ref_segment.xyxy(boxes[v], rig.shape[1:3]), scores[v])
            confs.append(np.sort(scores[v][keep]))
    cands = np.unique(np.concatenate(confs))
    counts = np.stack([len(c) - np.searchsorted(c, cands, side="right") for c in confs], 1)
    in_window = ((counts >= lo) & (counts <= hi)).sum(1)
    decoding = (counts.reshape(len(cands), len(rigs), -1).sum(2) >= lo).sum(1)
    best = np.lexsort((np.abs(counts.mean(1) - np.sqrt(lo * hi)), -in_window, -decoding))[0]
    thr = (float(cands[best]) + float(cands[min(best + 1, len(cands) - 1)])) / 2
    per_view = np.reshape([int((c > thr).sum()) for c in confs], (len(rigs), -1))
    return thr, per_view.tolist()


def gather_launches(config: dict) -> List[dict]:
    """The ``deform_gather`` launches of one request, from shapes: the 6
    encoder layers on the trunk's table, the 6 decoder layers on f32."""
    g, rig = config["gdino"], config["rig"]
    H, W = ref_gdino.resized_hw(rig["height"], rig["width"], g["short_side"], g["max_side"])
    S = sum(h * w for h, w in costs_segment.gdino_levels(g, H, W))
    L, d, V = g["num_feature_levels"], g["d_model"], rig["views"]
    trunk = 2 if config["compute_dtype"] == "bfloat16" else 4
    enc = dict(B=V, S=S, Q=S, nh=g["encoder_heads"], hd=d // g["encoder_heads"], L=L,
               P=g["encoder_points"], itemsize=trunk)
    dec = dict(B=V, S=S, Q=g["num_queries"], nh=g["decoder_heads"], hd=d // g["decoder_heads"],
               L=L, P=g["decoder_points"], itemsize=4)
    return [enc] * g["encoder_layers"] + [dec] * g["decoder_layers"]


def _launches() -> int:
    from d3fields_tpu_torch.models.groundingdino import deform_gather

    return deform_gather.deform_gather.launches


def _tracer():
    from d3fields_tpu_torch.utils.profiling import tracer

    return tracer


class Cell:
    def __init__(self, ctx):
        self.ctx, self.probe = ctx, ctx.probe
        self.cfg = ctx.config
        self.queries = list(self.cfg["queries"])
        self.samples = {}
        self.failed = 0
        self.min_launches = self.min_boxes = None
        self.boxes = []           # boxes decoded, per request of the window
        self.traced = 0           # requests run with the program's tracer on
        self._tracing = False     # this cell turned the tracer on
        self._req = {}
        self._stack = None
        self.last_readings = {}

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from d3fields_tpu_torch.models.groundingdino import model as gd
        from d3fields_tpu_torch.models.groundingdino.detector import GroundingDinoDetector
        from d3fields_tpu_torch.models.sam import model as sm
        from d3fields_tpu_torch.models.sam.predictor import SamPredictor
        from d3fields_tpu_torch.seg.grounded_sam import GroundedSAMBackend

        ctx, cfg = self.ctx, self.cfg
        lap = common.Laps(ctx)
        common.set_matmul_precision(cfg)
        self.rig = common.make_rig(ctx)
        self.frames = self.rig.frame_pool()
        lap("inputs_s")
        gcfg, scfg = program_configs(cfg)
        gmodel = gd.GroundingDino(gcfg, device=ctx.device)
        gmodel.load_state_dict(weights_segment.gdino_weights(cfg["gdino"], ctx.seed, ctx.device))
        smodel = sm.Sam(scfg, device=ctx.device)
        smodel.load_state_dict(weights_segment.sam_weights(cfg["sam"], ctx.seed, ctx.device))
        g = cfg["gdino"]
        self.detector = GroundingDinoDetector(
            gmodel, ref_gdino.toy_tokenize, short_side=g["short_side"], max_side=g["max_side"],
            device=ctx.device, compute_dtype=cfg["compute_dtype"])
        self.sam = SamPredictor(smodel, device=ctx.device, compute_dtype=cfg["compute_dtype"])
        del gmodel, smodel
        self.backend = GroundedSAMBackend(self.detector, self.sam)
        lap("program_s")
        lo, hi = cfg["box_window"]
        self.threshold, per_view = pick_box_threshold(
            self.detector, [f["color"] for f in self.frames], self.queries, lo, hi)
        lap("threshold_s")
        self._wrap()
        self.k = 0
        for _ in range(self.ctx.traffic["warmup_requests"]):
            self.step(None)
        lap("warmup_s")
        self.setup_laps = {**lap.laps, "box_threshold": self.threshold,
                           "boxes_per_view_per_position": per_view}
        self.min_launches = self.min_boxes = None
        self.boxes = []

    def _wrap(self) -> None:
        """The three stage calls inside the probe's spans, keeping what they return."""
        det, sam, probe = self.detector, self.sam, self.probe
        detect, encode, decode = det.predict_with_classes_batch, sam.set_images, \
            sam.predict_boxes_views

        def gdino(*args, **kwargs):
            with probe("gdino"):
                self._req["dets"] = detect(*args, **kwargs)
            return self._req["dets"]

        def sam_encode(*args, **kwargs):
            with probe("sam_encode"):
                return encode(*args, **kwargs)

        def sam_decode(*args, **kwargs):
            # closed by step() at the end of segment_views: the masks' trip to the host
            if self._stack is not None:
                self._stack.enter_context(probe("sam_decode"))
            self._req["decoded"] = decode(*args, **kwargs)
            return self._req["decoded"]

        det.predict_with_classes_batch = gdino
        sam.set_images = sam_encode
        sam.predict_boxes_views = sam_decode

    def _hooks(self):
        """Forward hooks on the detector that keep the query selection's
        inputs and the forward's outputs of a sampled request."""
        m, got = self.detector.model, self._req
        return [m.model.enc_output_norm.register_forward_hook(
                    lambda mod, i, o: got.__setitem__("obj_query", o)),
                m.model.encoder.layers[-1].register_forward_hook(
                    lambda mod, i, o: got.__setitem__("text", o[1])),
                m.register_forward_hook(lambda mod, i, o: got.__setitem__("raw", o))]

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
        pos = self.rig.position(self.k)
        self.k += 1
        self.traced += self._switch_tracer()
        self._req = {}
        hooks = self._hooks() if slot is not None else []
        before = _launches()
        try:
            with contextlib.ExitStack() as stack:
                self._stack = stack
                views = self.backend.segment_views(self.frames[pos]["color"], self.queries,
                                                   [self.threshold])
        finally:
            self._stack = None
            for h in hooks:
                h.remove()
        launched = _launches() - before
        boxes = sum(len(d.xyxy) for d in self._req["dets"])
        self.boxes.append(boxes)
        self.min_launches = launched if self.min_launches is None else \
            min(self.min_launches, launched)
        self.min_boxes = boxes if self.min_boxes is None else min(self.min_boxes, boxes)
        if slot is not None:
            r = self._req
            self.samples[slot] = {
                "pos": pos, "dets": r["dets"], "views": views, "obj_query": r["obj_query"],
                "text": r["text"], "raw": r["raw"], "emb": self.sam.image_embeddings(),
                "decoded": r.get("decoded")}
        return 1.0

    def held_bytes(self) -> int:
        storages = {}
        for s in self.samples.values():
            ts = [s["obj_query"], s["text"], *s["raw"], s["emb"]]
            if s["decoded"]:
                ts += [t for pair in s["decoded"] for t in pair]
            for t in ts:
                if t.is_cuda:
                    storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return sum(storages.values())

    def record(self) -> dict:
        cfg, V = self.cfg, self.cfg["rig"]["views"]
        flops = [costs_segment.segment_flops(cfg, V, b) for b in self.boxes]
        rec = {"flops_per_step": float(np.mean(flops)) if flops else 0.0,
               "peak_flops": costs.PEAK_FLOPS[cfg["compute_dtype"]],
               "gather_launches": gather_launches(cfg), "traced_requests": self.traced}
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
        self.detector = self.sam = self.backend = None
        common.free_device(self.ctx.device)

    # -- the check --------------------------------------------------------------
    def program_found(self, s: dict) -> List[ref_segment.Found]:
        """The program's detections with the decoder query each came from,
        found in the forward's own outputs (the scores equal to the bit)."""
        logits, boxes = s["raw"]
        scores = torch.sigmoid(logits).amax(-1).cpu().numpy()
        boxes = boxes.double().cpu().numpy()
        H, W = self.cfg["rig"]["height"], self.cfg["rig"]["width"]
        out = []
        for v, d in enumerate(s["dets"]):
            q = []
            for conf, xy in zip(d.confidence, d.xyxy):
                cand = np.flatnonzero(scores[v] == conf)
                if len(cand) == 0:
                    q.append(-1)
                    continue
                err = np.abs(ref_segment.xyxy(boxes[v, cand], (H, W)) - xy).max(1)
                q.append(int(cand[np.argmin(err)]))
            out.append(ref_segment.Found(xyxy=np.asarray(d.xyxy, np.float64),
                                         confidence=np.asarray(d.confidence, np.float64),
                                         class_id=np.asarray(d.class_id), query=np.asarray(q)))
        return out

    def check(self) -> dict:
        ctx, cfg = self.ctx, self.cfg
        P = common.reference_mode(ctx)
        gw = weights_segment.gdino_weights(cfg["gdino"], ctx.seed, ctx.device)
        sw = weights_segment.sam_weights(cfg["sam"], ctx.seed, ctx.device)
        worst = {}
        with torch.no_grad():
            for s in self.samples.values():
                scores = torch.matmul(s["obj_query"], s["text"].float().transpose(1, 2)).amax(-1)
                select = torch.topk(scores, cfg["gdino"]["num_queries"], dim=1).indices
                prog = {"found": self.program_found(s),
                        "scores": torch.sigmoid(s["raw"][0]).amax(-1).double().cpu().numpy(),
                        "boxes": s["raw"][1].double().cpu().numpy(),
                        "emb": s["emb"], "decoded": s["decoded"], "views": s["views"]}
                r = readings(prog, self.frames[s["pos"]]["color"], select, gw, sw, cfg,
                             self.threshold, ctx.limits["margins"], P)
                self.failed += any(r[k] > ctx.limits[k] for k in COMPARED)
                for k, v in r.items():
                    worst[k] = max(worst.get(k, 0), v)
                common.free_device(ctx.device)
        self.last_readings = worst
        lim = ctx.limits
        checks = {k: check(worst.get(k, float("inf")), lim[k]) for k in COMPARED}
        checks["samples"] = check(len(self.samples), lim["samples"], "min")
        checks["sam_boxes"] = check(self.min_boxes or 0, lim["sam_boxes"], "min")
        checks["deform_gather_launches"] = check(self.min_launches or 0,
                                                 lim["deform_gather_launches"], "min")
        return checks


# ---------------------------------------------------------------------------
# The compared numbers
# ---------------------------------------------------------------------------

def detection_readings(prog_found, prog_scores, prog_boxes, ref_logits, ref_boxes, spans,
                       threshold: float, hw, margins: dict) -> dict:
    """``det_conf_abs``, ``det_box_px``, ``det_unmatched`` of one request:
    the program's decoder queries against the reference's for the same
    queries (the reference ran the program's query selection). The errors
    are the worst over each view's ``top_queries`` best queries by the
    reference's score (a fixed sample, whatever a seed's threshold keeps;
    their boxes as xyxy pixels) and over the detections on both sides (the
    program's as its post-processing gave them). Left out of
    ``det_unmatched``: a query whose score on either side lies within
    ``det_margin`` of the threshold; one whose duplicate removal turns on
    an IoU within ``dedup_margin`` of 0.9 or on two confidences within
    ``det_margin``; a class whose two strongest spans lie within
    ``det_margin``, or with a token of the caption's classes within
    ``det_margin`` of the text threshold (which decides whether a span
    counts its strongest token above it or all of them).
    ``det_unmapped`` and ``det_class_flips`` are the parts of
    ``det_unmatched`` that a program detection missing from its own
    forward's outputs and a class that differs make."""
    delta, eps, top = margins["det_margin"], margins["dedup_margin"], margins["top_queries"]
    rs, rc = (t.cpu().numpy() for t in ref_segment.span_scores(ref_logits, spans))
    tokens = np.concatenate([np.arange(a, b) for a, b in spans])
    near_text = (np.abs(torch.sigmoid(ref_logits.double()).cpu().numpy()[..., tokens]
                        - ref_segment.TEXT_THRESHOLD) < delta).any(-1)
    ref_found = ref_segment.detections(ref_logits, ref_boxes, spans, threshold, hw)
    boxes = ref_boxes.double().cpu().numpy()
    out = {"det_conf_abs": 0.0, "det_box_px": 0.0, "det_unmatched": 0, "det_matched": 0,
           "det_unmapped": 0, "det_class_flips": 0}

    def worst(conf_err, box_err):
        out["det_conf_abs"] = max(out["det_conf_abs"], float(np.max(conf_err, initial=0.0)))
        out["det_box_px"] = max(out["det_box_px"], float(np.max(box_err, initial=0.0)))

    for v, (pf, rf) in enumerate(zip(prog_found, ref_found)):
        best = np.argsort(-rs[v], kind="stable")[:top]
        worst(np.abs(prog_scores[v, best] - rs[v, best]),
              np.abs(ref_segment.xyxy(prog_boxes[v, best], hw)
                     - ref_segment.xyxy(boxes[v, best], hw)))
        out["det_unmapped"] += int((pf.query < 0).sum())
        near = (np.abs(rs[v] - threshold) < delta) | (np.abs(prog_scores[v] - threshold) < delta)
        cand = np.flatnonzero(rs[v] > threshold - delta)
        xy = ref_segment.xyxy(boxes[v, cand], hw)
        iou = ref_segment.box_iou(xy, xy)
        np.fill_diagonal(iou, 0.0)
        close = (np.abs(iou - 0.9) < eps) | ((iou > 0.9 - eps) & (
            np.abs(rs[v, cand][:, None] - rs[v, cand][None]) < delta))
        ambiguous = near.copy()
        ambiguous[cand[close.any(1)]] = True
        pq = {int(q): i for i, q in enumerate(pf.query) if q >= 0}
        rq = {int(q): i for i, q in enumerate(rf.query)}
        for q in set(pq) | set(rq):
            if q in pq and q in rq:
                i, j = pq[q], rq[q]
                out["det_matched"] += 1
                worst([abs(pf.confidence[i] - rf.confidence[j])],
                      [np.abs(pf.xyxy[i] - rf.xyxy[j])])
                top2 = np.sort(rc[v, q])[-2:]
                if pf.class_id[i] != rf.class_id[j] and top2[-1] - top2[0] > delta \
                        and not near_text[v, q]:
                    out["det_class_flips"] += 1
            elif not ambiguous[q]:
                out["det_unmatched"] += 1
    out["det_unmatched"] += out["det_unmapped"] + out["det_class_flips"]
    return out


def mask_readings(prog_decoded, prog_views, ref_logits: Tensor, ref_iou: Tensor,
                  counts: Sequence[int], margins: dict) -> dict:
    """``iou_abs`` and ``mask_mismatch_share`` of one request: SAM's IoU
    predictions for the program's boxes, and every pixel of each view's
    masks (background first) against the sign of the reference's logits
    for the same boxes. The reference keeps the multimask output the
    program kept, unless its own IoUs pick another by more than
    ``multimask_tie``. Pixels whose logit lies within ``mask_logit_margin``
    of 0 are left out (for the background: of any instance's logit)."""
    tie, eps = margins["multimask_tie"], margins["mask_logit_margin"]
    out = {"iou_abs": 0.0, "mask_mismatch_share": 0.0}
    bad = seen = 0
    ref_l, ref_i = ref_logits.split(list(counts)), ref_iou.split(list(counts))
    for v, n in enumerate(counts):
        vm = prog_views[v]
        if n == 0:
            bad += int((~vm.masks[0]).sum()) + int(vm.masks.shape[0] != 1) * vm.masks[0].size
            seen += vm.masks[0].size
            continue
        masks_p, iou_p = prog_decoded[v]
        iou_p, iou_r = iou_p.double(), ref_i[v].double()
        out["iou_abs"] = max(out["iou_abs"], float((iou_p - iou_r).abs().max()))
        pick = iou_p.argmax(1)
        top = iou_r.topk(2, dim=1).values
        own = iou_r.argmax(1)
        pick = torch.where((own != pick) & (top[:, 0] - top[:, 1] > tie), own, pick)
        dev = ref_l[v].device
        logit = ref_l[v][torch.arange(n, device=dev), pick.to(dev)].double().cpu().numpy()
        if vm.masks.shape[0] != n + 1:
            bad, seen = bad + 1, seen + 1
            continue
        clear = np.abs(logit) >= eps
        bad += int(((vm.masks[1:] != (logit > 0)) & clear).sum())
        seen += int(clear.sum())
        all_clear = clear.all(0)
        bad += int(((vm.masks[0] != ~(logit > 0).any(0)) & all_clear).sum())
        seen += int(all_clear.sum())
    out["mask_mismatch_share"] = bad / max(seen, 1)
    return out


def readings(prog: dict, images: np.ndarray, select: Tensor, gw: dict, sw: dict, cfg: dict,
             threshold: float, margins: dict, P) -> dict:
    """The compared numbers of one request. ``prog``: ``found`` (each
    view's detections with their decoder queries), ``scores`` (V, Q) the
    program's query scores, ``emb`` (V, 64, 64, C), ``decoded`` (per view
    the bool masks (N, 3, H, W) and IoUs (N, 3) of SAM's decode),
    ``views`` (each view's masks, background first), ``boxes`` (V, Q, 4)
    the decoder's boxes (cxcywh in [0, 1]). ``select``: the
    program's query selection, which the reference's decoder takes."""
    g, s = cfg["gdino"], cfg["sam"]
    hw = images.shape[1:3]
    det = ref_gdino.detect(gw, images, cfg["queries"], g, P, select=select)
    out = detection_readings(prog["found"], prog["scores"], prog["boxes"], det["logits"],
                             det["boxes"], det["spans"], threshold, hw, margins)
    del det
    emb = ref_sam.embed(sw, images, s, P)
    e_p, e_r = prog["emb"].double(), emb.double()
    out["emb_rel"] = float(((e_p - e_r).flatten(1).norm(dim=1)
                            / e_r.flatten(1).norm(dim=1)).max())
    counts = [len(f.xyxy) for f in prog["found"]]
    if sum(counts):
        logits, iou = ref_sam.segment_boxes(sw, emb, [f.xyxy for f in prog["found"]], hw, s, P)
        out.update(mask_readings(prog["decoded"], prog["views"], logits, iou, counts, margins))
    else:
        out.update(iou_abs=0.0, mask_mismatch_share=0.0)
    return out

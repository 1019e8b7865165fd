"""What the drivers share: the program's DINOv2 backbone built from the
benchmark's weights, the rig's frames, and the descriptor comparison."""

from __future__ import annotations

import time

import torch

from port_bench import weights
from port_bench.reference import dinov2 as ref_dinov2
from port_bench.reference.precision import MODES, REFERENCE
from port_bench.rig import Rig

Tensor = torch.Tensor
OBS_KEYS = ("color", "depth", "pose", "K", "mask")


class SpannedBackbone:
    """The program's feature backend, called inside the ``dinov2`` span."""

    def __init__(self, backbone, probe):
        self.backbone, self.probe = backbone, probe

    def __call__(self, images, patch_hw=None):
        with self.probe("dinov2"):
            return self.backbone(images, patch_hw=patch_hw)


class Laps:
    """Seconds of each part of a set-up, each ending in a synchronise."""

    def __init__(self, ctx):
        self.sync, self.laps = ctx.probe.sync, {}
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.laps[name], self.t = now - self.t, now


def set_matmul_precision(config: dict) -> None:
    """TF32 on or off for the program's float32 products, as the
    configuration states."""
    torch.backends.cuda.matmul.allow_tf32 = bool(config["allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["allow_tf32"])


def program_backbone(ctx):
    """The program's ``Dinov2Backbone`` over the benchmark's weights, in the
    configuration's compute dtype (the backbone rounds its own copy)."""
    from d3fields_tpu_torch.models import dinov2

    m = ctx.config["model"]
    cfg = dinov2.Dinov2Config(
        hidden_size=m["hidden_size"], num_layers=m["num_layers"], num_heads=m["num_heads"],
        mlp_ratio=m["mlp_ratio"], patch_size=m["patch_size"], image_size=m["image_size"])
    model = dinov2.Dinov2(cfg, device=ctx.device)
    model.load_state_dict(weights.dinov2_weights(m, ctx.seed, ctx.device))
    return SpannedBackbone(
        dinov2.Dinov2Backbone(model.eval(), compute_dtype=ctx.config["compute_dtype"],
                              device=ctx.device), ctx.probe)


def free_device(device) -> None:
    """Return the program's freed blocks to the card before the reference runs."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def make_rig(ctx) -> Rig:
    r = ctx.config["rig"]
    return Rig(ctx.seed, r["views"], r["height"], r["width"], ctx.traffic["rig"])


def observation(frame: dict) -> dict:
    """What the rig hands the program: numpy colour, depth, cameras, masks."""
    return {k: frame[k] for k in OBS_KEYS}


def obs_tensors(frame: dict, device) -> dict:
    return {k: torch.as_tensor(frame[k], device=device) for k in ("depth", "pose", "K", "mask")}


def reference_mode(ctx, mode=None):
    return MODES[mode or REFERENCE[ctx.config["compute_dtype"]]]


def reference_descriptors(ctx, w: dict, frame: dict, P) -> Tensor:
    r = ctx.config["rig"]
    return ref_dinov2.descriptors(w, frame["color"], ctx.config["model"], r["patch_hw"], P)


def token_rel(got: Tensor, want: Tensor) -> float:
    """The largest relative L2 error of a descriptor (a patch token)."""
    a = got.reshape(-1, got.shape[-1]).double()
    b = want.reshape(-1, want.shape[-1]).double()
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1).clamp(min=1e-30)).max())


def row_rel(got: Tensor, want: Tensor, keep: Tensor) -> float:
    """The largest L2 error of a row among ``keep``, over the larger of the
    row's norm and a thousandth of the median row norm (fused descriptors of
    points seen at a low weight are small)."""
    a, b = got[keep].double(), want[keep].double()
    if a.shape[0] == 0:
        return 0.0
    nb = b.norm(dim=-1)
    seen = nb[nb > 0]
    floor = 1e-3 * float(seen.median()) if seen.numel() else 0.0
    return float(((a - b).norm(dim=-1) / nb.clamp(min=max(floor, 1e-30))).max())

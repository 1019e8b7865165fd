"""The XMem network: ``encode_key``, ``encode_value`` and ``segment``.

Counterpart of ``d3fields_tpu/models/xmem/network.py`` (the reference's
``XMem/model/network.py:17-198``). :class:`XMem` keeps the reference's
module tree and parameter names, which are the names the JAX package's
``convert_torch_state_dict`` reads, so a reference state dict loads into it
as it is. Layouts are NCHW; the object axis is folded into the batch for
the conv stacks. :func:`init_params` draws random weights as the JAX
package's ``init_params`` does; :func:`load_jax_params` carries the JAX
package's parameter tree across.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from d3fields_tpu_torch.config import XMemConfig
from d3fields_tpu_torch.models.xmem import blocks as B
from d3fields_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


class XMem(nn.Module):
    """XMem with the reference's parameter names. Construct with random
    weights through :func:`init_params` or load a state dict."""

    def __init__(self, cfg: XMemConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.key_encoder = B.KeyEncoder(dev)
        self.key_proj = B.KeyProjection(cfg.key_dim, dev)
        self.value_encoder = B.ValueEncoder(cfg.value_dim, cfg.hidden_dim, dev)
        self.decoder = B.Decoder(cfg.value_dim, cfg.hidden_dim, dev)

    def encode_key(self, image: Tensor, need_sk: bool = True, need_ek: bool = True):
        """image (B, 3, H, W) -> (key (B, CK, h, w), shrinkage (B, 1, h, w)
        or None, selection (B, CK, h, w) or None, f16, f8, f4)
        (``network.py:41-74``)."""
        f16, f8, f4 = self.key_encoder(image)
        key, shrinkage, selection = self.key_proj(f16, need_sk, need_ek)
        return key, shrinkage, selection, f16, f8, f4

    def encode_value(self, image: Tensor, f16: Tensor, hidden: Tensor, masks: Tensor,
                     is_deep_update: bool = True):
        """Values of every object of each image.

        image (B, 3, H, W); f16 (B, 1024, h, w); hidden (B, O, CH, h, w);
        masks (B, O, H, W) probabilities (no background). Returns (value
        (B, O, CV, h, w), hidden). Each object's input is [image, own mask,
        sum of the other masks] (``network.py:76-89``).
        """
        nb, O = masks.shape[:2]
        others = masks.sum(dim=1, keepdim=True) - masks
        img = image[:, None].expand((nb, O) + tuple(image.shape[1:]))
        g = torch.cat([img, masks[:, :, None], others[:, :, None]], dim=2)
        ve = self.value_encoder
        g = ve.trunk(B.fold(g))
        g = ve.fuser(B.broadcast_objects(f16, O), g)
        if is_deep_update:
            hidden = B.unfold(ve.hidden_reinforce(g, B.fold(hidden)), nb)
        return B.unfold(g, nb), hidden

    def segment(self, f16: Tensor, f8: Tensor, f4: Tensor, hidden: Tensor,
                memory_readout: Tensor, h_out: bool = True,
                obj_active: Optional[Tensor] = None):
        """Per-object logits from the memory readout (``network.py:110-125``).

        f16 (B, 1024, h, w), f8 (B, 512, 2h, 2w), f4 (B, 256, 4h, 4w);
        hidden (B, O, CH, h, w); memory_readout (B, O, CV, h, w).
        ``obj_active`` (B, O) bool forces the probability of object slots
        not yet entered to 0 before the soft aggregation. Returns
        (new hidden or None, logits (B, O, H, W) in the networks' dtype,
        prob with background (B, O+1, H, W) in f32: the sigmoid and the
        soft aggregation take the logits in f32, whatever the networks'
        dtype (the JAX package takes a bf16 sigmoid of bf16 logits).
        """
        nb, O = memory_readout.shape[:2]
        dec = self.decoder
        hid = B.fold(hidden)
        g16 = dec.fuser(B.broadcast_objects(f16, O),
                        torch.cat([B.fold(memory_readout), hid], dim=1))
        g8 = dec.up_16_8(B.broadcast_objects(f8, O), g16)
        g4 = dec.up_8_4(B.broadcast_objects(f4, O), g8)
        logits4 = dec.pred(F.relu(g4))
        new_hidden = None
        if h_out:
            new_hidden = B.unfold(
                dec.hidden_update(g16, g8, torch.cat([g4, logits4], dim=1), hid), nb)
        logits = B.unfold(B.upsample_4x_logits(logits4)[:, 0], nb)
        # the sigmoid in f32: in bf16 it steps by 2^-8 near 1, where the soft
        # aggregation's log-odds turn one step into up to 0.7
        prob = torch.sigmoid(logits.float())
        if obj_active is not None:
            prob = torch.where(obj_active[:, :, None, None], prob, torch.zeros_like(prob))
        return new_hidden, logits, B.soft_aggregate(prob, dim=1)


def init_params(cfg: XMemConfig, generator: Optional[torch.Generator] = None, *,
                device=None) -> XMem:
    """An :class:`XMem` with random weights drawn as the JAX package's
    ``init_params`` draws them: conv weights N(0, 2/fan_in), zero biases,
    identity batch norms, the CBAM MLPs N(0, 0.05²); from ``generator`` (on
    ``device``; one seeded with 0 when None). The numbers differ from
    JAX's; carry JAX's own with :func:`load_jax_params`."""
    dev = resolve_device(device)
    model = XMem(cfg, device=dev)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
                m.weight.normal_(0.0, float(np.sqrt(2.0 / fan_in)), generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.05, generator=gen)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model.eval()


# ---------------------------------------------------------------------------
# the JAX package's parameter tree -> state dict (the inverse of its
# convert_torch_state_dict)
# ---------------------------------------------------------------------------

def _conv(sd: dict, prefix: str, p: dict) -> None:
    sd[prefix + ".weight"] = np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if "b" in p:
        sd[prefix + ".bias"] = np.asarray(p["b"], np.float32)


def _bn(sd: dict, prefix: str, p: dict) -> None:
    for ours, theirs in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                         ("running_var", "var")):
        sd[f"{prefix}.{ours}"] = np.asarray(p[theirs], np.float32)


def _res_layer(sd: dict, prefix: str, blocks) -> None:
    for i, p in enumerate(blocks):
        pre = f"{prefix}.{i}"
        for name in ("conv1", "conv2", "conv3"):
            if name in p:
                _conv(sd, f"{pre}.{name}", p[name])
                _bn(sd, f"{pre}.bn{name[-1]}", p["bn" + name[-1]])
        if "downsample" in p:
            _conv(sd, pre + ".downsample.0", p["downsample"]["conv"])
            _bn(sd, pre + ".downsample.1", p["downsample"]["bn"])


def _group_res(sd: dict, prefix: str, p: dict) -> None:
    for name in ("conv1", "conv2", "downsample"):
        if name in p:
            _conv(sd, f"{prefix}.{name}", p[name])


def _fusion(sd: dict, prefix: str, p: dict) -> None:
    _group_res(sd, prefix + ".block1", p["block1"])
    _group_res(sd, prefix + ".block2", p["block2"])
    att = p["attention"]
    for ours, theirs in (("1", "mlp1"), ("3", "mlp2")):
        sd[f"{prefix}.attention.ChannelGate.mlp.{ours}.weight"] = np.asarray(
            att[theirs]["w"], np.float32).T  # (in, out) -> (out, in)
        sd[f"{prefix}.attention.ChannelGate.mlp.{ours}.bias"] = np.asarray(
            att[theirs]["b"], np.float32)
    _conv(sd, prefix + ".attention.SpatialGate.spatial.conv", att["spatial"])


def jax_state_dict(params: Dict) -> Dict[str, np.ndarray]:
    """The JAX package's XMem parameter tree (or any tree of its shape, such
    as AdamW's moments of it) as numpy arrays under the state-dict names of
    :class:`XMem`, in its layouts."""
    sd: dict = {}
    ke, ve, dec = params["key_encoder"], params["value_encoder"], params["decoder"]
    _conv(sd, "key_encoder.conv1", ke["conv1"])
    _bn(sd, "key_encoder.bn1", ke["bn1"])
    for ours, theirs in (("res2", "layer1"), ("layer2", "layer2"), ("layer3", "layer3")):
        _res_layer(sd, "key_encoder." + ours, ke[theirs])
    for ours, theirs in (("key_proj", "key"), ("d_proj", "d"), ("e_proj", "e")):
        _conv(sd, "key_proj." + ours, params["key_proj"][theirs])
    _conv(sd, "value_encoder.conv1", ve["conv1"])
    _bn(sd, "value_encoder.bn1", ve["bn1"])
    for name in ("layer1", "layer2", "layer3"):
        _res_layer(sd, "value_encoder." + name, ve[name])
    _fusion(sd, "value_encoder.fuser", params["value_fuser"])
    _conv(sd, "value_encoder.hidden_reinforce.transform", params["hidden_reinforce"])
    _fusion(sd, "decoder.fuser", dec["fuser"])
    for ours, theirs in (("g16_conv", "g16"), ("g8_conv", "g8"), ("g4_conv", "g4"),
                         ("transform", "transform")):
        _conv(sd, "decoder.hidden_update." + ours, dec["hidden_update"][theirs])
    for up in ("up_16_8", "up_8_4"):
        _conv(sd, f"decoder.{up}.skip_conv", dec[up]["skip"])
        _group_res(sd, f"decoder.{up}.out_conv", dec[up]["out"])
    _conv(sd, "decoder.pred", dec["pred"])
    return sd


def load_jax_params(model: XMem, params: Dict) -> XMem:
    """Copy the JAX package's XMem parameter tree (from its ``init_params``
    or ``convert_torch_state_dict``, leaves as numpy arrays) into ``model``,
    in place. Returns ``model``."""
    sd = jax_state_dict(params)
    own = model.state_dict()
    missing = {k for k in own if k not in sd and not k.endswith("num_batches_tracked")}
    unexpected = set(sd) - set(own)
    if missing or unexpected:
        raise ValueError(f"XMem parameter trees differ: missing {sorted(missing)[:5]}, "
                         f"unexpected {sorted(unexpected)[:5]}")
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                          strict=False)
    return model

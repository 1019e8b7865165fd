"""Random XMem weights from the seed, made on the device in one draw, as a
state dict in the layout of the published ``XMem.pth``
(https://github.com/hkchengrex/XMem), which the program loads as it loads
that file and the plain reference (``reference/xmem.py``) reads by name.

One ``torch.rand`` on the device's own generator fills every floating leaf,
each a view of that draw moved to its own range:

- convolution and linear weights and their biases U(-1/sqrt(fan_in),
  1/sqrt(fan_in)) (fan_in: the inputs summed into one output), PyTorch's
  default initialisation and what an untrained published XMem holds;
- batch norms the identity: scale 1, shift 0, running mean 0, running
  variance 1;
- the decoder's prediction head's weight (``decoder.pred.weight``) ten times
  that range (these three: the rule of ``chip_smoke.py::xmem_model``);
- the value encoder's first convolution on its two mask channels (own
  mask, other masks: ``value_encoder.conv1.weight[:, 3:5]``) and the
  decoder fusion's first convolutions on the memory readout's channels
  (``decoder.fuser.block1.conv1`` and ``.downsample``, input channels
  1024 to 1024 + value_dim) ten times that range.

Not the N(0, 2/fan_in) convolutions of ``network.init_params``: without
trained batch-norm statistics they grow ResNet-50's features to ~1e3 and
the shrinkage to ~1e6 at 480p, which turns the top-k softmax into a hard
argmax whose picks flip on rounding. The head's factor spreads the
untrained logits. The two role factors make the objects differ: with the
default range alone the image's stride-16 features drown each object's
mask in its values and its readout in the decoder, so the objects' logits
differ by ~5e-4 against a spread of ~0.12 and every pixel's two likeliest
objects lie within 4e-4 of each other, so that no label can be compared.
With them the objects' logits differ by ~0.03 against ~0.3 (at 240x432).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Tensor = torch.Tensor
PRED_SCALE = 10.0
# (leaf, input channels, factor) of the role scales, as functions of value_dim
ROLE_SCALES = (("value_encoder.conv1.weight", lambda cv: slice(3, 5), 10.0),
               ("decoder.fuser.block1.conv1.weight", lambda cv: slice(1024, 1024 + cv), 10.0),
               ("decoder.fuser.block1.downsample.weight", lambda cv: slice(1024, 1024 + cv), 10.0))


def _conv(name: str, cout: int, cin: int, k: int, bias: bool = True) -> list:
    out = [(name + ".weight", (cout, cin, k, k), cin * k * k)]
    return out + ([(name + ".bias", (cout,), cin * k * k)] if bias else [])


def _bn(name: str, c: int) -> list:
    return [(f"{name}.{k}", (c,), kind) for k, kind in
            (("weight", "one"), ("bias", "zero"), ("running_mean", "zero"),
             ("running_var", "one"))] + [(name + ".num_batches_tracked", (), "count")]


def _bottleneck(name: str, cin: int, mid: int, stride: int) -> list:
    out = (_conv(name + ".conv1", mid, cin, 1, False) + _bn(name + ".bn1", mid)
           + _conv(name + ".conv2", mid, mid, 3, False) + _bn(name + ".bn2", mid)
           + _conv(name + ".conv3", 4 * mid, mid, 1, False) + _bn(name + ".bn3", 4 * mid))
    if stride != 1 or cin != 4 * mid:
        out += _conv(name + ".downsample.0", 4 * mid, cin, 1, False) + _bn(
            name + ".downsample.1", 4 * mid)
    return out


def _basic(name: str, cin: int, cout: int, stride: int) -> list:
    out = (_conv(name + ".conv1", cout, cin, 3, False) + _bn(name + ".bn1", cout)
           + _conv(name + ".conv2", cout, cout, 3, False) + _bn(name + ".bn2", cout))
    if stride != 1 or cin != cout:
        out += _conv(name + ".downsample.0", cout, cin, 1, False) + _bn(
            name + ".downsample.1", cout)
    return out


def _layer(name: str, block, cin: int, width: int, blocks: int, stride: int) -> list:
    out, grow = [], 4 if block is _bottleneck else 1
    for i in range(blocks):
        out += block(f"{name}.{i}", cin if i == 0 else width * grow, width,
                     stride if i == 0 else 1)
    return out


def _group_res(name: str, cin: int, cout: int) -> list:
    out = _conv(name + ".conv1", cout, cin, 3) + _conv(name + ".conv2", cout, cout, 3)
    return out + (_conv(name + ".downsample", cout, cin, 3) if cin != cout else [])


def _fusion(name: str, x_dim: int, g_dim: int, mid: int, out: int) -> list:
    gate = name + ".attention.ChannelGate.mlp"
    return (_group_res(name + ".block1", x_dim + g_dim, mid)
            + [(gate + ".1.weight", (mid // 16, mid), mid), (gate + ".1.bias", (mid // 16,), mid),
               (gate + ".3.weight", (mid, mid // 16), mid // 16),
               (gate + ".3.bias", (mid,), mid // 16)]
            + _conv(name + ".attention.SpatialGate.spatial.conv", 1, 2, 7)
            + _group_res(name + ".block2", mid, out))


def xmem_shapes(xmem: dict) -> List[Tuple[str, tuple, object]]:
    """(name, shape, fan_in or 'one' / 'zero' / 'count') of every leaf of
    ``XMem.pth`` at the configuration's ``key_dim``, ``value_dim`` and
    ``hidden_dim``."""
    ck, cv, ch = xmem["key_dim"], xmem["value_dim"], xmem["hidden_dim"]
    leaves = (_conv("key_encoder.conv1", 64, 3, 7, False) + _bn("key_encoder.bn1", 64)
              + _layer("key_encoder.res2", _bottleneck, 64, 64, 3, 1)
              + _layer("key_encoder.layer2", _bottleneck, 256, 128, 4, 2)
              + _layer("key_encoder.layer3", _bottleneck, 512, 256, 6, 2)
              + _conv("key_proj.key_proj", ck, 1024, 3) + _conv("key_proj.d_proj", 1, 1024, 3)
              + _conv("key_proj.e_proj", ck, 1024, 3)
              + _conv("value_encoder.conv1", 64, 5, 7, False) + _bn("value_encoder.bn1", 64)
              + _layer("value_encoder.layer1", _basic, 64, 64, 2, 1)
              + _layer("value_encoder.layer2", _basic, 64, 128, 2, 2)
              + _layer("value_encoder.layer3", _basic, 128, 256, 2, 2)
              + _fusion("value_encoder.fuser", 1024, 256, cv, cv)
              + _conv("value_encoder.hidden_reinforce.transform", 3 * ch, cv + ch, 3)
              + _fusion("decoder.fuser", 1024, cv + ch, 512, 512)
              + _conv("decoder.hidden_update.g16_conv", 256, 512, 1)
              + _conv("decoder.hidden_update.g8_conv", 256, 256, 1)
              + _conv("decoder.hidden_update.g4_conv", 256, 257, 1)
              + _conv("decoder.hidden_update.transform", 3 * ch, 256 + ch, 3)
              + _conv("decoder.up_16_8.skip_conv", 512, 512, 3)
              + _group_res("decoder.up_16_8.out_conv", 512, 256)
              + _conv("decoder.up_8_4.skip_conv", 256, 256, 3)
              + _group_res("decoder.up_8_4.out_conv", 256, 256)
              + _conv("decoder.pred", 1, 256, 3))
    return leaves


def xmem_weights(xmem: dict, seed: int, device) -> Dict[str, Tensor]:
    """Every leaf on ``device`` (float32; the batch norms' counters int64),
    from one draw seeded with ``seed``."""
    leaves = xmem_shapes(xmem)
    drawn = [(n, s, f) for n, s, f in leaves if isinstance(f, int)]
    total = sum(torch.Size(s).numel() for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, fan_in in leaves:
        if fan_in == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        elif fan_in in ("one", "zero"):
            out[name] = torch.full(shape, 1.0 if fan_in == "one" else 0.0, device=device)
        else:
            n = torch.Size(shape).numel()
            bound = fan_in ** -0.5 * (PRED_SCALE if name == "decoder.pred.weight" else 1.0)
            out[name] = flat[at:at + n].view(shape).mul_(2 * bound).sub_(bound)
            at += n
    for name, channels, factor in ROLE_SCALES:
        out[name][:, channels(xmem["value_dim"])] *= factor
    return out

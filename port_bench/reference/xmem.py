"""XMem (Cheng & Schwing, ECCV 2022, arXiv:2207.07115) in plain PyTorch: the
networks, the three-tier memory and the frame schedule of its evaluation,
for the video cell's check.

Written from the published code (https://github.com/hkchengrex/XMem:
``model/network.py``, ``modules.py``, ``group_modules.py``, ``cbam.py``,
``resnet.py``; ``inference/inference_core.py``, ``memory_manager.py``,
``kv_memory_store.py``, ``memory_util.py``; ``eval.py``), over a state dict
in the layout of its ``XMem.pth``. One video, one view, every object given
on the first frame (DAVIS's protocol):

- the key encoder, ResNet-50 to stride 16 (``res2``, ``layer2``, ``layer3``),
  and the key, shrinkage (d² + 1) and selection (sigmoid) projections;
- the value encoder per object, ResNet-18 to stride 16 over [image, own
  mask, the other masks], the CBAM feature fusion with the key encoder's
  stride-16 features, the GRU hidden reinforcer;
- the decoder per object: the fusion of [readout, hidden] with the
  stride-16 features, the multi-scale GRU hidden updater, two upsampling
  blocks to stride 4, the logit head, x4 bilinear, sigmoid and the soft
  aggregation with the implicit background;
- the memory: working and long-term stores of keys, shrinkage, selection
  (working only) and values, with usage and life counts; the anisotropic
  L2 similarity and the top-k softmax readout over [long-term, working];
  consolidation of the working memory's candidates into the most used
  prototypes by a full-softmax potentiation; eviction of the least used
  long-term elements; the frame schedule (a memory frame every
  ``mem_every`` frames, deep updates with memory frames).

The stores grow by concatenation, as the published code's do.

Precision modes (``precision.py``; :data:`MODES`): ``f32`` runs everything
in float32 with TF32 off; ``bf16`` is the configuration stated in
bfloat16: every weight rounded to bf16 once and the networks run in bf16
(products summed in f32, batch norm's affine taken in f32 and rounded
once), while the memory, its similarity, top-k softmax and readout stay
float32, and the decoder's logits go through the sigmoid and the soft
aggregation in float32; ``fp8``, its control one
step down, quantises each convolution's and linear layer's operands to
float8 e4m3 and rounds the memory's products, their operands and the
similarity to TF32.

Departures from the published code, each on purpose:

- one object group: objects that enter after the first frame raise;
- deep updates ride the memory frames (``deep_update_every = -1``, the
  default); another schedule raises;
- the top-k softmax subtracts each query's largest similarity before the
  exponential (the published exponentiates the raw values): equal in exact
  arithmetic, and it cannot overflow;
- ``k`` is clamped to the memory's size (the published needs ``top_k``
  elements; a 480p frame alone holds 1,620);
- ties among usage values go to the lowest index, in consolidation's
  prototype picks and in eviction, and eviction keeps exactly
  ``max_long_term_elements - num_prototypes`` elements (the published
  drops every element tied with the last one to go, and fails when no
  element is to go);
- no ``end`` flag: the last frame of a video updates the memory as any
  other (its output is the same);
- no resize: a frame's short side must be the configured ``size``
  (DAVIS's 480p frames are 480x854); otherwise it raises;
- the networks run in the mode's dtype where the published evaluation
  runs under float16 autocast, and the sigmoid of the logits in float32
  where the published takes it in float16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import precision
from port_bench.reference.layers import cast
from port_bench.reference.precision import Precision

Tensor = torch.Tensor

F32 = Precision("f32", torch.float32, "plain", torch.float32, False, "exact")
MODES = {"f32": F32, "bf16": precision.MODES["bf16"], "fp8": precision.MODES["fp8"]}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
LIFE0 = 1e-7  # the life count of a new memory element


# ---------------------------------------------------------------------------
# Layers (weights ``w`` in the networks' dtype, names as in XMem.pth)
# ---------------------------------------------------------------------------

def conv(x: Tensor, w: dict, name: str, P: Precision, stride: int = 1,
         padding: int = 0) -> Tensor:
    return F.conv2d(P.operand(x), P.operand(w[name + ".weight"]), w.get(name + ".bias"),
                    stride, padding)


def linear(x: Tensor, w: dict, name: str, P: Precision) -> Tensor:
    return F.linear(P.operand(x), P.operand(w[name + ".weight"]), w[name + ".bias"])


def bn(x: Tensor, w: dict, name: str) -> Tensor:
    """Inference batch norm: the running statistics and the affine in f32,
    rounded once to ``x``'s dtype."""
    f = lambda k: w[f"{name}.{k}"].float()[:, None, None]  # noqa: E731
    y = (x.float() - f("running_mean")) * torch.rsqrt(f("running_var") + BN_EPS) * f("weight") \
        + f("bias")
    return y.to(x.dtype)


def bottleneck(x: Tensor, w: dict, name: str, stride: int, P: Precision) -> Tensor:
    """torchvision's Bottleneck (v1.5: the stride on the 3x3)."""
    out = F.relu(bn(conv(x, w, name + ".conv1", P), w, name + ".bn1"))
    out = F.relu(bn(conv(out, w, name + ".conv2", P, stride, 1), w, name + ".bn2"))
    out = bn(conv(out, w, name + ".conv3", P), w, name + ".bn3")
    if name + ".downsample.0.weight" in w:
        x = bn(conv(x, w, name + ".downsample.0", P, stride), w, name + ".downsample.1")
    return F.relu(out + x)


def basic_block(x: Tensor, w: dict, name: str, stride: int, P: Precision) -> Tensor:
    """torchvision's BasicBlock."""
    out = F.relu(bn(conv(x, w, name + ".conv1", P, stride, 1), w, name + ".bn1"))
    out = bn(conv(out, w, name + ".conv2", P, 1, 1), w, name + ".bn2")
    if name + ".downsample.0.weight" in w:
        x = bn(conv(x, w, name + ".downsample.0", P, stride), w, name + ".downsample.1")
    return F.relu(out + x)


def res_layer(x: Tensor, w: dict, name: str, block, blocks: int, stride: int,
              P: Precision) -> Tensor:
    for i in range(blocks):
        x = block(x, w, f"{name}.{i}", stride if i == 0 else 1, P)
    return x


def group_res_block(g: Tensor, w: dict, name: str, P: Precision) -> Tensor:
    """``GroupResBlock``: two 3x3 convolutions on relu'd input, plus the
    input or its 3x3 projection."""
    out = conv(F.relu(g), w, name + ".conv1", P, padding=1)
    out = conv(F.relu(out), w, name + ".conv2", P, padding=1)
    if name + ".downsample.weight" in w:
        g = conv(g, w, name + ".downsample", P, padding=1)
    return out + g


def cbam(x: Tensor, w: dict, name: str, P: Precision) -> Tensor:
    """The channel gate (an MLP over the average- and max-pooled channels)
    then the spatial gate (a 7x7 convolution over the channels' max and
    mean)."""
    mlp = name + ".ChannelGate.mlp"

    def gate(pooled):
        return linear(F.relu(linear(pooled.flatten(1), w, mlp + ".1", P)), w, mlp + ".3", P)

    hw = x.shape[-2:]
    att = gate(F.avg_pool2d(x, hw, stride=hw)) + gate(F.max_pool2d(x, hw, stride=hw))
    x = x * torch.sigmoid(att)[:, :, None, None]
    pooled = torch.cat([torch.max(x, 1)[0][:, None], torch.mean(x, 1)[:, None]], 1)
    return x * torch.sigmoid(conv(pooled, w, name + ".SpatialGate.spatial.conv", P, padding=3))


def fusion(x: Tensor, g: Tensor, w: dict, name: str, P: Precision) -> Tensor:
    """``FeatureFusionBlock``: each object's g beside the image's x, a res
    block, CBAM as a residual, a res block. x (C, h, w), g (O, Cg, h, w)."""
    g = torch.cat([x[None].expand(g.shape[0], -1, -1, -1), g], 1)
    g = group_res_block(g, w, name + ".block1", P)
    return group_res_block(g + cbam(g, w, name + ".attention", P), w, name + ".block2", P)


def gru(g: Tensor, h: Tensor, w: dict, name: str, P: Precision) -> Tensor:
    """XMem's GRU: the new value is made before the forget gate."""
    ch = h.shape[1]
    values = conv(torch.cat([g, h], 1), w, name, P, padding=1)
    forget = torch.sigmoid(values[:, :ch])
    update = torch.sigmoid(values[:, ch:2 * ch])
    new_value = torch.tanh(values[:, 2 * ch:])
    return forget * h * (1 - update) + update * new_value


def aggregate(prob: Tensor) -> Tensor:
    """Soft aggregation (``aggregate.py``): the implicit background
    prod(1 - p) first, renormalised through the log-odds, in f32."""
    prob = prob.float()
    new_prob = torch.cat([torch.prod(1 - prob, dim=0, keepdim=True), prob], 0)
    new_prob = new_prob.clamp(1e-7, 1 - 1e-7)
    return F.softmax(torch.log(new_prob / (1 - new_prob)), dim=0)


# ---------------------------------------------------------------------------
# The networks
# ---------------------------------------------------------------------------

def encode_key(img: Tensor, w: dict, P: Precision):
    """(3, H, W) -> key (CK, h, w), shrinkage (1, h, w), selection (CK, h,
    w), f16, f8, f4, each of one image."""
    x = img[None]
    x = F.relu(bn(conv(x, w, "key_encoder.conv1", P, 2, 3), w, "key_encoder.bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    f4 = res_layer(x, w, "key_encoder.res2", bottleneck, 3, 1, P)
    f8 = res_layer(f4, w, "key_encoder.layer2", bottleneck, 4, 2, P)
    f16 = res_layer(f8, w, "key_encoder.layer3", bottleneck, 6, 2, P)
    key = conv(f16, w, "key_proj.key_proj", P, padding=1)
    shrinkage = conv(f16, w, "key_proj.d_proj", P, padding=1) ** 2 + 1
    selection = torch.sigmoid(conv(f16, w, "key_proj.e_proj", P, padding=1))
    return key[0], shrinkage[0], selection[0], f16[0], f8[0], f4[0]


def encode_value(img: Tensor, f16: Tensor, hidden: Tensor, masks: Tensor, w: dict,
                 P: Precision):
    """Each object's value and reinforced hidden state. img (3, H, W), f16
    (1024, h, w), hidden (O, CH, h, w), masks (O, H, W) without the
    background. Returns (value (O, CV, h, w), hidden)."""
    O = masks.shape[0]
    if O == 1:
        others = torch.zeros_like(masks)
    else:
        others = torch.stack([masks[[j for j in range(O) if j != i]].sum(0) for i in range(O)])
    g = torch.cat([img[None].expand(O, -1, -1, -1), masks[:, None], others[:, None]], 1)
    g = bn(conv(g, w, "value_encoder.conv1", P, 2, 3), w, "value_encoder.bn1")
    g = F.relu(F.max_pool2d(g, 3, 2, 1))
    g = res_layer(g, w, "value_encoder.layer1", basic_block, 2, 1, P)
    g = res_layer(g, w, "value_encoder.layer2", basic_block, 2, 2, P)
    g = res_layer(g, w, "value_encoder.layer3", basic_block, 2, 2, P)
    g = fusion(f16, g, w, "value_encoder.fuser", P)
    return g, gru(g, hidden, w, "value_encoder.hidden_reinforce.transform", P)


def up_block(skip: Tensor, g: Tensor, w: dict, name: str, P: Precision) -> Tensor:
    """``UpsampleBlock``: the image's skip features (one convolution for
    all objects) plus each object's x2 bilinear g, then a res block."""
    skip = conv(skip[None], w, name + ".skip_conv", P, padding=1)
    g = F.interpolate(g, scale_factor=2, mode="bilinear", align_corners=False)
    return group_res_block(skip + g, w, name + ".out_conv", P)


def decode(f16: Tensor, f8: Tensor, f4: Tensor, hidden: Tensor, readout: Tensor, w: dict,
           P: Precision, h_out: bool):
    """Each object's logits (O, H, W) at full size from its memory readout
    (O, CV, h, w) and hidden state (O, CH, h, w); the updated hidden state
    where ``h_out``, else None."""
    g16 = fusion(f16, torch.cat([readout, hidden], 1), w, "decoder.fuser", P)
    g8 = up_block(f8, g16, w, "decoder.up_16_8", P)
    g4 = up_block(f4, g8, w, "decoder.up_8_4", P)
    logits = conv(F.relu(g4), w, "decoder.pred", P, padding=1)
    new_hidden = None
    if h_out:
        g4 = torch.cat([g4, logits], 1)
        u = "decoder.hidden_update."
        g = (conv(g16, w, u + "g16_conv", P)
             + conv(F.interpolate(g8, scale_factor=1 / 2, mode="area"), w, u + "g8_conv", P)
             + conv(F.interpolate(g4, scale_factor=1 / 4, mode="area"), w, u + "g4_conv", P))
        new_hidden = gru(g, hidden, w, u + "transform", P)
    logits = F.interpolate(logits, scale_factor=4, mode="bilinear", align_corners=False)
    return logits[:, 0], new_hidden


# ---------------------------------------------------------------------------
# The memory (float32)
# ---------------------------------------------------------------------------

def mm(a: Tensor, b: Tensor, P: Precision) -> Tensor:
    """A float32 product of the memory, operands and result as the mode stores them."""
    return P.r(torch.matmul(P.r(a), P.r(b)))


def similarity(mk: Tensor, ms: Optional[Tensor], qk: Tensor, qe: Optional[Tensor],
               P: Precision) -> Tensor:
    """The anisotropic L2 similarity (``get_similarity``): mk (CK, L), ms
    (L,), qk and qe (CK, N) -> (L, N)."""
    ck = mk.shape[0]
    if qe is not None:
        a_sq = mm(mk.pow(2).t(), qe, P)
        two_ab = 2 * mm(mk.t(), qk * qe, P)
        b_sq = (qe * qk.pow(2)).sum(0, keepdim=True)
        sim = -a_sq + two_ab - b_sq
    else:
        sim = -mk.pow(2).sum(0)[:, None] + 2 * mm(mk.t(), qk, P)
    if ms is not None:
        sim = sim * ms[:, None]
    return P.r(sim / math.sqrt(ck))


def top_k_softmax(sim: Tensor, top_k: int) -> Tensor:
    """Each query's softmax over its ``top_k`` most similar elements, zero
    elsewhere: (L, N) -> (L, N)."""
    values, indices = torch.topk(sim, k=min(top_k, sim.shape[0]), dim=0)
    x = torch.exp(values - values[:1])
    return torch.zeros_like(sim).scatter_(0, indices, x / x.sum(0, keepdim=True))


def most_used(usage: Tensor, k: int) -> Tensor:
    """Indices of the ``k`` largest usage values, largest first, ties to the
    lowest index."""
    return torch.sort(usage, descending=True, stable=True).indices[:k]


class Store:
    """Keys (CK, L), shrinkage (L,), selection (CK, L) or None, values (O,
    CV, L), use and life counts (L,), grown by concatenation."""

    def __init__(self):
        self.k = self.s = self.e = self.v = self.use = self.life = None

    @property
    def size(self) -> int:
        return 0 if self.k is None else self.k.shape[-1]

    def add(self, k, s, e, v) -> None:
        n = k.shape[-1]
        new = {"k": k, "s": s, "e": e, "v": v, "use": torch.zeros(n, device=k.device),
               "life": torch.full((n,), LIFE0, device=k.device)}
        for name, t in new.items():
            old = getattr(self, name)
            setattr(self, name, t if old is None or t is None else torch.cat([old, t], -1))

    def keep(self, idx) -> None:
        """Keep the elements ``idx`` (a slice or an index tensor), in that order."""
        for name in ("k", "s", "e", "v", "use", "life"):
            t = getattr(self, name)
            if t is not None:
                setattr(self, name, t[..., idx])

    def usage(self) -> Tensor:
        return self.use / self.life


class Memory:
    """``MemoryManager`` of one video, one object group."""

    def __init__(self, cfg: dict, hw: int, P: Precision):
        self.cfg, self.hw, self.P = cfg, hw, P
        self.work, self.long = Store(), Store()
        self.min_work = cfg["min_mid_term_frames"] * hw
        self.max_work = cfg["max_mid_term_frames"] * hw
        self.consolidations = self.evictions = 0

    @property
    def read_elements(self) -> int:
        return self.long.size + self.work.size

    def read(self, qk: Tensor, qe: Tensor) -> Tensor:
        """The readout (O, CV, N) of the queries qk, qe (CK, N); adds their usage."""
        lsize = self.long.size
        if lsize:
            keys = torch.cat([self.long.k, self.work.k], -1)
            shrinkage = torch.cat([self.long.s, self.work.s], -1)
            values = torch.cat([self.long.v, self.work.v], -1)
        else:
            keys, shrinkage, values = self.work.k, self.work.s, self.work.v
        affinity = top_k_softmax(similarity(keys, shrinkage, qk, qe, self.P), self.cfg["top_k"])
        usage = affinity.sum(1)
        for store, u in ((self.long, usage[:lsize]), (self.work, usage[lsize:])):
            if store.size:
                store.use = store.use + u
                store.life = store.life + 1
        O, CV = values.shape[:2]
        return mm(values.reshape(O * CV, -1), affinity, self.P).reshape(O, CV, -1)

    def add(self, k: Tensor, s: Tensor, e: Tensor, v: Tensor) -> None:
        """One frame's elements: k, e (CK, hw), s (hw,), v (O, CV, hw)."""
        self.work.add(k, s, e, v)
        if self.work.size >= self.max_work:
            room = self.cfg["max_long_term_elements"] - self.prototypes
            if self.long.size >= room:
                self.long.keep(torch.sort(most_used(self.long.usage(), room)).values)
                self.evictions += 1
            self.consolidate()

    @property
    def prototypes(self) -> int:
        return min(self.cfg["num_prototypes"], self.max_work - self.min_work)

    def consolidate(self) -> None:
        """The candidates (past the first frame, before the newest
        ``min_mid_term_frames - 1`` frames) leave the working memory; their
        most used become long-term prototypes, each a full-softmax readout
        of the candidates (the potentiation)."""
        P, work = self.P, self.work
        lo, hi = self.hw, work.size - self.min_work + self.hw
        ck, cs, ce = work.k[:, lo:hi], work.s[lo:hi], work.e[:, lo:hi]
        cv = work.v[..., lo:hi]
        idx = most_used(work.usage()[lo:hi], self.prototypes)
        pk = ck[:, idx]
        affinity = F.softmax(similarity(ck, cs, pk, ce[:, idx], P), dim=0)
        O, CV = cv.shape[:2]
        pv = mm(cv.reshape(O * CV, -1), affinity, P).reshape(O, CV, -1)
        ps = mm(cs[None], affinity, P)[0]
        work.keep(torch.cat([torch.arange(lo), torch.arange(hi, work.size)]).to(work.k.device))
        self.long.add(pk, ps, None, pv)
        self.consolidations += 1


# ---------------------------------------------------------------------------
# The video
# ---------------------------------------------------------------------------

def pad_spec(H: int, W: int):
    """``pad_divide_by(x, 16)``'s symmetric pads (lh, uh, lw, uw)."""
    ph, pw = -(-H // 16) * 16, -(-W // 16) * 16
    return (ph - H) // 2, ph - H - (ph - H) // 2, (pw - W) // 2, pw - W - (pw - W) // 2


class Tracker:
    """``InferenceCore`` with eval.py's frame handling for one video: an
    RGB frame normalised with ImageNet's statistics and padded to a
    multiple of 16; the first frame's index mask as one-hot objects; the
    probabilities unpadded."""

    def __init__(self, weights: Dict[str, Tensor], cfg: dict, num_objects: int, hw, P: Precision,
                 device):
        if cfg["deep_update_every"] >= 0:
            raise NotImplementedError("deep updates ride the memory frames only")
        if not (cfg["enable_long_term"] and cfg["enable_long_term_count_usage"]):
            raise NotImplementedError("the long-term memory, counting its usage, only")
        if min(hw) != cfg["size"]:
            raise NotImplementedError("frames whose short side is cfg['size'] only (no resize)")
        self.w = cast(weights, "", P.vit_dtype)
        self.cfg, self.O, self.P, self.device = cfg, num_objects, P, torch.device(device)
        self.H, self.W = hw
        self.pad = pad_spec(*hw)
        h = (self.H + self.pad[0] + self.pad[1]) // 16
        w = (self.W + self.pad[2] + self.pad[3]) // 16
        self.memory = Memory(cfg, h * w, P)
        self.hidden = torch.zeros(num_objects, cfg["hidden_dim"], h, w, device=self.device)
        self.ti, self.last_mem_ti = -1, 0
        self.last_readout = None

    def _padded(self, x: Tensor) -> Tensor:
        lh, uh, lw, uw = self.pad
        return F.pad(x, (lw, uw, lh, uh))

    @torch.no_grad()
    def step(self, rgb: np.ndarray, index_mask: Optional[np.ndarray] = None) -> Tensor:
        """rgb (H, W, 3) uint8; ``index_mask`` (H, W) on the first frame.
        Returns the probabilities with the background first (O+1, H, W)."""
        self.ti += 1
        if (index_mask is None) == (self.ti == 0):
            raise ValueError("the first frame, and only it, takes the index mask")
        P, w, dt = self.P, self.w, self.P.vit_dtype
        img = torch.as_tensor(rgb, device=self.device).float().permute(2, 0, 1) / 255
        mean = torch.tensor(IMAGENET_MEAN, device=self.device)[:, None, None]
        std = torch.tensor(IMAGENET_STD, device=self.device)[:, None, None]
        img = self._padded((img - mean) / std).to(dt)
        key, shrinkage, selection, f16, f8, f4 = encode_key(img, w, P)
        is_mem = self.ti - self.last_mem_ti >= self.cfg["mem_every"] or index_mask is not None
        self.last_readout = None
        if index_mask is not None:
            m = torch.as_tensor(index_mask, device=self.device)
            onehot = torch.stack([m == i + 1 for i in range(self.O)]).float()
            prob = aggregate(self._padded(onehot))
        else:
            readout = self.memory.read(key.flatten(1).float(), selection.flatten(1).float())
            self.last_readout = readout
            logits, hidden = decode(f16, f8, f4, self.hidden.to(dt),
                                    readout.reshape(self.O, -1, *key.shape[1:]).to(dt), w, P,
                                    h_out=not is_mem)
            prob = aggregate(torch.sigmoid(logits.float()))
            if not is_mem:
                self.hidden = hidden.float()
        if is_mem:
            value, hidden = encode_value(img, f16, self.hidden.to(dt), prob[1:].to(dt), w, P)
            self.memory.add(key.flatten(1).float(), shrinkage.flatten().float(),
                            selection.flatten(1).float(), value.flatten(2).float())
            self.hidden = hidden.float()
            self.last_mem_ti = self.ti
        lh, uh, lw, uw = self.pad
        return prob[:, lh:lh + self.H, lw:lw + self.W]


def replay(weights: Dict[str, Tensor], frame: Callable[[int], np.ndarray],
           index_mask: np.ndarray, cfg: dict, num_objects: int, P: Precision, stops: Iterable[int],
           device) -> Dict[int, dict]:
    """A video from its first frame through the last of ``stops``; at each
    stop the frame's ``prob`` (O+1, H, W), its memory ``readout`` (O, CV,
    h*w; None on the first frame) and ``read_elements`` (the elements the
    read attended; 0 on the first frame), with the ``consolidations`` and
    ``evictions`` so far. ``frame(t)`` gives frame t (H, W, 3) uint8."""
    stops = sorted(set(stops))
    out = {}
    with torch.no_grad(), P.matmul_mode():
        tracker = None
        for t in range(stops[-1] + 1):
            rgb = frame(t)
            if tracker is None:
                tracker = Tracker(weights, cfg, num_objects, rgb.shape[:2], P, device)
            elements = tracker.memory.read_elements if t else 0
            prob = tracker.step(rgb, index_mask if t == 0 else None)
            if t in stops:
                out[t] = {"prob": prob, "readout": tracker.last_readout,
                          "read_elements": elements,
                          "consolidations": tracker.memory.consolidations,
                          "evictions": tracker.memory.evictions}
    return out

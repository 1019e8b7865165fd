"""XMem training: the losses, the T-frame rollout and one AdamW step.

Counterpart of ``d3fields_tpu/models/xmem/trainer.py`` (the reference's
``XMem/model/trainer.py:20-234`` and ``XMem/model/losses.py:8-46``). The
rollout runs the whole batch at once through the port's batched modules:
the key encoder sees all B·T frames in one call, and every later call
takes the B samples of one frame. Autograd gives the gradients; there is
no jit, no donation and no vmap.

What is held to the JAX package:

- the trainable leaves are exactly the JAX parameter tree's leaves,
  batch-norm ``mean``/``var`` included: they are the modules' running
  statistics, made to require grad (:func:`train_leaves`), and
  ``blocks.batch_norm`` then computes the norm as JAX does;
- AdamW is optax's ``adamw`` (decoupled decay on every leaf, Adam's bias
  corrections in float32, see :func:`_optax_factor`) under optax's
  ``piecewise_constant_schedule``: update ``k`` (counted from 0) is
  decayed by ``gamma`` for every boundary ``b <= k``;
- the per-sample randomness (memory-frame subsets and deep-update coins)
  is drawn here from a ``torch.Generator``; a caller that holds JAX's
  draws passes them as :class:`Rollout`;
- the data-parallel step (``train_step(..., group=)``) is the JAX step on
  a batch laid over a mesh's ``dp`` axis: each rank holds its rows of the
  global batch, draws the global batch's randomness and keeps its rows,
  and averages the gradients of every leaf over the ranks, batch-norm
  statistics included, before its AdamW step. ``torch.nn.parallel.
  DistributedDataParallel`` is not used: it all-reduces only
  ``parameters()`` and broadcasts rank 0's buffers over the others, and
  here the running statistics are leaves that AdamW trains.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from d3fields_tpu_torch.config import XMemConfig
from d3fields_tpu_torch.models.xmem import blocks as B
from d3fields_tpu_torch.models.xmem import memory as M
from d3fields_tpu_torch.models.xmem import network as N

Tensor = torch.Tensor

BETAS = (0.9, 0.999)
EPS = 1e-8


# ---------------------------------------------------------------------------
# losses (XMem/model/losses.py)
# ---------------------------------------------------------------------------

def _dice_rows(masks: Tensor, cls_gt: Tensor) -> Tensor:
    """Per-sample dice loss, (B,): the mean over objects."""
    nb, O = masks.shape[:2]
    m = masks.reshape(nb, O, -1)
    labels = torch.arange(1, O + 1, device=cls_gt.device)
    gt = (cls_gt.reshape(nb, 1, -1) == labels[None, :, None]).to(m.dtype)
    num = 2.0 * (m * gt).sum(-1)
    den = m.sum(-1) + gt.sum(-1)
    return (1.0 - (num + 1.0) / (den + 1.0)).mean(-1)


def dice_loss(masks: Tensor, cls_gt: Tensor) -> Tensor:
    """masks (B, O, H, W) probabilities (no background); cls_gt (B, H, W)
    int (0 = background). Reference ``dice_loss`` (``losses.py:8-19``)."""
    return _dice_rows(masks, cls_gt).mean()


def hard_pixel_count(it: int, n: int, start_warm: int, end_warm: int,
                     top_p: float = 0.15) -> int:
    """How many of ``n`` per-pixel losses the bootstrapped CE averages at
    iteration ``it``: all before ``start_warm``, then a fraction falling
    linearly to ``top_p`` at ``end_warm``. ``round(frac * n)`` in float32,
    half to even, as the JAX package computes it (the reference's
    ``int()``/``topk`` truncates)."""
    if it < start_warm:
        return n
    f32 = np.float32
    frac = f32(top_p) + f32(f32(1.0 - top_p) * f32(end_warm - it)) / f32(end_warm - start_warm)
    frac = np.clip(frac, f32(top_p), f32(1.0))
    return int(np.round(f32(frac * f32(n))))


def _bootstrapped_ce_rows(logits: Tensor, cls_gt: Tensor, k: int) -> Tensor:
    """Per-row mean of the ``k`` largest per-pixel CE losses: logits
    (R, C, ...), cls_gt (R, ...) -> (R,)."""
    lp = F.log_softmax(logits.float(), dim=1)
    raw = -torch.gather(lp, 1, cls_gt[:, None].long())[:, 0].reshape(lp.shape[0], -1)
    hard = torch.sort(raw, dim=1, descending=True)[0][:, :k]
    return hard.sum(1) / max(k, 1)


def bootstrapped_ce(logits: Tensor, cls_gt: Tensor, it: int, start_warm: int,
                    end_warm: int, top_p: float = 0.15) -> Tensor:
    """logits (B, O+1, H, W); cls_gt (B, H, W). Hard-pixel mining CE over
    every pixel of the batch (``BootstrappedCE``, ``losses.py:22-43``)."""
    n = cls_gt.numel()
    k = hard_pixel_count(it, n, start_warm, end_warm, top_p)
    flat = logits.movedim(0, 1).reshape(1, logits.shape[1], -1)
    return _bootstrapped_ce_rows(flat, cls_gt.reshape(1, -1), k)[0]


# ---------------------------------------------------------------------------
# multi-frame forward + loss
# ---------------------------------------------------------------------------

def select_ref_frames(ti: int, num_ref_frames: int,
                      generator: Optional[torch.Generator] = None) -> Tensor:
    """Memory-frame indices for query frame ``ti`` (> ``num_ref_frames``):
    frame 0, then ``num_ref_frames - 1`` distinct random frames of
    ``[1, ti)``, the reference's ``cat([zeros(1), randperm(ti-1)[:n-1] + 1])``
    (``trainer.py:87-96``). (num_ref_frames,) int64 on the CPU."""
    perm = torch.randperm(ti - 1, generator=generator)[: num_ref_frames - 1] + 1
    return torch.cat([torch.zeros(1, dtype=perm.dtype), perm])


@dataclasses.dataclass
class Rollout:
    """The random choices of one batch's rollout.

    ``ref_frames[ti]`` (B, num_ref_frames) int64: each sample's memory
    frames for query frame ``ti``, for every ``ti > num_ref_frames``.
    ``deep_update`` (B, T) bool: whether frame ``ti``'s value encoding
    replaces the hidden state (only ``1 <= ti < T - 1`` are read); None
    always replaces it, as the JAX package does with ``rng=None``.
    """

    ref_frames: Dict[int, Tensor]
    deep_update: Optional[Tensor] = None

    def rows(self, lo: int, hi: int) -> "Rollout":
        """The choices of samples ``lo:hi`` (a rank's shard of the batch)."""
        return Rollout({ti: r[lo:hi] for ti, r in self.ref_frames.items()},
                       None if self.deep_update is None else self.deep_update[lo:hi])


def draw_rollout(generator: torch.Generator, batch: int, num_frames: int,
                 num_ref_frames: int, deep_update_prob: float = 0.2) -> Rollout:
    """One batch's random choices: per sample, the memory subsets of every
    query frame past the cap and a Bernoulli(``deep_update_prob``) coin per
    frame (the reference's ``trainer.py:87-96, 118``)."""
    refs = {}
    if num_ref_frames > 0:
        for ti in range(num_ref_frames + 1, num_frames):
            refs[ti] = torch.stack([select_ref_frames(ti, num_ref_frames, generator)
                                    for _ in range(batch)])
    coins = torch.rand((batch, num_frames), generator=generator) < deep_update_prob
    return Rollout(refs, coins)


def _gather_frames(x: Tensor, sel: Tensor) -> Tensor:
    """x (B, T, ...), sel (B, R) -> (B, R, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], sel]


def sequence_loss(model: N.XMem, batch: Dict[str, Tensor], it: int, *,
                  start_warm: int = 20000, end_warm: int = 70000,
                  num_ref_frames: int = 0, rollout: Optional[Rollout] = None,
                  return_probs: bool = False) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Each sample's T-frame rollout loss, (B,).

    batch: frames (B, T, 3, H, W), first_gt (B, O, H, W) one-hot, cls_gt
    (B, T, H, W) int, selector (B, O) 1.0 for live objects. Mirrors
    ``XMemTrainer.do_pass`` (``trainer.py:56-160``): frame 0 seeds the
    memory; each later frame reads it with a full softmax, is segmented,
    scored (bootstrapped CE on the aggregation's log-odds plus dice), and
    unless it is the last, encoded into the memory with the hidden state's
    deep update. ``num_ref_frames > 0`` caps the memory of frame ``ti`` at
    ``rollout.ref_frames[ti]`` once ``ti > num_ref_frames``; without a
    ``rollout`` the subsets come from a generator seeded with 1 and every
    frame deep-updates. ``aux["last_prob"]`` (B, O+1, H, W) with
    ``return_probs``.
    """
    frames, first_gt = batch["frames"], batch["first_gt"]
    cls_gt, selector = batch["cls_gt"], batch["selector"]
    nb, T = frames.shape[:2]
    O = first_gt.shape[1]
    if rollout is None:
        rollout = Rollout({})
        if num_ref_frames > 0:
            gen = torch.Generator().manual_seed(1)
            rollout.ref_frames = {
                ti: select_ref_frames(ti, num_ref_frames, gen)[None].expand(nb, -1)
                for ti in range(num_ref_frames + 1, T)}

    key, shrinkage, selection, f16, f8, f4 = (
        B.unfold(t, nb) for t in model.encode_key(B.fold(frames)))
    ck, h, w = key.shape[2:]
    hidden = torch.zeros((nb, O, model.cfg.hidden_dim, h, w), dtype=key.dtype,
                         device=key.device)
    v0, hidden = model.encode_value(frames[:, 0], f16[:, 0], hidden, first_gt,
                                    is_deep_update=True)
    values = [v0]  # each (B, O, CV, h, w)
    coins = rollout.deep_update
    if coins is not None:
        coins = coins.to(device=key.device)

    total = torch.zeros(nb, dtype=torch.float32, device=key.device)
    prob_with_bg = None
    for ti in range(1, T):
        if num_ref_frames > 0 and ti > num_ref_frames:
            sel = rollout.ref_frames[ti].to(key.device)
            R = sel.shape[1]
            ref_k = _gather_frames(key, sel)
            ref_s = _gather_frames(shrinkage, sel)
            ref_v = _gather_frames(torch.stack(values, dim=1), sel)
        else:
            R = ti
            ref_k, ref_s = key[:, :ti], shrinkage[:, :ti]
            ref_v = torch.stack(values, dim=1)
        # memory index order (frame, y, x), as the JAX package concatenates
        ref_k = ref_k.movedim(1, 2).reshape(nb, ck, R * h * w)
        ref_s = ref_s.reshape(nb, R * h * w)
        ref_v = ref_v.permute(0, 2, 3, 1, 4, 5).reshape(nb, O, -1, R * h * w)
        qk = key[:, ti].reshape(nb, ck, h * w)
        qe = selection[:, ti].reshape(nb, ck, h * w)
        aff = torch.softmax(M.similarity(ref_k, ref_s, qk, qe), dim=1)  # full softmax
        readout = torch.einsum("bocl,bln->bocn", ref_v, aff).reshape(nb, O, -1, h, w)

        new_hidden, logits, _ = model.segment(f16[:, ti], f8[:, ti], f4[:, ti], hidden,
                                              readout, h_out=ti < T - 1)
        # the selector masks dead objects before the soft aggregation
        prob = torch.sigmoid(logits) * selector[:, :, None, None]
        prob_with_bg = B.soft_aggregate(prob, dim=1)
        # CE reads the aggregation's log-odds, as the reference
        # (aggregate(..., return_logits=True), network.py:118)
        clipped = B.clip(prob_with_bg, 1e-7, 1.0 - 1e-7)
        logits_with_bg = torch.log(clipped / (1.0 - clipped))
        k = hard_pixel_count(it, cls_gt[0, ti].numel(), start_warm, end_warm)
        total = total + _bootstrapped_ce_rows(logits_with_bg, cls_gt[:, ti], k)
        total = total + _dice_rows(prob_with_bg[:, 1:], cls_gt[:, ti])

        if ti < T - 1:
            hidden = new_hidden
            v16, deep_hidden = model.encode_value(frames[:, ti], f16[:, ti], hidden,
                                                  prob_with_bg[:, 1:], is_deep_update=True)
            if coins is None:
                hidden = deep_hidden
            else:
                hidden = torch.where(coins[:, ti, None, None, None, None], deep_hidden, hidden)
            values.append(v16)
    aux: Dict[str, Tensor] = {}
    if return_probs:
        if T < 2:
            raise ValueError("return_probs needs a clip of >= 2 frames "
                             "(frame 0 only seeds the memory)")
        aux["last_prob"] = prob_with_bg
    # the reference sums per-frame ce + dice without dividing by the frame
    # count (losses.py:60-66)
    return total, aux


# ---------------------------------------------------------------------------
# optimizer and train step
# ---------------------------------------------------------------------------

def train_leaves(model: N.XMem) -> List[Tuple[str, Tensor]]:
    """The JAX parameter tree's leaves as ``(state-dict name, tensor)``:
    every parameter and every batch norm's running mean and variance, which
    are made to require grad (``num_batches_tracked`` is no leaf)."""
    leaves = []
    for name, t in model.state_dict(keep_vars=True).items():
        if name.endswith("num_batches_tracked"):
            continue
        if not t.requires_grad:
            t.requires_grad_(True)
        leaves.append((name, t))
    return leaves


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """optax ``adamw(piecewise_constant_schedule(lr, {s: gamma}),
    weight_decay)`` (``trainer.py:215``; the reference's AdamW + MultiStepLR,
    ``trainer.py:40-44``)."""

    lr: float = 1e-5
    weight_decay: float = 0.05
    steps: Tuple[int, ...] = (80000, 100000)
    gamma: float = 0.1

    def lr_at(self, k: int) -> float:
        """The learning rate of update ``k`` (counted from 0), in float32
        as optax computes it: decayed once for every boundary ``<= k``."""
        v = np.float32(self.lr)
        for boundary in sorted(self.steps):
            if k >= boundary:
                v = np.float32(np.float32(self.gamma) * v)
        return float(v)


def make_optimizer(lr: float = 1e-5, weight_decay: float = 0.05,
                   steps: Sequence[int] = (80000, 100000),
                   gamma: float = 0.1) -> OptimizerSpec:
    """AdamW + MultiStep decay (``trainer.py:215``)."""
    return OptimizerSpec(float(lr), float(weight_decay), tuple(int(s) for s in steps),
                         float(gamma))


def _optax_factor(step: int) -> float:
    """The factor that turns ``torch.optim.AdamW``'s Adam term at ``step``
    (1-based) into optax's: optax divides by the bias corrections
    ``1 - beta**step`` taken in float32, torch in float64 (the same fix as
    ``track/rigid.py::optax_lr_factor``). Exact up to the eps term."""
    b1, b2 = BETAS
    f32 = np.float32
    bc1 = float(f32(1) - np.power(f32(b1), f32(step)))
    bc2 = float(f32(1) - np.power(f32(b2), f32(step)))
    return (1 - b1 ** step) / bc1 * ((bc2 / (1 - b2 ** step)) ** 0.5)


@dataclasses.dataclass
class TrainState:
    """The model, its AdamW over :func:`train_leaves`, the schedule and the
    iteration (the number of updates done)."""

    model: N.XMem
    optimizer: torch.optim.AdamW
    spec: OptimizerSpec
    it: int = 0


def init_train_state(model: N.XMem, spec: OptimizerSpec) -> TrainState:
    opt = torch.optim.AdamW([t for _, t in train_leaves(model)], lr=spec.lr, betas=BETAS,
                            eps=EPS, weight_decay=spec.weight_decay)
    return TrainState(model, opt, spec, 0)


def _data_parallel(group) -> Optional[Tuple[int, int]]:
    """(world size, rank) of the step's group: ``group`` whatever its size,
    else the default group where one is initialized with more than one
    rank; None for the one-process step."""
    import torch.distributed as dist

    if group is None and not (dist.is_available() and dist.is_initialized()
                              and dist.get_world_size() > 1):
        return None
    return dist.get_world_size(group), dist.get_rank(group)


def _reduce_shard_sizes(nb: int, group, device) -> tuple:
    """Start the all-reduce of (nb, nb^2) over the ranks of ``group``, for
    :func:`_check_equal_shards`. gloo sums host numbers at once. Over NCCL
    the sums are on the card and come back to pinned host memory behind
    an event: the check, made once the backward pass is queued, waits for
    the work queued before this step and not for this step's own, so the
    host stays a step ahead of the card."""
    import torch.distributed as dist

    if dist.get_backend(group) != "nccl":
        n = torch.tensor([nb, nb * nb], dtype=torch.float64)
        dist.all_reduce(n, group=group)
        return n, None
    n = torch.full((2,), float(nb), dtype=torch.float64, device=device)
    n[1:] *= nb
    dist.all_reduce(n, group=group)
    host = torch.empty(2, dtype=torch.float64, pin_memory=True)
    host.copy_(n, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return host, done


def _check_equal_shards(sizes: tuple, nb: int, world: int) -> None:
    """Raise on every rank unless every rank holds ``nb`` samples: with
    unequal shards the ranks' mean of means is not the global mean (JAX's
    ``NamedSharding`` needs the batch to divide by the mesh likewise).
    ``(sum n)^2 == world * sum n^2`` holds only when all n are equal, and
    every rank reads the same sums (``sizes``, from
    :func:`_reduce_shard_sizes`) at every step, before the gradients are
    averaged."""
    host, done = sizes
    if done is not None:
        done.synchronize()
    s1, s2 = host.tolist()
    if s1 * s1 != world * s2:
        raise ValueError(f"unequal batch shards over {world} ranks: {int(s1)} samples in all, "
                         f"{nb} on this rank")


def train_step(state: TrainState, batch: Dict[str, Tensor], *, num_ref_frames: int = 0,
               start_warm: int = 20000, end_warm: int = 70000,
               rollout: Optional[Rollout] = None, group=None) -> Tuple[TrainState, Dict]:
    """One AdamW step on the batch's mean rollout loss (``trainer.py:229-257``).
    Updates ``state`` in place and returns it with ``{"loss": tensor}`` (the
    loss stays on the device: fetch it when it is needed). The rollout's
    choices are ``rollout``, else drawn from a generator seeded with the
    iteration.

    Data parallel over ``group`` (a ``torch.distributed`` group; the
    default group when it is initialized with more than one rank): with W
    ranks, ``batch`` is this rank's shard of a global batch of W * b rows,
    rank r holding rows r * b to (r + 1) * b - 1, and every rank must hold
    b (else ``ValueError`` on every rank, before the update). A drawn rollout is drawn for the global batch and cut to the rank's
    rows (``rollout``, when given, is the rank's already). After the
    backward pass every leaf's gradient is averaged over the group, the
    batch-norm statistics' too, so each rank takes the one-process step on
    the global batch; the returned loss is the global mean."""
    nb, T = batch["frames"].shape[:2]
    dp = _data_parallel(group)
    world, rank = dp or (1, 0)
    if dp:
        sizes = _reduce_shard_sizes(nb, group, batch["frames"].device)
    if rollout is None:
        rollout = draw_rollout(torch.Generator().manual_seed(state.it), world * nb, T,
                               num_ref_frames).rows(rank * nb, (rank + 1) * nb)
    losses, _ = sequence_loss(state.model, batch, state.it, start_warm=start_warm,
                              end_warm=end_warm, num_ref_frames=num_ref_frames,
                              rollout=rollout)
    loss = losses.mean()
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    loss = loss.detach()
    if dp:
        import torch.distributed as dist

        from d3fields_tpu_torch.parallel import ops

        _check_equal_shards(sizes, nb, world)
        ops.average_gradients([t for g in state.optimizer.param_groups for t in g["params"]],
                              group)
        dist.all_reduce(loss, group=group)
        loss /= world
    apply_update(state)
    return state, {"loss": loss}


def apply_update(state: TrainState) -> None:
    """Update ``state.it`` from the leaves' ``.grad``: optax's AdamW step at
    the schedule's lr for that update; then ``state.it`` counts it. torch
    decays by ``lr * weight_decay`` and scales the Adam term by ``lr``, so
    the float32 bias-correction factor multiplies the lr and divides the
    decay."""
    lr = state.spec.lr_at(state.it)
    f = _optax_factor(state.it + 1)
    for group in state.optimizer.param_groups:
        group["lr"] = lr * f
        group["weight_decay"] = state.spec.weight_decay / f
    state.optimizer.step()
    state.it += 1


def to_device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, Tensor]:
    """A loader batch (numpy, frames (B, T, H, W, 3)) as the trainer's
    tensors on ``device`` (frames (B, T, 3, H, W))."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    out["frames"] = out["frames"].permute(0, 1, 4, 2, 3)
    pin = torch.device(device).type == "cuda"
    return {k: (v.pin_memory() if pin else v).to(device, non_blocking=pin).contiguous()
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# checkpoints (reference trainer.py:160-202)
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, state: TrainState) -> None:
    """``torch.save`` of the iteration, the model's state dict (what
    ``eval_xmem --ckpt`` and ``apps/_backends.load_xmem`` read), the AdamW
    state and the optimizer's hyperparameters."""
    torch.save({"it": state.it,
                "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
                "optimizer": state.optimizer.state_dict(),
                "spec": dataclasses.asdict(state.spec)}, path)


def load_checkpoint(path: str, cfg: XMemConfig, spec: OptimizerSpec, device) -> TrainState:
    """A :func:`save_checkpoint` file as a train state on ``device`` under
    ``spec`` (the caller's schedule, as the JAX package's ``load_checkpoint``
    takes the caller's optimizer)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    model = N.XMem(cfg, device=device)
    model.load_state_dict(blob["model"])
    state = init_train_state(model.eval(), spec)
    state.optimizer.load_state_dict(blob["optimizer"])
    state.it = int(blob["it"])
    return state


def load_jax_train_state(blob: dict, cfg: XMemConfig, spec: OptimizerSpec,
                         device) -> TrainState:
    """A JAX trainer pickle (``TR.save_checkpoint``), as
    ``utils.convert.read_trainer_pickle`` reads it, as the port's train
    state: its parameters into the model, optax's ``mu``/``nu``/``count``
    into AdamW's ``exp_avg``/``exp_avg_sq``/``step``, and its iteration, so
    that training goes on as the JAX run would."""
    from d3fields_tpu_torch.utils.convert import find_opaque

    model = N.load_jax_params(N.XMem(cfg, device=device), blob["params"]).eval()
    state = init_train_state(model, spec)
    state.it = int(blob.get("it", 0))
    adam = find_opaque(blob.get("opt_state"), "ScaleByAdamState")
    if adam is None:
        raise ValueError("no optax Adam state in the JAX trainer checkpoint")
    count, mu, nu = adam.args[:3]
    mu, nu = N.jax_state_dict(mu), N.jax_state_dict(nu)
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    for name, t in train_leaves(model):
        state.optimizer.state[t] = {
            "step": step.clone(),
            "exp_avg": torch.from_numpy(np.ascontiguousarray(mu[name])).to(t.device),
            "exp_avg_sq": torch.from_numpy(np.ascontiguousarray(nu[name])).to(t.device)}
    return state

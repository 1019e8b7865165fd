"""Port parity: XMem training (``models/xmem/trainer.py``) of
d3fields_tpu_torch against d3fields_tpu.

The setup is tests/test_parallel_train.py:60-75's: ``XMemConfig(key_dim=16,
value_dim=32, hidden_dim=8)``, JAX ``init_params(PRNGKey(0))`` carried into
the port with ``load_jax_params``, and a B=2, T=3, O=2, 32x32 batch from
``RandomState(0)``. Tolerances: dice at rtol 1e-5 and the bootstrapped CE
at 1e-4 (tests/test_parallel_train.py:77-115); rollout losses at rtol
1e-5; gradients at a global relative error <= 1e-3 (``GRAD_RTOL``: the
port's own spread across summation orders is 1.5e-4 here) and a cosine >=
0.9999 on every leaf above rounding noise (``NOISE_SHARE``); each AdamW
step's update per element within a quarter of a step of JAX's, where JAX's
first moment is above rounding noise, and the parameters after the steps
at rtol 1e-4 / atol 1e-5 (the JAX package's dp-versus-replicated
tolerances, :236-238), every leaf, batch-norm statistics included. Each
JAX function compiles once, in the module fixture.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from d3fields_tpu.config import XMemConfig as JXMemConfig
from d3fields_tpu.models.xmem import network as JN
from d3fields_tpu.models.xmem import trainer as JTR
from d3fields_tpu_torch.config import XMemConfig
from d3fields_tpu_torch.models.xmem import network as N
from d3fields_tpu_torch.models.xmem import trainer as TR
from d3fields_tpu_torch.utils.convert import read_trainer_pickle

BV, T, O, H, W = 2, 3, 2, 32, 32
LR = 1e-5
STEP_KW = dict(start_warm=20000, end_warm=70000)
CAP_T, CAP_REF = 4, 2
# Gradients through the rollout of a random-weight XMem amplify rounding:
# the port against itself, one torch thread against four (another
# summation order in the convolutions), differs by a global 2.9e-5 at T=3
# and 1.5e-4 at T=4 on these inputs, as much as it differs from JAX.
GRAD_RTOL = 1e-3
# A leaf whose gradient is below this share of the whole gradient's norm is
# rounding noise around a true zero (key_proj's bias: one shift of every
# key leaves the L2 similarity as it was); its cosine is not held.
NOISE_SHARE = 1e-10
# Adam's first updates are +-lr whatever a gradient's size, so an element
# whose gradient is rounding noise around zero may step the other way, and
# the loss is sharp enough that the second step's gradient moves by 0.2%
# after such flips. An update may be off by more than STEP_TOL of a step
# only where JAX's first moment after it is below FLIP_SHARE of its leaf's
# rms. On these inputs the updates off by more than a quarter step had
# first moments below 0.046 of the rms; a missed or doubled step is off by
# a whole step on the ~92% of a leaf above the line.
STEP_TOL = 0.25
FLIP_SHARE = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per pytest-xdist worker: the workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(rs, bv, t):
    return {
        "frames": rs.rand(bv, t, H, W, 3).astype(np.float32),
        "first_gt": (rs.rand(bv, O, H, W) > 0.5).astype(np.float32),
        "cls_gt": rs.randint(0, O + 1, (bv, t, H, W)),
        "selector": np.ones((bv, O), np.float32),
    }


def _port_batch(batch):
    return TR.to_device_batch(batch, "cpu")


def _rollout_keys(it, bv):
    """The JAX train step's per-sample keys (``_train_step``)."""
    step_key = jax.random.fold_in(jax.random.PRNGKey(0), it)
    return [jax.random.fold_in(step_key, i) for i in range(bv)]


def _jax_rollout(it, bv, t, num_ref):
    """JAX's draws for a batch, as the port's Rollout: memory subsets from
    ``fold_in(key, 7919 + ti)`` and deep-update coins from ``fold_in(key,
    ti)`` (``sequence_loss``)."""
    keys = _rollout_keys(it, bv)
    refs = {ti: torch.from_numpy(np.stack([
        np.asarray(JTR.select_ref_frames(ti, num_ref, jax.random.fold_in(k, 7919 + ti)))
        for k in keys]).astype(np.int64)) for ti in range(num_ref + 1, t) if num_ref > 0}
    coins = np.zeros((bv, t), bool)
    for b, k in enumerate(keys):
        for ti in range(1, t - 1):
            coins[b, ti] = bool(jax.random.bernoulli(jax.random.fold_in(k, ti), 0.2))
    return TR.Rollout(refs, torch.from_numpy(coins))


@pytest.fixture(scope="module")
def setup():
    jcfg = JXMemConfig(key_dim=16, value_dim=32, hidden_dim=8)
    cfg = XMemConfig(key_dim=16, value_dim=32, hidden_dim=8)
    params = JN.init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, params)
    batch = _batch(np.random.RandomState(0), BV, T)
    cap_batch = _batch(np.random.RandomState(3), BV, CAP_T)

    def mean_loss(p, b, keys, num_ref):
        """The JAX train step's loss: sequence_loss vmapped over the batch."""
        return jax.vmap(lambda x, k: JTR.sequence_loss(
            p, x, jnp.asarray(0), jcfg, k, num_ref_frames=num_ref, **STEP_KW)[0],
            in_axes=(0, None if keys is None else 0))(b, keys).mean()

    grad_none = jax.jit(jax.value_and_grad(lambda p, b: mean_loss(p, b, None, 0)))
    grad_cap = jax.jit(jax.value_and_grad(lambda p, b, keys: mean_loss(p, b, keys, CAP_REF)))
    opt = JTR.make_optimizer(lr=LR)
    return dict(cfg=cfg, jcfg=jcfg, params=params, np_params=np_params, batch=batch,
                cap_batch=cap_batch, grad_none=grad_none, grad_cap=grad_cap, opt=opt,
                jstep=jax.jit(lambda s, b: JTR._train_step(s, b, jcfg, opt, **STEP_KW)))


def _model(setup):
    return N.load_jax_params(N.XMem(setup["cfg"], device="cpu"), setup["np_params"]).eval()


def _port_grads(model, batch, **kw):
    leaves = TR.train_leaves(model)
    losses, _ = TR.sequence_loss(model, batch, 0, **STEP_KW, **kw)
    loss = losses.mean()
    loss.backward()
    return float(loss.detach()), {n: (torch.zeros_like(t) if t.grad is None else t.grad).numpy()
                                  for n, t in leaves}


def _hold_grads(got: dict, jax_grads) -> None:
    want = N.jax_state_dict(jax.tree.map(np.asarray, jax_grads))
    assert set(got) == set(want)
    g = np.concatenate([got[k].ravel() for k in sorted(want)])
    r = np.concatenate([want[k].ravel() for k in sorted(want)])
    assert np.linalg.norm(g - r) <= GRAD_RTOL * np.linalg.norm(r)
    for k in want:
        a, b = got[k].ravel().astype(np.float64), want[k].ravel().astype(np.float64)
        if np.linalg.norm(b) < NOISE_SHARE * np.linalg.norm(r):
            continue  # rounding noise around a true zero; the global error holds it
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 0.9999, (k, cos)


@pytest.mark.parametrize("phase,it,rtol", [("warm", 0, 1e-5), ("ramp", 15, 1e-4),
                                           ("hard", 100, 1e-4)])
def test_losses_match_jax(phase, it, rtol):
    rs = np.random.RandomState(2)
    bv, o, h, w = 2, 3, 8, 8
    masks = rs.rand(bv, o, h, w).astype(np.float32)
    cls_gt = rs.randint(0, o + 1, (bv, h, w))
    logits = rs.randn(bv, o + 1, h, w).astype(np.float32)
    np.testing.assert_allclose(
        float(TR.dice_loss(torch.from_numpy(masks), torch.from_numpy(cls_gt))),
        float(JTR.dice_loss(jnp.asarray(masks), jnp.asarray(cls_gt))), rtol=1e-5)
    got = TR.bootstrapped_ce(torch.from_numpy(logits), torch.from_numpy(cls_gt), it, 10, 20)
    want = JTR.bootstrapped_ce(jnp.asarray(logits), jnp.asarray(cls_gt), jnp.asarray(it), 10, 20)
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)


def test_hard_pixel_count_rounds_as_jax():
    """k = round(frac * n) in float32, half to even, across the ramp."""
    for it in (0, 9, 10, 11, 13, 17, 19, 20, 25):
        frac = jnp.clip(0.15 + (1.0 - 0.15) * (20 - jnp.asarray(it)) / (20 - 10), 0.15, 1.0)
        frac = jnp.where(jnp.asarray(it) < 10, 1.0, frac)
        for n in (64, 1000, 1024, 4097):
            assert TR.hard_pixel_count(it, n, 10, 20) == int(jnp.round(frac * n))


def test_select_ref_frames_matches_reference_sampling():
    """Frame 0 always; the rest distinct, drawn from [1, ti); length
    num_ref (reference trainer.py:87-96; tests/test_parallel_train.py:118-135)."""
    for ti, num_ref in [(4, 3), (7, 3), (5, 2), (9, 4)]:
        for s in range(8):
            sel = TR.select_ref_frames(ti, num_ref, torch.Generator().manual_seed(s)).numpy()
            assert sel.shape == (num_ref,) and sel[0] == 0
            assert len(set(sel.tolist())) == num_ref
            assert (sel[1:] >= 1).all() and (sel < ti).all()
    gen = torch.Generator().manual_seed(0)
    picks = {int(v) for _ in range(64) for v in TR.select_ref_frames(6, 3, gen)[1:]}
    assert picks == {1, 2, 3, 4, 5}


def test_sequence_loss_and_grads_cap_not_binding(setup):
    """rng=None (every frame deep-updates): the loss and every leaf's
    gradient against JAX; with T - 1 <= num_ref_frames the capped rollout
    is the full one, bit for bit (tests/test_parallel_train.py:138-148)."""
    batch = _port_batch(setup["batch"])
    loss, grads = _port_grads(_model(setup), batch)
    jloss, jgrads = setup["grad_none"](setup["params"], setup["batch"])
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    _hold_grads(grads, jgrads)
    with torch.no_grad():
        model = _model(setup)
        full = TR.sequence_loss(model, batch, 0, **STEP_KW)[0]
        capped = TR.sequence_loss(model, batch, 0, num_ref_frames=2, **STEP_KW)[0]
    assert torch.equal(full, capped)


def test_sequence_loss_and_grads_cap_binding(setup):
    """T=4 with num_ref_frames=2: frame 3 reads a random subset of the
    memory. The port takes JAX's subsets and coins."""
    jkeys = jnp.stack(_rollout_keys(0, BV))
    jloss, jgrads = setup["grad_cap"](setup["params"], setup["cap_batch"], jkeys)
    rollout = _jax_rollout(0, BV, CAP_T, CAP_REF)
    assert rollout.deep_update[:, 1:CAP_T - 1].any()  # both branches of the coin
    assert not rollout.deep_update[:, 1:CAP_T - 1].all()
    loss, grads = _port_grads(_model(setup), _port_batch(setup["cap_batch"]),
                              num_ref_frames=CAP_REF, rollout=rollout)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    _hold_grads(grads, jgrads)


def _np_params(state) -> dict:
    return {k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()}


def _jax_dict(tree) -> dict:
    return N.jax_state_dict(jax.tree.map(np.asarray, tree))


def _steps_held(setup, state, jstate, n):
    """``n`` train steps of the port and of JAX from the same point, each
    update (param - param before the step) held to JAX's on every element
    of every leaf, batch-norm statistics included: within ``STEP_TOL`` of a
    step, except where JAX's first moment after the step is rounding noise
    (below ``FLIP_SHARE`` of its leaf's rms), where the step may go the
    other way. At the end every leaf is held at rtol 1e-4 / atol 1e-5 but
    for those elements. Returns both states and both loss lists."""
    batch = _port_batch(setup["batch"])
    before, jbefore = _np_params(state), _jax_dict(jstate.params)
    flipped = {k: np.zeros(v.shape, bool) for k, v in jbefore.items()}
    losses, jlosses = [], []
    for _ in range(n):
        lr = state.spec.lr_at(state.it)
        state, [loss] = _port_steps(state, batch, 1)
        jstate, [jloss] = _jax_steps(setup, jstate, 1)
        losses.append(loss)
        jlosses.append(jloss)
        got, want = _np_params(state), _jax_dict(jstate.params)
        mu = _jax_dict(jstate.opt_state[0].mu)
        for k in want:
            err = np.abs((got[k].astype(np.float64) - before[k]) - (want[k] - jbefore[k]))
            rms = np.sqrt(np.mean(np.square(mu[k], dtype=np.float64)))
            off = err > STEP_TOL * lr
            noise = np.abs(mu[k]) < FLIP_SHARE * rms
            assert not (off & ~noise).any(), (k, int((off & ~noise).sum()), float(err.max() / lr))
            flipped[k] |= off
        before, jbefore = got, want
    for k in jbefore:
        err = np.abs(before[k] - jbefore[k])
        assert (flipped[k] | (err <= 1e-5 + 1e-4 * np.abs(jbefore[k]))).all(), k
    return state, jstate, losses, jlosses


def _jax_steps(setup, state, n):
    losses = []
    for _ in range(n):
        state, out = setup["jstep"](state, setup["batch"])
        losses.append(float(out["loss"]))
    return state, losses


def _port_steps(state, batch, n):
    losses = []
    for _ in range(n):
        rollout = _jax_rollout(state.it, BV, T, 0)
        state, out = TR.train_step(state, batch, rollout=rollout, **STEP_KW)
        losses.append(float(out["loss"]))
    return state, losses


def test_train_leaves_are_the_jax_tree():
    """The trainable leaves are the JAX parameter tree's, one for one:
    batch-norm running statistics included, ``num_batches_tracked`` not."""
    jcfg = JXMemConfig(key_dim=16, value_dim=32, hidden_dim=8)
    shapes = jax.eval_shape(lambda: JN.init_params(jax.random.PRNGKey(0), jcfg))
    want = N.jax_state_dict(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    leaves = TR.train_leaves(N.XMem(XMemConfig(key_dim=16, value_dim=32, hidden_dim=8), device="cpu"))
    assert len(leaves) == len(jax.tree.leaves(shapes)) == len(want)
    assert {n: tuple(t.shape) for n, t in leaves} == {k: v.shape for k, v in want.items()}
    assert all(t.requires_grad for _, t in leaves)
    assert any(n.endswith("running_var") for n, _ in leaves)


def test_adamw_update_matches_optax():
    """The same gradients through optax's adamw (a decay boundary at update
    1) and the port's AdamW: every leaf after three updates, the moments
    and the count."""
    rs = np.random.RandomState(4)
    shapes = {"w": (3, 3, 4, 8), "b": (8,), "mean": (8,)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rs.randn(*s) * 10.0 ** rs.randint(-9, 1, s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    opt = JTR.make_optimizer(lr=3e-4, steps=(1,))
    jp, js = params, opt.init(params)
    for g in grads:
        upd, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)

    leaves = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in params.items()}
    spec = TR.make_optimizer(lr=3e-4, steps=(1,))
    state = TR.TrainState(None, torch.optim.AdamW(list(leaves.values()), betas=TR.BETAS,
                                                  eps=TR.EPS), spec)
    for g in grads:
        for k, t in leaves.items():
            t.grad = torch.from_numpy(g[k])
        TR.apply_update(state)
    assert state.it == 3
    adam = js[0]
    for k, t in leaves.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-9)
        st = state.optimizer.state[t]
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(adam.mu[k]), rtol=1e-6)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(adam.nu[k]), rtol=1e-6)
        assert float(st["step"]) == int(adam.count) == 3


def test_two_adamw_steps_match_jax(setup):
    """Two train steps of the port against ``TR.train_step``: the losses,
    and every leaf's updates, batch-norm mean and var included."""
    jstate = JTR.init_train_state(setup["params"], setup["opt"])
    state = TR.init_train_state(_model(setup), TR.make_optimizer(lr=LR))
    state, jstate, losses, jlosses = _steps_held(setup, state, jstate, 2)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert state.it == int(jstate.it) == 2
    moved = {k for k, v in state.model.state_dict().items()
             if k.endswith("running_mean")
             and not np.array_equal(v.numpy(), N.jax_state_dict(setup["np_params"])[k])}
    assert moved  # the statistics are trained, as in JAX


@pytest.mark.parametrize("boundary", [1, 2, 5])
def test_lr_schedule_boundary_matches_optax(boundary):
    """Update k (from 0) runs at optax's piecewise-constant lr: decayed
    from k == boundary on, in float32."""
    spec = TR.make_optimizer(lr=3e-4, steps=(boundary, boundary + 3), gamma=0.1)
    sched = optax.piecewise_constant_schedule(3e-4, {boundary: 0.1, boundary + 3: 0.1})
    for k in (boundary - 1, boundary, boundary + 1, boundary + 3, boundary + 4):
        assert spec.lr_at(k) == float(sched(k)), k


def test_checkpoint_roundtrip(setup, tmp_path):
    """A port checkpoint restores the model, AdamW's state and the
    iteration: the next step is the same from either."""
    batch = _port_batch(setup["batch"])
    spec = TR.make_optimizer(lr=LR)
    state, _ = _port_steps(TR.init_train_state(_model(setup), spec), batch, 1)
    path = str(tmp_path / "ckpt.pt")
    TR.save_checkpoint(path, state)
    restored = TR.load_checkpoint(path, setup["cfg"], spec, "cpu")
    assert restored.it == 1
    a, la = _port_steps(state, batch, 1)
    b, lb = _port_steps(restored, batch, 1)
    assert la == lb
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k


def test_load_jax_train_state_continues_the_run(setup, tmp_path):
    """A JAX trainer pickle after one step, read into the port, takes the
    same second step as JAX: its moments and count carry across."""
    jstate, _ = _jax_steps(setup, JTR.init_train_state(setup["params"], setup["opt"]), 1)
    path = str(tmp_path / "ckpt.pkl")
    JTR.save_checkpoint(path, jstate)
    state = TR.load_jax_train_state(read_trainer_pickle(path), setup["cfg"],
                                    TR.make_optimizer(lr=LR), "cpu")
    assert state.it == 1
    leaf = state.optimizer.param_groups[0]["params"][0]
    assert float(state.optimizer.state[leaf]["step"]) == 1.0
    state, jstate, losses, jlosses = _steps_held(setup, state, jstate, 1)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)

    # the app's --resume takes the pickle too, and goes on from its iteration
    from d3fields_tpu_torch.apps import train_xmem

    out = str(tmp_path / "run")
    assert train_xmem.main(["--synthetic", "--resume", path, "--steps", "2", "--batch", "1",
                            "--size", "32", "32", "--key_dim", "16", "--value_dim", "32",
                            "--hidden_dim", "8", "--out", out], device="cpu") == 0
    assert torch.load(out + "/ckpt_final.pt", weights_only=True)["it"] == 2

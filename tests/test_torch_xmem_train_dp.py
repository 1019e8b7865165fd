"""Port parity: data-parallel XMem training (``trainer.train_step(...,
group=)`` and ``apps/train_xmem.py --dp N``) against the JAX dp step.

The JAX reference is ``_train_step`` on a 2-device CPU mesh, its state
replicated and a global batch of 4 laid over the ``dp`` axis
(``shard_leading``/``replicate``, as tests/test_parallel_train.py:217-238
does). The port runs 2 ranks over gloo, each in its own process under a
time limit and killed after, each holding 2 rows of the global batch. The
model is tests/test_torch_xmem_train.py's (``XMemConfig(key_dim=16,
value_dim=32, hidden_dim=8)``, JAX ``init_params(PRNGKey(0))``); the clip
has 4 frames with ``num_ref_frames=2``, so frame 3 reads a drawn subset of
the memory, and every rank is given its rows of JAX's draws for the global
batch. Each step of a reference starts from the state the ranks reached.
Tolerances: every leaf's update by that file's rule (within ``STEP_TOL``
of a step of the reference's except where its first moment is below
``FLIP_SHARE`` of its leaf's rms; elsewhere every leaf at rtol 1e-4 / atol
1e-5, tests/test_parallel_train.py:236-238), batch-norm statistics
included, against JAX and against the port's one-process step on the
global batch; the loss at rtol 1e-5 against JAX, at rtol 1e-4 / atol 1e-5
against the one-process step; the two ranks bit for bit. The JAX step
compiles once, for both steps.
"""

import hashlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_xmem_train import FLIP_SHARE, STEP_TOL, _jax_rollout

from d3fields_tpu.config import XMemConfig as JXMemConfig
from d3fields_tpu.models.xmem import network as JN
from d3fields_tpu.models.xmem import trainer as JTR
from d3fields_tpu.parallel import mesh as jmesh
from d3fields_tpu_torch.config import XMemConfig
from d3fields_tpu_torch.models.xmem import network as N
from d3fields_tpu_torch.models.xmem import trainer as TR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = dict(key_dim=16, value_dim=32, hidden_dim=8)
WORLD, NB, T, O, H, W = 2, 4, 4, 2, 32, 32  # NB: the global batch
NUM_REF = 2
LR = 1e-5
STEPS = 2
STEP_KW = dict(start_warm=20000, end_warm=70000)
RANK_LIMIT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per pytest-xdist worker: the workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RANK_SCRIPT = r"""
import hashlib
import os
import sys
import numpy as np
import torch
from d3fields_tpu_torch.config import XMemConfig
from d3fields_tpu_torch.models.xmem import network as N
from d3fields_tpu_torch.models.xmem import trainer as TR
from d3fields_tpu_torch.parallel import broadcast_tensors, initialize_distributed, ops

addr, rank, data, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
assert initialize_distributed(addr, 2, rank, device="cpu")
d = torch.load(data, weights_only=True)
nb = d["nb"] // 2
rows = slice(rank * nb, (rank + 1) * nb)
batch = {k: v[rows] for k, v in d["batch"].items()}
kw = dict(num_ref_frames=d["num_ref"], start_warm=20000, end_warm=70000)


def fresh():
    model = N.XMem(XMemConfig(**d["widths"]), device="cpu")
    model.load_state_dict(d["model"])
    return TR.init_train_state(model.eval(), TR.make_optimizer(lr=d["lr"]))


def flat(state):
    return torch.cat([t.detach().reshape(-1) for _, t in TR.train_leaves(state.model)]).clone()


def moments(state):
    st = [state.optimizer.state[t] for _, t in TR.train_leaves(state.model)]
    return {k: torch.cat([s[k].reshape(-1) for s in st]) for k in ("exp_avg", "exp_avg_sq")}


res = {}
# the gradients each rank brings to the first average, and the average
state = fresh()
names = {id(t): n for n, t in TR.train_leaves(state.model)}
average = ops.average_gradients


def spy(leaves, group=None):
    if "local_bn" not in res:
        bn = [t for t in leaves if names[id(t)].endswith(("running_mean", "running_var"))]
        res["local_bn"] = {names[id(t)]: t.grad.clone() for t in bn}
        average(leaves, group)
        res["averaged_bn"] = {names[id(t)]: t.grad.clone() for t in bn}
    else:
        average(leaves, group)


ops.average_gradients = spy
res["jax_rollout"] = {"params": [], "moments": [], "loss": []}
for it in range(len(d["rollouts"])):
    r = d["rollouts"][it]
    rollout = TR.Rollout({ti: v[rows] for ti, v in r["ref_frames"].items()},
                         r["deep_update"][rows])
    state, o = TR.train_step(state, batch, rollout=rollout, **kw)
    res["jax_rollout"]["params"].append(flat(state))
    if it + 1 < len(d["rollouts"]):  # where the references take the next step from
        res["jax_rollout"]["moments"].append(moments(state))
    res["jax_rollout"]["loss"].append(float(o["loss"]))
ops.average_gradients = average
# the step's own draws: the global batch's, cut to this rank's rows ...
state, o = TR.train_step(fresh(), batch, **kw)
res["drawn"] = {"params": flat(state), "loss": float(o["loss"])}
# ... and, as a control, draws for this rank's rows alone
T = batch["frames"].shape[1]
own = TR.draw_rollout(torch.Generator().manual_seed(0), nb, T, d["num_ref"])
state, o = TR.train_step(fresh(), batch, rollout=own, **kw)
res["own_draws_loss"] = float(o["loss"])
# unequal shards: rank 1 holds one row fewer
try:
    TR.train_step(fresh(), {k: v[: nb - rank] for k, v in batch.items()}, **kw)
    res["unequal_shards"] = "no error"
except ValueError as e:
    res["unequal_shards"] = str(e)
# the broadcast of rank 0's leaves over a rank whose leaves differ
state = fresh()
if rank:
    with torch.no_grad():
        for _, t in TR.train_leaves(state.model):
            t.add_(1.0)
broadcast_tensors([t for _, t in TR.train_leaves(state.model)])
res["broadcast"] = flat(state)

# a gradient one rank lacks counts as zeros there
a, b = torch.zeros(3, requires_grad=True), torch.zeros(2, 2, requires_grad=True)
a.grad = torch.full((3,), float(rank + 1))
if rank:
    b.grad = torch.full((2, 2), 4.0)
ops.average_gradients([a, b])
res["missing_grad"] = {"a": a.grad, "b": b.grad}


def digests(x):
    # rank 1 sends the digests of the whole-model vectors, which are held
    # bit-equal to rank 0's
    if isinstance(x, torch.Tensor) and x.numel() > 10 ** 6:
        return hashlib.sha256(x.numpy().tobytes()).hexdigest()
    if isinstance(x, dict):
        return {k: digests(v) for k, v in x.items()}
    if isinstance(x, list):
        return [digests(v) for v in x]
    return x


torch.save(digests(res) if rank else res, out)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
threads = [open(f"/proc/self/task/{t}/comm").read().strip() for t in os.listdir("/proc/self/task")]
assert not [t for t in threads if "gloo" in t], threads
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    """The environment of a spawned process: this checkout first, one
    thread (the ranks share the machine's cores with the other workers)."""
    return {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
            "OMP_NUM_THREADS": "1"}


def _batch(rs):
    return {
        "frames": rs.rand(NB, T, H, W, 3).astype(np.float32),
        "first_gt": (rs.rand(NB, O, H, W) > 0.5).astype(np.float32),
        "cls_gt": rs.randint(0, O + 1, (NB, T, H, W)),
        "selector": np.ones((NB, O), np.float32),
    }


def _port_dict(model) -> dict:
    return {n: t.detach().numpy().copy() for n, t in TR.train_leaves(model)}


def _unflat(vec: torch.Tensor, like: dict) -> dict:
    out, offset = {}, 0
    for k, v in like.items():
        out[k] = vec[offset:offset + v.size].reshape(v.shape).numpy()
        offset += v.size
    return out


def _jax_train_state(jcfg, opt, like, it, params, exp_avg, exp_avg_sq):
    """The JAX train state of a port state (flattened leaves and AdamW
    moments, in ``train_leaves`` order) after ``it`` updates."""
    tree = lambda v: JN.convert_torch_state_dict(_unflat(v, like), jcfg)
    p = tree(params)
    adam, empty, sched = opt.init(p)
    count = jnp.asarray(it, jnp.int32)
    return JTR.TrainState(p, (adam._replace(count=count, mu=tree(exp_avg), nu=tree(exp_avg_sq)),
                              empty, sched._replace(count=count)), count)


def _port_train_state(like, it, params, exp_avg, exp_avg_sq):
    """The port's train state of the same flattened state."""
    state = TR.init_train_state(N.XMem(XMemConfig(**WIDTHS), device="cpu").eval(),
                                TR.make_optimizer(lr=LR))
    p, mu, nu = (_unflat(v, like) for v in (params, exp_avg, exp_avg_sq))
    with torch.no_grad():
        for n, t in TR.train_leaves(state.model):
            t.copy_(torch.from_numpy(p[n]))
            if it:
                state.optimizer.state[t] = {
                    "step": torch.tensor(float(it)), "exp_avg": torch.from_numpy(mu[n].copy()),
                    "exp_avg_sq": torch.from_numpy(nu[n].copy())}
    state.it = it
    return state


def _port_step(state, batch, rollout) -> dict:
    state, out = TR.train_step(state, batch, rollout=rollout, num_ref_frames=NUM_REF, **STEP_KW)
    leaves = TR.train_leaves(state.model)
    return {"params": _port_dict(state.model), "loss": float(out["loss"]), "lr": LR,
            "mu": {n: state.optimizer.state[t]["exp_avg"].numpy().copy() for n, t in leaves}}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Both ranks' results beside the references, JAX's dp step and the
    port's one-process step on the global batch, each step of a reference
    taken from the state the ranks reached before it: the random-weight
    rollout amplifies rounding, and one step's sign flips (below) move the
    next step's gradient by more than the rule's quarter step. The ranks
    run while the parent compiles and runs the first steps."""
    tmp = tmp_path_factory.mktemp("xmem_dp")
    jcfg = JXMemConfig(**WIDTHS)
    params = JN.init_params(jax.random.PRNGKey(0), jcfg)
    model = N.load_jax_params(N.XMem(XMemConfig(**WIDTHS), device="cpu"),
                              jax.tree.map(np.asarray, params)).eval()
    before = _port_dict(model)
    batch = _batch(np.random.RandomState(5))
    tbatch = TR.to_device_batch(batch, "cpu")
    rollouts = [_jax_rollout(it, NB, T, NUM_REF) for it in range(STEPS)]
    torch.save({"batch": tbatch, "model": model.state_dict(), "widths": WIDTHS, "nb": NB,
                "num_ref": NUM_REF, "lr": LR,
                "rollouts": [{"ref_frames": r.ref_frames, "deep_update": r.deep_update}
                             for r in rollouts]}, tmp / "data.pt")
    addr = f"localhost:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, addr, str(r),
                               str(tmp / "data.pt"), str(tmp / f"rank{r}.pt")],
                              cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    try:
        # JAX's dp step: the state replicated, the batch over the mesh's dp axis
        mesh = jmesh.make_mesh(dp=WORLD, tp=1)
        opt = JTR.make_optimizer(lr=LR)
        jbatch = {k: jmesh.shard_leading(mesh, jnp.asarray(v)) for k, v in batch.items()}
        jstep = jax.jit(lambda s, b: JTR._train_step(s, b, jcfg, opt, num_ref_frames=NUM_REF,
                                                     **STEP_KW))

        def jax_step(jstate):
            jstate, out = jstep(jmesh.replicate(mesh, jstate), jbatch)
            return {"params": N.jax_state_dict(jax.tree.map(np.asarray, jstate.params)),
                    "mu": N.jax_state_dict(jax.tree.map(np.asarray, jstate.opt_state[0].mu)),
                    "loss": float(out["loss"]), "lr": LR}

        jax_steps = [jax_step(JTR.init_train_state(params, opt))]
        start = TR.init_train_state(model, TR.make_optimizer(lr=LR))
        one = [_port_step(start, tbatch, rollouts[0])]
        start = _port_train_state(before, 0, *[torch.cat([torch.from_numpy(v).reshape(-1)
                                                          for v in before.values()])] * 3)
        drawn = _port_step(start, tbatch, None)
        errs = [p.communicate(timeout=RANK_LIMIT_S)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert [p.returncode for p in procs] == [0, 0], errs
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]
    shutil.rmtree(tmp)  # 1 GB of states
    reached = ranks[0]["jax_rollout"]
    for it in range(1, STEPS):
        at = (reached["params"][it - 1], *reached["moments"][it - 1].values())
        jax_steps.append(jax_step(_jax_train_state(jcfg, opt, before, it, *at)))
        one.append(_port_step(_port_train_state(before, it, *at), tbatch, rollouts[it]))
    return dict(before=before, rollouts=rollouts, jax=jax_steps, one=one, drawn=drawn,
                ranks=ranks)


def _hold_updates(before: dict, after: dict, want: dict, ref_before: dict = None,
                  flipped: dict = None) -> dict:
    """tests/test_torch_xmem_train.py's ``_steps_held`` rule for one step,
    from ``before`` here and ``ref_before`` in the reference (the same
    point by default): the update within ``STEP_TOL`` of a step of the
    reference's on every element of every leaf, except where the
    reference's first moment after it is below ``FLIP_SHARE`` of its leaf's
    rms (Adam's first updates are +-lr whatever a gradient's size, so an
    element whose gradient is rounding noise around zero may step the other
    way); every leaf at rtol 1e-4 / atol 1e-5 but for those elements and
    the ``flipped`` ones of earlier steps. Returns the elements off by more
    than ``STEP_TOL``, with ``flipped``."""
    ref_before = before if ref_before is None else ref_before
    out = {}
    for k, ref in want["params"].items():
        err = np.abs((after[k].astype(np.float64) - before[k]) - (ref - ref_before[k]))
        mu = want["mu"][k]
        rms = np.sqrt(np.mean(np.square(mu, dtype=np.float64)))
        off = err > STEP_TOL * want["lr"]
        noise = np.abs(mu) < FLIP_SHARE * rms
        assert not (off & ~noise).any(), (k, int((off & ~noise).sum()),
                                          float(err.max() / want["lr"]))
        out[k] = off if flipped is None else off | flipped[k]
        assert (out[k] | (np.abs(after[k] - ref) <= 1e-5 + 1e-4 * np.abs(ref))).all(), k
    return out


def _same(full: torch.Tensor, digest: str) -> bool:
    """Rank 0's vector against rank 1's digest of its own."""
    return hashlib.sha256(full.numpy().tobytes()).hexdigest() == digest


def _steps(dp) -> list:
    """Rank 0's states: the start, then after each step."""
    return [dp["before"]] + [_unflat(v, dp["before"]) for v in
                             dp["ranks"][0]["jax_rollout"]["params"]]


def test_draws_bind_the_memory_cap_and_both_coin_branches(dp):
    """The setup reaches what the dp step must get right: frame 3 reads a
    drawn memory subset, and the deep-update coins of frames 1-2 take both
    values."""
    for r in dp["rollouts"]:
        assert set(r.ref_frames) == {3} and r.ref_frames[3].shape == (NB, NUM_REF)
    coins = torch.stack([r.deep_update[:, 1:T - 1] for r in dp["rollouts"]])
    assert coins.any() and not coins.all()


def test_dp_steps_match_jax_dp_mesh(dp):
    """Two ranks' two steps against JAX's ``_train_step`` on a 2-device
    mesh: every leaf's update, batch-norm statistics included, the global
    loss, and both ranks bit for bit."""
    r0, r1 = dp["ranks"]
    for a, b in zip(r0["jax_rollout"]["params"], r1["jax_rollout"]["params"]):
        assert _same(a, b)
    assert r0["jax_rollout"]["loss"] == r1["jax_rollout"]["loss"]
    steps = _steps(dp)
    for before, after, want in zip(steps, steps[1:], dp["jax"]):
        _hold_updates(before, after, want)
    np.testing.assert_allclose(r0["jax_rollout"]["loss"], [s["loss"] for s in dp["jax"]],
                               rtol=1e-5)


def test_dp_steps_match_the_one_process_step(dp):
    """The ranks' steps against the port's one-process steps on the global
    batch with the same draws: the losses at rtol 1e-4 / atol 1e-5, every
    leaf by the same rule."""
    np.testing.assert_allclose(dp["ranks"][0]["jax_rollout"]["loss"],
                               [s["loss"] for s in dp["one"]], rtol=1e-4, atol=1e-5)
    steps = _steps(dp)
    for before, after, want in zip(steps, steps[1:], dp["one"]):
        _hold_updates(before, after, want)


def test_dp_step_draws_for_the_global_batch(dp):
    """Without a rollout each rank draws the global batch's choices and
    keeps its rows: the one-process step on the global batch. A rank that
    draws for its own rows alone gives its samples other memory frames and
    coins, and another loss."""
    r0, r1 = dp["ranks"]
    assert _same(r0["drawn"]["params"], r1["drawn"]["params"])
    np.testing.assert_allclose(r0["drawn"]["loss"], dp["drawn"]["loss"], rtol=1e-5)
    _hold_updates(dp["before"], _unflat(r0["drawn"]["params"], dp["before"]), dp["drawn"])
    assert r0["own_draws_loss"] == r1["own_draws_loss"]
    assert abs(r0["own_draws_loss"] - dp["drawn"]["loss"]) > 1e-4 * abs(dp["drawn"]["loss"])


def test_dp_step_averages_the_batch_norm_statistics(dp):
    """The running statistics are leaves: the ranks bring different
    gradients of them to the average (so a missing average would show),
    and leave with their mean."""
    r0, r1 = dp["ranks"]
    assert len(r0["local_bn"]) == 116
    differ = [k for k in r0["local_bn"]
              if not torch.allclose(r0["local_bn"][k], r1["local_bn"][k], rtol=1e-3, atol=0)]
    assert len(differ) > 100, len(differ)
    for k, g0 in r0["local_bn"].items():
        mean = (g0 + r1["local_bn"][k]) / 2
        torch.testing.assert_close(r0["averaged_bn"][k], mean, rtol=1e-6, atol=0)
        assert torch.equal(r0["averaged_bn"][k], r1["averaged_bn"][k])


def test_dp_step_refuses_unequal_shards(dp):
    for r in dp["ranks"]:
        assert r["unequal_shards"].startswith("unequal batch shards over 2 ranks: 3 samples")


def test_broadcast_tensors_gives_every_rank_rank_zeros_leaves(dp):
    r0, r1 = dp["ranks"]
    assert _same(r0["broadcast"], r1["broadcast"])
    want = torch.cat([torch.from_numpy(v).reshape(-1) for v in dp["before"].values()])
    assert torch.equal(r0["broadcast"], want)


def test_average_gradients_counts_a_missing_gradient_as_zeros(dp):
    for r in dp["ranks"]:
        assert torch.equal(r["missing_grad"]["a"], torch.full((3,), 1.5))
        assert torch.equal(r["missing_grad"]["b"], torch.full((2, 2), 2.0))


# ---------------------------------------------------------------------------
# the app: train_xmem --dp N
# ---------------------------------------------------------------------------

APP_ARGS = ["--synthetic", "--steps", "2", "--batch", "2", "--num_frames", "3", "--size", "32",
            "32", "--key_dim", "16", "--value_dim", "32", "--hidden_dim", "8", "--log_every",
            "1", "--save_every", "1"]
APP_LIMIT_S = 150
APP_LR = 1e-5  # the free-form default


def _jsonl(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def _ckpt_step(path: str) -> dict:
    """A checkpoint's leaves and AdamW first moments, for ``_hold_updates``."""
    blob = torch.load(path, weights_only=True)
    names = [n for n in blob["model"] if not n.endswith("num_batches_tracked")]
    return {"it": blob["it"], "params": {n: blob["model"][n].numpy() for n in names},
            "mu": {n: s["exp_avg"].numpy()
                   for n, s in zip(names, blob["optimizer"]["state"].values())},
            "lr": APP_LR}


def test_train_xmem_dp_spawns_ranks_and_matches_one_process(tmp_path):
    """``--dp 2`` with no group spawns two gloo ranks (the app in a process
    of its own, under a limit, its process group killed after): one
    ``train.jsonl`` holding rank 0's lines alone, the global losses, and
    checkpoints equal to the ``--dp 0`` run's by the rule above after each
    step (at rtol 1e-4 / atol 1e-5 but where the ``--dp 0`` run's first
    moment is rounding noise)."""
    from d3fields_tpu_torch.apps import train_xmem

    dp_out, one_out = str(tmp_path / "dp2"), str(tmp_path / "dp0")
    code = ("from d3fields_tpu_torch.apps.train_xmem import main\n"
            f"raise SystemExit(main({APP_ARGS + ['--dp', '2', '--out', dp_out]!r}, "
            "device='cpu'))\n")
    p = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        assert train_xmem.main(APP_ARGS + ["--dp", "0", "--out", one_out], device="cpu") == 0
        stdout, stderr = p.communicate(timeout=APP_LIMIT_S)
        assert p.returncode == 0, stderr[-3000:]
        assert stdout.count("[train_xmem] done") == 1  # rank 0 alone prints
        files = ["ckpt_1.pt", "ckpt_2.pt", "ckpt_final.pt", "train.jsonl"]
        assert sorted(os.listdir(dp_out)) == files
        rows = _jsonl(os.path.join(dp_out, "train.jsonl"))
        assert [r.get("event") for r in rows].count("start") == 1
        losses = [r["loss"] for r in rows if r.get("prefix") == "train"]
        want = [r["loss"] for r in _jsonl(os.path.join(one_out, "train.jsonl"))
                if r.get("prefix") == "train"]
        assert len(losses) == len(want) == 2
        np.testing.assert_allclose(losses, want, rtol=1e-4, atol=1e-5)
        got = [_ckpt_step(os.path.join(dp_out, f)) for f in files[:2]]
        ref = [_ckpt_step(os.path.join(one_out, f)) for f in files[:2]]
        assert [g["it"] for g in got] == [r["it"] for r in ref] == [1, 2]
        start = {k: np.zeros(v.shape) for k, v in ref[0]["params"].items()}  # the same init
        flipped = _hold_updates(start, got[0]["params"], ref[0])
        _hold_updates(got[0]["params"], got[1]["params"], ref[1], ref[0]["params"], flipped)
        final = torch.load(os.path.join(dp_out, "ckpt_final.pt"), weights_only=True)["model"]
        assert all(torch.equal(final[k], torch.from_numpy(v)) for k, v in got[1]["params"].items())
    finally:
        try:
            os.killpg(p.pid, signal.SIGKILL)  # the app and the ranks it spawned
        except ProcessLookupError:
            pass
        p.wait()
        shutil.rmtree(tmp_path)  # 0.4 GB checkpoints


def test_train_xmem_dp_needs_a_divisible_batch(tmp_path):
    from d3fields_tpu_torch.apps import train_xmem

    with pytest.raises(ValueError, match="batch count 3 not divisible by mesh axis 'dp' of "
                                         "size 2"):
        train_xmem.main(APP_ARGS + ["--batch", "3", "--dp", "2", "--out", str(tmp_path)],
                        device="cpu")


def test_train_xmem_dp_refuses_a_group_of_another_size(tmp_path):
    """A process group the caller started is used as it is, and its size
    must be ``--dp``."""
    import torch.distributed as dist

    from d3fields_tpu_torch.apps import train_xmem
    from d3fields_tpu_torch.parallel import initialize_distributed

    assert initialize_distributed(f"localhost:{_free_port()}", 1, 0, device="cpu")
    try:
        with pytest.raises(ValueError, match="--dp 2 in a process group of 1 ranks"):
            train_xmem.main(APP_ARGS + ["--dp", "2", "--out", str(tmp_path)], device="cpu")
    finally:
        dist.destroy_process_group()


def test_train_xmem_dp_needs_one_gpu_a_rank(tmp_path, monkeypatch):
    """On CUDA the app spawns one rank per GPU, and with fewer visible it
    raises rather than training on fewer devices or on the CPU."""
    from d3fields_tpu_torch.apps import train_xmem

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--dp 2: 2 CUDA device"):
        train_xmem.main(APP_ARGS + ["--dp", "2", "--out", str(tmp_path)])


def test_train_xmem_rank_runs_on_the_device_its_group_made_current(monkeypatch):
    """Under an srun step over two nodes of four GPUs (no ``LOCAL_RANK``),
    rank 5 runs on ``cuda:1``, its ``SLURM_LOCALID``: the device
    ``initialize_distributed`` made current, not the group rank."""
    import torch.distributed as dist

    from d3fields_tpu_torch.apps import train_xmem
    from d3fields_tpu_torch.parallel import initialize_distributed

    for k in ("LOCAL_RANK", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in dict(SLURM_STEP_NODELIST="node[01-02]", SLURM_NTASKS="8", SLURM_PROCID="5",
                     SLURM_LOCALID="1", MASTER_ADDR="localhost", MASTER_PORT="29500").items():
        monkeypatch.setenv(k, v)
    current, started = [], {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[-1])
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: started.update(backend=backend, **kw))
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 5)
    assert initialize_distributed(device="cuda")
    assert (started["backend"], started["world_size"], started["rank"]) == ("nccl", 8, 5)
    assert train_xmem._rank_device(None) == torch.device("cuda", 1)
    assert train_xmem._rank_device("cpu") == torch.device("cpu")

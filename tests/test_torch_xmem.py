"""Port parity: XMem (blocks, network, memory, core) and the video tracker of
d3fields_tpu_torch against d3fields_tpu.

The same numpy inputs go through the JAX function and its PyTorch
counterpart on the CPU. The full-width weights are the reference's module
tree at PyTorch's default initialisation (the scale of the reference
tests/test_xmem.py oracle) with random batch-norm statistics; they reach
JAX through its own ``convert_torch_state_dict`` and come back through
``load_jax_params``. Tolerances: blocks rtol 1e-5 / atol 1e-6; the network
at tests/test_xmem.py:122-205's (key 2e-4, value and segment 2e-3); memory
readouts and buffers at 1e-5; XMemCore 1e-5 on the seed frame and 1e-4
after it (tests/test_xmem.py:519-566); the tracker's resizes 1e-5 / 1e-6.

JAX's default top-k is the bisection form, which keeps every entry tied
at the threshold; the inputs here are random floats with no ties, and the
top-k softmax itself is held to ``topk_softmax_exact``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d3fields_tpu.config import XMemConfig as JXMemConfig
from d3fields_tpu.models.xmem import blocks as JB
from d3fields_tpu.models.xmem import core as JC
from d3fields_tpu.models.xmem import memory as JM
from d3fields_tpu.models.xmem import network as JN
from d3fields_tpu.seg import video_tracker as jvt
from d3fields_tpu_torch.config import XMemConfig
from d3fields_tpu_torch.models.xmem import blocks as B
from d3fields_tpu_torch.models.xmem import core as C
from d3fields_tpu_torch.models.xmem import memory as M
from d3fields_tpu_torch.models.xmem import network as N
from d3fields_tpu_torch.seg import video_tracker as tvt

# tests/test_xmem.py:541-544's video config
CORE_KW = dict(top_k=5, mem_every=2, max_mid_term_frames=3, min_mid_term_frames=2,
               num_prototypes=4, max_long_term_elements=64)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per pytest-xdist worker: the workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def _default_init(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """PyTorch's default initialisation of every conv and linear layer and
    random batch-norm statistics, from ``seed``."""
    torch.manual_seed(seed)
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.reset_parameters()
            elif isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(_t(rs.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(_t(0.1 * rs.randn(c).astype(np.float32)))
                m.running_mean.copy_(_t(0.1 * rs.randn(c).astype(np.float32)))
                m.running_var.copy_(_t(rs.uniform(0.5, 1.5, c).astype(np.float32)))
    return model.eval()


def _jax_tree(sd_module: torch.nn.Module, prefix: str, convert):
    """A submodule's parameters through one of the JAX converters."""
    sd = {f"{prefix}.{k}": v.detach().numpy() for k, v in sd_module.state_dict().items()}
    return convert(sd, prefix)


@pytest.fixture(scope="module")
def full():
    """(port model, JAX params) at full XMemConfig() widths."""
    model = _default_init(N.XMem(XMemConfig(), device="cpu"), 0)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return model, JN.convert_torch_state_dict(sd, JXMemConfig())


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _block_case(name, rs):
    """(port output, JAX output) of one block on random inputs."""
    x = rs.randn(2, 6, 8, 16).astype(np.float32)
    if name == "upsample_2x":
        return B.upsample_2x(_nchw(x)), JB.upsample_2x(jnp.asarray(x))
    if name == "upsample_4x_logits":
        return B.upsample_4x_logits(_nchw(x)), JB.upsample_4x_logits(jnp.asarray(x))
    if name in ("avg_pool_2", "avg_pool_4"):
        k = int(name[-1])
        y = rs.randn(2, 8, 12, 4).astype(np.float32)
        return B.avg_pool(_nchw(y), k), JB.avg_pool(jnp.asarray(y), k)
    if name == "max_pool_3x3_s2":
        return B.max_pool_3x3_s2(_nchw(x)), JB.max_pool_3x3_s2(jnp.asarray(x))
    if name == "group_res_block":
        m = _default_init(B.GroupResBlock(16, 24), 1)
        return m(_nchw(x)), JB.group_res_block(jnp.asarray(x),
                                               _jax_tree(m, "b", JN._group_res_t))
    if name == "group_res_block_identity":
        m = _default_init(B.GroupResBlock(16, 16), 2)
        return m(_nchw(x)), JB.group_res_block(jnp.asarray(x),
                                               _jax_tree(m, "b", JN._group_res_t))
    if name == "cbam":
        y = rs.randn(2, 6, 8, 32).astype(np.float32)
        m = _default_init(B.CBAM(32), 3)
        return m(_nchw(y)), JB.cbam(jnp.asarray(y), _jax_tree(m, "a", JN._cbam_t))
    if name == "feature_fusion":
        g = rs.randn(2, 6, 8, 24).astype(np.float32)
        m = _default_init(B.FeatureFusionBlock(16, 24, 32, 40), 4)
        return m(_nchw(x), _nchw(g)), JB.feature_fusion(
            jnp.asarray(x), jnp.asarray(g), _jax_tree(m, "f", JN._fusion_t))
    if name == "gru_update":
        h = rs.randn(2, 6, 8, 8).astype(np.float32)
        m = _default_init(B.HiddenReinforcer(16, 8), 5)
        return m(_nchw(x), _nchw(h)), JB.gru_update(
            jnp.asarray(x), jnp.asarray(h), JN._conv_t(
                {f"t.{k}": v.numpy() for k, v in m.transform.state_dict().items()}, "t"), 8)
    if name == "hidden_updater":
        g16 = rs.randn(2, 3, 4, 512).astype(np.float32)
        g8 = rs.randn(2, 6, 8, 256).astype(np.float32)
        g4 = rs.randn(2, 12, 16, 257).astype(np.float32)
        h = rs.randn(2, 3, 4, 8).astype(np.float32)
        m = _default_init(B.HiddenUpdater(8), 6)
        p = {k: JN._conv_t({f"u.{n}.{s}": t.numpy() for s, t in
                            getattr(m, n).state_dict().items()}, f"u.{n}")
             for k, n in (("g16", "g16_conv"), ("g8", "g8_conv"), ("g4", "g4_conv"),
                          ("transform", "transform"))}
        return m(_nchw(g16), _nchw(g8), _nchw(g4), _nchw(h)), JB.hidden_updater(
            jnp.asarray(g16), jnp.asarray(g8), jnp.asarray(g4), jnp.asarray(h), p, 8)
    if name == "upsample_block":
        skip = rs.randn(2, 12, 16, 24).astype(np.float32)
        m = _default_init(B.UpsampleBlock(24, 16, 12), 7)
        p = {"skip": JN._conv_t({f"s.{k}": v.numpy() for k, v in
                                 m.skip_conv.state_dict().items()}, "s"),
             "out": _jax_tree(m.out_conv, "o", JN._group_res_t)}
        return m(_nchw(skip), _nchw(x)), JB.upsample_block(jnp.asarray(skip),
                                                           jnp.asarray(x), p)
    if name in ("basic_block", "bottleneck_block"):
        m = _default_init(B.BasicBlock(16, 32, 2) if name == "basic_block"
                          else B.Bottleneck(16, 8, 32, 2), 8)
        kind = "basic" if name == "basic_block" else "bottleneck"
        p = _jax_tree(torch.nn.Sequential(m), "l", lambda sd, pre: JN._res_layer_t(
            sd, pre, 1, kind))[0]
        fn = JB.basic_block if kind == "basic" else JB.bottleneck_block
        return m(_nchw(x)), fn(jnp.asarray(x), p, stride=2)
    if name == "soft_aggregate":
        prob = rs.rand(3, 2, 8, 8).astype(np.float32)
        return (B.soft_aggregate(_t(prob), dim=1),
                jnp.stack([JB.soft_aggregate(jnp.asarray(p), axis=0) for p in prob])
                .transpose(0, 2, 3, 1))
    raise KeyError(name)


BLOCKS = ["upsample_2x", "upsample_4x_logits", "avg_pool_2", "avg_pool_4", "max_pool_3x3_s2",
          "group_res_block", "group_res_block_identity", "cbam", "feature_fusion",
          "gru_update", "hidden_updater", "upsample_block", "basic_block",
          "bottleneck_block", "soft_aggregate"]


@pytest.mark.parametrize("name", BLOCKS)
def test_block_matches_jax(name):
    with torch.no_grad():
        ours, ref = _block_case(name, np.random.RandomState(BLOCKS.index(name)))
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_pad_divide_by_and_unpad_match_jax():
    x = np.random.RandomState(0).randn(2, 3, 37, 50).astype(np.float32)
    ours, spec = B.pad_divide_by(_t(x), 16)
    ref, ref_spec = JB.pad_divide_by(jnp.asarray(x), 16, hw_axes=(2, 3))
    assert spec == ref_spec
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(B.unpad(ours, spec).numpy(), x)


# ---------------------------------------------------------------------------
# network
# ---------------------------------------------------------------------------

def test_state_dict_round_trips_through_the_jax_converter(full):
    """The port's names are the reference's: its state dict goes through
    JAX's convert_torch_state_dict and comes back through load_jax_params
    bit for bit; and JAX's own random parameters survive the other way."""
    model, jparams = full
    back = N.load_jax_params(N.XMem(XMemConfig(), device="cpu"),
                             jax.tree.map(np.asarray, jparams))
    own = model.state_dict()
    for k, v in back.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, own[k]), k
    jrand = jax.tree.map(np.asarray, JN.init_params(jax.random.PRNGKey(0), JXMemConfig()))
    m = N.load_jax_params(N.XMem(XMemConfig(), device="cpu"), jrand)
    again = JN.convert_torch_state_dict(
        {k: v.numpy() for k, v in m.state_dict().items()}, JXMemConfig())
    for a, b in zip(jax.tree.leaves(jrand), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_network_matches_jax(full):
    """encode_key, encode_value and segment at full widths on 48x64, two
    images in one batch."""
    model, jp = full
    rs = np.random.RandomState(3)
    O, H, W = 2, 48, 64
    img = rs.randn(2, H, W, 3).astype(np.float32)
    masks = rs.rand(2, O, H, W).astype(np.float32)
    hidden = (0.1 * rs.randn(2, O, H // 16, W // 16, 64)).astype(np.float32)
    readout = (0.1 * rs.randn(2, O, H // 16, W // 16, 512)).astype(np.float32)
    with torch.no_grad():
        tk, ts, te, tf16, tf8, tf4 = model.encode_key(_nchw(img))
        tv, th = model.encode_value(_nchw(img), tf16, _t(hidden).permute(0, 1, 4, 2, 3),
                                    _t(masks))
        sh, sl, sp = model.segment(tf16, tf8, tf4, _t(hidden).permute(0, 1, 4, 2, 3),
                                   _t(readout).permute(0, 1, 4, 2, 3))
    k, s, e, f16, f8, f4 = JN.encode_key(jp, jnp.asarray(img))
    for ours, ref in ((tk, k), (ts, s), (te, e), (tf16, f16)):
        np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=2e-4, atol=2e-4)
    for v in range(2):
        jv, jh = JN.encode_value(jp, jnp.asarray(img[v]), f16[v], jnp.asarray(hidden[v]),
                                 jnp.asarray(masks[v]))
        np.testing.assert_allclose(_nhwc(tv[v]), np.asarray(jv), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(_nhwc(th[v]), np.asarray(jh), rtol=2e-3, atol=2e-3)
        jh2, jl, jprob = JN.segment(jp, f16[v], f8[v], f4[v], jnp.asarray(hidden[v]),
                                    jnp.asarray(readout[v]))
        np.testing.assert_allclose(sp[v].numpy(), np.asarray(jprob), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(sl[v].numpy(), np.asarray(jl), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(_nhwc(sh[v]), np.asarray(jh2), rtol=2e-3, atol=2e-3)


def test_init_params_keeps_activations_finite():
    """Random weights of init_params (JAX's distributions) at full width."""
    model = N.init_params(XMemConfig(), torch.Generator().manual_seed(0), device="cpu")
    img = _t(np.random.RandomState(0).randn(1, 3, 96, 128).astype(np.float32))
    with torch.no_grad():
        k, s, e, f16, f8, f4 = model.encode_key(img)
        v, h = model.encode_value(img, f16, torch.zeros(1, 2, 64, 6, 8),
                                  torch.rand(1, 2, 96, 128, generator=torch.Generator()))
        _, _, prob = model.segment(f16, f8, f4, h, v)
    for x in (k, s, e, v, h, prob):
        assert torch.isfinite(x).all()
    np.testing.assert_allclose(prob.sum(1).numpy(), 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------

def _masked_sim():
    """tests/test_xmem.py:208-225's input: an invalid tail and a column with
    fewer than k valid entries."""
    rs = np.random.RandomState(7)
    sim = (5.0 * rs.randn(500, 37)).astype(np.float32)
    sim[200:, :] = -1e30
    sim[25:200, -1] = -1e30
    return sim


def test_topk_softmax_matches_exact_form():
    sim = _masked_sim()
    aff, usage = M.topk_softmax(_t(sim), 30, return_usage=True)
    ref, ref_usage = JM.topk_softmax_exact(jnp.asarray(sim), 30, return_usage=True)
    np.testing.assert_allclose(aff.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(usage.numpy(), np.asarray(ref_usage), rtol=1e-6, atol=1e-6)
    nnz = (aff.numpy() > 0).sum(axis=0)
    assert (nnz[:-1] == 30).all() and nnz[-1] == 25  # masked slots weigh exactly 0


@pytest.mark.parametrize("with_sel", [True, False])
def test_similarity_matches_jax(with_sel):
    rs = np.random.RandomState(6)
    mk, qk = rs.randn(2, 8, 40).astype(np.float32), rs.randn(2, 8, 12).astype(np.float32)
    ms = (rs.rand(2, 40) + 1.0).astype(np.float32)
    qe = rs.rand(2, 8, 12).astype(np.float32)
    ours = M.similarity(_t(mk), _t(ms) if with_sel else None, _t(qk),
                        _t(qe) if with_sel else None)
    for v in range(2):
        ref = JM.similarity(jnp.asarray(mk[v]), jnp.asarray(ms[v]) if with_sel else None,
                            jnp.asarray(qk[v]), jnp.asarray(qe[v]) if with_sel else None)
        np.testing.assert_allclose(ours[v].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _mem_cfg(long_term=True, max_lt=24):
    return dict(key_dim=8, value_dim=10, hidden_dim=4, max_mid_term_frames=3,
                min_mid_term_frames=1, num_prototypes=4, max_long_term_elements=max_lt,
                top_k=3, enable_long_term=long_term)


def _assert_memory_equal(ours: M.XMemMemory, ref, msg=""):
    """Sizes equal, and the filled part of every store at 1e-5 (view 0)."""
    assert ours.w_size == int(ref.w_size) and ours.l_size == int(ref.l_size), msg
    w, l = ours.w_size, ours.l_size
    for name, n in (("wk", w), ("ws", w), ("we", w), ("wv", w), ("w_use", w), ("w_life", w),
                    ("lk", l), ("ls", l), ("lv", l), ("l_use", l), ("l_life", l)):
        np.testing.assert_allclose(getattr(ours, name)[0][..., :n].numpy(),
                                   np.asarray(getattr(ref, name))[..., :n],
                                   rtol=1e-5, atol=1e-5, err_msg=f"{name} {msg}")


@pytest.mark.parametrize("steps, long_term, max_lt", [
    (9, True, 64),    # consolidations
    (16, True, 12),   # consolidations and long-term evictions
    (7, False, 24),   # no long-term memory: FIFO drops past capacity
])
def test_add_and_match_memory_match_jax(steps, long_term, max_lt):
    cfg = _mem_cfg(long_term, max_lt)
    ck, cv, O, hw = 8, 10, 2, 6
    jmem = JM.init_memory(JXMemConfig(**cfg), O, (2, 3))
    mem = M.init_memory(XMemConfig(**cfg), 1, O, (2, 3), device="cpu")
    rs = np.random.RandomState(steps)
    for t in range(steps):
        k, s = rs.randn(ck, hw).astype(np.float32), (rs.rand(hw) + 1).astype(np.float32)
        v, e = rs.randn(O, cv, hw).astype(np.float32), rs.rand(ck, hw).astype(np.float32)
        jmem = JM.add_memory(jmem, *(jnp.asarray(a) for a in (k, s, v, e)))
        M.add_memory(mem, *(_t(a)[None] for a in (k, s, v, e)))
        qk, qe = rs.randn(ck, hw).astype(np.float32), rs.rand(ck, hw).astype(np.float32)
        ref, jmem = JM.match_memory(jmem, jnp.asarray(qk), jnp.asarray(qe))
        ours = M.match_memory(mem, _t(qk)[None], _t(qe)[None])
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5,
                                   err_msg=f"readout at t={t}")
        _assert_memory_equal(mem, jmem, f"t={t}")
    assert (mem.l_size > 0) == long_term


def test_usage_ties_pick_the_lowest_index():
    """Consolidation's prototype pick and the long-term eviction on usages
    that tie (no match between adds: every usage is 0), as lax.top_k breaks
    ties; torch.topk promises no order on ties."""
    cfg = _mem_cfg(True, 12)
    ck, cv, O, hw = 8, 10, 2, 6
    jmem = JM.init_memory(JXMemConfig(**cfg), O, (2, 3))
    mem = M.init_memory(XMemConfig(**cfg), 1, O, (2, 3), device="cpu")
    rs = np.random.RandomState(0)
    for t in range(12):  # 5 consolidations at 4 prototypes into 12 slots: evictions
        k, s = rs.randn(ck, hw).astype(np.float32), (rs.rand(hw) + 1).astype(np.float32)
        v, e = rs.randn(O, cv, hw).astype(np.float32), rs.rand(ck, hw).astype(np.float32)
        jmem = JM.add_memory(jmem, *(jnp.asarray(a) for a in (k, s, v, e)))
        M.add_memory(mem, *(_t(a)[None] for a in (k, s, v, e)))
        _assert_memory_equal(mem, jmem, f"t={t}")
    assert float(mem.l_use.abs().max()) == 0.0 and mem.l_size == 12
    x = np.array([[0.0, 2.0, 0.0, 2.0, 1.0, 0.0, 2.0]], np.float32)
    np.testing.assert_array_equal(M._topk_lowest_index(_t(x), 5).numpy(),
                                  np.asarray(jax.lax.top_k(jnp.asarray(x), 5)[1]))


def test_multi_group_memory_matches_jax():
    """Mid-video entry with long-term memory: per-object visibility through
    consolidation and eviction (tests/test_xmem.py:919-983's scenario), the
    readouts, the usage and the visibility bits against JAX."""
    cfg = _mem_cfg(True, 12)
    ck, cv, O, hw = 8, 10, 2, 6
    jmem = JM.activate_objects(JM.init_memory(JXMemConfig(**cfg), O, (2, 3), multi_group=True),
                               jnp.asarray([True, False]))
    mem = M.init_memory(XMemConfig(**cfg), 1, O, (2, 3), multi_group=True, device="cpu")
    M.activate_objects(mem, torch.tensor([True, False]))
    rs = np.random.RandomState(13)
    saw_mixed = False
    for t in range(14):
        k, s = rs.randn(ck, hw).astype(np.float32), (rs.rand(hw) + 1).astype(np.float32)
        v, e = rs.randn(O, cv, hw).astype(np.float32), rs.rand(ck, hw).astype(np.float32)
        if t == 4:
            jmem = JM.activate_objects(jmem, jnp.asarray([True, True]))
            M.activate_objects(mem, torch.tensor([True, True]))
        jmem = JM.add_memory(jmem, *(jnp.asarray(a) for a in (k, s, v, e)))
        M.add_memory(mem, *(_t(a)[None] for a in (k, s, v, e)))
        qk, qe = rs.randn(ck, hw).astype(np.float32), rs.rand(ck, hw).astype(np.float32)
        ref, jmem = JM.match_memory(jmem, jnp.asarray(qk), jnp.asarray(qe))
        ours = M.match_memory(mem, _t(qk)[None], _t(qe)[None])
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5,
                                   err_msg=f"readout at t={t}")
        _assert_memory_equal(mem, jmem, f"t={t}")
        np.testing.assert_array_equal(mem.w_entry[0].numpy(), np.asarray(jmem.w_entry))
        ls = mem.l_size
        np.testing.assert_array_equal(mem.l_vis[0, :, :ls].numpy(),
                                      np.asarray(jmem.l_vis)[:, :ls])
        lv = mem.l_vis[0, 1, :ls]
        saw_mixed |= bool(lv.any()) and not bool(lv.all())
    assert saw_mixed, "the late object never saw part of the long-term memory"


# ---------------------------------------------------------------------------
# core
# ---------------------------------------------------------------------------

def _core_video(rs, T, V, O, H=48, W=64):
    return rs.rand(T, V, H, W, 3).astype(np.float32), \
        (rs.rand(V, O, H, W) > 0.6).astype(np.float32)


@pytest.mark.parametrize("case", ["sync", "deep_update_every_3"])
def test_core_matches_jax_frame_by_frame(full, case):
    """tests/test_xmem.py:519-566's video over 2 views at full widths: 7
    frames crossing two consolidations (8 frames and an explicit deep-update
    schedule for the second case)."""
    model, jp = full
    kw = dict(CORE_KW, **({"deep_update_every": 3} if case != "sync" else {}))
    T, V, O = (7, 2, 2) if case == "sync" else (8, 1, 2)
    core_j = JC.XMemCore(jp, JXMemConfig(**kw), num_views=V, num_objects=O, image_hw=(48, 64))
    core = C.XMemCore(model, XMemConfig(**kw), V, O, (48, 64), device="cpu")
    video, m0 = _core_video(np.random.RandomState(9), T, V, O)
    for t in range(T):
        mask = m0 if t == 0 else None
        ref = np.asarray(core_j.step(jnp.asarray(video[t]),
                                     None if mask is None else jnp.asarray(mask)))
        ours = core.step(video[t], mask).numpy()
        np.testing.assert_allclose(ours, ref, atol=1e-5 if t == 0 else 1e-4,
                                   err_msg=f"frame {t}")
        assert core.curr_ti == core_j.curr_ti and core.last_mem_ti == core_j.last_mem_ti
        assert core.mem.w_size == int(np.asarray(core_j.mem.w_size)[0])
        assert core.mem.l_size == int(np.asarray(core_j.mem.l_size)[0])
    assert core.mem.l_size == 2 * CORE_KW["num_prototypes"]  # two consolidations


def test_core_mid_video_entry_matches_jax(full):
    """Multi-group: object 3 enters at frame 3 with a mask while objects 1-2
    keep their predictions (tests/test_xmem.py:692-758's video, long-term
    memory off as there)."""
    model, jp = full
    kw = dict(top_k=5, mem_every=2, enable_long_term=False, max_mid_term_frames=8)
    core_j = JC.XMemCore(jp, JXMemConfig(**kw), num_views=1, num_objects=3, image_hw=(48, 64),
                         multi_group=True)
    core = C.XMemCore(model, XMemConfig(**kw), 1, 3, (48, 64), multi_group=True, device="cpu")
    rs = np.random.RandomState(17)
    video = rs.rand(6, 1, 48, 64, 3).astype(np.float32)
    m0 = np.concatenate([(rs.rand(1, 2, 48, 64) > 0.6), np.zeros((1, 1, 48, 64))], 1)
    m3 = np.concatenate([np.zeros((1, 2, 48, 64)), (rs.rand(1, 1, 48, 64) > 0.7)], 1)
    for t in range(6):
        mask, provided = {0: (m0, [True, True, False]),
                          3: (m3, [False, False, True])}.get(t, (None, None))
        if mask is None:
            ref, ours = core_j.step(jnp.asarray(video[t])), core.step(video[t])
        else:
            mask = mask.astype(np.float32)
            ref = core_j.step(jnp.asarray(video[t]), jnp.asarray(mask),
                              provided=np.array(provided))
            ours = core.step(video[t], mask, provided=np.array(provided))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4,
                                   err_msg=f"frame {t}")
        np.testing.assert_array_equal(core.mem.active.numpy(), np.asarray(core_j.mem.active))
        if t < 3:
            assert float(ours[0, 3].max()) < 1e-3  # the inactive slot is silent


def test_core_guards():
    with pytest.raises(ValueError, match="multiples of 16"):
        C.XMemCore(N.XMem(XMemConfig(), device="cpu"), XMemConfig(), 1, 1, (40, 64),
                   device="cpu")
    with pytest.raises(NotImplementedError, match="float32"):
        C.XMemCore(N.XMem(XMemConfig(), device="cpu"),
                   XMemConfig(compute_dtype="bfloat16"), 1, 1, (48, 64), device="cpu")
    with pytest.raises(ValueError, match="max_mid_term_frames >= 2"):
        M.init_memory(XMemConfig(enable_long_term=False, max_mid_term_frames=1), 1, 1, (2, 2),
                      device="cpu")
    if not torch.cuda.is_available():
        model = N.XMem(XMemConfig(), device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            C.XMemCore(model, XMemConfig(), 1, 1, (48, 64))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tvt.VideoMaskTracker(model, XMemConfig(), 1, 1, (48, 64))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            N.XMem(XMemConfig())


# ---------------------------------------------------------------------------
# video tracker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("in_hw, size", [((60, 80), 48), ((240, 320), 480), ((60, 40), 20)])
def test_prep_frames_matches_jax(in_hw, size):
    rs = np.random.RandomState(0)
    rgb = rs.randint(0, 255, (2,) + in_hw + (3,)).astype(np.uint8)
    rh, rw = tvt._resize_min_side(in_hw, size)
    assert (rh, rw) == jvt._resize_min_side(in_hw, size)
    ph, pw = -(-rh // 16) * 16, -(-rw // 16) * 16
    pad = ((ph - rh) // 2, ph - rh - (ph - rh) // 2, (pw - rw) // 2, pw - rw - (pw - rw) // 2)
    for frames in (rgb, rgb.astype(np.float32) / 255.0):
        ours = tvt.prep_frames(_t(frames), (rh, rw), pad)
        ref = jvt.prep_frames(frames, (rh, rw), pad)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("grid_hw, out_hw, pad", [
    ((48, 64), (30, 40), (0, 0, 0, 0)),    # a downscale: antialiasing matters
    ((480, 640), (240, 320), (0, 0, 0, 0)),  # the d3fields shape
    ((48, 64), (60, 80), (3, 5, 0, 0)),    # unpad, then an upscale
])
def test_upsample_probs_matches_jax(grid_hw, out_hw, pad):
    prob = np.random.RandomState(1).rand(2, 3, *grid_hw).astype(np.float32)
    ours = tvt.upsample_probs(_t(prob), pad, out_hw)
    ref = jvt.upsample_probs(jnp.asarray(prob), pad, out_hw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def tiny_xmem(seed=1):
    """(port model, JAX params, XMemConfig kwargs) of a narrow XMem for the
    tracker, facade and serving tests (the trunks keep their widths). The
    prediction head is scaled by 10: at the default initialisation every
    object's logit sits near 0, every pixel is a near-tie of the objects,
    and no label is decided by the computation."""
    kw = dict(key_dim=8, value_dim=16, hidden_dim=8, top_k=64, mem_every=2,
              max_mid_term_frames=3, min_mid_term_frames=1, num_prototypes=4,
              max_long_term_elements=64)
    model = _default_init(N.XMem(XMemConfig(**kw), device="cpu"), seed)
    with torch.no_grad():
        model.decoder.pred.weight.mul_(10.0)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return model, JN.convert_torch_state_dict(sd, JXMemConfig(**kw)), kw


def test_video_tracker_matches_jax():
    """process (one-hot and return_index) over a seed and 3 propagation
    frames, the soft probabilities, and clear_memory."""
    model, jp, kw = tiny_xmem()
    V, O, H, W = 2, 2, 60, 80
    jt = jvt.VideoMaskTracker(jp, JXMemConfig(**kw), V, O, (H, W), size=48)
    tt = tvt.VideoMaskTracker(model, XMemConfig(**kw), V, O, (H, W), size=48, device="cpu")
    rs = np.random.RandomState(1)
    mask = np.zeros((V, H, W), np.uint8)
    mask[:, 10:30, 10:40] = 1
    mask[:, 35:55, 45:75] = 2
    frames = rs.randint(0, 255, (4, V, H, W, 3)).astype(np.uint8)
    def off_the_knife_edge():
        """Pixels whose top two JAX probabilities are further apart than
        twice the probability tolerance: their labels must agree."""
        top2 = np.sort(np.asarray(jt.last_prob), axis=1)[:, -2:]
        return top2[:, 1] - top2[:, 0] > 2e-4

    for t in range(4):
        m = mask if t == 0 else None
        ref, ours = jt.process(frames[t], m), tt.process(frames[t], m)
        assert ours.shape == (V, H, W, O + 1) and ours.dtype == np.float32
        np.testing.assert_allclose(tt.last_prob.numpy(), np.asarray(jt.last_prob), atol=1e-4)
        sure = off_the_knife_edge()
        assert sure.mean() > 0.99
        np.testing.assert_array_equal(ours.argmax(-1)[sure], ref.argmax(-1)[sure])
        np.testing.assert_array_equal(ours.sum(-1), 1.0)
    idx, ref_idx = (tr.process(frames[1], return_index=True) for tr in (tt, jt))
    assert idx.dtype == np.uint8 and idx.shape == (V, H, W)
    np.testing.assert_array_equal(idx, tt.last_prob.argmax(1).numpy())
    sure = off_the_knife_edge()
    np.testing.assert_array_equal(idx[sure], ref_idx[sure])
    tt.clear_memory()
    assert not tt.first_mask_loaded and tt.core.curr_ti == -1 and tt.core.mem.w_size == 0
    with pytest.raises(ValueError, match="No mask"):
        tt.process(frames[0])
    tt.process(frames[0], mask)
    with pytest.raises(NotImplementedError, match="multi_group"):
        tt.process(frames[1], mask)


def test_xmem_default_config_matches_the_jax_package():
    assert dataclasses.asdict(XMemConfig()) == dataclasses.asdict(JXMemConfig())

"""Port parity: GroundingDINO of d3fields_tpu_torch against d3fields_tpu.

Both packages compute from one huggingface-layout state dict (the tiny
``build_random_hf`` model, with Swin's relative-position tables made
non-zero so that they count): the port loads it natively, the JAX package
through its converter. Tolerances are tests/test_groundingdino.py's:
the deformable gather 1e-6, BERT rtol 1e-4 / atol 1e-5, the full forward's
finite logits rtol 1e-3 / atol 2e-5 and boxes rtol 1e-4 / atol 1e-5;
detections equal in class and to 1e-4 in boxes and confidence.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d3fields_tpu.models.groundingdino import bert as jbert
from d3fields_tpu.models.groundingdino import detector as jdet
from d3fields_tpu.models.groundingdino import model as jgd
from d3fields_tpu.models.groundingdino.gather_pallas import (
    concat_corner_tables, deformable_gather_pallas)
from d3fields_tpu_torch.models.groundingdino import bert as tbert
from d3fields_tpu_torch.models.groundingdino import deform_gather as tdg
from d3fields_tpu_torch.models.groundingdino import detector as tdet
from d3fields_tpu_torch.models.groundingdino import model as tgd

IDS = np.array([[101, 10, 11, 1012, 12, 13, 1012, 102]], np.int64)


def toy_tokenizer(text):
    # crc32, not hash(): str hashes are salted per process
    return [200 + zlib.crc32(w.encode()) % 1000 for w in text.split()]


@pytest.fixture(scope="module")
def oracle():
    cfg = jgd.GroundingDinoConfig.tiny_test()
    hf = jgd.build_random_hf(cfg, seed=0)
    rs = np.random.RandomState(3)
    sd = {}
    for k, v in hf.state_dict().items():
        v = v.detach().clone()
        if k.endswith("relative_position_bias_table"):
            v += torch.as_tensor(rs.standard_normal(tuple(v.shape)).astype(np.float32))
        sd[k] = v
    jparams = jgd.convert_hf_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    port = tgd.GroundingDino(tgd.GroundingDinoConfig.tiny_test(), device="cpu")
    port.load_state_dict(sd, strict=True)
    return sd, jparams, port.eval(), cfg


def _gather_case(B, levels, nh, hd, P, Q, loc_range, seed, nan_share=0.0):
    rs = np.random.RandomState(seed)
    S = sum(h * w for h, w in levels)
    value = rs.randn(B, S, nh, hd).astype(np.float32)
    loc = rs.uniform(*loc_range, (B, Q, nh, len(levels), P, 2)).astype(np.float32)
    loc[rs.uniform(size=loc.shape) < nan_share] = np.nan
    wgt = rs.rand(B, Q, nh, len(levels), P).astype(np.float32)
    return value, loc, wgt / wgt.sum(axis=(-2, -1), keepdims=True)


# the shapes the kernel's routes branch on (csrc/deform_gather.cu): corner
# rows of hd/4 float4 lanes, or of hd floats when hd % 4 != 0; rounds of 32
# samples; NaN positions (NaN rows, on the CPU, on the card and in JAX)
GATHER_CASES = {
    # tests/test_groundingdino.py:465-473: samples out of bounds, padded query tail
    "edge": (2, ((13, 17), (7, 9), (4, 5)), 4, 8, 4, 333, (-0.2, 1.2), 0.0),
    # hd not a multiple of 4, one level, samples far outside [0, 1]
    "odd_hd": (1, ((11, 6),), 3, 6, 3, 40, (-3.0, 4.0), 0.0),
    # 3 lanes per corner row: 10 lane groups and 2 idle lanes
    "hd12": (1, ((9, 11), (5, 6)), 4, 12, 4, 40, (-0.2, 1.2), 0.0),
    # the detector's heads and width at a small map
    "hd32_nh8": (1, ((9, 11), (5, 6), (3, 3)), 8, 32, 4, 24, (-0.2, 1.2), 0.0),
    # L*P = 48 > 32 lanes: two rounds of the index phase
    "lp48": (1, ((9, 11), (5, 6), (3, 3)), 2, 8, 16, 24, (-0.2, 1.2), 0.0),
    # NaN positions and samples far outside [0, 1]
    "nan": (1, ((9, 11), (5, 6)), 2, 8, 4, 40, (-3.0, 4.0), 0.05),
}


@pytest.mark.parametrize("B, levels, nh, hd, P, Q, loc_range, nan_share",
                         list(GATHER_CASES.values()), ids=list(GATHER_CASES))
def test_deform_gather_matches_jax_core_and_pallas_kernel(B, levels, nh, hd, P, Q, loc_range,
                                                          nan_share):
    value, loc, wgt = _gather_case(B, levels, nh, hd, P, Q, loc_range, seed=7,
                                   nan_share=nan_share)
    got = tdg.deform_gather(torch.as_tensor(value), levels, torch.as_tensor(loc),
                            torch.as_tensor(wgt)).numpy()
    assert got.shape == (B, Q, nh * hd)
    ref = np.asarray(jgd.deformable_attention_core(jnp.asarray(value), list(levels),
                                                   jnp.asarray(loc), jnp.asarray(wgt)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    pallas = np.asarray(deformable_gather_pallas(
        concat_corner_tables(jnp.asarray(value), levels), levels, jnp.asarray(loc),
        jnp.asarray(wgt), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)


# chip_smoke.GATHER_SHAPES' "edge" (hd = 8: one 16-byte bf16 load a corner
# row) and "hd12" (8-byte loads, 3 lanes a row) for the bf16-table route
BF16_GATHER_CASES = {
    "edge": (2, ((13, 17), (7, 9), (4, 5)), 4, 8, 4, 333, (-0.2, 1.2)),
    "hd12": (2, ((13, 17), (7, 9)), 4, 12, 4, 500, (-0.2, 1.2)),
}


@pytest.mark.parametrize("case", list(BF16_GATHER_CASES))
def test_deform_gather_bf16_table_matches_pallas_kernel(case):
    """A bf16 ``value`` (the encoder under compute_dtype='bfloat16') against
    the Pallas kernel in interpret mode on corner tables that JAX builds from
    the same bf16 values; one sample position is NaN, which makes its row
    NaN in both. The inputs are exact in bf16 and both sum in f32: only the
    order of the sum differs."""
    B, levels, nh, hd, P, Q, loc_range = BF16_GATHER_CASES[case]
    value, loc, wgt = _gather_case(B, levels, nh, hd, P, Q, loc_range, seed=11)
    loc[1, 7, 2, 0, 1, 0] = np.nan
    v16 = torch.as_tensor(value).to(torch.bfloat16)
    got = tdg.deform_gather(v16, levels, torch.as_tensor(loc), torch.as_tensor(wgt))
    assert got.dtype == torch.float32 and got.shape == (B, Q, nh * hd)
    jv16 = jnp.asarray(v16.float().numpy()).astype(jnp.bfloat16)
    tables = concat_corner_tables(jv16, levels)
    assert tables.dtype == jnp.bfloat16
    pallas = np.asarray(deformable_gather_pallas(tables, levels, jnp.asarray(loc),
                                                 jnp.asarray(wgt), interpret=True))
    nan_rows = np.isnan(got.numpy()).any(-1)
    assert nan_rows.sum() == 1 and nan_rows[1, 7]
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(pallas))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-6)


def test_deform_gather_rejects_what_the_kernel_does_not_take():
    value, loc, wgt = (torch.as_tensor(a) for a in
                       _gather_case(1, ((4, 5),), 2, 4, 2, 3, (0, 1), seed=0))
    with pytest.raises(ValueError, match="do not cover"):
        tdg.deform_gather(value, ((4, 4),), loc, wgt)
    with pytest.raises(ValueError, match="do not fit"):
        tdg.deform_gather(value, ((4, 5),), loc, wgt[:, :2])
    with pytest.raises(TypeError, match="float32"):
        tdg.deform_gather(value.double(), ((4, 5),), loc, wgt)
    with pytest.raises(ValueError, match="no kernel"):
        tdg.deform_gather(value.to("meta"), ((4, 5),), loc.to("meta"), wgt.to("meta"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_deform_gather_kernel_matches_plain(cuda, case):
    B, levels, nh, hd, P, Q, loc_range, nan_share = GATHER_CASES[case]
    value, loc, wgt = (torch.as_tensor(a, device=cuda) for a in
                       _gather_case(B, levels, nh, hd, P, Q, loc_range, seed=1,
                                    nan_share=nan_share))
    before = tdg.deform_gather.launches
    out = tdg.deform_gather(value, levels, loc, wgt)
    torch.cuda.synchronize()
    assert tdg.deform_gather.launches == before + 1
    torch.testing.assert_close(out, tdg.deform_gather_plain(value, levels, loc, wgt),
                               rtol=1e-4, atol=1e-5, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_deform_gather_bf16_kernel_matches_plain(cuda, case):
    """The bf16-table route at every width it loads (hd 8 and 32: 16 bytes,
    hd 12: 8 bytes, hd 6: one element) against the plain version."""
    B, levels, nh, hd, P, Q, loc_range, nan_share = GATHER_CASES[case]
    value, loc, wgt = (torch.as_tensor(a, device=cuda) for a in
                       _gather_case(B, levels, nh, hd, P, Q, loc_range, seed=1,
                                    nan_share=nan_share))
    value = value.to(torch.bfloat16)
    before = tdg.deform_gather.launches_bf16
    out = tdg.deform_gather(value, levels, loc, wgt)
    torch.cuda.synchronize()
    assert tdg.deform_gather.launches_bf16 == before + 1
    torch.testing.assert_close(out, tdg.deform_gather_plain(value, levels, loc, wgt),
                               rtol=1e-5, atol=1e-6, equal_nan=True)


def test_bert_matches_jax():
    from transformers import BertConfig as HFBert, BertModel

    torch.manual_seed(1)
    hf = BertModel(HFBert(vocab_size=200, hidden_size=16, num_hidden_layers=2,
                          num_attention_heads=2, intermediate_size=32,
                          max_position_embeddings=32), add_pooling_layer=False).eval()
    cfg = dict(vocab_size=200, hidden_size=16, num_layers=2, num_heads=2,
               intermediate_size=32, max_position=32)
    jparams = jbert.convert_hf_bert({k: v.numpy() for k, v in hf.state_dict().items()},
                                    jbert.BertConfig(**cfg))
    port = tbert.Bert(tbert.BertConfig(**cfg), device="cpu")
    port.load_state_dict(hf.state_dict(), strict=True)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 200, (2, 10))
    mask3d = (rs.rand(2, 10, 10) > 0.3) | np.eye(10, dtype=bool)
    pos = rs.randint(0, 32, (2, 10))
    types = np.zeros((2, 10), np.int64)
    encode = jax.jit(jbert.bert_encode, static_argnames="cfg")
    ref = np.asarray(encode(jparams, jnp.asarray(ids), jnp.asarray(mask3d), jnp.asarray(types),
                            jnp.asarray(pos), cfg=jbert.BertConfig(**cfg)))
    with torch.no_grad():
        got = port(*(torch.as_tensor(a) for a in (ids, mask3d, types, pos))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_host_tables_match_jax():
    """Text masks, tokenisation, the level sine tables and the proposals
    are numpy copies: equal to the bit. The query sine features run on the
    device: equal to the last bit of sin and cos."""
    ids = np.array([[101, 10, 11, 1012, 12, 13, 1029, 7, 102]], np.int64)
    for a, b in zip(tgd.generate_text_masks(ids), jgd.generate_text_masks(ids)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tdet.tokenize_classes(["mug", "red can"], toy_tokenizer),
                    jdet.tokenize_classes(["mug", "red can"], toy_tokenizer)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tgd.sine_position_embedding(13, 17, 32, 20.0),
                                  np.asarray(jgd.sine_position_embedding(13, 17, 32, 20.0)))
    shapes = ((100, 134), (50, 67), (25, 34), (13, 17))
    for a, b in zip(tgd._grid_proposals(shapes), jgd._grid_proposals(shapes)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # computed on the device: sin and cos may differ in the last bit
    pos = np.random.RandomState(0).rand(2, 5, 4).astype(np.float32)
    np.testing.assert_allclose(
        tgd.get_sine_pos_embed(torch.as_tensor(pos), 16).numpy(),
        np.asarray(jgd.get_sine_pos_embed(jnp.asarray(pos), 16)), rtol=0, atol=1e-6)


def test_forward_builds_its_host_tables_once_per_layout(oracle):
    """The forward's host-built tables (level sine tables, reference
    points, proposals, the deformable attention's normaliser) are copied to
    the device once per (level layout, device), not in every forward: a
    copy from the host mid-forward waits for the device. The cached tables
    are the numpy builders' values."""
    port = oracle[2]
    px = torch.as_tensor(np.random.RandomState(1).randn(1, 40, 48, 3).astype(np.float32))
    for fn in (tgd._level_constants, tgd._level_normalizer, tgd._sine_dim_t):
        fn.cache_clear()
    with torch.no_grad():
        first = port(px, IDS)
        misses = [fn.cache_info().misses for fn in
                  (tgd._level_constants, tgd._level_normalizer, tgd._sine_dim_t)]
        again = port(px, IDS)
    assert [fn.cache_info().misses for fn in
            (tgd._level_constants, tgd._level_normalizer, tgd._sine_dim_t)] == misses
    assert misses[0] == misses[1] == 1
    for a, b in zip(first, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.no_grad():
        shapes = tuple((int(x.shape[1]), int(x.shape[2])) for x in port._vision_maps(px))
    d, temp = port.cfg.d_model, port.cfg.pe_temperature
    c = tgd._level_constants(shapes, d, temp, torch.device("cpu"))
    assert tgd._level_constants.cache_info().misses == 1  # the forward's own entry
    props, valid = tgd._grid_proposals(shapes)
    np.testing.assert_array_equal(c["proposals"].numpy(), props)
    np.testing.assert_array_equal(c["valid"].numpy(), valid)
    np.testing.assert_array_equal(c["ref"].numpy(), tgd._encoder_reference_points(shapes))
    for p, (h, w) in zip(c["pos"], shapes):
        np.testing.assert_array_equal(p.numpy(), tgd.sine_position_embedding(h, w, d, temp))


def _forward_pair(oracle, px):
    _, jparams, port, cfg = oracle
    ref_l, ref_b = (np.asarray(a) for a in
                    jgd.groundingdino_forward(jparams, cfg, jnp.asarray(px), IDS.repeat(len(px), 0)))
    with torch.no_grad():
        got_l, got_b = (a.numpy() for a in port(torch.as_tensor(px), IDS.repeat(len(px), 0)))
    return got_l, got_b, ref_l, ref_b


def test_full_forward_matches_jax(oracle):
    """Two views of 60x70: neither side is a multiple of the patch (4) or,
    after patching, of the window (4), and the odd 15-row grid takes
    patch merging's padding."""
    px = np.random.RandomState(0).randn(2, 60, 70, 3).astype(np.float32)
    got_l, got_b, ref_l, ref_b = _forward_pair(oracle, px)
    fin = np.isfinite(ref_l)
    np.testing.assert_array_equal(np.isfinite(got_l), fin)
    np.testing.assert_allclose(got_l[fin], ref_l[fin], rtol=1e-3, atol=2e-5)
    np.testing.assert_allclose(got_b, ref_b, rtol=1e-4, atol=1e-5)


def test_forward_with_the_plain_gather_is_the_same_forward(oracle):
    """On the CPU the default gather is the plain version, so
    ``gather=deform_gather_plain`` must not change a bit; a gather that is
    not callable is refused."""
    _, _, port, _ = oracle
    px = torch.as_tensor(np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        a = port(px, IDS)
        b = port(px, IDS, gather=tdg.deform_gather_plain)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(TypeError, match="gather"):
        port(px, IDS, gather="plain")


def test_forward_takes_a_gather_callable_in_every_layer(oracle):
    """A callable ``gather`` replaces the gather of all the encoder's and
    the decoder's deformable attentions, and sees their inputs."""
    _, _, port, cfg = oracle
    px = torch.as_tensor(np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32))
    calls = []

    def capture(value, shapes, loc, attn):
        calls.append((tuple(value.shape), tuple(shapes), tuple(loc.shape)))
        return tdg.deform_gather_plain(value, shapes, loc, attn)

    with torch.no_grad():
        a = port(px, IDS)
        b = port(px, IDS, gather=capture)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    assert len(calls) == cfg.encoder_layers + cfg.decoder_layers
    S = calls[0][0][1]
    assert {c[2][1] for c in calls[:cfg.encoder_layers]} == {S}
    assert {c[2][1] for c in calls[cfg.encoder_layers:]} == {cfg.num_queries}
    assert all(sum(h * w for h, w in c[1]) == S for c in calls)


def _top10_agreement(l_a, b_a, l_b, b_b):
    """tests/test_groundingdino.py:408-440's detection-level rule on one
    view: (the largest gap of the sorted best-token scores, the smallest
    best IoU of a top-10 query of ``a`` against the top 10 of ``b``)."""
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))  # noqa: E731
    s_a, s_b = sig(l_a).max(1), sig(l_b).max(1)

    def cxcywh_iou(a, b):
        lt = np.maximum(a[:, None, :2] - a[:, None, 2:] / 2, b[None, :, :2] - b[None, :, 2:] / 2)
        rb = np.minimum(a[:, None, :2] + a[:, None, 2:] / 2, b[None, :, :2] + b[None, :, 2:] / 2)
        inter = np.clip(rb - lt, 0, None).prod(-1)
        return inter / (a[:, 2:].prod(-1)[:, None] + b[:, 2:].prod(-1)[None] - inter + 1e-9)

    top_a, top_b = np.argsort(-s_a)[:10], np.argsort(-s_b)[:10]
    iou = cxcywh_iou(b_a[top_a], b_b[top_b])
    return float(np.abs(np.sort(s_a) - np.sort(s_b)).max()), float(iou.max(axis=1).min())


def test_bf16_trunk_matches_jax_bf16(oracle):
    """The gated bf16 trunk (Swin, input projections, encoder layers in
    bf16; BERT, selection, decoder and heads f32) against the JAX package's
    with its Pallas gather interpreted, which sums the bf16 tables in f32
    as the port's gather does (its XLA gather sums in bf16). Held to the
    detection-level rule of tests/test_groundingdino.py:408-440, against
    JAX's bf16 and against the port's own f32; the weights the detector
    rounds are a copy, the f32 model is left as it was."""
    _, jparams, port, cfg = oracle
    px = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
    ref_l, ref_b = (np.asarray(a) for a in jgd.groundingdino_forward(
        jparams, cfg, jnp.asarray(px), IDS, "bfloat16", gather_impl="pallas_interpret"))
    det = tdet.GroundingDinoDetector(port, toy_tokenizer, device="cpu",
                                     compute_dtype="bfloat16")
    assert det.model is not port and det.model.compute_dtype == torch.bfloat16
    assert port.compute_dtype == torch.float32
    assert det.model.model.decoder.layers[0].fc1.weight is port.model.decoder.layers[0].fc1.weight
    with torch.no_grad():
        l16, b16 = (a.numpy() for a in det.model(torch.as_tensor(px), IDS))
        l32, b32 = (a.numpy() for a in port(torch.as_tensor(px), IDS))
    assert l16.dtype == b16.dtype == np.float32
    np.testing.assert_array_equal(np.isfinite(l16), np.isfinite(ref_l))
    for label, (la, ba) in (("jax_bf16", (ref_l, ref_b)), ("port_f32", (l32, b32))):
        score_gap, min_iou = _top10_agreement(la[0], ba[0], l16[0], b16[0])
        assert score_gap < 0.05, (label, score_gap)
        assert min_iou > 0.9, (label, min_iou)


def test_load_jax_params_equals_native_load(oracle):
    sd, jparams, port, _ = oracle
    carried = tgd.load_jax_params(tgd.GroundingDino(port.cfg, device="cpu"),
                                  jax.tree.map(np.asarray, jparams))
    assert set(carried.state_dict()) == set(sd)
    for k, v in carried.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)


def test_init_params_follows_hf_init(oracle):
    sd = oracle[0]
    cfg = tgd.GroundingDinoConfig.tiny_test()
    a = tgd.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = tgd.init_params(cfg, device="cpu")
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    got = a.state_dict()
    for k in got:
        if k.endswith(("sampling_offsets.bias", "attention_weights.weight",
                       "attention_weights.bias", "sampling_offsets.weight",
                       "fusion_layer.vision_param", "relative_position_index")):
            torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0, msg=k)
    assert abs(float(got["model.enc_output.weight"].std()) - 0.02) < 5e-3
    assert float(got["bbox_embed.0.layers.2.weight"].abs().max()) > 0  # randomised, not HF's 0
    assert float(got["model.decoder.layer_norm.weight"].std()) > 0.05
    with torch.no_grad():
        logits, boxes = a(torch.zeros(1, 64, 64, 3), IDS)
    assert torch.isfinite(boxes).all() and logits.shape == (1, cfg.num_queries, cfg.max_text_len)


def test_detections_match_jax(oracle):
    _, jparams, port, cfg = oracle
    imgs = np.random.RandomState(11).randint(0, 255, (3, 72, 96, 3), dtype=np.uint8)
    kw = dict(tokenize=toy_tokenizer, short_side=64, max_side=96)
    ref = jdet.GroundingDinoDetector(jparams, cfg, **kw).predict_with_classes_batch(
        imgs, ["mug", "red can"], 0.3)
    got = tdet.GroundingDinoDetector(port, device="cpu", **kw).predict_with_classes_batch(
        imgs, ["mug", "red can"], 0.3)
    assert len(got) == 3 and sum(len(r.class_id) for r in ref) > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.class_id, r.class_id)
        np.testing.assert_allclose(g.xyxy, r.xyxy, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g.confidence, r.confidence, rtol=1e-4, atol=1e-4)


def test_postprocess_is_exact_against_jax_full_map_reference():
    """The device reduction + host tail equal the JAX package's full-map
    numpy post-processing, including a width-0 class span and the fallback
    when every span token is below the text threshold."""
    rs = np.random.RandomState(11)
    V, Q, L = 3, 64, 32
    logits = torch.as_tensor(rs.randn(V, Q, L).astype(np.float32) * 2.0)
    boxes = rs.uniform(0.2, 0.8, (V, Q, 4)).astype(np.float32)
    spans = [(1, 4), (5, 5), (6, 12)]
    probs = torch.sigmoid(logits).numpy()
    for thr in (0.25, 0.95):
        red = tdet._reduce_detection_outputs(
            logits, torch.as_tensor(tdet._span_mask(spans, L)), thr)
        scores, span_thr, span_fb = (t.numpy() for t in red)
        for v in range(V):
            ref = jdet._postprocess_view(probs[v], boxes[v], spans, 0.3, thr, (120, 160))
            got = tdet._postprocess_view_reduced(scores[v], span_thr[v], span_fb[v], boxes[v],
                                                 0.3, (120, 160))
            np.testing.assert_array_equal(got.xyxy, ref.xyxy)
            np.testing.assert_array_equal(got.confidence, ref.confidence)
            np.testing.assert_array_equal(got.class_id, ref.class_id)

"""Port parity: SAM of d3fields_tpu_torch against d3fields_tpu.

Both packages compute from one huggingface ``SamModel`` state dict (the
tiny ``build_random_hf`` model): the port loads it natively, the JAX
package through its converter. Tolerances are tests/test_sam.py's: the
encoder rtol 1e-4 / atol 1e-4, prompt embeddings rtol 1e-4 / atol 1e-5.
The tiny random decoder emits ~1e-5-sized logits, so its outputs are
compared at rtol 1e-4 / atol 1e-5 of the JAX output's own scale.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d3fields_tpu.models import resize as jresize
from d3fields_tpu.models.sam import model as jsam
from d3fields_tpu.models.sam.predictor import SamPredictor as JPredictor
from d3fields_tpu_torch.models import resize as tresize
from d3fields_tpu_torch.models.sam import model as tsam
from d3fields_tpu_torch.models.sam.predictor import SamPredictor as TPredictor

BOXES = np.array([[4.0, 6.0, 40.0, 50.0], [10.0, 5.0, 60.0, 44.0], [0.0, 0.0, 63.0, 63.0]],
                 np.float32)


@pytest.fixture(scope="module")
def oracle():
    cfg = jsam.SamConfig.tiny_test()
    sd = jsam.build_random_hf(cfg, seed=0).state_dict()
    jparams = jsam.convert_hf_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    port = tsam.Sam(tsam.SamConfig.tiny_test(), device="cpu")
    port.load_state_dict(sd, strict=True)
    return sd, jparams, port.eval(), cfg


def _close_at_scale(got, ref, rtol=1e-4, atol=1e-5):
    scale = np.abs(ref).max() + 1e-12
    np.testing.assert_allclose(got / scale, ref / scale, rtol=rtol, atol=atol)


def test_encoder_matches_jax(oracle):
    _, jparams, port, cfg = oracle
    px = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    ref = np.asarray(jsam.vision_encoder(jparams["vision"], jnp.asarray(px), cfg))
    with torch.no_grad():
        got = port.encode(torch.as_tensor(px)).numpy()
    assert got.shape == (2, cfg.grid, cfg.grid, cfg.output_channels)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_prompt_embeddings_match_jax(oracle):
    _, jparams, port, cfg = oracle
    with torch.no_grad():
        sparse = port.embed_boxes(torch.as_tensor(BOXES)).numpy()
        pe = port.image_wide_positional_embedding().numpy()
    np.testing.assert_allclose(
        sparse, np.asarray(jsam.embed_boxes(jparams["prompt"], jnp.asarray(BOXES),
                                            cfg.image_size)), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        pe, np.asarray(jsam.image_wide_positional_embedding(jparams["prompt"], cfg.grid)),
        rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("multimask", [True, False])
def test_box_decode_matches_jax(oracle, multimask):
    _, jparams, port, cfg = oracle
    px = np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32)
    emb = jsam.sam_encode_image(jparams, jnp.asarray(px), cfg)
    ref_m, ref_i = (np.asarray(a) for a in
                    jsam.sam_decode_boxes(jparams, emb, jnp.asarray(BOXES), cfg, multimask))
    embs = torch.as_tensor(np.array(emb))[None].expand(len(BOXES), -1, -1, -1)
    with torch.no_grad():
        got_m, got_i = (a.numpy() for a in
                        port.decode_boxes(embs, torch.as_tensor(BOXES), multimask))
    assert got_m.shape == ref_m.shape and got_i.shape == ref_i.shape
    _close_at_scale(got_m, ref_m)
    _close_at_scale(got_i, ref_i)


def _rig():
    rs = np.random.RandomState(3)
    imgs = rs.randint(0, 255, (4, 48, 56, 3), dtype=np.uint8)
    boxes = [
        np.array([[4.0, 4.0, 30.0, 40.0], [10.0, 8.0, 44.0, 30.0]], np.float32),
        np.zeros((0, 4), np.float32),
        np.array([[2.0, 2.0, 20.0, 20.0]], np.float32),
        np.array([[6.0, 3.0, 50.0, 46.0], [1.0, 1.0, 10.0, 12.0], [12.0, 20.0, 40.0, 44.0]],
                 np.float32),
    ]
    return imgs, boxes


def test_predict_boxes_views_matches_per_view_loop_and_jax(oracle):
    """One batched decode of every view's boxes (a view with none among
    them) == the per-view set_image / predict_boxes loop, and == the JAX
    predictor: bool masks of the original size, iou to float tolerance."""
    _, jparams, port, cfg = oracle
    imgs, boxes = _rig()
    pred = TPredictor(port, device="cpu")
    got = pred.set_images(imgs).predict_boxes_views(boxes)
    ref = JPredictor(jparams, cfg).set_images(imgs).predict_boxes_views(boxes)
    assert len(got) == 4
    for v, ((m, i), (rm, ri)) in enumerate(zip(got, ref)):
        assert m.dtype == torch.bool and tuple(m.shape) == rm.shape == (len(boxes[v]), 3, 48, 56)
        np.testing.assert_allclose(i.numpy(), ri, rtol=1e-4, atol=1e-5)
        if len(boxes[v]):
            assert (m.numpy() == rm).mean() > 0.999  # equal up to knife-edge logits
            lm, li = pred.set_image(imgs[v]).predict_boxes(boxes[v])
            assert (lm == m).float().mean() > 0.999
            np.testing.assert_allclose(li.numpy(), i.numpy(), rtol=1e-4, atol=1e-5)


def test_bf16_encoder_matches_jax_bf16(oracle):
    """``SamPredictor(compute_dtype='bfloat16')`` (ViT trunk in bf16 with f32
    LayerNorm statistics and softmax, f32 neck) against the JAX package's
    bf16 encoder, and against the port's own f32 encoder, under
    tests/test_sam.py:212-235's budgets: embedding cosine above 0.995, the
    0-thresholded box masks equal on more than 98% of pixels and IoU
    predictions within 0.05. The predictor rounds a copy of the trunk; the
    decoder's weights are the f32 model's own."""
    _, jparams, port, cfg = oracle
    px = np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32)
    pred = TPredictor(port, device="cpu", compute_dtype="bfloat16")
    assert pred.model.vision_encoder.layers[0].attn.qkv.weight.dtype == torch.bfloat16
    assert pred.model.vision_encoder.neck.conv1.weight is port.vision_encoder.neck.conv1.weight
    assert port.vision_encoder.layers[0].attn.qkv.weight.dtype == torch.float32
    with torch.no_grad():
        e16 = pred.model.encode(torch.as_tensor(px))
        e32 = port.encode(torch.as_tensor(px))
    assert e16.dtype == torch.float32
    j16 = jsam.vision_encoder(jparams["vision"], jnp.asarray(px), cfg, "bfloat16")
    boxes = jnp.asarray(BOXES[:1])
    jm, ji = (np.asarray(a) for a in jsam.sam_decode_boxes(jparams, j16[0], boxes, cfg, True))

    def decode(emb):
        with torch.no_grad():
            m, i = pred.model.decode_boxes(emb, torch.as_tensor(BOXES[:1]), True)
        return m.numpy(), i.numpy()

    m16, i16 = decode(e16)
    for label, emb, (m, i) in (("jax_bf16", np.asarray(j16), (jm, ji)),
                               ("port_f32", e32.numpy(), decode(e32))):
        a, b = e16.numpy().reshape(-1, e16.shape[-1]), emb.reshape(-1, emb.shape[-1])
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)
        assert cos.min() > 0.995, (label, cos.min())
        assert ((m16 > 0) == (m > 0)).mean() > 0.98, label
        assert np.abs(i16 - i).max() < 0.05, label


def test_init_params_has_the_structure_of_random_params_direct(oracle):
    """``random_params_direct`` carried into the port fills every parameter
    and buffer, and every leaf is of the kind init_params draws (zeros,
    ones or N(0, 0.02²))."""
    cfg = tsam.SamConfig.tiny_test()
    direct = tsam.load_jax_params(tsam.Sam(cfg, device="cpu"),
                                  jax.tree.map(np.asarray, jsam.random_params_direct(oracle[3])))
    drawn = tsam.init_params(cfg, device="cpu")
    again = tsam.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def kind(t):
        return "zeros" if bool((t == 0).all()) else "ones" if bool((t == 1).all()) else "normal"

    for (k, a), b, c in zip(direct.state_dict().items(), drawn.state_dict().values(),
                            again.state_dict().values()):
        assert kind(a) == kind(b), k
        torch.testing.assert_close(b, c, rtol=0, atol=0, msg=k)
    assert abs(float(drawn.state_dict()["vision_encoder.layers.0.attn.qkv.weight"].std())
               - 0.02) < 5e-3
    with torch.no_grad():
        emb = drawn.encode(torch.zeros(1, cfg.image_size, cfg.image_size, 3))
        masks, iou = drawn.decode_boxes(emb, torch.as_tensor(BOXES[:1]))
    assert torch.isfinite(masks).all() and torch.isfinite(iou).all()


def test_load_jax_params_equals_native_load(oracle):
    sd, jparams, port, _ = oracle
    carried = tsam.load_jax_params(tsam.Sam(port.cfg, device="cpu"),
                                   jax.tree.map(np.asarray, jparams))
    for k, v in carried.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)


def test_bilinear_resize_exact_matches_jax():
    """atol 3e-5: F.interpolate takes the source coordinate in float32, the
    JAX package's weight table in float64; on N(0, 1) data that moves
    downscaled values by up to 1.2e-5 beyond rtol 1e-5 (40 seeds)."""
    rs = np.random.RandomState(4)
    for (H, W), (h, w) in [((16, 16), (64, 64)), ((64, 64), (37, 53)), ((37, 53), (48, 56))]:
        img = rs.standard_normal((3, H, W, 2)).astype(np.float32)
        ref = np.asarray(jresize.bilinear_resize_exact(jnp.asarray(img), (h, w)))
        got = tresize.bilinear_resize_exact(torch.as_tensor(img), (h, w)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=3e-5, err_msg=f"{(H, W)}->{(h, w)}")


# ---------------------------------------------------------------------------
# point and mask prompts (tests/test_sam.py:63-160)
# ---------------------------------------------------------------------------

CLICKS = np.array([[[8.0, 9.0], [30.0, 22.0]], [[40.0, 41.0], [0.0, 0.0]]], np.float32)
CLICK_LABELS = np.array([[1, 0], [1, -1]], np.int32)


def test_point_and_mask_embeddings_match_jax(oracle):
    _, jparams, port, cfg = oracle
    mask = np.random.RandomState(5).randn(2, 4 * cfg.grid, 4 * cfg.grid).astype(np.float32)
    with torch.no_grad():
        sparse = port.embed_points(torch.as_tensor(CLICKS),
                                   torch.as_tensor(CLICK_LABELS, dtype=torch.int64)).numpy()
        dense = port.embed_mask_dense(torch.as_tensor(mask)).numpy()
    ref = np.asarray(jsam.embed_points(jparams["prompt"], jnp.asarray(CLICKS),
                                       jnp.asarray(CLICK_LABELS), cfg.image_size, pad=True))
    assert sparse.shape == ref.shape == (2, 3, cfg.prompt_hidden)
    np.testing.assert_allclose(sparse, ref, rtol=1e-4, atol=1e-5)
    ref = np.asarray(jsam.embed_mask_dense(jparams["prompt"], jnp.asarray(mask)))
    assert dense.shape == ref.shape == (2, cfg.grid, cfg.grid, cfg.prompt_hidden)
    np.testing.assert_allclose(dense, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("P,masked,multimask", [(2, False, True), (2, True, False),
                                                (4, False, False), (4, True, True)])
def test_point_decode_matches_jax(oracle, P, masked, multimask):
    """``decode_points`` against ``sam_decode_points`` at the same click
    count (P = 2 carries a -1 row), with and without a mask prompt."""
    _, jparams, port, cfg = oracle
    rs = np.random.RandomState(6 + P)
    px = rs.randn(1, 64, 64, 3).astype(np.float32)
    pts = rs.uniform(0, 63, (2, P, 2)).astype(np.float32)
    lbl = rs.randint(0, 2, (2, P)).astype(np.int32)
    lbl[1, -1] = -1
    mask = rs.randn(2, 4 * cfg.grid, 4 * cfg.grid).astype(np.float32) if masked else None
    emb = jsam.sam_encode_image(jparams, jnp.asarray(px), cfg)
    ref_m, ref_i = (np.asarray(a) for a in jsam.sam_decode_points(
        jparams, emb, jnp.asarray(pts), jnp.asarray(lbl), cfg, multimask,
        mask_input=None if mask is None else jnp.asarray(mask)))
    embs = torch.as_tensor(np.array(emb))[None].expand(2, -1, -1, -1)
    with torch.no_grad():
        got_m, got_i = (a.numpy() for a in port.decode_points(
            embs, torch.as_tensor(pts), torch.as_tensor(lbl, dtype=torch.int64), multimask,
            mask_input=None if mask is None else torch.as_tensor(mask)))
    assert got_m.shape == ref_m.shape and got_i.shape == ref_i.shape
    _close_at_scale(got_m, ref_m)
    _close_at_scale(got_i, ref_i)


def test_predict_points_matches_jax(oracle):
    """``SamPredictor.predict_points`` on a non-square image against the JAX
    predictor at P = 4 clicks (where it adds no bucket pad), then one
    refinement round with the low-res logits fed back as ``mask_input``."""
    _, jparams, port, cfg = oracle
    rs = np.random.RandomState(7)
    rgb = (rs.rand(50, 60, 3) * 255).astype(np.uint8)
    pts = rs.uniform(0, 49, (2, 4, 2)).astype(np.float32)
    lbl = np.array([[1, 1, 0, 0], [1, 0, 1, -1]], np.int32)
    tp = TPredictor(port, device="cpu").set_image(rgb)
    jp = JPredictor(jparams, cfg).set_image(rgb)
    got, ref = tp.predict_points(pts, lbl), jp.predict_points(pts, lbl)
    assert got[0].dtype == torch.bool and tuple(got[0].shape) == ref[0].shape == (2, 3, 50, 60)
    assert (got[0].numpy() == ref[0]).mean() > 0.999  # equal up to knife-edge logits
    _close_at_scale(got[1].numpy(), ref[1])
    _close_at_scale(got[2].numpy(), ref[2])
    best = ref[1].argmax(1)
    low = ref[2][np.arange(2), best]
    got = tp.predict_points(pts, lbl, multimask_output=False, mask_input=torch.as_tensor(low))
    ref = jp.predict_points(pts, lbl, multimask_output=False, mask_input=low)
    assert tuple(got[0].shape) == ref[0].shape == (2, 1, 50, 60)
    assert (got[0].numpy() == ref[0]).mean() > 0.999
    _close_at_scale(got[1].numpy(), ref[1])
    _close_at_scale(got[2].numpy(), ref[2])
    with pytest.raises(ValueError, match="one low-res logit map per prompt"):
        tp.predict_points(pts, lbl, mask_input=low[:1])


def test_jax_click_bucket_moves_the_decode_and_the_port_pads_none():
    """The JAX predictor pads a prompt's clicks to ``_bucket(P)`` with -1
    entries; they join the decoder's token attention. With the tiny SAM of
    ``random_params_direct``, two clicks padded to four move the low-res
    logits by 2.7% of their scale and the IoU by 5.0e-6 (ROADMAP, 'Reference
    caveats'). The port decodes the two clicks unpadded, as
    ``sam_decode_points`` does when called directly."""
    cfg = jsam.SamConfig.tiny_test()
    params = jsam.random_params_direct(cfg)
    px = jnp.asarray(np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32))
    emb = jsam.sam_encode_image(params, px, cfg)
    pts, lbl = CLICKS[:1], np.array([[1, 0]], np.int32)
    pts4 = np.concatenate([pts, np.zeros((1, 2, 2), np.float32)], 1)
    lbl4 = np.concatenate([lbl, -np.ones((1, 2), np.int32)], 1)
    m2, i2 = (np.asarray(a) for a in jsam.sam_decode_points(
        params, emb, jnp.asarray(pts), jnp.asarray(lbl), cfg, True))
    m4, i4 = (np.asarray(a) for a in jsam.sam_decode_points(
        params, emb, jnp.asarray(pts4), jnp.asarray(lbl4), cfg, True))
    assert np.abs(m4 - m2).max() / np.abs(m2).max() > 0.02
    assert np.abs(i4 - i2).max() > 1e-6
    port = tsam.load_jax_params(tsam.Sam(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got_m, got_i = (a.numpy() for a in port.decode_points(
            torch.as_tensor(np.array(emb))[None], torch.as_tensor(pts),
            torch.as_tensor(lbl, dtype=torch.int64)))
    _close_at_scale(got_m, m2)
    _close_at_scale(got_i, i2)

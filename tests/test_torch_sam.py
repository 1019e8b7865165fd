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

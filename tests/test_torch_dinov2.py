"""Port parity: DINOv2 of d3fields_tpu_torch against d3fields_tpu.

Both packages run the same weights: the JAX parameter dict is carried into
the port with ``load_jax_params``, or a random huggingface ``Dinov2Model``
is converted by each package's own converter. Tolerances are
tests/test_dinov2.py's: tokens rtol 2e-3 / atol 2e-4 (3e-4 where the
positional table is interpolated), patch-token cosine deficit < 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d3fields_tpu.models import dinov2 as jd2
from d3fields_tpu.models import resize as jresize
from d3fields_tpu_torch.models import dinov2 as td2
from d3fields_tpu_torch.models import resize as tresize

CFG = jd2.Dinov2Config.tiny_test()
TCFG = td2.Dinov2Config.tiny_test()


def _cos_deficit(a, b):
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)
    return (1 - cos).max()


@pytest.fixture(scope="module")
def jax_params():
    """JAX-layout parameters with every leaf random (biases, norms and
    layer scales too), so the carry is checked leaf by leaf."""
    shapes = jd2.init_params(jax.random.PRNGKey(0), CFG)
    rs = np.random.RandomState(0)
    out = {}
    for k, v in shapes.items():
        noise = rs.standard_normal(v.shape).astype(np.float32)
        if k.startswith(("ln", "norm_w", "ls")) and not k.endswith("_b"):
            out[k] = 1.0 + 0.1 * noise
        else:
            out[k] = 0.02 * noise
    return out


@pytest.fixture(scope="module")
def port_model(jax_params):
    return td2.load_jax_params(td2.Dinov2(TCFG, device="cpu"), jax_params)


@pytest.fixture(scope="module")
def hf_model():
    from transformers import Dinov2Config as HFConfig, Dinov2Model

    torch.manual_seed(0)
    hf_cfg = HFConfig(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
                      intermediate_size=256, patch_size=14, image_size=56,
                      layerscale_value=0.5)
    return Dinov2Model(hf_cfg).eval()


def _tokens(model, pixels, pos):
    with torch.no_grad():
        return model.forward_tokens(torch.as_tensor(pixels), torch.as_tensor(np.array(pos))).numpy()


@pytest.mark.parametrize("hw, atol", [((56, 56), 2e-4), ((42, 70), 3e-4)])
def test_forward_tokens_matches_jax(jax_params, port_model, rng, hw, atol):
    pixels = rng.standard_normal((2,) + hw + (3,)).astype(np.float32)
    gh, gw = hw[0] // 14, hw[1] // 14
    jbb = jd2.Dinov2Backbone({k: jnp.asarray(v) for k, v in jax_params.items()}, CFG)
    tbb = td2.Dinov2Backbone(port_model, device="cpu")
    jpos = np.asarray(jbb.interpolated_pos_embed(gh, gw))
    tpos = tbb.interpolated_pos_embed(gh, gw).numpy()
    np.testing.assert_array_equal(tpos, jpos)
    ref = np.asarray(jd2.forward_tokens(jbb.params, jnp.asarray(pixels), jnp.asarray(jpos),
                                        CFG.num_heads))
    out = _tokens(port_model, pixels, tpos)
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=atol)
    assert _cos_deficit(out[:, 1:], ref[:, 1:]) < 1e-3


@pytest.mark.parametrize("resize_mode", ["pil", "device"])
def test_backbone_end_to_end_matches_jax(jax_params, port_model, rng, resize_mode):
    imgs = rng.integers(0, 255, size=(3, 40, 60, 3), dtype=np.uint8)
    jbb = jd2.Dinov2Backbone({k: jnp.asarray(v) for k, v in jax_params.items()}, CFG,
                             resize_mode=resize_mode)
    tbb = td2.Dinov2Backbone(port_model, resize_mode=resize_mode, device="cpu")
    ref = np.asarray(jbb(imgs))  # patch_hw defaults to (4, 6)
    out = tbb(imgs).numpy()
    assert out.shape == (3, 4, 6, 64)
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=3e-4)
    assert _cos_deficit(out, ref) < 1e-3


def test_convert_hf_state_dict_matches_jax_conversion(hf_model, rng):
    cfg = jd2.Dinov2Config(hidden_size=64, num_layers=3, num_heads=4, image_size=56,
                           layerscale_init=0.5)
    tcfg = td2.Dinov2Config(hidden_size=64, num_layers=3, num_heads=4, image_size=56,
                            layerscale_init=0.5)
    jparams = jd2.convert_hf_state_dict(hf_model.state_dict(), cfg)
    model = td2.Dinov2(tcfg, device="cpu")
    model.load_state_dict(td2.convert_hf_state_dict(hf_model.state_dict(), tcfg))
    pixels = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    pos = np.asarray(jparams["pos_embed"])
    ref = np.asarray(jd2.forward_tokens(jparams, jnp.asarray(pixels), jnp.asarray(pos),
                                        cfg.num_heads))
    out = _tokens(model, pixels, pos)
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-4)
    with torch.no_grad():
        hf = hf_model(torch.as_tensor(pixels).permute(0, 3, 1, 2)).last_hidden_state.numpy()
    np.testing.assert_allclose(out, hf, rtol=2e-3, atol=2e-4)


def test_convert_hub_state_dict_loads_natively(hf_model):
    """A hub-layout state dict (built from the HF tensors, as
    tests/test_dinov2.py does) loads as it is and agrees with the HF
    conversion; the unused mask_token is dropped."""
    sd = hf_model.state_dict()
    conv = td2.convert_hf_state_dict(sd, TCFG)
    hub = dict(conv)
    hub["mask_token"] = torch.zeros(1, 64)
    out = td2.convert_hub_state_dict(hub, TCFG)
    assert set(out) == set(td2.Dinov2(TCFG, device="cpu").state_dict())
    for k in conv:
        torch.testing.assert_close(out[k], conv[k], rtol=0, atol=0)


def test_init_params_draws_the_jax_distribution():
    model = td2.init_params(TCFG, torch.Generator().manual_seed(0), device="cpu")
    again = td2.init_params(TCFG, device="cpu")
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    sd = model.state_dict()
    assert abs(float(sd["blocks.0.attn.qkv.weight"].std()) - 0.02) < 2e-3
    assert float(sd["blocks.0.attn.qkv.bias"].abs().max()) == 0.0
    assert float(sd["blocks.1.ls2.gamma"].min()) == TCFG.layerscale_init


def test_resizers_match_jax(rng):
    x = rng.standard_normal((7, 9, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tresize.cubic_resize_np(x, (13, 4), scale_hw=(1.9, 0.5)),
        jresize.cubic_resize_np(x, (13, 4), scale_hw=(1.9, 0.5)))
    for (H, W), (h, w) in [((240, 320), (336, 448)), ((120, 164), (56, 84)),
                           ((37, 53), (14, 28))]:
        img = rng.uniform(0, 1, size=(2, H, W, 3)).astype(np.float32)
        ref = np.asarray(jresize.bilinear_resize(jnp.asarray(img), (h, w)))
        out = tresize.bilinear_resize(torch.as_tensor(img), (h, w)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5, err_msg=f"{(H, W)}->{(h, w)}")


def test_pil_resize_numpy_path_bit_exact_vs_pillow(rng):
    """The port's integer resampler gives Pillow's bytes: down, up,
    identity, odd ratios; one image or a batch."""
    from PIL import Image

    for (H, W), (h, w) in [((480, 640), (112, 140)), ((48, 64), (112, 140)),
                           ((100, 100), (100, 100)), ((37, 53), (14, 28)),
                           ((240, 320), (336, 448))]:
        img = rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8)
        ref = np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))
        np.testing.assert_array_equal(
            tresize.pil_bilinear_resize_u8(torch.as_tensor(img), (h, w)).numpy(), ref)
        np.testing.assert_array_equal(
            tresize.pil_bilinear_resize_u8(torch.as_tensor(img[None]), (h, w))[0].numpy(), ref)

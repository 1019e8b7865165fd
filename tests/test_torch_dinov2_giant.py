"""DINOv2 with the SwiGLU feed-forward and register tokens (torch hub's
``dinov2_vitg14_reg``), on the CPU at a small size.

The program's ``Dinov2Backbone`` is held to the benchmark's plain
reference (``port_bench/reference/dinov2_vitg.py``) over the benchmark's
seeded weights (``port_bench/weights_vitg.py``). The size keeps the
giant-reg model's structure: width 64, 3 layers, 4 heads, the SwiGLU's
hidden width by the hub's rule (176), 4 registers, a 112-pixel pretraining
grid (8x8 positions), so that the 4x6 and 4x4 patch grids downsample the
positional table and its antialiasing counts.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from d3fields_tpu_torch.apps import _backends
from d3fields_tpu_torch.models import dinov2 as td2
from d3fields_tpu_torch.utils.profiling import DEVICE_SPANS, DEVICE_US, tracer
from port_bench import weights, weights_vitg
from port_bench.drivers.common import token_rel
from port_bench.reference import dinov2_vitg as ref
from port_bench.reference.precision import MODES

SEED = 2 ** 32 + 11
CFG = td2.Dinov2Config(hidden_size=64, num_layers=3, num_heads=4, image_size=112, ffn="swiglu",
                       num_register_tokens=4, interpolate_antialias=True, interpolate_offset=0.0)
MODEL = dict(hidden_size=64, num_layers=3, num_heads=4, mlp_ratio=4, patch_size=14,
             image_size=112, ffn="swiglu", ffn_hidden=176, num_register_tokens=4,
             interpolate_antialias=True, interpolate_offset=0.0)
VITL = dict(hidden_size=1024, num_layers=24, num_heads=16, mlp_ratio=4, patch_size=14,
            image_size=518)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the Tier-1 run's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hub_weights():
    return weights_vitg.vitg_weights(MODEL, SEED, "cpu")


@pytest.fixture(scope="module")
def model(hub_weights):
    m = td2.Dinov2(CFG, device="cpu")
    m.load_state_dict(hub_weights)
    return m.eval()


@pytest.fixture(scope="module")
def images():
    rs = np.random.RandomState(5)
    return rs.randint(0, 256, size=(3, 40, 60, 3)).astype(np.uint8)


def _descriptors(model, images, dtype, patch_hw=(4, 6)):
    backbone = td2.Dinov2Backbone(model, compute_dtype=dtype, device="cpu")
    return backbone(torch.as_tensor(images), patch_hw=patch_hw)


def test_hidden_width_follows_the_hub_rule():
    """``SwiGLUFFNFused``'s (int(4D * 2/3) + 7) // 8 * 8: 4096 at D = 1536,
    176 at D = 64; the GELU MLP keeps 4D."""
    assert td2.Dinov2Config.vit_giant2_reg().ffn_hidden == 4096
    assert td2.Dinov2Config.vit_giant2().ffn_hidden == 4096
    assert CFG.ffn_hidden == MODEL["ffn_hidden"] == ref.ffn_hidden(64, 4) == 176
    assert ref.ffn_hidden(1536, 4) == 4096
    assert td2.Dinov2Config.vit_large().ffn_hidden == 4096
    g = td2.Dinov2Config.vit_giant2_reg()
    assert (g.hidden_size, g.num_layers, g.num_heads, g.num_register_tokens) == (1536, 40, 24, 4)
    assert (g.interpolate_antialias, g.interpolate_offset) == (True, 0.0)
    assert (td2.Dinov2Config.vit_giant2().interpolate_offset,
            td2.Dinov2Config.vit_giant2().num_register_tokens) == (0.1, 0)
    with pytest.raises(ValueError, match="ffn"):
        td2.Dinov2Config(ffn="geglu")


def test_backbone_matches_the_reference_f32(model, hub_weights, images):
    """Float32 against the reference's f64 mode (the reference of a float32
    configuration): every descriptor within 1e-5 relative; the registers
    dropped, the patch tokens kept."""
    got = _descriptors(model, images, "float32")
    want = ref.descriptors(hub_weights, images, MODEL, (4, 6), MODES["f64"])
    assert got.shape == want.shape == (3, 4, 6, 64)
    assert token_rel(got, want) < 1e-5


def test_backbone_matches_the_reference_bf16(model, hub_weights, images):
    """bfloat16 against the reference's bf16 mode (bf16 weights and
    activations, each op rounded as torch rounds it, statistics and softmax
    in f32): within 1e-3 relative on the CPU (the ops are the same), where
    the f32 reference lies much further off."""
    got = _descriptors(model, images, "bfloat16")
    want = ref.descriptors(hub_weights, images, MODEL, (4, 6), MODES["bf16"])
    exact = ref.descriptors(hub_weights, images, MODEL, (4, 6), MODES["f64"])
    assert token_rel(got, want) < 1e-3
    assert token_rel(got, exact) > 10 * max(token_rel(got, want), 1e-4)


@pytest.mark.parametrize("grid", [(4, 6), (3, 5), (8, 8)])
def test_positional_table_is_antialiased_at_the_exact_size(model, grid):
    """offset 0: torch hub's ``F.interpolate(mode="bicubic", antialias=True,
    size=grid)`` in float64, stored as float32; the class row unchanged."""
    backbone = td2.Dinov2Backbone(model, device="cpu")
    got = backbone.interpolated_pos_embed(*grid)
    pe = model.pos_embed.detach().double()[0]
    x = pe[1:].reshape(1, 8, 8, -1).permute(0, 3, 1, 2)
    want = F.interpolate(x, mode="bicubic", antialias=True, align_corners=False, size=grid)
    want = torch.cat([pe[:1], want[0].permute(1, 2, 0).reshape(grid[0] * grid[1], -1)]).float()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if grid != (8, 8):
        plain = F.interpolate(x, mode="bicubic", align_corners=False, size=grid)[0]
        assert (plain.permute(1, 2, 0).reshape(-1, 64).float() - got[1:]).abs().max() > 1e-3


def test_tracer_counts_the_tokens_and_the_swiglu_calls(model, images):
    """4 views on a 4x4 grid: one transformer call of 4 x (1 + 4 + 16)
    tokens through the 3 SwiGLU layers, one ``dinov2.forward`` span and no
    span or counter of a block's feed-forward."""
    backbone = td2.Dinov2Backbone(model, device="cpu")
    imgs = torch.as_tensor(np.concatenate([images, images[:1]]))
    tracer.reset()
    tracer.enable()
    try:
        backbone(imgs, patch_hw=(4, 4))
    finally:
        tracer.disable()
    s = tracer.summary()
    tracer.reset()
    c = s["counters"]
    assert (c["dinov2_forwards"], c["dinov2_tokens"]) == (1, 84)
    assert sum(isinstance(b.mlp, td2._SwiGLUFFN) for b in model.blocks) == 3
    assert {k for k in c if not k.endswith((DEVICE_US, DEVICE_SPANS))} == {
        "dinov2_forwards", "dinov2_tokens"}
    assert set(s["spans"]) == {"dinov2.forward"} and s["spans"]["dinov2.forward"]["count"] == 1


def test_load_jax_params_refuses_swiglu_and_registers():
    """The JAX package has neither: its parameters cannot fill such a model."""
    for cfg in (CFG, td2.Dinov2Config(**{**td2.Dinov2Config.tiny_test().__dict__,
                                         "ffn": "swiglu"}),
                td2.Dinov2Config(**{**td2.Dinov2Config.tiny_test().__dict__,
                                    "num_register_tokens": 4})):
        with pytest.raises(ValueError, match="JAX"):
            td2.load_jax_params(td2.Dinov2(cfg, device="cpu"), {})


def _meta(leaves):
    return {name: torch.empty(shape, device="meta") for name, shape, _, _ in leaves}


@pytest.mark.parametrize("name, leaves", [
    ("vit_large", lambda: weights.dinov2_shapes(VITL)),
    ("vit_giant2_reg", lambda: weights_vitg.vitg_shapes(dict(
        VITL, hidden_size=1536, num_layers=40, num_heads=24, ffn_hidden=4096,
        num_register_tokens=4))),
    ("vit_giant2", lambda: weights_vitg.vitg_shapes(dict(
        VITL, hidden_size=1536, num_layers=40, num_heads=24, ffn_hidden=4096,
        num_register_tokens=0))),
])
def test_config_is_read_from_a_full_size_hub_state_dict(name, leaves):
    """The shapes of torch hub's state dicts (no data): ``dinov2_vitl14``,
    ``dinov2_vitg14_reg`` and ``dinov2_vitg14`` each give their preset."""
    sd = _meta(leaves())
    sd["mask_token"] = torch.empty(1, sd["cls_token"].shape[-1], device="meta")
    assert td2.config_for_state_dict(sd) == getattr(td2.Dinov2Config, name)()


def test_config_of_an_unknown_state_dict_raises():
    sd = _meta(weights_vitg.vitg_shapes(dict(MODEL, num_layers=2)))
    with pytest.raises(ValueError, match="preset"):
        td2.config_for_state_dict(sd)


@pytest.mark.parametrize("layout", ["vitl", "giant_reg"])
def test_load_dinov2_reads_the_layout_from_the_state_dict(tmp_path, monkeypatch, hub_weights,
                                                          layout):
    """A hub-layout file (with its ``mask_token``) through ``load_dinov2``:
    the preset read from its keys and widths (the small configs standing
    in for ``vit_large`` and ``vit_giant2_reg``), every tensor loaded as
    it is, and ``convert_hub_state_dict`` giving the same dict."""
    monkeypatch.setattr(td2.Dinov2Config, "vit_large", staticmethod(td2.Dinov2Config.tiny_test))
    monkeypatch.setattr(td2.Dinov2Config, "vit_giant2_reg", staticmethod(lambda: CFG))
    if layout == "vitl":
        cfg = td2.Dinov2Config.tiny_test()
        sd = dict(td2.init_params(cfg, device="cpu").state_dict())
    else:
        cfg, sd = CFG, dict(hub_weights)
    sd["mask_token"] = torch.zeros(1, cfg.hidden_size)
    path = str(tmp_path / "hub.pth")
    torch.save(sd, path)
    loaded = _backends.load_dinov2(path, "cpu")
    assert loaded.cfg == cfg
    converted = td2.convert_hub_state_dict(sd, cfg)
    assert set(converted) == set(loaded.state_dict()) == set(sd) - {"mask_token"}
    assert ("register_tokens" in converted) == (layout == "giant_reg")
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
        torch.testing.assert_close(converted[k], sd[k], rtol=0, atol=0, msg=k)


def test_init_params_draws_the_new_leaves():
    """Register tokens N(0, 0.02^2) as the class token; the SwiGLU's
    matrices N(0, 0.02^2), its biases zero."""
    m = td2.init_params(td2.Dinov2Config(**{**CFG.__dict__, "hidden_size": 128,
                                            "num_heads": 2}), device="cpu")
    assert 0.015 < float(m.register_tokens.detach().std()) < 0.025
    blk = m.blocks[0].mlp
    assert (tuple(blk.w12.weight.shape), tuple(blk.w3.weight.shape)) == ((688, 128), (128, 344))
    assert 0.019 < float(blk.w12.weight.detach().std()) < 0.021
    assert not blk.w12.bias.any() and not blk.w3.bias.any()

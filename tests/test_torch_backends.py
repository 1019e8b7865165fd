"""The port's checkpoint-built backends (apps/_backends.py) against the JAX
package's.

- The SAM and GroundingDINO configs and both variant tables equal the JAX
  ones field by field, with the same error on an unknown width; a Swin of
  window 12 (Swin-B's) is held to the JAX Swin at BERT's tolerances of
  tests/test_torch_groundingdino.py (rtol 1e-4, atol 1e-5).
- A random tiny checkpoint of each family, written with ``torch.save`` in
  the reference layout (torch-hub DINOv2, huggingface SAM and
  GroundingDINO, XMem.pth) or as the JAX package's ``.npz``, loads into a
  module whose state dict is bit-equal to ``load_jax_params`` of the JAX
  ``convert_family`` of the same file. The tiny widths take the place of
  the production ones in the variant tables, on both sides, in the test only.
- The audit drops what the JAX allow-list covers and refuses anything
  else; the tokenizer's ids equal the JAX tokenizer's and huggingface
  ``BertTokenizer``'s; missing checkpoints raise. DINOv2 is built in bf16,
  as the JAX backend builds it, and ``D3F_SAM_DTYPE`` / ``D3F_GDINO_DTYPE``
  select SAM's and GroundingDINO's compute dtypes as in the JAX package;
  any other value raises.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import d3fields_tpu.apps._backends as JB
from d3fields_tpu import config as jconfig
from d3fields_tpu.models import dinov2 as jd2
from d3fields_tpu.models.groundingdino import model as jgd
from d3fields_tpu.models.groundingdino import swin as jsw
from d3fields_tpu.models.sam import model as jsam
from d3fields_tpu.utils.convert import convert_family, save_params
from d3fields_tpu_torch import config as tconfig
from d3fields_tpu_torch.apps import _backends as TB
from d3fields_tpu_torch.models import dinov2 as td2
from d3fields_tpu_torch.models.groundingdino import model as tgd
from d3fields_tpu_torch.models.groundingdino import swin as tsw
from d3fields_tpu_torch.models.sam import model as tsam
from d3fields_tpu_torch.models.xmem import network as txn
from d3fields_tpu_torch.utils.convert import audit_state_dict

from test_torch_xmem import tiny_xmem

ENV = ("D3F_DINOV2_CKPT", "D3F_SAM_CKPT", "D3F_GDINO_CKPT", "D3F_BERT_VOCAB",
       "D3F_XMEM_CKPT", "D3F_SAM_DTYPE", "D3F_GDINO_DTYPE")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


# ---------------------------------------------------------------------------
# configs and variant tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["vit_base", "vit_large", "vit_huge", "tiny_test"])
def test_sam_configs_equal_jax(name):
    assert dataclasses.asdict(getattr(tsam.SamConfig, name)()) == \
        dataclasses.asdict(getattr(jsam.SamConfig, name)())


def test_variant_tables_equal_jax():
    for w in (768, 1024, 1280):
        assert dataclasses.asdict(tsam.config_for_encoder_width(w)) == \
            dataclasses.asdict(jsam.config_for_encoder_width(w))
    for w in (96, 128):
        assert dataclasses.asdict(tgd.config_for_trunk(w)) == \
            dataclasses.asdict(jgd.config_for_trunk(w))
        assert tgd.trunk_name(w) == jgd.trunk_name(w)
    assert dataclasses.asdict(tgd.GroundingDinoConfig.swin_b()) == \
        dataclasses.asdict(jgd.GroundingDinoConfig.swin_b())
    assert dataclasses.asdict(tsw.SwinConfig.base()) == dataclasses.asdict(jsw.SwinConfig.base())
    for port, ref in ((tsam.config_for_encoder_width, jsam.config_for_encoder_width),
                      (tgd.config_for_trunk, jgd.config_for_trunk),
                      (tgd.trunk_name, jgd.trunk_name)):
        with pytest.raises(ValueError) as want:
            ref(512)
        with pytest.raises(ValueError) as got:
            port(512)
        assert str(got.value) == str(want.value)


def test_swin_window_12_matches_jax():
    """Swin-B's window 12 in a narrow four-stage Swin: a 100x130 input pads
    every stage's map (25x33, 13x17, 7x9, 4x5) to the window, and the odd
    sides take patch merging's padding."""
    cfg = tsw.SwinConfig(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 2, 4),
                         window_size=12)
    model = tsw.Swin(cfg, device="cpu")
    rs = np.random.RandomState(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if isinstance(dict(model.named_modules()).get(name.rsplit(".", 1)[0]),
                          torch.nn.LayerNorm) and name.endswith("weight"):
                p.copy_(torch.as_tensor(1.0 + 0.1 * rs.randn(*p.shape).astype(np.float32)))
            else:
                p.copy_(torch.as_tensor(0.05 * rs.randn(*p.shape).astype(np.float32)))
        for blk_table in (m.relative_position_bias_table for m in model.modules()
                          if isinstance(m, tsw._WindowSelfAttention)):
            blk_table.copy_(torch.as_tensor(rs.randn(*blk_table.shape).astype(np.float32)))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jcfg = jsw.SwinConfig(**dataclasses.asdict(cfg))
    params = jsw.convert_hf_swin(sd, jcfg)
    px = rs.randn(2, 100, 130, 3).astype(np.float32)
    ref = jsw.swin_backbone(params, jnp.asarray(px), jcfg)
    with torch.no_grad():
        got = model(torch.as_tensor(px))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref] == \
        [(2, 13, 17, 32), (2, 7, 9, 64), (2, 4, 5, 128)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# checkpoint files of each family
# ---------------------------------------------------------------------------

@pytest.fixture
def tiny_tables(monkeypatch):
    """The tiny configs in the variant tables of both packages."""
    monkeypatch.setattr(tsam, "_ENCODER_WIDTHS", {32: tsam.SamConfig.tiny_test})
    monkeypatch.setattr(jsam, "_ENCODER_WIDTHS", {32: jsam.SamConfig.tiny_test})
    monkeypatch.setattr(tgd, "_TRUNKS", {8: ("tiny", tgd.GroundingDinoConfig.tiny_test)})
    monkeypatch.setattr(jgd, "_TRUNKS", {8: ("tiny", jgd.GroundingDinoConfig.tiny_test)})
    monkeypatch.setattr(td2.Dinov2Config, "vit_large", staticmethod(td2.Dinov2Config.tiny_test))
    monkeypatch.setattr(jd2.Dinov2Config, "vit_large", staticmethod(jd2.Dinov2Config.tiny_test))


@functools.lru_cache(maxsize=None)
def _reference_state_dict(family: str):
    """A random tiny checkpoint in the family's reference layout, and the
    JAX config its converter takes."""
    if family == "dinov2_hub":
        model = td2.init_params(td2.Dinov2Config.tiny_test(), device="cpu")
        sd = dict(model.state_dict())
        sd["mask_token"] = torch.randn(1, model.cfg.hidden_size,
                                       generator=torch.Generator().manual_seed(1))
        return sd, jd2.Dinov2Config.tiny_test()
    if family == "sam":
        return dict(jsam.build_random_hf(jsam.SamConfig.tiny_test(), seed=0).state_dict()), None
    if family == "gdino":
        return dict(jgd.build_random_hf(jgd.GroundingDinoConfig.tiny_test(), seed=0)
                    .state_dict()), None
    model, _, kw = tiny_xmem(seed=3)
    return dict(model.state_dict()), jconfig.XMemConfig(**kw)


def _jax_params(family, sd):
    sd_np = {k: v.detach().numpy() for k, v in sd.items()}
    return convert_family(family, sd_np, _reference_state_dict(family)[1])[0]


def _load_port(family, path, monkeypatch):
    """The port's module, built by _backends from ``path`` on the CPU."""
    if family == "dinov2_hub":
        # the f32 model the loader returns is held bit for bit; the backend
        # runs a bf16 copy of it, as JAX _backends.py:88 builds DINOv2
        model = TB.load_dinov2(path, "cpu")
        backbone = TB.build_feature_backend(path, device="cpu")
        assert backbone.compute_dtype == "bfloat16"
        f32 = model.state_dict()
        for k, v in backbone.model.state_dict().items():
            torch.testing.assert_close(v, f32[k].to(v.dtype), rtol=0, atol=0, msg=k)
        return model
    if family == "sam":
        return TB.load_sam(path, "cpu")
    if family == "gdino":
        return TB.load_groundingdino(path, "cpu")
    _, _, xkw = tiny_xmem(seed=3)
    monkeypatch.setattr(tconfig, "XMemConfig", functools.partial(tconfig.XMemConfig, **xkw,
                                                                 size=-1))
    factory = TB.build_video_tracker_factory(path, device="cpu")
    return factory(2, 2, (32, 48)).core.model


def _carried(family, params):
    """``load_jax_params`` of the JAX tree into a fresh port module."""
    params = jax.tree.map(np.asarray, params)
    if family == "dinov2_hub":
        return td2.load_jax_params(td2.Dinov2(td2.Dinov2Config.tiny_test(), device="cpu"), params)
    if family == "sam":
        return tsam.load_jax_params(tsam.Sam(tsam.SamConfig.tiny_test(), device="cpu"), params)
    if family == "gdino":
        return tgd.load_jax_params(
            tgd.GroundingDino(tgd.GroundingDinoConfig.tiny_test(), device="cpu"), params)
    _, _, kw = tiny_xmem(seed=3)
    return txn.load_jax_params(txn.XMem(tconfig.XMemConfig(**kw), device="cpu"), params)


def _assert_bit_equal(got: torch.nn.Module, want: torch.nn.Module):
    a, b = got.state_dict(), want.state_dict()
    assert set(a) == set(b)
    for k in b:
        if k.endswith("num_batches_tracked"):
            continue  # counters: load_jax_params leaves the module's own
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


FAMILIES = ["dinov2_hub", "sam", "gdino", "xmem"]


@pytest.mark.parametrize("family", FAMILIES)
def test_torch_checkpoint_loads_as_jax_converts_it(tmp_path, monkeypatch, tiny_tables, family):
    sd = _reference_state_dict(family)[0]
    path = str(tmp_path / "ckpt.pth")
    torch.save(sd, path)
    _assert_bit_equal(_load_port(family, path, monkeypatch),
                      _carried(family, _jax_params(family, sd)))


@pytest.mark.parametrize("family", FAMILIES)
def test_npz_loads_as_jax_converts_it(tmp_path, monkeypatch, tiny_tables, family):
    """A .npz that the JAX package's save_params wrote from its converted
    tree; the SAM and Swin variants are read from the tree's leaves."""
    params = _jax_params(family, _reference_state_dict(family)[0])
    path = str(tmp_path / "params.npz")
    save_params(path, jax.tree.map(np.asarray, params))
    _assert_bit_equal(_load_port(family, path, monkeypatch), _carried(family, params))


def test_xmem_single_object_checkpoint_gets_a_zero_channel(tmp_path, monkeypatch):
    sd = dict(_reference_state_dict("xmem")[0])
    full = sd["value_encoder.conv1.weight"]
    sd["value_encoder.conv1.weight"] = full[:, :4].clone()
    path = str(tmp_path / "single.pth")
    torch.save(sd, path)
    model = _load_port("xmem", path, monkeypatch)
    w = model.state_dict()["value_encoder.conv1.weight"]
    torch.testing.assert_close(w[:, :4], full[:, :4], rtol=0, atol=0)
    assert w.shape[1] == 5 and not w[:, 4].any()
    ref = _carried("xmem", _jax_params("xmem", sd))
    _assert_bit_equal(model, ref)


def test_audit_drops_allowed_keys_and_refuses_others(tmp_path, tiny_tables):
    """A tied head (bbox_embed.1) differing from bbox_embed.0 is dropped: the
    tie loads bbox_embed.0, as the JAX converter reads it; a step counter
    is dropped; an unknown key and a missing key raise, listing the key."""
    sd = dict(_reference_state_dict("gdino")[0])
    sd["bbox_embed.1.layers.0.weight"] = torch.full_like(sd["bbox_embed.0.layers.0.weight"], 7.0)
    path = str(tmp_path / "g.pth")
    torch.save(sd, path)
    model = TB.load_groundingdino(path, "cpu")
    for name in ("bbox_embed.1", "model.decoder.bbox_embed.1"):
        torch.testing.assert_close(model.state_dict()[f"{name}.layers.0.weight"],
                                   sd["bbox_embed.0.layers.0.weight"], rtol=0, atol=0)

    xsd = dict(_reference_state_dict("xmem")[0])
    counter = next(k for k in xsd if k.endswith("num_batches_tracked"))
    xsd[counter] = torch.tensor(777)
    model = txn.XMem(tconfig.XMemConfig(**tiny_xmem(seed=3)[2]), device="cpu")
    kept = audit_state_dict(model, xsd, "xmem")
    assert int(kept[counter]) == 0
    model.load_state_dict(kept, strict=True)

    extra = dict(sd, **{"model.stray.weight": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match=r"1 tensor\(s\).*'model.stray.weight': \(3, 2\)"):
        audit_state_dict(tgd.GroundingDino(tgd.GroundingDinoConfig.tiny_test(), device="cpu"),
                            extra, "gdino")
    short = {k: v for k, v in sd.items() if k != "model.level_embed"}
    with pytest.raises(KeyError, match="model.level_embed"):
        audit_state_dict(tgd.GroundingDino(tgd.GroundingDinoConfig.tiny_test(), device="cpu"),
                            short, "gdino")


def test_tokenizer_matches_jax_and_hf_bert(tmp_path):
    """tests/test_groundingdino.py:250-290's vocab and captions."""
    from transformers import BertTokenizer

    vocab = [
        "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
        "coffee", "mug", "blue", "green", "shoe", "a", "the", "toy",
        "mickey", "'", "s", ".", ",", "/", "!", "-", "cafe", "table",
        "spoon", "on", "red", "##s", "##ful", "cup", "##board", "手", "机",
        "wooden", "block", "##e",
    ]
    vf = tmp_path / "vocab.txt"
    vf.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    hf = BertTokenizer(str(vf), do_lower_case=True)
    ours, ref = TB._wordpiece_tokenizer(str(vf)), JB._wordpiece_tokenizer(str(vf))
    captions = [
        "coffee mug.", "blue/green shoe", "Mickey's toy!", "café table",
        "spoons , cupboard", "red cups on the table.", "wooden  block\t!", "手机",
        "unknownword mug", "a cupful of coffee", "mug on the table", "red\x07 cup",
    ]
    for cap in captions:
        want = hf(cap, add_special_tokens=False)["input_ids"]
        assert ours(cap) == ref(cap) == want, cap


def test_missing_checkpoints_and_bf16_raise(tmp_path, monkeypatch):
    for port, ref in ((TB.build_feature_backend, JB.build_feature_backend),
                      (TB.build_mask_backend, JB.build_mask_backend)):
        with pytest.raises(FileNotFoundError) as want:
            ref()
        with pytest.raises(FileNotFoundError) as got:
            port(device="cpu")
        assert str(got.value) == str(want.value)
    assert TB.build_video_tracker_factory(device="cpu") is None
    assert JB.build_video_tracker_factory() is None
    for f in ("s.pth", "g.pth"):
        (tmp_path / f).write_bytes(b"")
    monkeypatch.setenv("D3F_SAM_CKPT", str(tmp_path / "s.pth"))
    monkeypatch.setenv("D3F_GDINO_CKPT", str(tmp_path / "g.pth"))
    # the dtype variables are read before the checkpoints: a bad value
    # raises, naming the variable
    for var in ("D3F_SAM_DTYPE", "D3F_GDINO_DTYPE"):
        monkeypatch.setenv(var, "float16")
        with pytest.raises(ValueError, match=f"{var}='float16'"):
            TB.build_mask_backend(device="cpu")
        monkeypatch.delenv(var)


@pytest.mark.parametrize("sam_dtype, gdino_dtype", [(None, None), ("bfloat16", None),
                                                     (None, "bfloat16"),
                                                     ("bfloat16", "bfloat16")])
def test_mask_backend_dtypes_follow_the_environment(tmp_path, monkeypatch, tiny_tables,
                                                    sam_dtype, gdino_dtype):
    """``D3F_SAM_DTYPE`` / ``D3F_GDINO_DTYPE`` (unset: float32) build the
    predictor and the detector in that dtype, as JAX ``_backends.py:127-151``
    passes them on: the SAM ViT trunk and the GroundingDINO gated trunk
    rounded to bf16, the decoders and heads f32."""
    paths = {}
    for family, var in (("sam", "D3F_SAM_CKPT"), ("gdino", "D3F_GDINO_CKPT")):
        paths[var] = tmp_path / f"{family}.pth"
        torch.save(_reference_state_dict(family)[0], paths[var])
        monkeypatch.setenv(var, str(paths[var]))
    for var, dtype in (("D3F_SAM_DTYPE", sam_dtype), ("D3F_GDINO_DTYPE", gdino_dtype)):
        if dtype is not None:
            monkeypatch.setenv(var, dtype)
    backend = TB.build_mask_backend(device="cpu")
    want = {None: torch.float32, "bfloat16": torch.bfloat16}
    sam, gdino = backend.sam.model, backend.detector.model
    assert backend.sam.compute_dtype == (sam_dtype or "float32")
    assert backend.detector.compute_dtype == (gdino_dtype or "float32")
    assert sam.vision_encoder.layers[0].attn.qkv.weight.dtype == want[sam_dtype]
    assert sam.vision_encoder.neck.conv1.weight.dtype == torch.float32
    assert sam.mask_decoder.iou_token.weight.dtype == torch.float32
    assert gdino.compute_dtype == want[gdino_dtype]
    assert gdino.model.encoder.layers[0].deformable_layer.fc1.weight.dtype == want[gdino_dtype]
    assert gdino.model.decoder.layers[0].fc1.weight.dtype == torch.float32
    assert gdino.model.text_backbone.embeddings.word_embeddings.weight.dtype == torch.float32

"""The benchmark's plain GroundingDINO and SAM references
(``port_bench/reference/``) against the port, on the CPU at tiny sizes.

Weights are the benchmark's own seeded draw (``port_bench/weights_segment.py``:
no leaf at zero or a constant). In float32 the port is held to the
reference in float64 (the ``f64`` mode); under bf16 semantics the port's
``compute_dtype="bfloat16"`` wrappers to the ``bf16`` mode. Zeroing a
mechanism's weights (relative-position tables, sampling offsets,
bi-attention gates) must move the reference's output by far more than the
tolerance, so that a fault there would show. Where ``transformers`` is
importable, the reference also agrees with huggingface's models loaded
with the same weights.
"""

import dataclasses

import numpy as np
import pytest
import torch

from d3fields_tpu_torch.models.groundingdino import model as tgd
from d3fields_tpu_torch.models.groundingdino.deform_gather import deform_gather_plain
from d3fields_tpu_torch.models.groundingdino.detector import GroundingDinoDetector
from d3fields_tpu_torch.models.sam import model as tsam
from d3fields_tpu_torch.models.sam.predictor import SamPredictor
from port_bench import weights_segment
from port_bench.reference import bert as rbert
from port_bench.reference import gdino as rgdino
from port_bench.reference import layers as rlayers
from port_bench.reference import msda as rmsda
from port_bench.reference import sam as rsam
from port_bench.reference import swin as rswin
from port_bench.reference.precision import MODES

F64, BF16 = MODES["f64"], MODES["bf16"]
QUERIES = ["mug", "red can"]
BOXES = [np.array([[3.0, 4.0, 30.0, 40.0], [10.0, 5.0, 60.0, 44.0]], np.float32),
         np.array([[0.0, 0.0, 63.0, 47.0]], np.float32)]
# float32 against float64: the port's float32 sums over the tiny models'
# ~20 layers stay within 1e-6 of the scale (measured 7e-7); 1e-4 leaves room
F32_RTOL = 1e-4
# bf16 against bf16: both round at the same boundaries and sum in f32, in
# other orders (a linear where the reference convolves, the decoder after a
# bf16 encoder): a few bf16 steps (2^-8) of the outputs' scale
BF16_RTOL = 3e-2


def close_at_scale(got, want, rtol):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    keep = torch.isfinite(want)
    assert torch.equal(keep, torch.isfinite(got))
    scale = want[keep].abs().max()
    err = (got[keep] - want[keep]).abs().max() / scale
    assert err < rtol, f"{float(err)} of the scale {float(scale)}"
    return float(err)


def moved(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    keep = torch.isfinite(a) & torch.isfinite(b)
    return float((a[keep] - b[keep]).abs().max() / a[keep].abs().max())


@pytest.fixture(scope="module")
def gd_setup():
    cfg = tgd.GroundingDinoConfig.tiny_test()
    g = dataclasses.asdict(cfg)
    g.update(short_side=64, max_side=96)
    w = weights_segment.gdino_weights(g, 2 ** 31 + 11, "cpu")
    model = tgd.GroundingDino(cfg, device="cpu")
    model.load_state_dict(w)
    images = np.random.default_rng(0).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    return g, w, model.eval(), images


@pytest.fixture(scope="module")
def sam_setup():
    cfg = tsam.SamConfig.tiny_test()
    s = dataclasses.asdict(cfg)
    w = weights_segment.sam_weights(s, 2 ** 31 + 11, "cpu")
    model = tsam.Sam(cfg, device="cpu")
    model.load_state_dict(w)
    images = np.random.default_rng(1).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    return s, w, model.eval(), images


def test_weights_draw_every_leaf(gd_setup, sam_setup):
    """Every floating leaf drawn: none zero, none constant; tied names share
    one tensor; the same seed gives the same weights."""
    for w in (gd_setup[1], sam_setup[1]):
        for k, v in w.items():
            if v.is_floating_point():
                assert v.numel() < 2 or float(v.std()) > 0, k
                assert float(v.abs().max()) > 0, k
    g, w = gd_setup[0], gd_setup[1]
    assert w["bbox_embed.0.layers.2.weight"] is w["model.decoder.bbox_embed.1.layers.2.weight"]
    again = weights_segment.gdino_weights(g, 2 ** 31 + 11, "cpu")
    assert all(torch.equal(again[k], v) for k, v in w.items())


def test_swin_matches_port(gd_setup):
    g, w, model, _ = gd_setup
    px = torch.as_tensor(np.random.default_rng(2).standard_normal((2, 3, 61, 93)),
                         dtype=torch.float32)
    with torch.no_grad():
        got = model.model.backbone.conv_encoder.model(px.permute(0, 2, 3, 1))
    wb = rlayers.cast(w, rgdino.BACKBONE, torch.float64)
    want = rswin.forward(wb, px.double(), g["swin"], F64)
    assert len(got) == len(want) == len(g["swin"]["out_stages"])
    for a, b in zip(got, want):
        close_at_scale(a.permute(0, 3, 1, 2), b, F32_RTOL)


def test_bert_matches_port(gd_setup):
    g, w, model, _ = gd_setup
    ids, _ = rgdino.caption(QUERIES)
    mask, pos = rgdino.text_masks(ids)
    np.testing.assert_array_equal(mask, tgd.generate_text_masks(ids)[0])
    np.testing.assert_array_equal(pos, tgd.generate_text_masks(ids)[1])
    ids_t, mask_t, pos_t = (torch.as_tensor(a) for a in (ids, mask, pos))
    with torch.no_grad():
        got = model.model.text_backbone(ids_t, mask_t, torch.zeros_like(ids_t), pos_t)
    tx = g["text"]
    want = rbert.forward(rlayers.cast(w, "model.text_backbone.", torch.float64), ids_t, mask_t,
                         pos_t, tx["num_heads"], tx["num_layers"], F64)
    close_at_scale(got, want, F32_RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deformable_core_matches_port(dtype):
    """Deformable DETR's grid_sample sampling against the kernel's plain
    version, a bf16 table widened to f32 on both sides; samples outside the
    map and at its edges."""
    rs = np.random.default_rng(3)
    shapes = [(9, 11), (5, 6), (3, 3)]
    S = sum(h * w for h, w in shapes)
    value = torch.as_tensor(rs.standard_normal((2, S, 4, 8)), dtype=torch.float32).to(dtype)
    loc = torch.as_tensor(rs.uniform(-0.2, 1.2, (2, 30, 4, 3, 4, 2)), dtype=torch.float32)
    att = torch.softmax(torch.as_tensor(rs.standard_normal((2, 30, 4, 12)),
                                        dtype=torch.float32), -1).reshape(2, 30, 4, 3, 4)
    got = deform_gather_plain(value, shapes, loc, att)
    want = rmsda.sample(value.double(), shapes, loc.double(), att.double())
    close_at_scale(got, want, 1e-5)


def _program_selection(detector, images, ids):
    """The port's own top proposals, read as the benchmark's driver reads
    them (forward hooks on the selection's inputs)."""
    got = {}
    m = detector.model.model
    hooks = [m.enc_output_norm.register_forward_hook(lambda mod, i, o: got.update(obj=o)),
             m.encoder.layers[-1].register_forward_hook(lambda mod, i, o: got.update(text=o[1]))]
    try:
        logits, boxes = detector.forward_views(images, ids)
    finally:
        for h in hooks:
            h.remove()
    scores = torch.matmul(got["obj"], got["text"].float().transpose(1, 2)).amax(-1)
    return logits, boxes, torch.topk(scores, detector.cfg.num_queries, dim=1).indices


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gdino_forward_matches_port(gd_setup, dtype):
    """Logits and boxes of the whole forward through the detector's
    preprocessing, the reference taking the port's query selection."""
    g, w, model, images = gd_setup
    det = GroundingDinoDetector(model, rgdino.toy_tokenize, short_side=64, max_side=96,
                                device="cpu", compute_dtype=dtype)
    ids, _ = rgdino.caption(QUERIES)
    logits, boxes, select = _program_selection(det, images, ids)
    P, rtol = (F64, F32_RTOL) if dtype == "float32" else (BF16, BF16_RTOL)
    ref = rgdino.detect(w, images, QUERIES, g, P, select=select)
    close_at_scale(logits, ref["logits"], rtol)
    close_at_scale(boxes, ref["boxes"], rtol)
    if dtype == "float32":
        assert torch.equal(ref["select"], rgdino.detect(w, images, QUERIES, g, P)["select"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sam_matches_port(sam_setup, dtype):
    """The image embeddings through the predictor's preprocessing, then
    the box decode: IoU predictions and low-resolution logits."""
    s, w, model, images = sam_setup
    pred = SamPredictor(model, device="cpu", compute_dtype=dtype).set_images(images)
    P, rtol = (F64, F32_RTOL) if dtype == "float32" else (BF16, BF16_RTOL)
    emb = rsam.embed(w, images, s, P)
    close_at_scale(pred.image_embeddings(), emb, rtol)
    boxes, view = rsam.box_prompts(BOXES, images.shape[1:3], s, "cpu")
    with torch.no_grad():
        low, iou = model.decode_boxes(pred.image_embeddings()[view], boxes)
    want_low, want_iou = rsam.decode(w, emb, boxes, view, s, P)
    close_at_scale(low, want_low, rtol)
    close_at_scale(iou, want_iou, rtol)
    logits, _ = rsam.segment_boxes(w, emb, BOXES, images.shape[1:3], s, P)
    masks = torch.cat([m for m, _ in pred.predict_boxes_views(BOXES)])
    clear = logits.abs() > 1e-3 * float(logits.abs().max())
    assert torch.equal(masks[clear], (logits > 0)[clear])


def _zeroed(w, pattern):
    return {k: (torch.zeros_like(v) if pattern in k else v) for k, v in w.items()}


@pytest.mark.parametrize("pattern", ["relative_position_bias_table", "sampling_offsets",
                                     "fusion_layer.vision_param", "fusion_layer.text_param"])
def test_gdino_mechanisms_move_the_output(gd_setup, pattern):
    """Zeroing the Swin bias tables, the sampling-offset projections or a
    bi-attention gate moves the logits or boxes by at least 100 times the
    float32 tolerance."""
    g, w, _, images = gd_setup
    base = rgdino.detect(w, images, QUERIES, g, F64)
    off = rgdino.detect(_zeroed(w, pattern), images, QUERIES, g, F64, select=base["select"])
    assert max(moved(base["logits"], off["logits"]), moved(base["boxes"], off["boxes"])) \
        > 100 * F32_RTOL


@pytest.mark.parametrize("pattern", ["rel_pos_h", "rel_pos_w"])
def test_sam_relative_positions_move_the_output(sam_setup, pattern):
    s, w, _, images = sam_setup
    assert moved(rsam.embed(w, images, s, F64), rsam.embed(_zeroed(w, pattern), images, s, F64)) \
        > 100 * F32_RTOL


def test_reference_agrees_with_huggingface(gd_setup, sam_setup):
    """huggingface's GroundingDino and Sam, loaded with the same weights."""
    pytest.importorskip("transformers")
    from transformers import (BertConfig, GroundingDinoConfig, GroundingDinoForObjectDetection,
                              SamConfig, SamModel, SwinConfig)
    from transformers.models.sam.configuration_sam import (SamMaskDecoderConfig,
                                                           SamPromptEncoderConfig,
                                                           SamVisionConfig)

    g, gw, _, images = gd_setup
    sw_, tx = g["swin"], g["text"]
    hf = GroundingDinoForObjectDetection(GroundingDinoConfig(
        backbone_config=SwinConfig(
            embed_dim=sw_["embed_dim"], depths=list(sw_["depths"]),
            num_heads=list(sw_["num_heads"]), window_size=sw_["window_size"],
            mlp_ratio=sw_["mlp_ratio"], patch_size=sw_["patch_size"],
            out_features=[f"stage{i + 1}" for i in sw_["out_stages"]]),
        text_config=BertConfig(
            vocab_size=tx["vocab_size"], hidden_size=tx["hidden_size"],
            num_hidden_layers=tx["num_layers"], num_attention_heads=tx["num_heads"],
            intermediate_size=tx["intermediate_size"], max_position_embeddings=tx["max_position"],
            type_vocab_size=tx["type_vocab_size"]),
        d_model=g["d_model"], encoder_layers=g["encoder_layers"],
        decoder_layers=g["decoder_layers"], encoder_attention_heads=g["encoder_heads"],
        decoder_attention_heads=g["decoder_heads"], encoder_ffn_dim=g["encoder_ffn_dim"],
        decoder_ffn_dim=g["decoder_ffn_dim"], num_queries=g["num_queries"],
        max_text_len=g["max_text_len"], num_feature_levels=g["num_feature_levels"])).eval()
    hf.load_state_dict(gw, strict=True)
    ids, _ = rgdino.caption(QUERIES)
    ids = torch.as_tensor(np.repeat(ids, len(images), 0))
    with torch.no_grad():
        out = hf(pixel_values=rgdino.pixels(images, g, "cpu"), input_ids=ids,
                 token_type_ids=torch.zeros_like(ids), attention_mask=torch.ones_like(ids))
    ref = rgdino.detect(gw, images, QUERIES, g, F64)
    close_at_scale(out.logits, ref["logits"], F32_RTOL)
    close_at_scale(out.pred_boxes, ref["boxes"], F32_RTOL)

    s, w, _, images = sam_setup
    hs = SamModel(SamConfig(
        vision_config=SamVisionConfig(
            hidden_size=s["hidden_size"], num_hidden_layers=s["num_layers"],
            num_attention_heads=s["num_heads"], mlp_dim=s["mlp_dim"],
            patch_size=s["patch_size"], image_size=s["image_size"],
            window_size=s["window_size"], global_attn_indexes=list(s["global_attn_indexes"]),
            output_channels=s["output_channels"], num_pos_feats=s["prompt_hidden"] // 2),
        prompt_encoder_config=SamPromptEncoderConfig(
            hidden_size=s["prompt_hidden"], image_size=s["image_size"],
            patch_size=s["patch_size"], mask_input_channels=s["mask_input_channels"]),
        mask_decoder_config=SamMaskDecoderConfig(
            hidden_size=s["prompt_hidden"], num_attention_heads=s["decoder_heads"],
            num_hidden_layers=s["decoder_layers"], mlp_dim=s["decoder_mlp_dim"],
            num_multimask_outputs=s["num_multimask_outputs"],
            iou_head_depth=s["iou_head_depth"],
            iou_head_hidden_dim=s["iou_head_hidden"]))).eval()
    hs.load_state_dict(w, strict=True)
    emb = rsam.embed(w, images, s, F64)
    boxes, view = rsam.box_prompts(BOXES, images.shape[1:3], s, "cpu")
    with torch.no_grad():
        e = hs.get_image_embeddings(rsam.pixels(images, s["image_size"], "cpu"))
        o = hs(image_embeddings=e[view], input_boxes=boxes[:, None], multimask_output=True)
    close_at_scale(e.permute(0, 2, 3, 1), emb, F32_RTOL)
    low, iou = rsam.decode(w, emb, boxes, view, s, F64)
    close_at_scale(o.pred_masks[:, 0], low, F32_RTOL)
    close_at_scale(o.iou_scores[:, 0], iou, F32_RTOL)

"""Port parity: f-BRS (HRNet-OCR, the click model, its predictor and
controller) and S2M of d3fields_tpu_torch against d3fields_tpu.

Weights are drawn with numpy at PyTorch's default convolution scale
(U(+-1/sqrt(fan_in)); the JAX ``init_params`` scale of 0.1 grows HRNet's
features to ~1e5), with random batch-norm statistics, and carried into both
packages: the JAX parameter dict as it is, the port through
``load_jax_params``. Tolerances are tests/test_interactive.py's: HRNet and
f-BRS forwards atol 2e-4, S2M atol 3e-4; the BRS loss and gradient rtol
1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3fields_tpu.models.fbrs import hrnet as jh
from d3fields_tpu.models.fbrs import model as jm
from d3fields_tpu.models.fbrs import predictor as jpred
from d3fields_tpu.models.s2m import S2MController as JS2MController
from d3fields_tpu.models.s2m import model as js2m
from d3fields_tpu_torch.models.fbrs import hrnet as th
from d3fields_tpu_torch.models.fbrs import model as tm
from d3fields_tpu_torch.models.fbrs import predictor as tpred
from d3fields_tpu_torch.models.s2m import S2MController as TS2MController
from d3fields_tpu_torch.models.s2m import model as ts2m
from d3fields_tpu_torch.utils.convert import audit_state_dict


def random_params(spec: dict, seed: int) -> dict:
    """A JAX parameter dict for a ``param_spec`` (convs {"w" HWIO, "b"},
    batch norms {"scale", "bias", "mean", "var"}), drawn with numpy."""
    rs = np.random.RandomState(seed)
    out = {}
    for k in sorted(spec):
        s = spec[k]
        if s["kind"] == "bn":
            c = s["shape"][0]
            p = {"scale": rs.uniform(0.5, 1.5, c), "bias": rs.normal(0, 0.1, c),
                 "mean": rs.normal(0, 0.1, c), "var": rs.uniform(0.5, 1.5, c)}
        else:
            b = float(np.prod(s["shape"][:3])) ** -0.5
            p = {"w": rs.uniform(-b, b, s["shape"])}
            if s["bias"]:
                p["b"] = rs.uniform(-b, b, s["shape"][-1])
        out[k] = {n: np.asarray(v, np.float32) for n, v in p.items()}
    return out


def fbrs_spec(cfg: jm.FbrsConfig) -> dict:
    spec = {f"feature_extractor.{k}": v for k, v in jh.param_spec(cfg.backbone).items()}
    spec["rgb_conv.0"] = {"kind": "conv", "shape": (1, 1, 5, 8), "bias": True}
    spec["rgb_conv.2"] = {"kind": "bn", "shape": (8,)}
    spec["rgb_conv.3"] = {"kind": "conv", "shape": (1, 1, 8, 3), "bias": True}
    return spec


def fbrs_pair(seed: int, width: int = 6):
    """(JAX params, JAX config, the port's model) of one random f-BRS. The
    class head is scaled by 10 to spread the untrained logits, which
    otherwise sit within 0.02 of 0 and leave f-BRS no room to honour a
    click within its 20 evaluations."""
    jcfg = jm.FbrsConfig(backbone=jh.HrnetConfig(width=width, ocr_width=8, small=True),
                         norm_radius=20.0)
    params = random_params(fbrs_spec(jcfg), seed)
    params["feature_extractor.cls_head"]["w"] *= 10.0
    tcfg = tm.FbrsConfig(backbone=th.HrnetConfig(width=width, ocr_width=8, small=True),
                         norm_radius=20.0)
    return params, jcfg, tm.load_jax_params(tm.FbrsModel(tcfg, device="cpu"), params)


@pytest.fixture(scope="module")
def fbrs():
    return fbrs_pair(11)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("small", [True, False])
def test_hrnet_ocr_forward_matches_jax(small):
    """Stem, three fused stages, OCR attention, the cls and aux heads."""
    cfg = jh.HrnetConfig(width=6, ocr_width=8, small=small)
    params = random_params(jh.param_spec(cfg), 1)
    net = th.load_jax_params(th.HighResolutionNet(th.HrnetConfig(6, 8, small), device="cpu"),
                             params)
    x = np.random.RandomState(1).randn(2, 48, 64, 3).astype(np.float32)
    out_j, aux_j = jax.jit(jh.forward, static_argnames="cfg")(params, cfg, jnp.asarray(x))
    with torch.no_grad():
        out_t, aux_t = net(nchw(x))
    assert out_t.shape == (2, 1, 12, 16) and aux_t.shape == (2, 1, 12, 16)
    np.testing.assert_allclose(out_t[:, 0].numpy(), np.asarray(out_j)[..., 0], atol=2e-4)
    np.testing.assert_allclose(aux_t[:, 0].numpy(), np.asarray(aux_j)[..., 0], atol=2e-4)
    # the reference's state dict: the JAX converter reads the port's back
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    back = jh.convert_torch_state_dict(sd, cfg)
    for k, p in params.items():
        for n, v in p.items():
            np.testing.assert_array_equal(np.asarray(back[k][n]), v, err_msg=f"{k}.{n}")


def test_fbrs_forward_dist_maps_and_head_match_jax(fbrs):
    """``dist_maps`` with several clicks of each polarity and unused rows;
    the forward, and the backbone features then the OCR head, on a flipped
    pair with one click of each polarity (the shapes the predictor tests
    below give the JAX executables)."""
    params, jcfg, model = fbrs
    many = np.array([[[10.0, 20.0], [30.0, 50.0], [-1.0, -1.0], [25.0, 12.0], [-1, -1], [-1, -1]],
                     [[5.5, 7.25], [-1.0, -1.0], [-1, -1], [40.0, 60.0], [1.0, 2.0], [-1, -1]]],
                    np.float32)
    ref = np.asarray(jm.dist_maps(jnp.asarray(many), (64, 80), 20.0))
    got = tm.dist_maps(torch.from_numpy(many), (64, 80), 20.0).numpy()
    np.testing.assert_allclose(got, ref.transpose(0, 3, 1, 2), atol=1e-6)
    rs = np.random.RandomState(2)
    img = rs.randn(2, 64, 80, 3).astype(np.float32)
    pts = np.array([[[10.0, 20.0], [30.0, 50.0]], [[5.5, 7.25], [-1.0, -1.0]]], np.float32)
    ref = np.asarray(jm.forward_jit(params, jcfg, jnp.asarray(img), jnp.asarray(pts)))
    with torch.no_grad():
        out = model(nchw(img), torch.from_numpy(pts))
        feats = model.backbone_feats(nchw(img), torch.from_numpy(pts))
        head = model.head_from_feats(feats, (64, 80))
    assert out.shape == (2, 1, 64, 80)
    np.testing.assert_allclose(out[:, 0].numpy(), ref[..., 0], atol=2e-4)
    jfeats = np.asarray(jax.jit(jm.backbone_feats, static_argnames=("cfg",))(
        params, jcfg, jnp.asarray(img), jnp.asarray(pts)))
    np.testing.assert_allclose(feats.numpy(), jfeats.transpose(0, 3, 1, 2), atol=2e-4)
    ref = np.asarray(jax.jit(jm.head_from_feats, static_argnames=("cfg", "out_hw"))(
        params, jcfg, jnp.asarray(jfeats), (64, 80)))
    np.testing.assert_allclose(head[:, 0].numpy(), ref[..., 0], atol=2e-4)


def test_fbrs_state_dict_loads_natively_and_sniffs_its_config(fbrs):
    """The reference ``fbrs.pth`` layout: ``detect_config`` reads width, OCR
    width and ``small`` from it (as the JAX one does), the audit passes it
    with the batch-norm counters, and the JAX converter reads it back."""
    params, jcfg, model = fbrs
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = tm.detect_config(sd, norm_radius=20.0)
    assert cfg == tm.FbrsConfig(th.HrnetConfig(6, 8, True), 20.0)
    np_sd = {k: v.numpy() for k, v in sd.items()}
    assert jm.detect_config(np_sd).backbone == jh.HrnetConfig(width=6, ocr_width=8, small=True)
    fresh = tm.FbrsModel(cfg, device="cpu")
    fresh.load_state_dict(audit_state_dict(fresh, sd, "fbrs"), strict=True)
    back, _ = jm.convert_torch_state_dict(np_sd)
    for k, p in params.items():
        for n, v in p.items():
            np.testing.assert_array_equal(np.asarray(back[k][n]), v, err_msg=f"{k}.{n}")


def test_brs_loss_and_gradient_match_jax(fbrs):
    """``brs_loss`` and its ``torch.autograd.grad`` against the JAX
    predictor's ``_val_grad`` at three (scale, bias) points, on the cached
    features of a flipped batch with mirrored click stamps."""
    params, jcfg, model = fbrs
    rs = np.random.RandomState(3)
    img = rs.rand(64, 80, 3).astype(np.float32)
    clicks = [jpred.Click(True, (20.0, 30.0)), jpred.Click(False, (35.0, 50.0))]
    jp = jpred.FbrsPredictor(params, jcfg, brs=True, with_flip=True)
    tp = tpred.FbrsPredictor(model, brs=True, with_flip=True, device="cpu")
    pts = jpred._points_array(clicks, 8)
    flipped = pts.copy()
    flipped[..., 1] = np.where(flipped.max(-1) >= 0, 79 - flipped[..., 1], flipped[..., 1])
    pts = np.concatenate([pts, flipped])
    image = np.concatenate([img[None], img[None, :, ::-1]])
    pos, neg = jpred._click_masks(clicks, (64, 80))
    pos = np.concatenate([pos, pos[:, :, ::-1]])
    neg = np.concatenate([neg, neg[:, :, ::-1]])
    jfeats = jp._feats_fn(jp.params, jcfg, jnp.asarray(image), jnp.asarray(pts))
    with torch.no_grad():
        tp.input_data = model.backbone_feats(nchw(image), torch.from_numpy(pts))
    C = 2 * jcfg.backbone.feats_channels
    for k, sb in enumerate([np.zeros(C, np.float32), rs.normal(0, 0.05, C).astype(np.float32),
                            rs.normal(0, 0.3, C).astype(np.float32)]):
        (loss_j, aux_j), grad_j = jp._val_grad(jp.params, jfeats, jnp.asarray(sb),
                                               jnp.asarray(pos), jnp.asarray(neg), (64, 80))
        loss_t, grad_t, logits_t, _, fpos_t, fneg_t = tp.val_grad(
            sb, torch.from_numpy(pos), torch.from_numpy(neg), (64, 80))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4, atol=1e-5,
                                   err_msg=f"point {k}")
        np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), rtol=1e-4, atol=1e-5,
                                   err_msg=f"point {k}")
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(aux_j[0]), atol=2e-4)
        np.testing.assert_allclose([float(fpos_t), float(fneg_t)],
                                   [float(aux_j[1]), float(aux_j[2])], rtol=1e-4, atol=1e-5)
        assert np.abs(np.asarray(grad_j)).max() > 1e-4  # a gradient worth comparing


def test_nobrs_prediction_with_zoom_in_matches_jax(fbrs):
    """The NoBRS click pipeline (click layout, flip with logit averaging,
    the zoom-in crop with its click remapping and paste-back) over a
    4-click sequence, click for click."""
    params, jcfg, model = fbrs
    zoom = dict(target_size=48, skip_clicks=1, expansion_ratio=1.4, min_crop_size=20)
    jp = jpred.FbrsPredictor(params, jcfg, brs=False, with_flip=True, zoom_in=jpred.ZoomIn(**zoom))
    tp = tpred.FbrsPredictor(model, brs=False, with_flip=True, zoom_in=tpred.ZoomIn(**zoom),
                             device="cpu")
    img = np.random.RandomState(8).rand(64, 80, 3).astype(np.float32)
    jp.set_input_image(img)
    tp.set_input_image(img)
    jc, tc = jpred.Clicker(), tpred.Clicker()
    seq = [(True, (20.0, 30.0)), (True, (28.0, 44.0)), (False, (50.0, 70.0)),
           (True, (24.0, 36.0))]
    engaged = 0
    for i, (positive, yx) in enumerate(seq):
        jc.add_click(jpred.Click(positive, yx))
        tc.add_click(tpred.Click(positive, yx))
        ref, got = jp.get_prediction(jc), tp.get_prediction(tc)
        assert got.shape == (64, 80)
        np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=f"click {i}")
        assert tp.zoom_in._object_roi == jp.zoom_in._object_roi
        engaged += tp.zoom_in._object_roi is not None
    assert engaged >= 2  # the zoom-in crop was taken


def test_fbrs_controller_matches_jax_and_brs_behaves(fbrs):
    """Two clicks through ``FBRSController`` (f-BRS-B with its L-BFGS-B
    search, the flip, the zoom-in from the second click) against the JAX
    controller; then the behaviour of tests/test_interactive.py:187-245:
    the positive click is honoured, the negative click's probability falls
    below the NoBRS one, undo gives back the exact earlier mask and a
    repeated click the same one."""
    params, jcfg, model = fbrs
    ctl = tpred.FBRSController(model, target_size=48, device="cpu")
    jctl = jpred.FBRSController(params, jcfg, target_size=48)
    img = np.random.RandomState(9).rand(64, 80, 3).astype(np.float32)
    masks = []
    for x, y, positive in ((30, 20, True), (60, 45, False)):
        m, jm_ = ctl.interact(img, x, y, positive), jctl.interact(img, x, y, positive)
        assert m.shape == (64, 80) and m.dtype == bool
        np.testing.assert_allclose(ctl.probs_history[-1], jctl.probs_history[-1], atol=1e-5)
        np.testing.assert_array_equal(m, jm_)
        masks.append(m)
    assert ctl.predictor.evaluations >= 1  # the L-BFGS search ran
    assert ctl.predictor.zoom_in._object_roi is not None
    p2 = ctl.probs_history[-1]
    assert p2[20, 30] > 0.5, "positive click not honoured after BRS"
    plain = tpred.FbrsPredictor(model, brs=False, with_flip=True, zoom_in=None, device="cpu")
    plain.set_input_image(img)
    clicker = tpred.Clicker()
    clicker.add_click(tpred.Click(True, (20.0, 30.0)))
    clicker.add_click(tpred.Click(False, (45.0, 60.0)))
    p_plain = plain.get_prediction(clicker)
    assert p2[45, 60] < p_plain[45, 60], (p2[45, 60], p_plain[45, 60])
    np.testing.assert_array_equal(ctl.undo(), masks[0])
    np.testing.assert_array_equal(ctl.interact(img, x=60, y=45, is_positive=False), masks[1])


# ---------------------------------------------------------------------------
# S2M
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def s2m():
    params = random_params(js2m.param_spec(js2m.S2mConfig()), 5)
    return params, ts2m.load_jax_params(ts2m.S2M(device="cpu"), params)


def test_s2m_forward_matches_jax(s2m):
    """DeepLabV3+ over the 6-channel ResNet-50: dilated layer4, ASPP with
    its pooled branch, the low-level projection."""
    params, model = s2m
    x = np.random.RandomState(4).randn(1, 64, 96, 6).astype(np.float32)
    ref = np.asarray(js2m.forward_jit(params, js2m.S2mConfig(), jnp.asarray(x)))
    with torch.no_grad():
        got = model(nchw(x))
    assert got.shape == (1, 1, 64, 96)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got[:, 0].numpy(), ref[..., 0], atol=3e-4)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    fresh = ts2m.S2M(device="cpu")
    fresh.load_state_dict(audit_state_dict(fresh, sd, "s2m"), strict=True)


def test_s2m_controller_matches_jax(s2m):
    """The scribble interaction: per-object channels, the /16 pad and
    unpad, the sigmoid; two objects, one entering by its scribble."""
    params, model = s2m
    rs = np.random.RandomState(6)
    img = rs.rand(56, 72, 3).astype(np.float32)
    prev = np.zeros((56, 72), np.uint8)
    prev[10:30, 20:40] = 1
    scr = np.full((56, 72), 255, np.uint8)
    scr[12:18, 22:30] = 1
    scr[40:46, 50:60] = 2
    scr[5:8, 5:10] = 0
    ref = JS2MController(params, num_objects=2).interact(img, prev, scr)
    got = TS2MController(model, num_objects=2, device="cpu").interact(img, prev, scr)
    assert got.shape == ref.shape == (2, 56, 72)
    np.testing.assert_allclose(got, ref, atol=3e-4)

"""The plain reference agrees with itself and with the published operations
it is written from, on a tiny rig."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from port_bench import weights
from port_bench.reference import dinov2 as ref_dinov2
from port_bench.reference import field
from port_bench.reference.precision import MODES, fp8, round_tf32
from port_bench.reference.resize import pil_bilinear_u8
from port_bench.rig import Rig, query_points

RIG = {"focal": 52.0, "positions": 4, "drift_per_frame": [[0.008, 0.004, 0.0],
                                                          [-0.005, 0.006, 0.0]],
       "texture_waves": 3, "texture_wavelength_m": [0.04, 0.10]}
TINY = {"hidden_size": 64, "num_layers": 2, "num_heads": 4, "mlp_ratio": 4, "patch_size": 14,
        "image_size": 56}
F64 = MODES["f64"]


def frame_tensors(seed=3):
    rig = Rig(seed, 4, 48, 64, RIG)
    f = rig.render(1)
    return f, {k: torch.as_tensor(f[k]) for k in ("depth", "pose", "K", "mask")}


@pytest.mark.parametrize("shape,out", [((2, 48, 64, 3), (56, 84)), ((1, 240, 320, 3), (336, 448)),
                                       ((1, 50, 70, 3), (28, 42))])
def test_pil_resize_matches_the_ports_and_pillows(shape, out):
    from d3fields_tpu_torch.models.resize import pil_bilinear_resize_u8

    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    ours = pil_bilinear_u8(img, out)
    np.testing.assert_array_equal(ours, pil_bilinear_resize_u8(torch.as_tensor(img), out).numpy())
    Image = pytest.importorskip("PIL.Image")
    pil = np.asarray(Image.fromarray(img[0]).resize(out[::-1], Image.BILINEAR))
    np.testing.assert_array_equal(ours[0], pil)


def test_field_taps_match_grid_sample():
    f, obs = frame_tensors()
    desc = torch.randn(4, 4, 6, 16, dtype=torch.float64)
    pts = torch.as_tensor(query_points(5, 4096, 1, [[-0.3, -0.4, 0.0], [0.6, 0.4, 0.4]])[0])
    out = field.query(obs, desc, pts, 0.02, F64)
    xy, z, front, zf = field.project(pts.double(), obs["pose"].double(), obs["K"].double(), F64)
    H, W = 48, 64
    grid = torch.stack([xy[..., 0] / (W - 1) * 2 - 1, xy[..., 1] / (H - 1) * 2 - 1], -1)[:, :, None]
    inter = F.grid_sample(obs["depth"].double()[:, None], grid, mode="nearest",
                          align_corners=True)[:, 0, :, 0]
    d = inter - zf
    valid = (inter > 0) & front & (d > -0.02)
    w = torch.exp(torch.clamp(0.02 - d.abs(), max=0) / 0.02) * valid
    cnt = valid.double().sum(0)
    for name, m in (("dino_feats", desc), ("mask", obs["mask"].double())):
        s = F.grid_sample(m.permute(0, 3, 1, 2), grid, mode="bilinear", align_corners=True)
        want = (s[..., 0] * w[:, None]).sum(0).T / (cnt[:, None] + 1e-6)
        keep = ~out["ambiguous"]
        torch.testing.assert_close(out[name][keep], want[keep], rtol=1e-12, atol=1e-12)
    dist = (torch.clamp(d, -0.02, 0.02) * valid).sum(0) / (cnt + 1e-6)
    dist = torch.where(cnt == 0, torch.full_like(dist, 1e3), dist)
    torch.testing.assert_close(out["dist"], dist, rtol=1e-12, atol=1e-12)
    assert 0 < out["ambiguous"].double().mean() < 0.05


def test_field_agrees_with_the_ports_eval_field():
    from d3fields_tpu_torch.fields.fusion import eval_field
    from d3fields_tpu_torch.fields.state import state_from_obs

    f, obs = frame_tensors()
    desc = torch.randn(4, 4, 6, 32)
    pts = torch.as_tensor(query_points(6, 8192, 1, [[-0.3, -0.4, 0.0], [0.6, 0.4, 0.4]])[0])
    ours = field.query(obs, desc.double(), pts, 0.02, F64)
    st = state_from_obs(f, dino_feats=desc, mask=f["mask"], device="cpu")
    port = eval_field(st, pts)
    keep = ~ours["ambiguous"]
    assert torch.equal(port["valid_mask"][keep], ours["valid_mask"][keep])
    for k, tol in (("dist", 1e-6), ("mask", 1e-4), ("dino_feats", 1e-4)):
        assert float((port[k].double() - ours[k])[keep].abs().max()) < tol


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_vit_agrees_with_the_ports_dinov2(compute_dtype):
    from d3fields_tpu_torch.models import dinov2

    f, _ = frame_tensors()
    w = weights.dinov2_weights(TINY, 11, "cpu")
    cfg = dinov2.Dinov2Config(**{k: TINY[k] for k in ("hidden_size", "num_layers", "num_heads",
                                                      "mlp_ratio", "patch_size", "image_size")})
    model = dinov2.Dinov2(cfg, device="cpu")
    model.load_state_dict(w)
    port = dinov2.Dinov2Backbone(model, compute_dtype=compute_dtype, device="cpu")(
        f["color"], patch_hw=(4, 6))
    P = MODES["f64" if compute_dtype == "float32" else "bf16"]
    ref = ref_dinov2.descriptors(w, f["color"], TINY, (4, 6), P)
    err = float(((port.double() - ref.double()).norm(dim=-1) / ref.double().norm(dim=-1)).max())
    assert err < (1e-5 if compute_dtype == "float32" else 2e-2)


def test_lower_precisions_round_as_stated():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -12, 1.0 + 2 ** -10])
    r = round_tf32(x)
    assert r.tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -1.0, 1.0 + 2 ** -10]  # ties to even
    y = torch.linspace(-3, 3, 101)
    q = fp8(y)
    assert float((q - y).abs().max()) <= 3 / 448 * 16 and float((q - y).abs().max()) > 0
    assert len(torch.unique(q)) < 101

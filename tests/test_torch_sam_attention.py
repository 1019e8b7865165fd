"""SAM's vision attention (``models/attention.py``) and its CUDA kernel
(``csrc/sam_attention.cu``).

On the CPU: the plain version is the composition ``_VisionAttention``
computed before the kernel, bit for bit in f32; the kernel's bias terms
rebuild the plain bias; the CPU launches nothing; the kernel's refusals. On
the card (marked ``cuda``, skipped elsewhere): the kernel against the plain
chain at ViT-H's global and window shapes in both routes, its counters over
a ViT-H encode, its raises, and no (B*nh, L, L) tensor in a global layer.
This file imports no JAX, so that the card tests run on a machine without
it: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_sam_attention.py``.
"""

import numpy as np
import pytest
import torch

from d3fields_tpu_torch.models import attention as sa
from d3fields_tpu_torch.models.sam import model as sm
from d3fields_tpu_torch.models.sam.predictor import SamPredictor
from d3fields_tpu_torch.utils.profiling import tracer

# the budget of tests/test_torch_sam.py::test_bf16_encoder_matches_jax_bf16
# (JAX tests/test_sam.py:212): bf16 against its f32 counterpart, cosine of
# each embedding row above 0.995; here each output row of the attention
BF16_MIN_COS = 0.995
F32_RTOL = 1e-5  # the kernel sums in another order and takes expf of f32 logits


def composition(attn: sm._VisionAttention, x: torch.Tensor) -> torch.Tensor:
    """``_VisionAttention.forward`` as it was before the kernel: the oracle
    of the plain version."""
    B, h, w, C = x.shape
    nh = attn.num_heads
    hd = C // nh
    qkv = attn.qkv(x.reshape(B, h * w, C)).reshape(B, h * w, 3, nh, hd)
    qkv = qkv.permute(2, 0, 3, 1, 4).reshape(3, B * nh, h * w, hd)
    q, k, v = qkv[0], qkv[1], qkv[2]
    logits = torch.matmul(q * (hd ** -0.5), k.transpose(-1, -2))
    idx_h = torch.arange(h)[:, None] - torch.arange(h)[None] + h - 1
    idx_w = torch.arange(w)[:, None] - torch.arange(w)[None] + w - 1
    q4 = q.reshape(q.shape[0], h, w, -1)
    bias_h = torch.einsum("bhwc,hkc->bhwk", q4, attn.rel_pos_h[idx_h])
    bias_w = torch.einsum("bhwc,wkc->bhwk", q4, attn.rel_pos_w[idx_w])
    logits.add_((bias_h[..., :, None] + bias_w[..., None, :]).reshape(-1, h * w, h * w))
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = torch.matmul(probs, v).reshape(B, nh, h, w, hd).permute(0, 2, 3, 1, 4)
    return attn.proj(out.reshape(B, h, w, C))


def random_attention(dim: int, nh: int, rel_size: int, seed: int, device="cpu"):
    attn = sm._VisionAttention(dim, nh, rel_size, device)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (0.3 if p.dim() == 2 else 0.1))
    return attn


def windows(views: int, grid: int, dim: int, window: int, seed: int) -> torch.Tensor:
    """A (views, grid, grid, dim) map cut into zero-padded windows, as
    ``_VisionLayer`` hands them to the attention."""
    x = np.random.RandomState(seed).randn(views, grid, grid, dim).astype(np.float32)
    x = torch.as_tensor(x)
    return sm._window_partition(x, window)[0]


# name: (heads, head width, grid, window (0: global))
CASES = {
    "tiny_test": (2, 16, 8, 14),      # SamConfig.tiny_test: an 8x8 grid padded to a 14-window
    "hd64_window": (2, 64, 10, 14),   # ViT-B/L's width, padded zero tokens as keys
    "hd80_window": (2, 80, 17, 14),   # ViT-H's width: 2x2 windows, the last ones padded
    "global16": (2, 80, 16, 0),       # a 16x16 global grid
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_is_the_composition_it_replaced(case):
    nh, hd, grid, window = CASES[case]
    dim = nh * hd
    attn = random_attention(dim, nh, window or grid, seed=len(case))
    if window:
        x = windows(2, grid, dim, window, seed=3)
        assert x.shape[1:3] == (window, window)
    else:
        x = torch.as_tensor(np.random.RandomState(4).randn(2, grid, grid, dim).astype(np.float32))
    launches = sa.sam_attention.launches
    with torch.no_grad():
        got, want = attn(x), composition(attn, x)
    assert torch.equal(got, want)
    assert sa.sam_attention.launches == launches


def test_plain_version_keeps_the_trunk_dtype():
    attn = random_attention(32, 2, 14, seed=5).to(torch.bfloat16)
    x = windows(1, 8, 32, 14, seed=6).to(torch.bfloat16)
    with torch.no_grad():
        got, want = attn(x), composition(attn, x)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("hw", [(14, 14), (8, 8), (5, 7), (64, 3)])
def test_bias_rows_rebuild_the_plain_bias(hw):
    """The kernel's bias terms, gathered and scaled as it gathers and scales
    them, against ``rel_pos_bias``; q read as a strided view of qkv, as on
    the card."""
    h, w = hw
    B, nh, hd, L = 2, 3, 16, h * w
    gen = torch.Generator().manual_seed(h * w)
    qkv = torch.randn((B, L, 3, nh, hd), generator=gen)
    rel_h = torch.randn((2 * h - 1, hd), generator=gen)
    rel_w = torch.randn((2 * w - 1, hd), generator=gen)
    q = qkv[:, :, 0]
    rows = sa.bias_rows(q, rel_h, rel_w)
    ph, pw = sa.padded(2 * h - 1), sa.padded(2 * w - 1)
    assert rows.shape == (nh, B, L, ph + pw) and rows.is_contiguous()
    assert ph % 8 == 0 and pw % 8 == 0
    i = torch.arange(L)
    gh, gw = i // w, i % w
    col_h = (gh[:, None] - gh[None] + h - 1).expand(nh, B, L, L)
    col_w = (ph + gw[:, None] - gw[None] + w - 1).expand(nh, B, L, L)
    got = (rows.gather(-1, col_h) + rows.gather(-1, col_w)) * hd ** -0.5
    want = sa.rel_pos_bias(hw, rel_h, rel_w, q.permute(0, 2, 1, 3).reshape(B * nh, L, hd))
    torch.testing.assert_close(got.transpose(0, 1).reshape(B * nh, L, L), want,
                               rtol=1e-5, atol=1e-5)


def test_cpu_launches_and_counts_nothing():
    attn = random_attention(32, 2, 8, seed=7)
    x = torch.randn(1, 8, 8, 32)
    before = (sa.sam_attention.launches, sa.sam_attention.launches_bf16)
    tracer.reset()
    tracer.enable()
    try:
        with torch.no_grad(), tracer.span("seg.sam.encode"):
            attn(x)
        counters = tracer.summary()["counters"]
    finally:
        tracer.disable()
        tracer.reset()
    assert "sam_attn" not in counters
    assert (sa.sam_attention.launches, sa.sam_attention.launches_bf16) == before


def qkv_of(B, hw, nh, hd, dtype=torch.float32, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    h, w = hw
    qkv = torch.randn((B, h * w, 3 * nh * hd), generator=gen, device=device)
    rel_h = torch.randn((2 * h - 1, hd), generator=gen, device=device) * 0.1
    rel_w = torch.randn((2 * w - 1, hd), generator=gen, device=device) * 0.1
    return (qkv.reshape(B, h * w, 3, nh, hd).to(dtype), rel_h.to(dtype), rel_w.to(dtype))


def odd_offset(dev):
    """qkv whose rows start at an odd element: not 16-byte aligned."""
    flat = torch.randn((2, 196 * 96 + 1), device=dev)[:, 1:]
    _, rel_h, rel_w = qkv_of(2, (14, 14), 2, 16, device=dev)
    return flat.reshape(2, 196, 3, 2, 16), rel_h, rel_w


def strided_last_dim(dev):
    qkv, rel_h, rel_w = qkv_of(2, (4, 4), 16, 16, device=dev)
    return qkv.transpose(3, 4).contiguous().transpose(3, 4), rel_h, rel_w


# what the kernel does not take, made on a device
REFUSED = {
    "head_width": lambda dev: qkv_of(2, (14, 14), 2, 32, device=dev),
    "float16": lambda dev: qkv_of(2, (14, 14), 2, 16, torch.float16, dev),
    "table_dtype": lambda dev: (lambda q, h, w: (q, h.double(), w))(
        *qkv_of(2, (14, 14), 2, 16, device=dev)),
    "stride": odd_offset,
    "last_dim_strided": strided_last_dim,
    "wide_tables": lambda dev: qkv_of(1, (2, 300), 1, 16, device=dev),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_kernel_refuses_what_it_does_not_take(case):
    qkv, rel_h, rel_w = REFUSED[case]("cpu")
    hw = (rel_h.shape[0] + 1) // 2, (rel_w.shape[0] + 1) // 2
    assert sa.kernel_refusal(qkv, rel_h, rel_w, hw) is not None


@pytest.mark.parametrize("hd", sa.KERNEL_HEAD_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_the_projection_layout(hd, dtype):
    qkv, rel_h, rel_w = qkv_of(2, (14, 14), 2, hd, dtype)
    assert sa.kernel_refusal(qkv, rel_h, rel_w, (14, 14)) is None


def test_malformed_inputs_raise():
    qkv, rel_h, rel_w = qkv_of(1, (4, 4), 2, 16)
    with pytest.raises(ValueError, match="h\\*w"):
        sa.sam_attention(qkv, rel_h, rel_w, (4, 5))
    with pytest.raises(ValueError, match="do not fit"):
        sa.sam_attention(qkv, rel_h[:-1], rel_w, (4, 4))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# ViT-H: a global layer over 4 views, a windowed layer's 4 x 25 windows
VIT_H = {"global": (4, (64, 64)), "window": (100, (14, 14))}


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(VIT_H))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_the_plain_chain_at_vit_h_shapes(cuda, shape, dtype):
    B, hw = VIT_H[shape]
    qkv, rel_h, rel_w = qkv_of(B, hw, 16, 80, dtype, cuda, seed=11)
    launches = sa.sam_attention.launches
    with torch.no_grad():
        got = sa.sam_attention(qkv, rel_h, rel_w, hw)
        torch.cuda.synchronize()
        assert sa.sam_attention.launches == launches + 1
        want = sa.sam_attention_plain(qkv, rel_h, rel_w, hw)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=F32_RTOL,
                                       atol=F32_RTOL * float(want.abs().max()))
            return
        cos = torch.nn.functional.cosine_similarity(got.float(), want.float(), dim=-1)
        assert float(cos.min()) > BF16_MIN_COS
        # the logits stay f32 in the kernel: at least as close to the f32
        # chain on the same bf16 inputs as the bf16 chain is
        exact = sa.sam_attention_plain(qkv.float(), rel_h.float(), rel_w.float(), hw)
        assert rel_l2(got, exact) <= rel_l2(want, exact)


@pytest.mark.cuda
def test_a_vit_h_encode_launches_once_a_layer(cuda):
    model = sm.init_params(sm.SamConfig.vit_huge(), device=cuda)
    rgb = np.random.RandomState(2).randint(0, 255, (1, 240, 320, 3)).astype(np.uint8)
    for dtype, bf16 in (("float32", 0), ("bfloat16", 32)):
        pred = SamPredictor(model, device=cuda, compute_dtype=dtype)
        before = (sa.sam_attention.launches, sa.sam_attention.launches_bf16)
        tracer.reset()
        tracer.enable()
        try:
            pred.set_images(rgb)
            torch.cuda.synchronize()
            summary = tracer.summary()
        finally:
            tracer.disable()
            tracer.reset()
        assert (sa.sam_attention.launches - before[0],
                sa.sam_attention.launches_bf16 - before[1]) == (32, bf16)
        assert summary["counters"]["sam_attn"] == 32
        assert summary["counters_by_span"]["seg.sam.encode"]["sam_attn"] == 32


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(REFUSED))
def test_the_card_raises_where_the_kernel_refuses(cuda, case):
    qkv, rel_h, rel_w = REFUSED[case](cuda)
    hw = (rel_h.shape[0] + 1) // 2, (rel_w.shape[0] + 1) // 2
    launches = sa.sam_attention.launches
    with pytest.raises(ValueError):
        sa.sam_attention(qkv, rel_h, rel_w, hw)
    assert sa.sam_attention.launches == launches


@pytest.mark.cuda
def test_no_logits_sized_tensor_in_a_global_layer(cuda):
    cfg = sm.SamConfig.vit_huge()
    layer = sm._VisionLayer(cfg, 0, cuda).to(torch.bfloat16)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0, 0.02)
    B, L, nh = 4, cfg.grid ** 2, cfg.num_heads
    x = torch.randn((B, cfg.grid, cfg.grid, cfg.hidden_size), device=cuda, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        layer(x)
    torch.cuda.synchronize()
    logits_bytes = B * nh * L * L * 2  # one bf16 (B*nh, L, L) tensor: 2.1 GB
    assert torch.cuda.max_memory_allocated() - base < logits_bytes // 4


def test_the_benchmark_reads_the_launches_a_request():
    from port_bench import harness

    read = harness.reader("sam_attn_launches.segment")
    assert read({"program_counters": {"sam_attn": 96, "seg_boxes": 30},
                 "traced_requests": 3}) == 32
    # a program without the counter (the kernel's parent) reads nothing
    assert read({"program_counters": {"seg_boxes": 30}, "traced_requests": 3}) is None
    assert read({"traced_requests": 3}) is None

"""DINOv2's attention (``models/attention.py::vit_attention``) and the
bias-free mode of its CUDA kernel (``csrc/sam_attention.cu``).

On the CPU: ``_Attention.forward`` is the chain it computed before the
kernel, bit for bit in f32 and bf16; the CPU launches nothing; the
refusals, each with its own reason; the wrapper's shape checks; the
benchmark's reader of the launches. On the card (marked ``cuda``, skipped
elsewhere): the kernel against the plain chain at ViT-L's shape over 4
views and at ragged sequence lengths in both routes, a full bf16 ViT-L
backbone against its CPU output, the raises, and no (B*nh, L, L) tensor.
This file imports no JAX, so that the card tests run on a machine without
it: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_dinov2_attention.py``.
"""

import numpy as np
import pytest
import torch

from d3fields_tpu_torch.models import attention as at
from d3fields_tpu_torch.models import dinov2 as d2
from d3fields_tpu_torch.utils.profiling import tracer

# tests/test_dinov2.py:99: bf16 patch tokens against f32, 1 - cos < 1e-3
TOKEN_MAX_COS_DEFICIT = 1e-3
# the attention rows, as tests/test_torch_sam_attention.py holds SAM's
BF16_MIN_COS = 0.995
F32_RTOL = 1e-5  # the kernel sums in another order and takes expf of f32 logits


def composition(attn: d2._Attention, x: torch.Tensor) -> torch.Tensor:
    """``_Attention.forward`` as it was before the kernel: the oracle of the
    plain version."""
    B, N, D = x.shape
    nh = attn.num_heads
    qkv = attn.qkv(x).reshape(B, N, 3, nh, D // nh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * (1.0 / np.sqrt(D // nh))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(B, N, D)
    return attn.proj(out)


def random_attention(dim: int, nh: int, seed: int, device="cpu") -> d2._Attention:
    attn = d2._Attention(dim, nh, device)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (0.2 if p.dim() == 2 else 0.1))
    return attn


# name: (heads, head width, tokens)
CASES = {
    "tiny_test": (4, 16, 17),    # Dinov2Config.tiny_test: a 4x4 grid and CLS
    "vit_l_heads": (2, 64, 65),  # ViT-L's head width, a ragged last key tile
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CASES))
def test_cpu_forward_is_the_chain_it_replaced(case, dtype):
    nh, hd, N = CASES[case]
    attn = random_attention(nh * hd, nh, seed=len(case)).to(dtype)
    x = torch.as_tensor(np.random.RandomState(3).randn(2, N, nh * hd).astype(np.float32))
    x = x.to(dtype)
    before = (at.vit_attention.launches, at.vit_attention.launches_bf16)
    tracer.reset()
    tracer.enable()
    try:
        with torch.no_grad():
            got, want = attn(x), composition(attn, x)
        counters = tracer.summary()["counters"]
    finally:
        tracer.disable()
        tracer.reset()
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert (at.vit_attention.launches, at.vit_attention.launches_bf16) == before
    assert "dinov2_attn" not in counters


def qkv_of(B, L, nh, hd, dtype=torch.float32, device="cpu", seed=0):
    """qkv (B, L, 3, nh, hd) as the projection writes it: a view of (B, L,
    3*nh*hd) rows; N(0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((B, L, 3 * nh * hd), generator=gen, device=device)
    return qkv.reshape(B, L, 3, nh, hd).to(dtype)


def odd_offset(dev):
    """qkv whose rows start at an odd element: not 16-byte aligned."""
    flat = torch.randn((2, 17 * 3 * 2 * 64 + 1), device=dev)[:, 1:]
    return flat.reshape(2, 17, 3, 2, 64)


def broadcast(B, L, nh):
    """A (B, L, 3, nh, 64) qkv of one stored row (zero strides): the
    limits' shapes without their memory."""
    return lambda dev: torch.zeros((1, 1, 3, 1, 64), device=dev).expand(B, L, 3, nh, 64)


# what the bias-free mode does not take, made on a device, and the words of its reason
REFUSED = {
    "head_width": (lambda dev: qkv_of(2, 17, 2, 80, device=dev), "head widths"),
    "tiny_head_width": (lambda dev: qkv_of(2, 17, 4, 16, device=dev), "head widths"),
    "float16": (lambda dev: qkv_of(2, 17, 2, 64, torch.float16, dev), "float32 or bfloat16"),
    "stride": (odd_offset, "16-byte rows"),
    "last_dim_strided": (lambda dev: qkv_of(2, 17, 2, 64, device=dev).transpose(3, 4)
                         .contiguous().transpose(3, 4), "16-byte rows"),
    "sequence": (broadcast(1, 2 ** 30, 1), "index and grid limits"),
    "batch": (broadcast(2 ** 16, 1, 1), "index and grid limits"),
    "heads": (broadcast(1, 1, 2 ** 16), "index and grid limits"),
    "requires_grad": (lambda dev: qkv_of(2, 17, 2, 64, device=dev).requires_grad_(),
                      "requires grad"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refusal_names_its_reason(case):
    make, words = REFUSED[case]
    reason = at.vit_attention_refusal(make("cpu"))
    assert reason is not None and words in reason
    # no other case's reason
    others = {w for c, (_, w) in REFUSED.items() if w != words}
    assert not any(w in reason for w in others)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 769])
def test_refusal_takes_the_projection_layout(L, dtype):
    qkv = qkv_of(2, L, 16, 64, dtype)
    assert at.vit_attention_refusal(qkv) is None
    # where DINOv2's qkv linear writes it
    attn = random_attention(128, 2, seed=1).to(dtype)
    with torch.no_grad():
        qkv = attn.qkv(torch.zeros((3, L, 128), dtype=dtype)).reshape(3, L, 3, 2, 64)
    assert at.vit_attention_refusal(qkv) is None


def test_malformed_inputs_raise():
    with pytest.raises(ValueError, match="\\(B, L, 3, nh, hd\\)"):
        at.vit_attention(torch.zeros((2, 17, 3, 128)))
    with pytest.raises(ValueError, match="\\(B, L, 3, nh, hd\\)"):
        at.vit_attention(torch.zeros((2, 17, 2, 2, 64)))
    with pytest.raises(ValueError, match="no kernel for device"):
        at.vit_attention(torch.zeros((2, 17, 3, 2, 64), device="meta"))


def test_the_benchmark_reads_the_launches_a_request():
    from port_bench import harness

    read = harness.reader("dinov2_attn_launches.query")
    kernel = "void (anonymous namespace)::sam_attention_bf16_kernel<64, 2, 2>(...)"
    ops = ([(kernel, 4e-5, "dinov2")] * 72 + [("nvjet_gemm", 1e-4, "dinov2")] * 96
           + [(kernel, 4e-5, None), ("fused_interp_slice_kernel", 4e-4, "batch_eval")])
    assert read({"profile": {"steps": 3, "ops": ops}}) == 24
    # the plain chain's parent: no such launch, nothing read
    assert read({"profile": {"steps": 3, "ops": ops[72:-2]}}) is None
    assert read({}) is None


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


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


# (B, L): ViT-L over 4 views of a 24x32 grid and CLS; ragged sequences
# (one token, a part of a key tile, a tile and one)
SHAPES = {"vit_l_4views": (4, 769), "one": (2, 1), "part_tile": (3, 17), "tile_and_one": (2, 257)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_the_plain_chain(cuda, shape, dtype):
    B, L = SHAPES[shape]
    qkv = qkv_of(B, L, 16, 64, dtype, cuda, seed=L)
    launches = at.vit_attention.launches
    with torch.no_grad():
        got = at.vit_attention(qkv)
        torch.cuda.synchronize()
        assert at.vit_attention.launches == launches + 1
        want = at.vit_attention_plain(qkv)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=F32_RTOL,
                                       atol=F32_RTOL * float(want.abs().max()))
            return
        cos = torch.nn.functional.cosine_similarity(got.float(), want.float(), dim=-1)
        assert float(cos.min()) > BF16_MIN_COS
        # the logits stay f32 in the kernel: at least as close to the f32
        # chain on the same bf16 inputs as the bf16 chain is
        exact = at.vit_attention_plain(qkv.float())
        assert rel_l2(got, exact) <= rel_l2(want, exact)


@pytest.mark.cuda
def test_bf16_vit_l_backbone_on_the_card_matches_the_cpu(cuda):
    """A full ViT-L in bf16, its 24 layers' attention on the kernel, against
    the same backbone on the CPU (the plain chain), within the JAX bf16
    budget; one launch and one ``dinov2_attn`` a layer."""
    cfg = d2.Dinov2Config.vit_large()
    model = d2.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rgb = np.random.RandomState(5).randint(0, 255, (1, 240, 320, 3)).astype(np.uint8)
    cpu = d2.Dinov2Backbone(model, compute_dtype="bfloat16", device="cpu")(rgb, patch_hw=(24, 32))
    card = d2.Dinov2Backbone(model, compute_dtype="bfloat16", device=cuda)
    before = (at.vit_attention.launches, at.vit_attention.launches_bf16)
    tracer.reset()
    tracer.enable()
    try:
        got = card(rgb, patch_hw=(24, 32))
        torch.cuda.synchronize()
        counters = tracer.summary()["counters"]
    finally:
        tracer.disable()
        tracer.reset()
    assert (at.vit_attention.launches - before[0],
            at.vit_attention.launches_bf16 - before[1]) == (24, 24)
    assert counters["dinov2_attn"] == 24
    a, b = got.cpu().reshape(-1, cfg.hidden_size), cpu.reshape(-1, cfg.hidden_size)
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    assert float((1 - cos).max()) < TOKEN_MAX_COS_DEFICIT


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(REFUSED))
def test_the_card_raises_where_the_kernel_refuses(cuda, case):
    qkv = REFUSED[case][0](cuda)
    launches = at.vit_attention.launches
    with pytest.raises(ValueError):
        at.vit_attention(qkv)
    assert at.vit_attention.launches == launches


@pytest.mark.cuda
def test_no_logits_sized_tensor_in_a_layer(cuda):
    cfg = d2.Dinov2Config.vit_large()
    attn = random_attention(cfg.hidden_size, cfg.num_heads, seed=2, device=cuda)
    attn = attn.to(torch.bfloat16)
    B, L = SHAPES["vit_l_4views"]
    x = torch.randn((B, L, cfg.hidden_size), device=cuda, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        attn(x)
    torch.cuda.synchronize()
    logits_bytes = B * cfg.num_heads * L * L * 2  # one bf16 (B*nh, L, L) tensor: 75.7 MB
    assert torch.cuda.max_memory_allocated() - base < logits_bytes // 2

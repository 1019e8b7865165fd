"""DINOv2's transformer as a CUDA graph (``utils/cuda_graph.py::GraphCache``
behind ``Dinov2.forward_tokens``).

On the CPU: ``forward_tokens`` runs ``forward_tokens_eager`` as it is and
captures nothing; the tracer's counters of a call are those of the eager
forward; a call of several tensors passes the cache through, and the
cache's key tells each input apart; a recording keeps the host's counts
for the replays; a copy of a model starts with an empty cache; and the
benchmark's reader ``dinov2_graph_share.query``. On the card (marked
``cuda``, skipped elsewhere), at the query cells' shape (4 views of 336x448,
a 24x32 patch grid): the graph against ``forward_tokens_eager`` bit for bit
for ViT-L in f32 and bf16 and ViT-g/14-reg in bf16, with the launch
counters of the eager forward a call; a second grid, moved weights, a cast
copy, a mesh of two on one card, and a capture under ``torch.profiler``
whose kernels the harness charges to the enclosing ``pb.dinov2`` range.
This file imports no JAX, so that the card tests run on a machine without
it: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_dinov2_graph.py``.
"""

import copy
import gc
import re
import weakref

import numpy as np
import pytest
import torch

from d3fields_tpu_torch.models import attention as at
from d3fields_tpu_torch.models import dinov2 as d2
from d3fields_tpu_torch.models.common import cast_copy
from d3fields_tpu_torch.parallel import make_mesh
from d3fields_tpu_torch.utils import cuda_graph
from d3fields_tpu_torch.utils.profiling import tracer
from port_bench import harness

CAPTURES, REPLAYS = "dinov2_graph_captures", "dinov2_graph_replays"
TINY = {
    "mlp": d2.Dinov2Config.tiny_test(),
    "swiglu_reg": d2.Dinov2Config(hidden_size=64, num_layers=3, num_heads=4, image_size=112,
                                  ffn="swiglu", num_register_tokens=4,
                                  interpolate_antialias=True, interpolate_offset=0.0),
}


@pytest.fixture
def traced():
    tracer.reset()
    tracer.enable()
    yield tracer
    tracer.disable()
    tracer.reset()


def counts(tr) -> tuple:
    c = tr.summary()["counters"]
    return c.get(CAPTURES, 0), c.get(REPLAYS, 0)


def tiny_backbone(name: str, dtype: str = "float32") -> d2.Dinov2Backbone:
    cfg = TINY[name]
    model = d2.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    return d2.Dinov2Backbone(model.eval(), compute_dtype=dtype, device="cpu")


def pixels(n: int, gh: int, gw: int, device="cpu", seed: int = 0) -> torch.Tensor:
    """Normalised pixels of ``n`` views on a (gh, gw) patch grid."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(n, gh * 14, gw * 14, 3, generator=gen, device=device)


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(TINY))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@torch.no_grad()
def test_the_cpu_runs_the_eager_forward(name, dtype, traced):
    bb = tiny_backbone(name, dtype)
    x, pos = pixels(2, 4, 6), bb.interpolated_pos_embed(4, 6)
    got = bb.model.forward_tokens(x, pos)
    assert torch.equal(got, bb.model.forward_tokens_eager(x, pos))
    assert got.dtype == torch.float32
    assert not bb.model._graphs._entries and counts(traced) == (0, 0)


@pytest.mark.parametrize("name, swiglu", [("mlp", 0), ("swiglu_reg", 3)])
def test_a_calls_counters_on_the_cpu(name, swiglu, traced):
    """One backbone call of 3 views on a 4x6 grid: one transformer call of 3
    x (1 + R + 24) tokens through the model's layers (SwiGLU ones where it
    has them), one ``dinov2.forward`` span and none a layer, no attention
    launch (the CPU takes the plain chain) and no graph."""
    bb = tiny_backbone(name)
    rgb = np.random.RandomState(1).randint(0, 256, (3, 40, 60, 3)).astype(np.uint8)
    bb(rgb, patch_hw=(4, 6))
    s = traced.summary()
    c = s["counters"]
    R = TINY[name].num_register_tokens
    assert (c["dinov2_forwards"], c["dinov2_tokens"]) == (1, 3 * (1 + R + 24))
    assert sum(isinstance(b.mlp, d2._SwiGLUFFN) for b in bb.model.blocks) == swiglu
    assert "dinov2_attn" not in c and counts(traced) == (0, 0)
    assert set(s["spans"]) == {"dinov2.forward"} and s["spans"]["dinov2.forward"]["count"] == 1


def test_a_recording_keeps_the_host_effects_for_the_replays(traced):
    """What a graphed call counts: inside a recording an attention launch's
    counters do not move, and the CPU's eager forward keeps no effect (its
    plain chain launches nothing); running the kept effects, as each replay
    does, moves them as the eager call does."""
    bb = tiny_backbone("swiglu_reg")
    x, pos = pixels(1, 4, 4), bb.interpolated_pos_embed(4, 4)
    launches = (at.vit_attention.launches, at.vit_attention.launches_bf16)
    with torch.no_grad(), cuda_graph._recording() as tape:
        bb.model.forward_tokens_eager(x, pos)
        cuda_graph.host_effect(at._count_vit, True)
    assert "dinov2_attn" not in traced.summary()["counters"]
    assert (at.vit_attention.launches, at.vit_attention.launches_bf16) == launches
    assert tape == [(at._count_vit, (True,))]
    for _ in range(2):
        for fn, args in tape:
            fn(*args)
    c = traced.summary()["counters"]
    assert c["dinov2_attn"] == 2
    assert (at.vit_attention.launches - launches[0],
            at.vit_attention.launches_bf16 - launches[1]) == (2, 2)
    cuda_graph.host_effect(at._count_vit, False)  # outside a recording: now
    assert at.vit_attention.launches - launches[0] == 3


def test_a_call_of_several_tensors_passes_through_on_the_cpu(traced):
    cache = cuda_graph.GraphCache("probe")
    a, b = torch.ones(2, 3), torch.zeros(4)
    out = a + 1
    assert cache(lambda x, y, flag: out if flag else None, a, b, True, weights=()) is out
    assert not cache._entries and not cuda_graph.capturable(a, b)
    assert not cuda_graph.capturable()
    assert traced.summary()["counters"] == {}


@pytest.mark.parametrize("change", ["first_shape", "second_shape", "second_dtype",
                                    "second_strides", "flag"])
def test_the_signature_covers_each_input(change):
    a, b = torch.zeros(4, 6, 3), torch.zeros(25, 8)
    base = cuda_graph._signature((a, b, True))
    assert cuda_graph._signature((a.clone(), b.clone(), True)) == base
    other = {
        "first_shape": (torch.zeros(2, 6, 3), b, True),
        "second_shape": (a, torch.zeros(13, 8), True),
        "second_dtype": (a, b.bfloat16(), True),
        "second_strides": (a, torch.zeros(8, 25).t(), True),
        "flag": (a, b, False),
    }[change]
    assert cuda_graph._signature(other) != base


@pytest.mark.parametrize("how", ["deepcopy", "cast_copy"])
def test_a_copy_starts_with_an_empty_cache(how):
    model = d2.Dinov2(TINY["mlp"], device="cpu")
    model._graphs._entries["full"] = object()
    model._graphs._tree = cuda_graph._Tree((model,))
    twin = copy.deepcopy(model) if how == "deepcopy" else cast_copy(model, torch.bfloat16)
    assert twin is not model and len(twin._graphs._entries) == 0
    assert twin._graphs._tree is None  # its views would read the original's dicts
    assert twin._graphs.counter == model._graphs.counter == "dinov2_graph"
    assert len(model._graphs._entries) == 1


def test_the_graphs_weights_are_every_tensor_of_the_model():
    model = d2.Dinov2(TINY["swiglu_reg"], device="cpu")
    tensors = list(model.parameters()) + list(model.buffers())
    assert sorted(cuda_graph._addresses((model,))) == sorted(t.data_ptr() for t in tensors)


def test_a_kept_tree_sees_moved_assigned_and_replaced_weights():
    """``GraphCache`` keeps one ``_Tree`` of its weights: its reading follows
    ``nn.Module.to`` and ``load_state_dict(assign=True)`` as a new walk's
    does, and a replaced submodule makes it stale."""
    model = d2.Dinov2(TINY["mlp"], device="cpu")
    tree = cuda_graph._Tree((model,))
    before = tree.addresses()
    assert tree.current((model,)) and before == cuda_graph._addresses((model,))
    kept = [t.data for t in model.state_dict().values()]  # no address is reused
    model.to(torch.float64)
    assert tree.current((model,)) and tree.addresses() == cuda_graph._addresses((model,))
    assert not set(tree.addresses()) & set(before)
    moved = tree.addresses()
    kept += [t.data for t in model.state_dict().values()]
    model.load_state_dict({k: v.clone() for k, v in model.state_dict().items()}, assign=True)
    assert tree.current((model,)) and tree.addresses() == cuda_graph._addresses((model,))
    assert not set(tree.addresses()) & set(moved)
    model.blocks[1].mlp = copy.deepcopy(model.blocks[1].mlp)
    assert not tree.current((model,))
    assert not tree.current((model.blocks[0],))


def test_a_model_with_a_kept_tree_is_freed_without_the_cycle_collector():
    """The cache's tree holds its roots weakly: a model whose cache has read
    its weights is freed (and its card memory with it) as soon as the last
    reference goes, not at a later cyclic collection."""
    model = d2.Dinov2(TINY["mlp"], device="cpu")
    model._graphs._tree = cuda_graph._Tree((model,))
    assert model._graphs._tree.current((model,))
    ref = weakref.ref(model)
    gc.disable()
    try:
        del model
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("counters, share", [
    (None, None),
    ({}, None),
    ({"dinov2_forwards": 5, "dinov2_tokens": 5 * 3092}, None),  # the parent's program
    ({"dinov2_forwards": 0, "dinov2_graph_replays": 0}, None),
    ({"dinov2_forwards": 40, "dinov2_graph_replays": 40}, 100.0),
    ({"dinov2_forwards": 40, "dinov2_graph_replays": 30}, 75.0),
])
def test_graph_share_reader(counters, share):
    read = harness.reader("dinov2_graph_share.query")
    rec = {} if counters is None else {"program_counters": counters}
    assert read(rec) == share


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

GRID = (24, 32)  # the query cells': 4 views of 240x320 resized to 336x448
CONFIGS = {"vitl14-f32": (d2.Dinov2Config.vit_large, "float32"),
           "vitl14-bf16": (d2.Dinov2Config.vit_large, "bfloat16"),
           "vitg14reg-bf16": (d2.Dinov2Config.vit_giant2_reg, "bfloat16")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    # the cells' precision: TF32 off for the f32 parts
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def backbone_at(name: str, device) -> d2.Dinov2Backbone:
    """A backbone of the configuration ``name`` with random weights, in its
    compute dtype."""
    preset, dtype = CONFIGS[name]
    model = d2.init_params(preset(), torch.Generator(device=device).manual_seed(0),
                           device=device)
    return d2.Dinov2Backbone(model.eval(), compute_dtype=dtype, device=device)


def launch_counts(tr) -> tuple:
    c = tr.summary()["counters"]
    return (at.vit_attention.launches, at.vit_attention.launches_bf16,
            c.get("dinov2_attn", 0))


def increments(tr, call) -> tuple:
    """``call()``'s result and what it added to :func:`launch_counts`."""
    before = launch_counts(tr)
    out = call()
    return out, tuple(b - a for a, b in zip(before, launch_counts(tr)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
@torch.no_grad()
def test_the_graph_is_the_eager_forward_at_the_cells_shape(cuda, name, traced):
    bb = backbone_at(name, cuda)
    model, pos = bb.model, bb.interpolated_pos_embed(*GRID)
    L = model.cfg.num_layers
    bf16 = L * (bb.compute_dtype == "bfloat16")
    want_counts = (L, bf16, L)
    tokens = []
    for seed in range(3):
        x = pixels(4, *GRID, device=cuda, seed=seed)
        assert x.shape == (4, 336, 448, 3)
        graphed, graphed_counts = increments(traced, lambda: model.forward_tokens(x, pos))
        eager, eager_counts = increments(traced, lambda: model.forward_tokens_eager(x, pos))
        assert graphed_counts == eager_counts == want_counts
        assert torch.equal(graphed, eager)
        tokens.append(graphed)
    assert tokens[0].shape == (4, 1 + model.cfg.num_register_tokens + 24 * 32,
                               model.cfg.hidden_size)
    assert not any(torch.equal(a, b) for a, b in zip(tokens, tokens[1:]))
    assert counts(traced) == (1, 3)


@pytest.mark.cuda
@torch.no_grad()
def test_a_second_grid_captures_a_second_graph(cuda, traced):
    bb = backbone_at("vitl14-bf16", cuda)
    model = bb.model
    for _ in range(2):
        for grid in (GRID, (16, 20)):
            x, pos = pixels(4, *grid, device=cuda), bb.interpolated_pos_embed(*grid)
            assert torch.equal(model.forward_tokens(x, pos), model.forward_tokens_eager(x, pos))
    assert counts(traced) == (2, 4) and len(model._graphs._entries) == 2


@pytest.mark.cuda
@torch.no_grad()
def test_moved_weights_are_captured_again(cuda, traced):
    bb = backbone_at("vitl14-f32", cuda)
    model, pos = bb.model, bb.interpolated_pos_embed(*GRID)
    x = pixels(4, *GRID, device=cuda)

    def check():
        assert torch.equal(model.forward_tokens(x, pos), model.forward_tokens_eager(x, pos))

    check()
    model.to("cpu").to(cuda)  # every parameter in new storage
    check()
    assert counts(traced) == (2, 2) and len(model._graphs._entries) == 1
    model.load_state_dict({k: v.clone() for k, v in model.state_dict().items()}, assign=True)
    check()
    assert counts(traced) == (3, 3) and len(model._graphs._entries) == 1
    # an in-place write keeps the addresses: the graph reads the new values
    model.blocks[3].mlp.fc1.weight.mul_(2.0)
    check()
    assert counts(traced) == (3, 4)


@pytest.mark.cuda
@torch.no_grad()
def test_a_cast_copy_of_a_graphed_model_captures_its_own(cuda, traced):
    bb = backbone_at("vitl14-f32", cuda)
    model, pos = bb.model, bb.interpolated_pos_embed(*GRID)
    x = pixels(4, *GRID, device=cuda)
    model.forward_tokens(x, pos)
    assert len(model._graphs._entries) == 1
    twin = cast_copy(model, torch.bfloat16, ("cls_token", "patch_embed.", "blocks.", "norm."))
    assert len(twin._graphs._entries) == 0
    assert torch.equal(twin.forward_tokens(x, pos), twin.forward_tokens_eager(x, pos))
    assert torch.equal(model.forward_tokens(x, pos), model.forward_tokens_eager(x, pos))
    assert counts(traced) == (2, 3)


@pytest.mark.cuda
def test_a_mesh_of_two_on_one_card(cuda, traced, monkeypatch):
    """``shard_views`` over a mesh that names the card twice: one replica,
    two chunks of 2 views a call, one graph replayed for each in turn;
    the tokens are the eager forward's on the same chunks."""
    bb = backbone_at("vitl14-bf16", cuda).shard_views(make_mesh(2, devices=[cuda, cuda]))
    rgb = [np.random.RandomState(s).randint(0, 256, (4, 240, 320, 3)).astype(np.uint8)
           for s in (1, 2)]
    graphed = [bb(r, patch_hw=GRID) for r in rgb]
    assert counts(traced) == (1, 4)
    monkeypatch.setattr(d2.Dinov2, "forward_tokens", d2.Dinov2.forward_tokens_eager)
    for r, g in zip(rgb, graphed):
        assert torch.equal(g, bb(r, patch_hw=GRID))
    assert counts(traced) == (1, 4)


@pytest.mark.cuda
def test_a_capture_under_the_profiler(cuda, traced, tmp_path, monkeypatch):
    """The first call captures inside the profile. The harness charges each
    attention launch, the eager warm-up's and both replays', to the
    ``pb.dinov2`` range around the call."""
    from torch.profiler import ProfilerActivity, profile, record_function

    bb = backbone_at("vitl14-bf16", cuda)
    rgb = [np.random.RandomState(s).randint(0, 256, (4, 240, 320, 3)).astype(np.uint8)
           for s in (1, 2)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("pb.window"):
            out = []
            for r in rgb:
                with record_function("pb.dinov2"):
                    out.append(bb(r, patch_hw=GRID))
            torch.cuda.synchronize()
    assert counts(traced) == (1, 2)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    ops = harness.read_trace(path)["ops"]
    attn = [span for name, _, span in ops if re.search(r"sam_attention_bf16_kernel", name)]
    assert attn and set(attn) == {"dinov2"}
    assert len(attn) == 3 * 24
    monkeypatch.setattr(d2.Dinov2, "forward_tokens", d2.Dinov2.forward_tokens_eager)
    for r, o in zip(rgb, out):
        assert torch.equal(o, bb(r, patch_hw=GRID))

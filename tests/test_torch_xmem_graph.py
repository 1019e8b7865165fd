"""XMem's key encoder as a CUDA graph (``utils/cuda_graph.py::GraphCache``
behind ``XMem.encode_key``).

On the CPU: the cache runs the function as it is and counts nothing; a
copy of a model (``copy.deepcopy``, ``cast_copy``) starts with an empty
cache; the weights' addresses, which decide when a graph is stale, move
with ``nn.Module.to`` and stay with an in-place ``copy_``. On the card
(marked ``cuda``, skipped elsewhere), at the video cell's widths and the
benchmark's weights: the graph against ``encode_key_eager`` bit for bit at
the cell's shape in both dtypes, a tracker over 30 frames graphed against
eager, a second shape, autograd on, weights moved, a cast copy, copies
captured in turn in the device's one pool, two trackers sharing one f32
model, and a capture under ``torch.profiler``.
This file imports no JAX, so that the card tests run on a machine without
it: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_xmem_graph.py``.
"""

import copy
import dataclasses

import pytest
import torch

from d3fields_tpu_torch.config import XMemConfig
from d3fields_tpu_torch.models.common import cast_copy
from d3fields_tpu_torch.models.xmem.network import XMem
from d3fields_tpu_torch.seg.video_tracker import VideoMaskTracker, prep_frames
from d3fields_tpu_torch.utils import cuda_graph
from d3fields_tpu_torch.utils.convert import audit_state_dict
from d3fields_tpu_torch.utils.profiling import tracer
from port_bench import harness, weights_xmem
from port_bench.videos import Video

CELL = harness.Spec("xmem-r50-bf16.davis480p")
WIDTHS = {k: CELL.config["xmem"][k] for k in ("key_dim", "value_dim", "hidden_dim")}
H, W, OBJECTS = CELL.config["video"]["height"], CELL.config["video"]["width"], 3
SEED = 2 ** 35 + 11
CAPTURES, REPLAYS = "xmem_key_graph_captures", "xmem_key_graph_replays"


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


def model_at(cfg: XMemConfig, device) -> XMem:
    """An f32 XMem of ``cfg``'s widths with the benchmark's weights."""
    model = XMem(cfg, device=device)
    xmem = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "compute_dtype"}
    sd = weights_xmem.xmem_weights(xmem, SEED, device)
    model.load_state_dict(audit_state_dict(model, sd, "xmem"), strict=True)
    return model.eval()


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

def test_the_cpu_runs_the_function_as_it_is(traced):
    cache = cuda_graph.GraphCache("probe")
    x = torch.ones(2, 3)
    out = (x + 1,)
    assert cache(lambda t, flag: out if flag else None, x, True, weights=()) is out
    assert not cache._entries and not cuda_graph.capturable(x)
    assert traced.summary()["counters"] == {}


@pytest.mark.parametrize("how", ["deepcopy", "cast_copy"])
def test_a_copy_starts_with_an_empty_cache(how):
    model = XMem(XMemConfig(key_dim=8, value_dim=16, hidden_dim=8), device="cpu")
    model._key_graphs._entries["full"] = object()
    twin = copy.deepcopy(model) if how == "deepcopy" else cast_copy(model, torch.bfloat16)
    assert twin is not model and len(twin._key_graphs._entries) == 0
    assert twin._key_graphs.counter == model._key_graphs.counter == "xmem_key_graph"
    assert len(model._key_graphs._entries) == 1


def test_the_weights_addresses_move_with_new_storage_and_stay_with_copy():
    model = XMem(XMemConfig(key_dim=8, value_dim=16, hidden_dim=8), device="cpu")
    weights = (model.key_encoder, model.key_proj)
    tensors = [t for m in weights for t in list(m.parameters()) + list(m.buffers())]
    before = cuda_graph._addresses(weights)
    assert len(before) == len(tensors) == len(set(before))
    with torch.no_grad():
        model.key_proj.key_proj.weight.copy_(torch.ones_like(model.key_proj.key_proj.weight))
    assert cuda_graph._addresses(weights) == before
    # nn.Module.to: every floating tensor in new storage (the batch norms'
    # integer counters stay where they are)
    model.to(torch.float64)
    moved = cuda_graph._addresses(weights)
    assert sum(a != b for a, b in zip(moved, before)) == sum(
        t.is_floating_point() for t in tensors)
    # load_state_dict(assign=True): every tensor
    model.load_state_dict({k: v.clone() for k, v in model.state_dict().items()}, assign=True)
    assigned = cuda_graph._addresses(weights)
    assert not set(assigned) & set(moved)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    # the cell's precision: TF32 off for the f32 parts
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def cell_frames(device, dtype, n: int, number: int = 0, height: int = H, width: int = W):
    """The video cell's first ``n`` frames of a video as ``encode_key``
    takes them: normalised, padded to /16, (1, 3, ph, pw) in ``dtype``."""
    v = Video(SEED, number, height, width, OBJECTS, n, CELL.traffic["video"])
    ph, pw = -(-height // 16) * 16, -(-width // 16) * 16
    pad = ((ph - height) // 2, (ph - height + 1) // 2, (pw - width) // 2, (pw - width + 1) // 2)
    out = []
    for t in range(n):
        rgb = torch.from_numpy(v.render(t)[0]).to(device)[None]
        img = prep_frames(rgb, (height, width), pad)
        out.append(img.permute(0, 3, 1, 2).to(dtype).contiguous())
    return out


def assert_equal(graphed, eager):
    assert len(graphed) == len(eager) == 6
    for a, b in zip(graphed, eager):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@torch.no_grad()
def test_the_graph_is_the_eager_call_at_the_cells_shape(cuda, dtype, traced):
    model = cast_copy(model_at(XMemConfig(**WIDTHS), cuda), dtype)
    frames = cell_frames(cuda, dtype, 4)
    assert frames[0].shape == (1, 3, 480, 864)
    keys = []
    for img in frames:
        graphed = model.encode_key(img)
        assert_equal(graphed, model.encode_key_eager(img))
        keys.append(graphed[0])
    assert not any(torch.equal(a, b) for a, b in zip(keys, keys[1:]))
    assert counts(traced) == (1, 4)


def short_schedule(**kw) -> XMemConfig:
    """The cell's widths with a memory frame in 3 and at most 7 working
    frames: over 30 frames, 10 memory frames and one consolidation (at 18)."""
    return XMemConfig(**WIDTHS, mem_every=3, max_mid_term_frames=7, min_mid_term_frames=3,
                      size=480, **kw)


def track(model, cfg, device, frames_u8, mask0, n: int):
    tracker = VideoMaskTracker(model, cfg, 1, OBJECTS, (H, W), size=cfg.size, device=device)
    out = []
    for t in range(n):
        index = tracker.process(frames_u8[t][None], mask0[None] if t == 0 else None,
                                return_index=True)
        out.append((index, tracker.last_prob.clone()))
    return out


@pytest.mark.cuda
def test_a_tracker_replays_one_graph_a_frame(cuda, traced, monkeypatch):
    cfg = short_schedule(compute_dtype="bfloat16")
    model = model_at(cfg, cuda)
    frames, mask0 = Video(SEED, 1, H, W, OBJECTS, 30, CELL.traffic["video"]).render_all()
    graphed = track(model, cfg, cuda, frames, mask0, 30)
    c = traced.summary()["counters"]
    assert (c[CAPTURES], c[REPLAYS], c["xmem_frames"]) == (1, 30, 30)
    assert c["xmem_mem_frames"] == 10 and c["xmem_consolidations"] == 1
    monkeypatch.setattr(XMem, "encode_key", XMem.encode_key_eager)
    eager = track(model, cfg, cuda, frames, mask0, 30)
    assert counts(traced) == (1, 30)
    for (ig, pg), (ie, pe) in zip(graphed, eager):
        assert (ig == ie).all()
        assert torch.equal(pg, pe)


@pytest.mark.cuda
@torch.no_grad()
def test_a_second_shape_captures_a_second_graph(cuda, traced):
    model = cast_copy(model_at(XMemConfig(**WIDTHS), cuda), torch.bfloat16)
    big = cell_frames(cuda, torch.bfloat16, 2)
    small = cell_frames(cuda, torch.bfloat16, 1, height=240, width=432)[0]
    assert_equal(model.encode_key(big[0]), model.encode_key_eager(big[0]))
    assert_equal(model.encode_key(small), model.encode_key_eager(small))
    assert counts(traced) == (2, 2)
    assert_equal(model.encode_key(big[1]), model.encode_key_eager(big[1]))
    assert_equal(model.encode_key(small), model.encode_key_eager(small))
    assert counts(traced) == (2, 4) and len(model._key_graphs._entries) == 2


@pytest.mark.cuda
def test_autograd_on_runs_eagerly(cuda, traced):
    model = cast_copy(model_at(XMemConfig(**WIDTHS), cuda), torch.bfloat16)
    img = cell_frames(cuda, torch.bfloat16, 1)[0]
    with torch.enable_grad():
        out = model.encode_key(img)
    assert all(t.requires_grad for t in out)
    with torch.no_grad():
        assert_equal(tuple(t.detach() for t in out), model.encode_key_eager(img))
    assert counts(traced) == (0, 0) and len(model._key_graphs._entries) == 0


@pytest.mark.cuda
@torch.no_grad()
def test_moved_weights_are_captured_again(cuda, traced):
    model = model_at(XMemConfig(**WIDTHS), cuda)
    a, b = cell_frames(cuda, torch.float32, 2)
    assert_equal(model.encode_key(a), model.encode_key_eager(a))
    model.to("cpu").to(cuda)  # every parameter and buffer in new storage
    assert_equal(model.encode_key(b), model.encode_key_eager(b))
    assert counts(traced) == (2, 2) and len(model._key_graphs._entries) == 1
    # an in-place write keeps the addresses: the graph reads the new values
    model.key_proj.key_proj.weight.mul_(2.0)
    assert_equal(model.encode_key(a), model.encode_key_eager(a))
    assert counts(traced) == (2, 3)


@pytest.mark.cuda
@torch.no_grad()
def test_a_cast_copy_of_a_graphed_model_captures_its_own(cuda, traced):
    model = model_at(XMemConfig(**WIDTHS), cuda)
    img = cell_frames(cuda, torch.float32, 1)[0]
    model.encode_key(img)
    assert len(model._key_graphs._entries) == 1
    twin = cast_copy(model, torch.bfloat16)
    assert len(twin._key_graphs._entries) == 0
    assert_equal(twin.encode_key(img.bfloat16()), twin.encode_key_eager(img.bfloat16()))
    assert_equal(model.encode_key(img), model.encode_key_eager(img))
    assert counts(traced) == (2, 3)


@pytest.mark.cuda
@torch.no_grad()
def test_copies_captured_in_turn_reuse_the_pool(cuda, traced):
    """A tracker's bf16 copy of the weights captures its own graph; the
    copies of videos one after another leave the device's memory as the
    first left it (the graphs share one pool)."""
    model = model_at(XMemConfig(**WIDTHS), cuda)
    img = cell_frames(cuda, torch.bfloat16, 1)[0]
    reserved = []
    for _ in range(5):
        twin = cast_copy(model, torch.bfloat16)
        assert_equal(twin.encode_key(img), twin.encode_key_eager(img))
        del twin
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    assert counts(traced) == (5, 5)
    assert max(reserved[1:]) - reserved[1] <= 8 << 20, reserved


@pytest.mark.cuda
def test_two_trackers_sharing_an_f32_model(cuda, traced):
    cfg = short_schedule()
    model = model_at(cfg, cuda)
    videos = [Video(SEED, i, H, W, OBJECTS, 8, CELL.traffic["video"]).render_all()
              for i in (2, 3)]
    alone = [track(model, cfg, cuda, f, m, 8) for f, m in videos]
    trackers = [VideoMaskTracker(model, cfg, 1, OBJECTS, (H, W), size=cfg.size, device=cuda)
                for _ in videos]
    assert trackers[0].core.model is trackers[1].core.model is model
    turns = [[], []]
    for t in range(8):
        for i, (tr, (frames, mask0)) in enumerate(zip(trackers, videos)):
            index = tr.process(frames[t][None], mask0[None] if t == 0 else None,
                               return_index=True)
            turns[i].append((index, tr.last_prob.clone()))
    assert counts(traced) == (1, 32)
    for mine, ref in zip(turns, alone):
        for (i1, p1), (i2, p2) in zip(mine, ref):
            assert (i1 == i2).all()
            assert torch.equal(p1, p2)


@pytest.mark.cuda
@torch.no_grad()
def test_a_capture_under_the_profiler(cuda, traced):
    from torch.profiler import ProfilerActivity, profile

    model = cast_copy(model_at(XMemConfig(**WIDTHS), cuda), torch.bfloat16)
    a, b = cell_frames(cuda, torch.bfloat16, 2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = [model.encode_key(a), model.encode_key(b)]
        torch.cuda.synchronize()
    assert counts(traced) == (1, 2)
    assert_equal(out[0], model.encode_key_eager(a))
    assert_equal(out[1], model.encode_key_eager(b))
    assert sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()) > 0

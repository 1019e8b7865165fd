"""CUDA graphs of a function of one tensor: captured once for each call
signature, replayed on every later call.

A replay launches the kernels one eager call launched, with the same
arguments and on the same bytes, in one ``cudaGraphLaunch``. A forward of a
few hundred small launches (a ResNet trunk with its batch norms and relus)
then costs the host one launch instead of a pass of each op through
PyTorch's dispatcher, and its answers are the eager call's, bit for bit.

:class:`GraphCache` holds the graphs of one function for the module that
owns the cache; :func:`capturable` says when a call may be graphed.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from d3fields_tpu_torch.utils.profiling import tracer

Tensor = torch.Tensor


def capturable(x: Tensor) -> bool:
    """Whether a call on ``x`` may replay a graph: ``x`` is on a CUDA
    device, autograd is off (a graph records no backward), and no capture
    is under way on the current stream (the call would be recorded into it)."""
    return (x.is_cuda and not torch.is_grad_enabled()
            and not torch.cuda.is_current_stream_capturing())


def _addresses(modules: Sequence[nn.Module]) -> Tuple[int, ...]:
    """The address of every parameter and buffer of ``modules`` and their
    submodules. Plain loops over the modules' dicts: this runs on every
    call, and ``named_parameters`` costs several times more."""
    data_ptr, out, stack = Tensor.data_ptr, [], list(modules)
    while stack:
        m = stack.pop()
        if m is None:
            continue
        for t in m._parameters.values():
            if t is not None:
                out.append(data_ptr(t))
        for t in m._buffers.values():
            if t is not None:
                out.append(data_ptr(t))
        stack.extend(m._modules.values())
    return tuple(out)


class _Entry(NamedTuple):
    graph: torch.cuda.CUDAGraph
    static_in: Tensor
    outputs: Tuple[Optional[Tensor], ...]
    weights: Tuple[int, ...]  # the addresses of the weights at capture


# A device's graphs are captured on one side stream into one memory pool,
# that of the device's first graph, which is kept for the pool's sake. A
# capture takes the blocks that dropped graphs left there, so the pool
# holds what the graphs alive at once need, and no capture synchronises or
# empties the caching allocator (``torch.cuda.graph`` does both: in the
# video cell, where each video's tracker captures anew, that cost ~0.1 s a
# capture and the allocations of the video's later frames). Graphs of one
# pool may share blocks, intermediates and outputs alike, so their replays
# must come one after another on one stream (the port issues its work on
# the current stream), and a graph's outputs hold only until the device's
# next replay: :class:`GraphCache` clones them right after its own.
_DEVICES: Dict[torch.device, list] = {}  # device -> [capture stream, pool's graph]


def _capture(fn: Callable, x: Tensor, flags: tuple, weights: Tuple[int, ...]) -> _Entry:
    """One call of ``fn`` on a static copy of ``x`` captured into a graph
    in the device's pool, after an eager call on the capture stream (cuDNN
    picks its algorithms and allocates its workspaces there, outside the
    capture)."""
    dev = x.device
    if dev not in _DEVICES:
        _DEVICES[dev] = [torch.cuda.Stream(dev), None]
    side, first = _DEVICES[dev]
    pool = () if first is None else (first.pool(),)
    static_in = x.clone()
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev), torch.cuda.stream(side):
        fn(static_in, *flags)
        graph.capture_begin(*pool)
        try:
            outputs = tuple(fn(static_in, *flags))
        finally:
            graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    if first is None:
        _DEVICES[dev][1] = graph
    return _Entry(graph, static_in, outputs, weights)


class GraphCache:
    """The CUDA graphs of one function ``fn(x, *flags)`` of a tensor that
    returns a tuple of tensors (or None), one graph a call signature:
    ``x``'s shape, strides, dtype and device, the flags, and the TF32
    switches (a graph keeps the kernels chosen at its capture).

    Where :func:`capturable` allows, a signature's first call captures a
    graph (:func:`_capture`) and replays it; a later call copies ``x`` into
    the graph's input buffer on the current stream and replays. Every call
    returns clones of the graph's outputs, so that no later replay (of this
    graph or of another in the device's pool) overwrites a tensor a caller
    holds. Elsewhere ``fn(x, *flags)`` runs as it is. One caller at a time:
    the input buffer and the outputs are shared.

    ``weights`` are the modules whose parameters and buffers ``fn`` reads.
    A graph reads them where they lay at its capture, so the cache drops
    every graph once any of them lies elsewhere (``nn.Module.to``,
    ``load_state_dict(assign=True)``) and captures anew; an in-place
    ``copy_`` keeps the address, and the replay reads the new values. A
    copy of the cache (``copy.deepcopy`` of the module that holds it)
    starts empty.

    The tracer counts ``<counter>_captures`` and ``<counter>_replays``
    (every graphed call, a capturing one included)."""

    def __init__(self, counter: str):
        self.counter = counter
        self._entries: Dict[tuple, _Entry] = {}

    def __deepcopy__(self, memo) -> "GraphCache":
        return GraphCache(self.counter)

    def __call__(self, fn: Callable, x: Tensor, *flags,
                 weights: Sequence[nn.Module]) -> Tuple[Optional[Tensor], ...]:
        if not capturable(x):
            return fn(x, *flags)
        addresses = _addresses(weights)
        key = (tuple(x.shape), x.stride(), x.dtype, x.device, flags,
               torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        entry = self._entries.get(key)
        if entry is None or entry.weights != addresses:
            # a graph of moved weights reads memory that may hold anything now
            self._entries = {k: e for k, e in self._entries.items() if e.weights == addresses}
            entry = self._entries[key] = _capture(fn, x, flags, addresses)
            tracer.count(self.counter + "_captures")
        entry.static_in.copy_(x)
        entry.graph.replay()
        tracer.count(self.counter + "_replays")
        return tuple(None if t is None else t.clone() for t in entry.outputs)

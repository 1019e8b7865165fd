"""CUDA graphs of a function of tensors: captured once for each call
signature, replayed on every later call.

A replay launches the kernels one eager call launched, with the same
arguments and on the same bytes, in one ``cudaGraphLaunch``. A forward of a
few hundred small launches (a ResNet trunk with its batch norms and relus,
a ViT's blocks) then costs the host one launch instead of a pass of each op
through PyTorch's dispatcher, and its answers are the eager call's, bit for
bit.

:class:`GraphCache` holds the graphs of one function for the module that
owns the cache; :func:`capturable` says when a call may be graphed;
:func:`host_effect` keeps the host's accounts of the launches (launch
counters, the tracer's counts) true under replay.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import operator
import threading
import weakref
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from d3fields_tpu_torch.utils.profiling import tracer

Tensor = torch.Tensor


def capturable(*xs: Tensor) -> bool:
    """Whether a call on the tensors ``xs`` may replay a graph: each is on a
    CUDA device, autograd is off (a graph records no backward), and no
    capture is under way on the current stream (the call would be recorded
    into it)."""
    return (bool(xs) and all(x.is_cuda for x in xs) and not torch.is_grad_enabled()
            and not torch.cuda.is_current_stream_capturing())


class _Tape(threading.local):
    effects: Optional[list] = None  # the host effects of the call this thread records


_TAPE = _Tape()


def host_effect(fn: Callable, *args) -> None:
    """``fn(*args)``, the host's account of device work its caller has just
    launched (a launch counter, a tracer count): run now, or, while
    :class:`GraphCache` records a call on this thread, kept and run on each
    replay of that call's graph instead. So a graphed call counts what its
    eager call counts, once a call, and a recording, which launches
    nothing, counts nothing."""
    tape = _TAPE.effects
    if tape is None:
        fn(*args)
    else:
        tape.append((fn, args))


@contextlib.contextmanager
def _recording() -> Iterator[List[tuple]]:
    """The :func:`host_effect` calls made on this thread inside the block,
    kept, not run."""
    outer, _TAPE.effects = _TAPE.effects, []
    try:
        yield _TAPE.effects
    finally:
        _TAPE.effects = outer


class _Tree:
    """Live views of the parameter, buffer and submodule dicts of
    ``modules`` and of all their submodules, walked once. Read on every
    call: :meth:`addresses` takes every parameter's and buffer's address
    through the views in C loops (an assigned parameter shows in its dict's
    view, a moved one in its address), and :meth:`current` says whether the
    tree still holds the same modules (a replaced, added or removed
    submodule needs a new walk). A walk of ViT-g's 445 modules in Python
    costs ~0.4 ms on the card's host, this read a fraction of it. The roots
    are held weakly: a module's cache holds its tree, and the module may be
    a root."""

    def __init__(self, modules: Sequence[nn.Module]):
        self.roots = tuple(weakref.ref(m) for m in modules)
        self.tensors, self.children, stack = [], [], list(modules)
        while stack:
            m = stack.pop()
            if m is None:
                continue
            self.tensors += (m._parameters.values(), m._buffers.values())
            self.children.append(m._modules.values())
            stack.extend(m._modules.values())
        self.shape = self._modules()

    def _modules(self) -> tuple:
        return tuple(itertools.chain.from_iterable(self.children))

    def current(self, modules: Sequence[nn.Module]) -> bool:
        return (len(modules) == len(self.roots)
                and all(r() is m for r, m in zip(self.roots, modules))
                and self._modules() == self.shape)

    def addresses(self) -> Tuple[int, ...]:
        return tuple(map(Tensor.data_ptr, filter(_is_tensor,
                                                 itertools.chain.from_iterable(self.tensors))))


_is_tensor = functools.partial(operator.is_not, None)


def _addresses(modules: Sequence[nn.Module]) -> Tuple[int, ...]:
    """The address of every parameter and buffer of ``modules`` and their
    submodules."""
    return _Tree(modules).addresses()


class _Entry(NamedTuple):
    graph: torch.cuda.CUDAGraph
    static_in: Tuple[Tensor, ...]  # a buffer for each tensor argument
    outputs: Tuple[Optional[Tensor], ...]
    single: bool  # fn returned one tensor, not a tuple
    effects: Tuple[tuple, ...]  # the host effects of one call (host_effect)
    weights: Tuple[int, ...]  # the addresses of the weights at capture


def _signature(args: tuple) -> tuple:
    """What a graph of a call on ``args`` is bound to: each tensor's shape,
    strides, dtype and device, each other argument's value, and the TF32
    switches (a graph keeps the kernels chosen at its capture)."""
    return (tuple((tuple(a.shape), a.stride(), a.dtype, a.device) if isinstance(a, Tensor)
                  else a for a in args),
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


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


def _capture(fn: Callable, args: tuple, weights: Tuple[int, ...]) -> _Entry:
    """One call of ``fn`` on ``args``, each tensor a static copy, captured
    into a graph in the device's pool, after an eager call on the capture
    stream (cuDNN picks its algorithms and allocates its workspaces there,
    and each hand-written kernel is loaded, outside the capture). Neither
    call's host effects run: the caller's replay runs the recorded ones."""
    dev = next(a for a in args if isinstance(a, Tensor)).device
    if dev not in _DEVICES:
        _DEVICES[dev] = [torch.cuda.Stream(dev), None]
    side, first = _DEVICES[dev]
    pool = () if first is None else (first.pool(),)
    static = tuple(a.clone() if isinstance(a, Tensor) else a for a in args)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev), torch.cuda.stream(side):
        with _recording():
            fn(*static)
        with _recording() as effects:
            graph.capture_begin(*pool)
            try:
                out = fn(*static)
            finally:
                graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    if first is None:
        _DEVICES[dev][1] = graph
    single = isinstance(out, Tensor)
    return _Entry(graph, tuple(a for a in static if isinstance(a, Tensor)),
                  (out,) if single else tuple(out), single, tuple(effects), weights)


class GraphCache:
    """The CUDA graphs of one function ``fn(*args)`` that returns a tensor,
    or a tuple of tensors and Nones, one graph a call signature
    (:func:`_signature`): each tensor argument's shape, strides, dtype and
    device, each other argument's value (flags, hashable), and the TF32
    switches.

    Where :func:`capturable` allows for the tensor arguments, a signature's
    first call captures a graph (:func:`_capture`) and replays it; a later
    call copies each tensor argument into its own input buffer of the graph
    on the current stream and replays. Every call returns clones of the
    graph's outputs, so that no later replay (of this graph or of another
    in the device's pool) overwrites a tensor a caller holds, and runs the
    host effects (:func:`host_effect`) one eager call runs. Elsewhere
    ``fn(*args)`` runs as it is. One caller at a time: the input buffers
    and the outputs are shared.

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
        self._tree: Optional[_Tree] = None  # of the last call's weights

    def __deepcopy__(self, memo) -> "GraphCache":
        return GraphCache(self.counter)

    def __call__(self, fn: Callable, *args, weights: Sequence[nn.Module]):
        xs = tuple(a for a in args if isinstance(a, Tensor))
        if not capturable(*xs):
            return fn(*args)
        if self._tree is None or not self._tree.current(weights):
            self._tree = _Tree(weights)
        addresses = self._tree.addresses()
        key = _signature(args)
        entry = self._entries.get(key)
        if entry is None or entry.weights != addresses:
            # a graph of moved weights reads memory that may hold anything now
            self._entries = {k: e for k, e in self._entries.items() if e.weights == addresses}
            entry = self._entries[key] = _capture(fn, args, addresses)
            tracer.count(self.counter + "_captures")
        for buf, x in zip(entry.static_in, xs):
            buf.copy_(x)
        entry.graph.replay()
        for effect, effect_args in entry.effects:
            effect(*effect_args)
        tracer.count(self.counter + "_replays")
        out = tuple(None if t is None else t.clone() for t in entry.outputs)
        return out[0] if entry.single else out

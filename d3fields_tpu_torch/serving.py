"""Software-pipelined serving loop: overlap device work with host I/O.

Counterpart of ``d3fields_tpu/serving.py:44-111``. The reference's
per-frame loops are synchronous: every frame runs ``update ->
text_queries -> rigid_tracking`` and blocks on the GPU result before
touching the next frame (``vis_tracking.py:70-138``). PyTorch launches CUDA
work asynchronously, so the card can already run frame ``t+1`` while the
host writes frame ``t``'s pickles. :class:`AsyncFrameLoop` defers each
frame's fetch by ``depth`` frames; ``depth=0`` is the reference's
synchronous loop. Results are identical either way: only when the host
copy happens changes. ``FusedFrameStep`` (one dispatch per frame with the
XMem tracker) is not ported yet.
"""

from __future__ import annotations

import collections
from typing import Any, Callable

import torch

__all__ = ["AsyncFrameLoop"]


def _fetch(tree: Any) -> Any:
    """Tensors -> host numpy arrays (one blocking copy each), through
    dicts, lists and tuples; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _fetch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fetch(v) for v in tree)
    return tree


class AsyncFrameLoop:
    """Deferred-fetch frame pipeline.

    ``submit(frame_id, outputs)`` enqueues a frame's *device* outputs
    (tensors in any nesting of dicts, lists and tuples; other leaves
    pass through). Once more than ``depth``
    frames are in flight, the oldest is fetched to host numpy and handed
    to ``consumer(frame_id, host_outputs)``. ``flush()`` drains the
    queue; the loop is also a context manager that flushes on exit.

    The producer must NOT host-sync inside its own frame step for the
    overlap to materialize — keep the per-frame chain on the device (e.g.
    ``rigid_tracking_steps`` instead of the numpy-returning wrapper) and
    let this loop do the only fetch.

    ``depth`` is the host-visible latency in frames. Device memory holds
    ``depth + 1`` frames of outputs; keep outputs small (match points,
    masks) rather than full feature volumes when deep pipelines are used.
    """

    def __init__(self, consumer: Callable[[Any, Any], None], depth: int = 1):
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        self._consumer = consumer
        self._depth = depth
        self._q: collections.deque = collections.deque()
        self.frames_consumed = 0

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def in_flight(self) -> int:
        return len(self._q)

    def submit(self, frame_id: Any, outputs: Any) -> None:
        self._q.append((frame_id, outputs))
        while len(self._q) > self._depth:
            self._drain_one()

    def _drain_one(self) -> None:
        # pop only AFTER the consumer returns: a transient consumer error
        # (e.g. ENOSPC mid-pickle) leaves the frame queued, so a caller
        # that handles the error can flush() again without losing it
        frame_id, outputs = self._q[0]
        self._consumer(frame_id, _fetch(outputs))
        self._q.popleft()
        self.frames_consumed += 1

    def flush(self) -> None:
        while self._q:
            self._drain_one()

    def __enter__(self) -> "AsyncFrameLoop":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # don't mask an in-flight exception with consumer work on partial
        # results; drain only on clean exit
        if exc_type is None:
            self.flush()

"""Device-side `if` and `while` for a captured frame: run_if and run_while.

Inside a CUDA graph capture (frame_graph.FrameGraph) each becomes a conditional
node of the graph (csrc/conditional.cu): the predicate is a bool on the
card, the body's torch operations and kernels are captured into the node's
body graph, and a replay tests the predicate on the card, so the transparent
peel loop runs as many passes as the frame needs with no host read (the JAX
package's lax.while_loop, tpu_renderer/pipeline.py). The PyTorch this port
runs on exposes no conditional node of its own, so the node is spliced into
the capture through the CUDA runtime.

Everywhere else (the CPU, an eager frame on the card) the host reads the
predicate each time, which gives the same result.

A body's memory comes from the pool bodies_into() names (the FrameGraph's
own), on a stream of its nesting depth. The launch counters count what a
body launches on the card: what a body's kernels counted on the host is
taken back and added to the counters' tallies on the card by an operation
captured at the end of the body (raster._Counter.restore, to_device), so
every pass counts.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch

from tpu_renderer_torch.kernels import _build
from tpu_renderer_torch.kernels.raster import _Counter, _entry, _launch, _ptr, _stream

IF, WHILE = 0, 1

_scope = threading.local()


@contextlib.contextmanager
def bodies_into(pool):
    """While a frame is captured: conditional bodies allocate from `pool`
    (a torch.cuda.MemPool the graph keeps alive as long as itself)."""
    outer = getattr(_scope, "pool", None), getattr(_scope, "depth", 0)
    _scope.pool, _scope.depth = pool, 0
    try:
        yield
    finally:
        _scope.pool, _scope.depth = outer


@functools.cache
def _body_stream(index: int, depth: int) -> torch.cuda.ExternalStream:
    """The stream conditional bodies of nesting depth `depth` are captured
    on, on card `index` (made once, kept for the process)."""
    handle = ctypes.c_void_p()
    with torch.cuda.device(index):
        _launch("graph_body_stream", ctypes.byref(handle))
    return torch.cuda.ExternalStream(handle.value, device=torch.device("cuda", index))


def _capturing(pred) -> bool:
    return pred.is_cuda and torch.cuda.is_current_stream_capturing()


class _Body:
    """Capture the block into the body of a conditional node of `kind`
    tested on `pred`; set(next) ends a WHILE body with the next pass's
    test."""

    def __init__(self, kind: int, pred):
        if pred.dtype != torch.bool or pred.numel() != 1:
            raise ValueError(f"a conditional node tests a one-element bool, "
                             f"got {pred.dtype} {tuple(pred.shape)}")
        self.kind, self.pred = kind, pred

    def __enter__(self):
        pool = getattr(_scope, "pool", None)
        if pool is None:
            raise RuntimeError("a conditional node is captured only inside a "
                               "FrameGraph capture (frame_graph.FrameGraph)")
        dev = self.pred.device
        self.depth = _scope.depth
        self.stream = _body_stream(dev.index, self.depth)
        handle = ctypes.c_ulonglong()
        _launch("graph_conditional_begin", _stream(dev),
                ctypes.c_void_p(self.stream.cuda_stream), ctypes.c_int(self.kind),
                _ptr(self.pred), ctypes.byref(handle))
        self.handle = handle.value
        self.before = _Counter.snapshot()
        self._context = contextlib.ExitStack()
        self._context.enter_context(torch.cuda.stream(self.stream))
        if self.depth == 0:
            # routes this thread's allocations, so nested bodies' too
            self._context.enter_context(torch.cuda.use_mem_pool(pool, device=dev))
        _scope.depth = self.depth + 1
        return self

    def set(self, pred):
        """A WHILE body's last step: the next pass runs where pred holds."""
        _launch("graph_conditional_set", ctypes.c_void_p(self.stream.cuda_stream),
                ctypes.c_ulonglong(self.handle), _ptr(pred.contiguous()))

    def __exit__(self, exc_type, *exc):
        try:
            if exc_type is None:
                _Counter.to_device(_Counter.restore(self.before), self.pred.device)
        finally:
            _scope.depth = self.depth
            self._context.close()
            # ended even when the body raised, so the stream can capture again
            err = _entry("graph_conditional_end")(ctypes.c_void_p(self.stream.cuda_stream))
        if exc_type is None and err:
            raise RuntimeError(f"graph_conditional_end failed: {_build.error_string(err)}")
        return False


def run_if(pred, body) -> None:
    """body() where the one-element bool pred holds: an IF node under a
    FrameGraph capture, a host test elsewhere."""
    if _capturing(pred):
        with _Body(IF, pred):
            body()
    elif bool(pred):
        body()


def run_while(pred, body) -> None:
    """body() for as long as the test holds: pred for the first pass, then
    what body() returns. A WHILE node under a FrameGraph capture, host tests
    elsewhere."""
    if _capturing(pred):
        with _Body(WHILE, pred) as node:
            node.set(body())
    else:
        while bool(pred):
            pred = body()

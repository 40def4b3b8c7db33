"""The graphed frame: the port's counterpart of jax.jit(render_frame).

FrameGraph captures pipeline.render_frame once per key of statics as a CUDA
graph, with its transparent peel loop on the device (a WHILE node around an
IF node, kernels/conditional.py: lax.while_loop's counterpart), and replays
it for each frame's params, draw_model and background, which it copies into
buffers of its own. A replay enqueues the whole frame with one launch, where
the eager frame launches every operation from Python and waits for the host
at each peel test. GraphCache keeps a few graphs by key: the Engine's
draw_device (on the card outside pipeline.eager(), with no mesh or a mesh
over nccl) goes through one, and pipeline.render_frames replays one a
frame when it is given the Engine's render_fn().

Given a mesh (parallel/multichip.Mesh), a FrameGraph captures the rank's
render_frame_multichip instead, collectives and all: the counterpart of
the JAX package's jax.jit over shard_map. Only nccl's collectives can be
captured (gloo's run on the host), so the Engine graphs a mesh over nccl
alone, and every rank captures the same frame at the same draw.
"""

from __future__ import annotations

import collections
import functools

import torch

from tpu_renderer_torch.kernels import conditional, raster
from tpu_renderer_torch.pipeline import FrameParams, SceneBuffers, render_frame
from tpu_renderer_torch.utils import profiling


class _Input:
    """One input a graph reads: a buffer of its own, copied from the
    caller's tensor before a replay when that is another tensor than the
    last one copied, or was written since."""

    def __init__(self, src):
        self.buf = src.clone()
        self._src, self._version = src, src._version

    def refresh(self, src) -> None:
        if src is self._src and src._version == self._version:
            return
        if src.shape != self.buf.shape or src.dtype != self.buf.dtype:
            raise ValueError(f"a graph input changed from {self.buf.dtype} "
                             f"{tuple(self.buf.shape)} to {src.dtype} {tuple(src.shape)}")
        self.buf.copy_(src)
        self._src, self._version = src, src._version


def graph_key(buffers: SceneBuffers, bg_fb, statics: dict, mesh=None) -> tuple:
    """What a FrameGraph is captured for: render_frame's statics (extent,
    out extent, tile, caps, fp16, transp_textured, fused, trilinear, pot),
    the scene's buffers, by identity, the mesh's shape and this rank
    (None with no mesh), and the trace's flag (profiling.graph_flag: None
    with tracing off, so a graph holds stamps only where it was captured
    while tracing); not the values of the params, draw_model or the
    background, which a replay copies in."""
    ids = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            ids.append((id(x), tuple(x.shape)))
        elif isinstance(x, tuple):
            for v in x:
                walk(v)

    walk(buffers._replace(draw_model=None))
    where = None if mesh is None else (mesh.n_rows, mesh.n_tri, mesh.rank)
    return (tuple(ids), tuple(buffers.draw_model.shape), tuple(bg_fb.shape),
            tuple(sorted(statics.items())), where, profiling.graph_flag())


def _frame_fn(mesh):
    """What a FrameGraph captures: render_frame, or over a mesh the rank's
    render_frame_multichip."""
    if mesh is None:
        return render_frame
    from tpu_renderer_torch.parallel.multichip import render_frame_multichip

    return functools.partial(render_frame_multichip, mesh=mesh)


class FrameGraph:
    """One frame captured as a CUDA graph, for one key of statics
    (graph_key), replayed for any params, draw_model and background. With
    a mesh, the rank's part of the mesh frame (render_frame_multichip):
    its collectives are captured too, so the backend must be nccl.

    At construction one eager frame runs on a side stream (it fills the
    lazy caches, loads the kernels, and is this call's frame: `first`), then
    the frame is captured, its peel loop a conditional node on the device
    (kernels/conditional.py). The image and the aux scalars live in the
    graph's memory and each replay overwrites them; replay() returns copies.
    The graph keeps the scene's buffers it reads alive, so that their ids in
    its key (graph_key) stay theirs. A failure to capture or replay raises:
    nothing falls back to the eager frame.

    The launch counters stay true: a capture launches nothing, so what its
    wrappers counted is taken back, and each replay adds it; the launches
    inside the peel loop count on the card (raster._Counter.to_device).

    The set-up record (profiling.setup_step) holds the first frame and the
    capture; captured while tracing, the graph holds the frame's device
    spans, and each replay counts a traced frame."""

    def __init__(self, buffers: SceneBuffers, params: FrameParams, bg_fb, statics: dict,
                 mesh=None):
        if mesh is not None and mesh.backend != "nccl":
            raise ValueError(f"a mesh frame is captured over nccl alone, not "
                             f"{mesh.backend}: its collectives run on the host")
        frame = _frame_fn(mesh)
        dev = buffers.draw_model.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), profiling.setup_step("first frame"):
            # also makes the mesh's communicators, before any capture
            image, aux = frame(buffers, params, bg_fb=bg_fb, **statics)
            torch.cuda.synchronize(dev)
        torch.cuda.current_stream(dev).wait_stream(side)
        for t in (image, *aux.values()):
            t.record_stream(torch.cuda.current_stream(dev))
        self.first = image, aux
        self.keys = sorted(aux)

        self._inputs = [_Input(t) for t in (*params, buffers.draw_model, bg_fb)]
        bufs = [i.buf for i in self._inputs]
        static_params = FrameParams(*bufs[:len(params)])
        self._buffers = buffers._replace(draw_model=bufs[len(params)])
        raster._Counter.make_tallies(dev)
        before = raster._Counter.snapshot()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.device, self.traced = dev, profiling.graph_flag() is not None
        self._graph = torch.cuda.CUDAGraph()
        self._bodies = torch.cuda.MemPool()
        pool = torch.cuda.graph_pool_handle()
        with torch.cuda.stream(torch.cuda.Stream(dev)), \
                conditional.bodies_into(self._bodies), profiling.setup_step("capture") as rec:
            self._graph.capture_begin(pool=pool)
            try:
                img, aux = frame(self._buffers, static_params, bg_fb=bufs[-1], **statics)
                self._image = img
                self._aux = torch.stack([aux[k].to(torch.int32) for k in self.keys])
                self._graph.capture_end()
            except BaseException:
                _abandon(self._graph, dev, pool)
                raise
            finally:
                self._launches = raster._Counter.restore(before)
        self.capture_ms = rec["ms"]
        self.pool_mib = (torch.cuda.memory_reserved(dev) - reserved) / 2 ** 20

    def replay(self, buffers: SceneBuffers, params: FrameParams, bg_fb):
        """The frame for these inputs: (image, aux) as render_frame returns
        them, copies of the graph's own (the next replay overwrites those).
        Host spans, while tracing: replay, and inside it refresh, launch and
        clones."""
        with profiling.span("replay"):
            with profiling.span("refresh"):
                for i, t in zip(self._inputs, (*params, buffers.draw_model, bg_fb)):
                    i.refresh(t)
            with profiling.span("launch"):
                if self.traced:
                    profiling.replayed_frame(self.device)
                self._graph.replay()
            raster._Counter.add(self._launches)
            with profiling.span("clones"):
                aux = self._aux.clone()
                return self._image.clone(), {k: aux[i] for i, k in enumerate(self.keys)}


def _abandon(graph, dev, pool) -> None:
    """End a capture that failed part way, so that the process goes on: a
    capture that an operation invalidated (a host read, say) makes torch's
    capture_end raise before it stops sending the stream's allocations to
    the graph's pool, and that pool's test would outlive the graph."""
    try:
        graph.capture_end()
    except RuntimeError:
        torch._C._cuda_endAllocateToPool(dev.index, pool)
        torch._C._cuda_releasePool(dev.index, pool)


class GraphCache:
    """FrameGraphs by key (graph_key), at most `size`: a key change (caps,
    extent, render scale, path) captures anew and drops the least recently
    used graph, whose memory pool is about the frame's peak."""

    def __init__(self, size: int = 2):
        self.size = size
        self._graphs = collections.OrderedDict()
        self.captured = []   # (capture ms, pool MiB) of every capture

    def __len__(self) -> int:
        return len(self._graphs)

    def graph(self, buffers: SceneBuffers, params: FrameParams, bg_fb, statics: dict,
              mesh=None):
        """(graph, first): the key's graph, with its warm-up frame when this
        call captured it (else None)."""
        with profiling.span("graph"):
            key = graph_key(buffers, bg_fb, statics, mesh)
            g = self._graphs.get(key)
            if g is not None:
                self._graphs.move_to_end(key)
                return g, None
        while len(self._graphs) >= self.size:
            self._drop(self._graphs.popitem(last=False)[1])
        with profiling.span("capture"):
            g = FrameGraph(buffers, params, bg_fb, statics, mesh)
        self._graphs[key] = g
        self.captured.append((g.capture_ms, g.pool_mib))
        first, g.first = g.first, None
        return g, first

    def frame(self, buffers: SceneBuffers, params: FrameParams, *, bg_fb, mesh=None,
              **statics):
        """render_frame's (image, aux) through the key's graph (render_frame's
        signature, with bg_fb required); with a mesh, render_frame_multichip's
        on this rank."""
        g, first = self.graph(buffers, params, bg_fb, statics, mesh)
        return first if first is not None else g.replay(buffers, params, bg_fb)

    def clear(self) -> None:
        while self._graphs:
            self._drop(self._graphs.popitem()[1])

    @staticmethod
    def _drop(g: FrameGraph) -> None:
        # a replay of it may still be running
        torch.cuda.current_stream(g._image.device).synchronize()

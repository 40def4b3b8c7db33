"""The one general generator of the benchmark's traffic. A traffic mix is
a data file, traffic/<mix>.json, whose "loop" names one of the loops
below and whose other keys are that loop's parameters:

* "sequence": an offline sequence render, closed loop. Each batch stages
  batch_frames cameras (Engine.update_scene), renders them through
  pipeline.render_frames with the Engine's render_fn() (on the card a
  replay of the frame graph a frame) and ends when its per-frame checksums
  reach the host; the next batch is staged after that.
* "viewer": the interactive viewer, closed loop: one
  Engine.draw_pipelined(stats_interval=0) a frame, the camera moved on the
  host before each call, with the Engine's FRAME_OVERLAP frames in flight;
  every full image is delivered to the host.

The camera sweeps its yaw back and forth over yaw_span at yaw_step a frame
from the configuration's yaw, and the run's seed picks where in that cycle
it starts: every seed renders the same set of cameras, in another order.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np

from benchmark.tracing import host_range


class Path:
    """The camera's yaw at frame i of a run."""

    def __init__(self, traffic: dict, camera: dict, seed: int):
        self.step = float(traffic["yaw_step"])
        self.period = max(2 * round(float(traffic["yaw_span"]) / self.step), 1)
        self.phase = int(np.random.default_rng(seed).integers(self.period))
        self.base = float(camera["yaw"])

    def yaw(self, i: int) -> np.float32:
        k = (self.phase + i) % self.period
        half = self.period // 2
        return np.float32(self.base + self.step * (k if k <= half else self.period - k))


def frame_statics(eng) -> dict:
    """render_frame's keyword arguments for this engine's scene and extent
    (a copy of the program's bench.frame_statics)."""
    cfg = eng.config
    return dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w, fp16=cfg.framebuffer_fp16,
                transp_textured=eng._transp_textured(), fused=eng._fused,
                trilinear=eng._trilinear, pot=eng._pot, **eng._extents(), **eng._caps)


def sequence(eng, path: Path, traffic: dict, seconds: float, frame: Callable,
             first: int = 0, batches: Optional[int] = None) -> dict:
    """Batches from path index `first` until `seconds` have passed (or
    `batches` batches). frame(i, fn) wraps the program's frame function for
    frame i. Returns frames and the window's seconds."""
    from tpu_renderer_torch.pipeline import render_frames

    n = int(traffic["batch_frames"])
    kw = frame_statics(eng)
    render = eng.render_fn()
    i, done = first, 0
    t0 = time.perf_counter()
    while True:
        with host_range("stage cameras"):
            params = []
            for j in range(n):
                eng.camera.yaw = path.yaw(i + j)
                params.append(eng.update_scene())
        counter = iter(range(i, i + n))
        with host_range("render_frames"):
            _, sums = render_frames(eng.flat.buffers, params,
                                    frame=lambda *a, **k: frame(next(counter), render, *a, **k),
                                    **kw)
        with host_range("fetch checksums"):
            sums.cpu()
        i += n
        done += 1
        if (batches is not None and done >= batches) or (
                batches is None and time.perf_counter() - t0 >= seconds):
            break
    return dict(frames=i - first, seconds=time.perf_counter() - t0, next=i)


def viewer(eng, path: Path, traffic: dict, seconds: float, deliver: Callable,
           first: int = 0, calls: Optional[int] = None) -> dict:
    """draw_pipelined calls from path index `first` until `seconds` have
    passed (or `calls` calls). deliver(i, image) receives each image
    delivered in the window with its frame's index. Returns the calls'
    start and end times and the window's seconds; the frames still in
    flight are drained after the window."""
    lag = eng.FRAME_OVERLAP - 1
    starts: List[float] = []
    ends: List[float] = []
    i = first
    t0 = time.perf_counter()
    while (calls is not None and i - first < calls) or (
            calls is None and time.perf_counter() - t0 < seconds):
        eng.camera.yaw = path.yaw(i)
        s = time.perf_counter()
        with host_range("draw_pipelined"):
            out = eng.draw_pipelined(stats_interval=0)
        e = time.perf_counter()
        starts.append(s)
        ends.append(e)
        if out is not None:
            deliver(i - lag, out)
        i += 1
    window = time.perf_counter() - t0
    eng.flush_pipelined()
    return dict(starts=starts, ends=ends, seconds=window, next=i)

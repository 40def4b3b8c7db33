"""Timers of one call on the card, in milliseconds, each the median of
several runs:

* ``event_ms``: CUDA events around one call on an idle card; the call's
  host time up to its launch counts, then the card's work.
* ``device_ms``: the card's time alone, one pair of events around the
  replay of a CUDA graph that captured `launches` calls, over the count
  (the host's work happened at capture; the graph's gap between two
  launches counts).
* ``host_ms``: what the host spends to enqueue one call,
  time.perf_counter around `calls` calls with no synchronise.
* ``batched_ms``: one pair of events around `launches` back-to-back calls,
  over the count: the larger of the card's time and the host's enqueue.

Every fn is a no-argument call that launches only on the current stream
and does not synchronise (every kernel wrapper of the port qualifies).
They need a CUDA card; nothing here runs at import.
"""

from __future__ import annotations

import statistics
import time

import torch


def event_ms(fn, runs: int, warmup: int = 2) -> float:
    """Median ms of fn() over `runs` calls, each between a pair of CUDA
    events recorded on an idle card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, launches: int = 50, runs: int = 5, fresh: bool = False) -> float:
    """Device ms a call of fn(): the median over `runs` replays of a CUDA
    graph of `launches` calls, each replay between one pair of CUDA events,
    over the count. Each captured call's output is freed before the next,
    which takes its memory, so the calls write one buffer over and over
    (for a background buffer of 33 MB, one the 50 MB L2 can hold);
    fresh=True keeps every output, so each call writes memory of its own."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    kept = []
    with torch.cuda.graph(graph):
        for _ in range(launches):
            out = fn()
            if fresh:
                kept.append(out)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph, kept
    return statistics.median(times)


def host_ms(fn, calls: int = 50, runs: int = 5, warmup: int = 10) -> float:
    """Host ms a call of fn(): the median over `runs` runs of
    time.perf_counter around `calls` calls with no synchronise (the card
    is drained before each run, outside the clock)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1000.0 / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def batched_ms(fn, launches: int = 50, runs: int = 5, warmup: int = 10) -> float:
    """Ms a call of fn(), for calls of tens of microseconds: one pair of
    CUDA events around `launches` back-to-back calls, over the count; the
    median of `runs` such batches. Host and card both inside the pair."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)

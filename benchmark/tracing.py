"""Reading the device from the benchmark's side: torch.profiler's device
intervals, their union (busy time), the idle gaps named by what the
benchmark's host code was doing, the heaviest device operations, and the
stage windows placed around the program's functions from outside.

The stage windows are a frozen copy of the pattern of the program's
utils/bench_frame.staged: a named function of a program module is
replaced, for the duration of a block, by a call that synchronises the
device before and after it inside a record_function range, so that every
device operation of that call lies inside the range; the frames inside
draw eagerly (pipeline.eager()), since a graph's replay calls no Python.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
from typing import Dict, Iterable, List, Tuple

import torch

HOST_PREFIX = "bench:"     # the benchmark's own host ranges
STAGE_PREFIX = "stage:"    # the stage windows
TOP = 10                   # entries of each breakdown list


def host_range(name: str):
    """A named range of the benchmark's host code in the profiler's trace."""
    return torch.profiler.record_function(HOST_PREFIX + name)


def device_intervals(events) -> List[Tuple[float, float, str]]:
    """(start_us, end_us, name) of each device operation (kernel, memcpy,
    memset) in a profile's events, sorted; the device copies of
    record_function ranges are left out."""
    out = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith((STAGE_PREFIX, HOST_PREFIX))]
    return sorted(out)


def host_ranges(events, prefix: str = HOST_PREFIX) -> List[Tuple[float, float, str]]:
    """(start_us, end_us, name) of the host ranges whose names start with
    prefix, the prefix removed, sorted by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name[len(prefix):])
                  for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.name.startswith(prefix))


def busy_us(intervals) -> float:
    """The length of the union of the intervals."""
    busy, end = 0.0, float("-inf")
    for s, e, _ in intervals:
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def idle_gaps(intervals, hosts, t0: float, t1: float) -> List[list]:
    """The TOP longest stretches of [t0, t1] in which no device operation
    ran, each named by the innermost of the benchmark's host ranges running
    at its start ("outside the benchmark's ranges" where none), in seconds."""
    gaps, end = [], t0
    for s, e, _ in intervals:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:TOP]:
        inside = [h for h in hosts if h[0] <= s < h[1]]
        name = min(inside, key=lambda h: h[1] - h[0])[2] if inside else \
            "outside the benchmark's ranges"
        out.append([name, (e - s) / 1e6])
    return out


def top_ops(intervals) -> List[list]:
    """The TOP device operations by their summed time, in seconds."""
    total: Dict[str, float] = {}
    for s, e, name in intervals:
        total[name] = total.get(name, 0.0) + (e - s)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:160], us / 1e6] for name, us in ranked]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def staged(device, functions: Iterable[str]):
    """Inside the block, each "module.attribute" of functions runs between
    two synchronisations inside a record_function("stage:<module.attribute>")
    range. The attributes are restored on exit."""
    from tpu_renderer_torch import pipeline

    originals = []
    for full in functions:
        mod_name, attr = full.rsplit(".", 1)
        mod = importlib.import_module(mod_name)
        originals.append((mod, attr, getattr(mod, attr), full))

    def wrap(name, fn):
        def call(*args, **kwargs):
            _sync(device)
            with torch.profiler.record_function(STAGE_PREFIX + name):
                out = fn(*args, **kwargs)
                _sync(device)
            return out
        return call

    try:
        for mod, attr, fn, full in originals:
            setattr(mod, attr, wrap(full, fn))
        with pipeline.eager():
            yield
    finally:
        for mod, attr, fn, _ in originals:
            setattr(mod, attr, fn)


def stage_device_us(events) -> Dict[str, float]:
    """Device time of the operations inside each stage window, by window
    name; each operation goes to the window it overlaps most."""
    windows = host_ranges(events, STAGE_PREFIX)
    starts = [w[0] for w in windows]
    out: Dict[str, float] = {}
    for s, e, _ in device_intervals(events):
        lo = max(bisect.bisect_right(starts, s) - 1, 0)
        hi = bisect.bisect_right(starts, e)
        best, name = 0.0, None
        for ws, we, wname in windows[lo:hi]:
            overlap = min(e, we) - max(s, ws)
            if overlap > best:
                best, name = overlap, wname
        if name is not None:
            out[name] = out.get(name, 0.0) + (e - s)
    return out

"""Tracing / profiling — the port's equivalent of the reference's
std::chrono counters + ImGui stats HUD (vk_engine.cpp:1164-1200, 1358-1359,
1472-1476; display vk_engine.cpp:1186-1190).

* ``tracing`` turns the program's span log on (off by default): host spans
  (``span``) on time.perf_counter_ns, and device spans (``device_span``,
  ``device_frame``), each boundary a one-thread stamp kernel
  (kernels/csrc/trace.cu) that appends the card's global timer to a log on
  the device. Stamps are captured into a frame graph like any launch, so
  they run in every replay and in every pass of the peel loop's WHILE node,
  where torch.profiler sees nothing. ``Trace.summary()`` reads the log by
  frame.
  The summary also lists the launches of the counters in LAUNCH_COUNTERS
  over the block (kernel 2.12's, those of its two-tap instance, and
  kernel 2.13's).
* ``setup_step`` / ``setup_record``: the set-up record, always on: the
  steps that run once (Engine.init, with the scene's sampler statics, the
  kernel library, a frame graph's first frame and capture).
* ``device_trace`` wraps torch.profiler for per-kernel device timing (the
  analog of GPU timestamp queries, which the reference does not have) and
  writes the span log beside it (spans.json).
* ``debug_mode`` turns on the NaN checks (the analog of the Vulkan
  validation layer, vk_engine.cpp:39-44): every torch operation and every
  CUDA kernel wrapper (``checked``) raises at the first NaN it writes; the
  frames inside draw eagerly (pipeline.eager()).
* ``stats_text`` is the stats window as text.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import importlib
import json
import os
import time
from typing import Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

HOST_PREFIX = "tpu_renderer_torch:"   # a host span's name in torch.profiler's trace
CALIBRATION_PAIRS = 20                # stamp-and-synchronise pairs at each end of a trace
TIMER_STEP_READS = 1 << 16            # global-timer reads that find its smallest step
# the launch counters a trace's summary lists: name -> (module under
# tpu_renderer_torch.kernels, counter)
LAUNCH_COUNTERS = {"shade.fused": ("shade", "fused_counter"),
                   "shade.trilinear": ("shade", "trilinear_counter"),
                   "vertex.setup": ("vertex", "setup_counter")}

# The open tracing() block's Trace, or None: the one test a span pays when
# tracing is off.
_active = None

# Span name -> tag, for the process's life: a captured graph holds its
# stamps' tags.
_tags: dict = {}
_names: list = []


def _tag(name: str) -> int:
    tag = _tags.get(name)
    if tag is None:
        tag = _tags[name] = len(_names)
        _names.append(name)
    return tag


class _Off:
    """What span and device_span return with tracing off: one shared
    context that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _capturing(device) -> bool:
    """Is the current stream of `device` capturing a graph?"""
    if device.type != "cuda":
        return False
    with torch.cuda.device(device):
        return torch.cuda.is_current_stream_capturing()


class _DeviceLog:
    """The stamps' log on one device: `rows` (capacity, 4) int64 of (tag * 2
    + 1 at a span's end, time ns, instance or -1, frame), and `state` [the
    cursor, the device frame counter]. The cursor counts past the capacity:
    what it counts beyond it was dropped. On the card a stamp is the
    trace_stamp kernel (csrc/trace.cu) on the current stream, its time the
    global timer; on the CPU its plain twin below, its time
    time.perf_counter_ns. Made before any capture that stamps into it (the
    graphs hold its pointers), kept for the process."""

    def __init__(self, device, capacity: int):
        self.device, self.capacity = device, capacity
        self.rows = torch.zeros((capacity, 4), dtype=torch.int64, device=device)
        self.state = torch.zeros(2, dtype=torch.int64, device=device)
        self.clock = torch.zeros(1, dtype=torch.int64, device=device)

    def stamp(self, code: int, instance, new_frame: bool) -> None:
        from tpu_renderer_torch.kernels import raster

        raster.stamp_counter.launches += 1
        if self.device.type == "cuda":
            raster._launch("trace_stamp", raster._ptr(self.rows), raster._ptr(self.state),
                           ctypes.c_longlong(self.capacity), ctypes.c_longlong(code),
                           None if instance is None else raster._ptr(instance),
                           ctypes.c_int(int(new_frame)), raster._stream(self.device))
            return
        t = time.perf_counter_ns()
        cursor, frame = self.state.tolist()
        frame += int(new_frame)
        if cursor < self.capacity:
            self.rows[cursor] = torch.tensor(
                [code, t, -1 if instance is None else int(instance), frame])
        self.state.copy_(torch.tensor([cursor + 1, frame]))

    def read(self):
        """(the stamps as lists, in the order they were made; the number
        dropped past the capacity)."""
        cursor = int(self.state[0])
        return self.rows[:min(cursor, self.capacity)].tolist(), max(cursor - self.capacity, 0)

    def calibrate(self):
        """(device ns, host ns, round trip ns): the tightest of
        CALIBRATION_PAIRS stamps of the global timer, each timed on
        time.perf_counter_ns from just before its launch to the end of a
        synchronise; its host time is the pair's midpoint. On the CPU the
        clocks are one."""
        if self.device.type != "cuda":
            t = time.perf_counter_ns()
            return t, t, 0
        from tpu_renderer_torch.kernels import raster

        best = None
        for _ in range(CALIBRATION_PAIRS):
            torch.cuda.synchronize(self.device)
            h0 = time.perf_counter_ns()
            raster._launch("trace_clock", raster._ptr(self.clock), raster._stream(self.device))
            torch.cuda.synchronize(self.device)
            h1 = time.perf_counter_ns()
            if best is None or h1 - h0 < best[2]:
                best = (int(self.clock), (h0 + h1) // 2, h1 - h0)
        return best

    def timer_step_ns(self) -> Optional[int]:
        """The global timer's smallest step, ns (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        from tpu_renderer_torch.kernels import raster

        raster._launch("trace_timer_step", raster._ptr(self.clock),
                       ctypes.c_int(TIMER_STEP_READS), raster._stream(self.device))
        return int(self.clock)


_logs: dict = {}   # (device, capacity) -> _DeviceLog


class Trace:
    """One tracing() block: the host spans, the device log's stamps (read
    at the block's end), the clocks' calibration at both ends, and the
    frames begun (eager frames and replays of a traced graph, counted on the
    host as the device counts them).

    The device spans stamp on the device the frame runs on (render_frame's
    device, a replayed graph's), into that device's log: the block takes it
    at its first stamp or replay there (log_on), and stamps on one device.

    A host span is [name, start ns, end ns, parent index (-1: none), frame];
    a span's frame is the one given, else its parent's, else the next frame
    to begin (top-level work prepares the next frame)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.device = self.log = None
        self.frame_device = None   # the device of the open device_frame
        self.frames = 0
        self.host: list = []
        self.host_dropped = 0
        self.stack: list = []
        self.timer_step_ns = None
        self.calibration: list = []
        self.stamps = None
        self.device_dropped = 0
        self._launches0 = _launch_totals()   # LAUNCH_COUNTERS at the block's start
        self.launches = None                # over the block, once closed

    def log_on(self, device) -> _DeviceLog:
        """The log of `device`, the block's one device: at its first use,
        emptied, the global timer's step read and the clocks calibrated,
        which a capture cannot do (a traced graph's first frame runs eagerly
        before its capture, and a replay is no capture)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self.log is not None:
            if device != self.device:
                raise ValueError(f"a tracing() block stamps on one device: this one "
                                 f"stamps on {self.device}, not {device}")
            return self.log
        if _capturing(device):
            raise RuntimeError("the trace's log is taken before the capture that stamps into it")
        key = (device, self.capacity)
        if key not in _logs:
            _logs[key] = _DeviceLog(device, self.capacity)
        self.device, self.log = device, _logs[key]
        self.log.state.zero_()
        self.timer_step_ns = self.log.timer_step_ns()
        self.calibration = [self.log.calibrate()]
        return self.log

    def close(self) -> None:
        self.launches = {k: n - self._launches0[k] for k, n in _launch_totals().items()}
        if self.log is None:   # nothing stamped
            self.stamps = []
            return
        self.calibration.append(self.log.calibrate())
        self.stamps, self.device_dropped = self.log.read()

    # -- the clocks ----------------------------------------------------------

    def to_host_ns(self, t: int) -> float:
        """A device time on time.perf_counter_ns: the offset of the two
        calibrations, interpolated linearly between them."""
        (g0, h0, _), (g1, h1, _) = self.calibration
        rate = (h1 - h0) / (g1 - g0) if g1 != g0 else 1.0
        return h0 + (t - g0) * rate

    # -- reading -------------------------------------------------------------

    def device_spans(self) -> list:
        """The closed device spans, [name, start ns, end ns (host clock),
        parent index, frame, instance], in the order they began. A span
        left open (a frame that raised) is dropped with what it held
        open."""
        spans, stack = [], []
        for code, t, instance, frame in self.stamps or []:
            tag, end = divmod(code, 2)
            if not end:
                spans.append([_names[tag], t, None, stack[-1] if stack else -1, frame, instance])
                stack.append(len(spans) - 1)
                continue
            while stack and spans[stack[-1]][0] != _names[tag]:
                stack.pop()
            if stack:
                spans[stack.pop()][2] = t
        closed = [i for i, s in enumerate(spans) if s[2] is not None]
        index = {old: new for new, old in enumerate(closed)}
        out = []
        for i in closed:
            name, t0, t1, parent, frame, instance = spans[i]
            while parent >= 0 and parent not in index:
                parent = spans[parent][3]
            out.append([name, self.to_host_ns(t0), self.to_host_ns(t1),
                        index.get(parent, -1), frame, instance])
        return out

    def summary(self) -> dict:
        """By traced frame (one whose `frame` device span closed), in
        order: device ms by span name, total and self (less the child
        spans), host ms by span name, the peel passes and the ms of those
        that shaded; over the trace, each host span's total and self ms and
        count; the device gaps between consecutive traced frames, longest
        first, each named by the innermost host span running at its start;
        the entries dropped past the capacity, device and host; the
        launches of LAUNCH_COUNTERS over the block (graph replays and the
        card-counted peel loop included); the calibration's spread (the
        larger round trip of the tightest pair at either end, us), the
        clocks' drift across the trace (us) and the global timer's step
        (ns)."""
        dev = self.device_spans()
        kids, shaded = _child_ms(dev), {s[3] for s in dev if s[0] == "shade"}
        frames: dict = {}
        for i, (name, t0, t1, parent, frame, _) in enumerate(dev):
            f = frames.setdefault(frame, dict(frame=frame, device_ms={}, device_self_ms={},
                                              host_ms={}, peel_passes=0, peel_shaded_ms=[]))
            ms = (t1 - t0) / 1e6
            f["device_ms"][name] = f["device_ms"].get(name, 0.0) + ms
            f["device_self_ms"][name] = f["device_self_ms"].get(name, 0.0) + ms - kids[i]
            if name == "peel_pass":
                f["peel_passes"] += 1
                if i in shaded:
                    f["peel_shaded_ms"].append(ms)
        host: dict = {}
        host_kids = _child_ms(self.host)
        for i, (name, t0, t1, parent, frame) in enumerate(self.host):
            if t1 is None:   # still open
                continue
            ms = (t1 - t0) / 1e6
            h = host.setdefault(name, dict(ms=0.0, self_ms=0.0, n=0))
            h["ms"] += ms
            h["self_ms"] += ms - host_kids[i]
            h["n"] += 1
            if frame in frames:
                per = frames[frame]["host_ms"]
                per[name] = per.get(name, 0.0) + ms
        whole = {s[4]: s for s in dev if s[0] == "frame" and s[3] == -1}
        traced = [frames[k] for k in sorted(frames) if k in whole]
        gaps = []
        for a, b in zip(traced, traced[1:]):
            start, stop = whole[a["frame"]][2], whole[b["frame"]][1]
            gaps.append([self.host_span_at(start), (stop - start) / 1e6])
        gaps.sort(key=lambda g: -g[1])
        calibration_us = drift_us = None
        if self.calibration:   # a device stamped
            (g0, h0, rt0), (g1, h1, rt1) = self.calibration
            calibration_us, drift_us = max(rt0, rt1) / 1e3, ((h1 - h0) - (g1 - g0)) / 1e3
        return dict(frames=traced, host=host, gaps=gaps,
                    dropped=self.device_dropped + self.host_dropped,
                    launches=dict(self.launches),
                    calibration_us=calibration_us, clock_drift_us=drift_us,
                    timer_step_ns=self.timer_step_ns)

    def host_span_at(self, t: float) -> str:
        """The innermost host span running at host time t."""
        inside = [s for s in self.host if s[2] is not None and s[1] <= t < s[2]]
        if not inside:
            return "outside the program's spans"
        return min(inside, key=lambda s: s[2] - s[1])[0]

    def to_json(self) -> dict:
        """spans.json: the host and device spans on time.perf_counter_ns,
        the set-up record, the summary, and unix_minus_perf_ns (what
        places a span on torch.profiler's clock, the Unix epoch)."""
        keys = ("name", "start_ns", "end_ns", "parent", "frame")
        return dict(host=[dict(zip(keys, s)) for s in self.host],
                    device=[dict(zip(keys + ("instance",), s)) for s in self.device_spans()],
                    setup=setup_record(), summary=self.summary(),
                    unix_minus_perf_ns=time.time_ns() - time.perf_counter_ns())


def _launch_totals() -> dict:
    """Each counter of LAUNCH_COUNTERS' launches so far (a sync a device
    tally)."""
    return {name: getattr(importlib.import_module(f"tpu_renderer_torch.kernels.{mod}"),
                          counter).total()
            for name, (mod, counter) in LAUNCH_COUNTERS.items()}


def _child_ms(spans) -> list:
    """For each span (its parent index at [3]), the ms its children
    cover."""
    out = [0.0] * len(spans)
    for s in spans:
        if s[3] >= 0 and s[2] is not None:
            out[s[3]] += (s[2] - s[1]) / 1e6
    return out


@contextlib.contextmanager
def tracing(capacity: int = 1 << 16):
    """Turn the span log on for the block; yields its Trace, read after the
    block (Trace.summary()). The device spans stamp on the device the
    frames run on (a card, or the CPU), one device a block. At most
    `capacity` device stamps and host spans are kept; the rest are dropped
    and counted. Frames drawn inside go through graphs of their own
    (frame_graph.graph_key holds graph_flag()). Blocks do not nest."""
    global _active
    if _active is not None:
        raise RuntimeError("tracing() blocks do not nest")
    trace = Trace(capacity)
    _active = trace
    try:
        yield trace
    finally:
        _active = None
        trace.close()


def graph_flag():
    """What a frame graph captured now holds of the trace: None with tracing
    off (no stamp), else the log's capacity (its stamps write that log)."""
    return None if _active is None else _active.capacity


def frame_number() -> int:
    """The frames the open trace has seen begin (0 with tracing off)."""
    return 0 if _active is None else _active.frames


def replayed_frame(device) -> None:
    """A traced graph's replay on `device` begins a frame (its device_frame
    stamp counts it on the card, in that device's log)."""
    if _active is not None:
        _active.log_on(device)
        _active.frames += 1


class _HostSpan:
    __slots__ = ("trace", "name", "frame", "index", "record")

    def __init__(self, trace, name, frame):
        self.trace, self.name, self.frame = trace, name, frame

    def __enter__(self):
        tr = self.trace
        parent = tr.stack[-1] if tr.stack else -1
        if self.frame is None:
            self.frame = tr.host[parent][4] if parent >= 0 else tr.frames + 1
        self.record = None
        if torch.autograd._profiler_enabled():
            self.record = torch.profiler.record_function(HOST_PREFIX + self.name)
            self.record.__enter__()
        if len(tr.host) < tr.capacity:
            self.index = len(tr.host)
            tr.host.append([self.name, time.perf_counter_ns(), None, parent, self.frame])
        else:
            self.index = -1
            tr.host_dropped += 1
        tr.stack.append(self.index)
        return self

    def __exit__(self, *exc):
        tr = self.trace
        if self.index >= 0:
            tr.host[self.index][2] = time.perf_counter_ns()
        tr.stack.pop()
        if self.record is not None:
            self.record.__exit__(*exc)
        return False


def span(name: str, frame: Optional[int] = None):
    """A host span around the block, while tracing: its name, start and end
    on time.perf_counter_ns, its parent span and its frame (`frame`, else
    the parent's, else the next frame to begin); under an active
    torch.profiler also a record_function("tpu_renderer_torch:<name>")."""
    if _active is None:
        return _OFF
    return _HostSpan(_active, name, frame)


class _DeviceSpan:
    __slots__ = ("trace", "tag", "instance", "device", "outer", "log")

    def __init__(self, trace, name, instance, device):
        self.trace, self.tag, self.instance = trace, _tag(name), instance
        self.device = device   # a frame's (device_frame), else None

    def __enter__(self):
        tr = self.trace
        if self.device is not None:   # a frame
            self.log = tr.log_on(self.device)
            if not _capturing(self.device):
                tr.frames += 1
            self.outer, tr.frame_device = tr.frame_device, self.device
        elif self.instance is not None:
            self.log = tr.log_on(self.instance.device)
        elif tr.frame_device is not None:
            self.log = tr.log_on(tr.frame_device)
        else:
            raise RuntimeError("a device span without an instance is inside a device_frame")
        self.log.stamp(2 * self.tag, self.instance, self.device is not None)
        return self

    def __exit__(self, exc_type, *exc):
        if self.device is not None:
            self.trace.frame_device = self.outer
        # not after a failure: a capture it invalidated takes no launch
        if exc_type is None:
            self.log.stamp(2 * self.tag + 1, self.instance, False)
        return False


def device_span(name: str, instance=None):
    """A device span around the block's work, while tracing: a stamp of the
    card's global timer where the block's first launch is enqueued and one
    after its last, on the device's current stream (kernels/csrc/trace.cu),
    captured into a graph or a conditional node's body like any launch.
    The device is `instance`'s, else the open device_frame's. instance: a
    one-element int32 tensor read on the card at each stamp (a peel pass's
    number). With tracing off nothing is launched."""
    if _active is None:
        return _OFF
    return _DeviceSpan(_active, name, instance, None)


def device_frame(device):
    """The device span `frame` around one frame's work on `device`, which
    the spans inside stamp on: its first stamp also counts the frame on the
    card, so every stamp inside carries it."""
    if _active is None:
        return _OFF
    return _DeviceSpan(_active, "frame", None, torch.device(device))


# -- the set-up record ----------------------------------------------------------

_setup = collections.deque(maxlen=256)
_setup_open: list = []


@contextlib.contextmanager
def setup_step(name: str):
    """Record a step that runs once (always on): its name, its parent step's
    name, its start on time.perf_counter_ns and its ms. Yields the record,
    to which the step may add what it measured."""
    rec = dict(name=name, parent=_setup_open[-1]["name"] if _setup_open else None,
               start_ns=time.perf_counter_ns())
    _setup_open.append(rec)
    try:
        yield rec
    finally:
        _setup_open.pop()
        rec["ms"] = (time.perf_counter_ns() - rec["start_ns"]) / 1e6
        _setup.append(rec)


def setup_record() -> list:
    """The set-up steps recorded in this process (the last 256), in the
    order they began."""
    return sorted((dict(r) for r in _setup), key=lambda r: r["start_ns"])


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with torch.profiler (host and, with a card, device
    activity) and the program's span log (tracing()); on exit write
    trace.json (a Chrome trace), key_averages.txt (time by operation) and
    spans.json (Trace.to_json()) into log_dir. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tracing() as trace, profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(row_limit=60))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(trace.to_json(), f)


# Operations that hand out memory without writing it: what they return is
# whatever the allocator held, NaN bit patterns included, until it is written.
_UNWRITTEN = frozenset({"empty", "empty_like", "empty_strided", "empty_permuted",
                        "new_empty", "new_empty_strided", "resize_"})


def check_outputs(name: str, out) -> None:
    """Raise FloatingPointError if a floating tensor of out (a tensor, or a
    tuple or list of them) holds a NaN. A host sync a tensor."""
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if (isinstance(t, torch.Tensor) and t.is_floating_point()
                and bool(torch.isnan(t).any())):
            raise FloatingPointError(f"debug_mode: invalid value (nan) "
                                     f"encountered in {name}")


class NanCheck(TorchDispatchMode):
    """debug_mode's dispatch mode: raises FloatingPointError at the first
    operation whose floating output holds a NaN, naming the operation."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNWRITTEN:
            check_outputs(str(func), out)
        return out


def _nan_checking() -> bool:
    """Is a debug_mode block active on this thread?"""
    return any(isinstance(m, NanCheck) for m in _get_current_dispatch_mode_stack())


def checked(kernel_wrapper):
    """Decorate a CUDA kernel wrapper: inside debug_mode its outputs are
    checked for NaN as every torch operation's are (the kernel launches
    through ctypes, which torch's dispatch does not see)."""

    @functools.wraps(kernel_wrapper)
    def wrapper(*args, **kwargs):
        out = kernel_wrapper(*args, **kwargs)
        if _nan_checking():
            check_outputs(kernel_wrapper.__name__, out)
        return out

    return wrapper


@contextlib.contextmanager
def debug_mode():
    """Validation-layer analog (the JAX package's debug_mode, which sets
    jax_debug_nans): inside the block every torch operation and every CUDA
    kernel wrapper checks its floating outputs and raises FloatingPointError
    at the first NaN, naming the operation or kernel. Infinities pass, as
    they do under jax_debug_nans (the frame makes them on purpose). Each
    check synchronises with the card; debug only. The frames inside draw
    eagerly (pipeline.eager()): a CUDA graph's replay dispatches no
    operation to check."""
    from tpu_renderer_torch import pipeline

    with NanCheck(), pipeline.eager():
        yield


def stats_text(stats) -> str:
    """The ImGui stats window, as text (vk_engine.cpp:1186-1190)."""
    return (
        f"frametime {stats.frame_time:.3f} ms\n"
        f"drawtime {stats.mesh_draw_time:.3f} ms\n"
        f"update time {stats.scene_update_time:.3f} ms\n"
        f"triangles {stats.triangle_count}\n"
        f"draws {stats.drawcall_count}"
    )

"""Tracing / profiling — the port's equivalent of the reference's
std::chrono counters + ImGui stats HUD (vk_engine.cpp:1164-1200, 1358-1359,
1472-1476; display vk_engine.cpp:1186-1190).

* ``FrameTimer`` reproduces the EngineStats wall-clock counters.
* ``device_trace`` wraps torch.profiler for per-kernel device timing (the
  analog of GPU timestamp queries, which the reference does not have).
* ``debug_mode`` turns on the NaN checks (the analog of the Vulkan
  validation layer, vk_engine.cpp:39-44): every torch operation and every
  CUDA kernel wrapper (``checked``) raises at the first NaN it writes; the
  frames inside draw eagerly (pipeline.eager()).
* ``stats_text`` is the stats window as text.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)


class FrameTimer:
    """Rolling wall-clock stats like the reference's per-frame chrono."""

    def __init__(self, window: int = 60):
        self.window = window
        self.samples: list[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples.append((time.perf_counter() - self._t0) * 1000.0)
        if len(self.samples) > self.window:
            self.samples.pop(0)

    @property
    def mean_ms(self) -> float:
        return sum(self.samples) / max(len(self.samples), 1)

    @property
    def fps(self) -> float:
        m = self.mean_ms
        return 1000.0 / m if m else 0.0


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with torch.profiler (host and, with a card, device
    activity); on exit write trace.json (a Chrome trace) and
    key_averages.txt (time by operation) into log_dir. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(row_limit=60))


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

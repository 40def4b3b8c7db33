"""Tracing / profiling — the port's equivalent of the reference's
std::chrono counters + ImGui stats HUD (vk_engine.cpp:1164-1200, 1358-1359,
1472-1476; display vk_engine.cpp:1186-1190).

* ``FrameTimer`` reproduces the EngineStats wall-clock counters.
* ``device_trace`` wraps torch.profiler for per-kernel device timing (the
  analog of GPU timestamp queries, which the reference does not have).
* ``stats_text`` is the stats window as text.
"""

from __future__ import annotations

import contextlib
import os
import time


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
    import torch
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


def stats_text(stats) -> str:
    """The ImGui stats window, as text (vk_engine.cpp:1186-1190)."""
    return (
        f"frametime {stats.frame_time:.3f} ms\n"
        f"drawtime {stats.mesh_draw_time:.3f} ms\n"
        f"update time {stats.scene_update_time:.3f} ms\n"
        f"triangles {stats.triangle_count}\n"
        f"draws {stats.drawcall_count}"
    )

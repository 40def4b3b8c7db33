"""The bench frame on one CUDA card: its scene, and where its time goes.

    python3 -m tpu_renderer_torch.utils.bench_frame [--path PATH] [--frames 20] [--out DIR]

The bench frame is the JAX package's bench.py frame: the demo scene at
grid=64 (seed 0), 1920x1080, camera (0, 6, 128), pitch -0.18, the default
gradient background, through Engine(device="cuda").draw_device(). --path
picks the frame: "bench" (the default), "trilinear" (its samplers
LINEAR_MIPMAP_LINEAR: two mip taps), "stress" (grid 128, camera (0, 6,
256)), "textured-glass" (the bench scene, its glass sampling the checker
texture: the depth peel, kernel 2.3) or "deferred" (fused=False: kernels
2.4 and 2.5). Run as a script, this module prints, each from its own pass
over the same engine:

1. frame ms, graphed (a replay of the engine's frame graph,
   frame_graph.py) and eager (pipeline.eager()) in turns, graphed, eager,
   eager, graphed, --frames / 2 frames a turn: host clock around
   draw_device() ending in synchronize(), median, p25, p75 and min; the
   host ms of the draw_device() call itself (before the synchronize); the
   host syncs inside it (torch.cuda.set_sync_debug_mode's warnings); the
   peak device memory of one frame each way; and each capture's ms and
   memory pool MiB;
2. stage ms, eager: each stage of pipeline.render_frame (PATHS[path])
   between two synchronize() calls, host clock, summed within a frame,
   median over --frames frames;
3. under torch.profiler, over --profile-frames frames as in 1, graphed and
   eager: device busy ms a frame (the union of kernel, memcpy and memset
   intervals), device operations a frame, the frame's wall ms under the
   profiler, and the idle share 1 - busy / wall, all of the same profiled
   frames;
4. under torch.profiler, eager, with the stages of 2: each stage's device
   ms, the device work that ran inside the stage's synchronised host window
   (each operation goes to the window it overlaps most; work between
   windows, the composites, is "other").

It writes key_averages.txt (pass 3, graphed; key_averages_eager.txt eager)
and bench_frame.json under --out (default: profile/ in the checkout's
output directory, which .gitignore lists). Without CUDA it exits 1. For a --path other than "bench", the
names end in _<path>.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from tpu_renderer_torch import pipeline
from tpu_renderer_torch.config import RendererConfig
from tpu_renderer_torch.engine import Engine
from tpu_renderer_torch.kernels import raster, shade, vertex
from tpu_renderer_torch.scene import load_scene
from tpu_renderer_torch.utils.demo import build_demo_glb

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = dict(width=1920, height=1080, grid=64, camera=(0.0, 6.0, 128.0), pitch=-0.18)

# (name, module, attribute): the functions render_frame calls by module
# attribute, in frame order. sort+bins runs twice a frame (opaque and
# transparent); the background is cached by the Engine and not a stage.
STAGES = (
    ("cull", vertex, "draw_visibility"),
    ("setup", vertex, "triangle_setup_rows"),
    ("sort+bins", pipeline, "_binned"),
    ("raster A + epilogue", raster, "rasterize_fused"),
    ("shade", shade, "shade_fused"),
    ("accum B", raster, "rasterize_accum"),
    ("present", pipeline, "to_packed_u32"),
)
# The textured-glass frame: shade runs once for the opaque pass and once a
# layer; the peel's binning (pipeline._bins) falls under "other".
PEEL_STAGES = (
    ("cull", vertex, "draw_visibility"),
    ("setup", vertex, "triangle_setup_rows"),
    ("sort+bins", pipeline, "_binned"),
    ("raster A + epilogue", raster, "rasterize_fused"),
    ("peel 2.3 + epilogue", raster, "rasterize_peel_fused"),
    ("shade", shade, "shade_fused"),
    ("present", pipeline, "to_packed_u32"),
)
# The deferred frame (fused=False): opaque and transparent setups, bins and
# refines summed; the layer blend shades its layer.
DEFERRED_STAGES = (
    ("cull", vertex, "draw_visibility"),
    ("setup", vertex, "triangle_setup_c"),
    ("fat rows", shade, "build_shade_rows"),
    ("chunk bins", raster, "bin_triangles"),
    ("refine bins", raster, "refine_bins"),
    ("raster 2.4", raster, "rasterize"),
    ("shade", shade, "shade"),
    ("peel 2.5", raster, "rasterize_peel"),
    ("blend layer", shade, "blend_layer"),
    ("present", pipeline, "to_packed_u32"),
)
PATHS = {"bench": STAGES, "trilinear": STAGES, "stress": STAGES,
         "textured-glass": PEEL_STAGES, "deferred": DEFERRED_STAGES}
MODES = ("graphed", "eager", "eager", "graphed")   # the turns of pass 1
HAND_KERNELS = ("raster_fused_kernel", "raster_accum_kernel", "raster_peel_fused_kernel",
                "raster_deferred_kernel", "raster_peel_deferred_kernel")
STAGE_PREFIX = "stage:"


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi prints them; raises if
    nvidia-smi fails or prints nothing."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    if out.returncode != 0 or not line:
        raise RuntimeError(f"nvidia-smi failed (rc {out.returncode}): "
                           f"{out.stderr.strip()}")
    return line


def texture_the_glass(scene):
    """The demo scene's glass material samples the checker material's
    texture, with its sampler: the scene's transparency then binds a
    texture and takes the depth peel. Returns the scene."""
    checker = next(m for m in scene.materials if m.name == "checker")
    for m in scene.materials:
        if m.name == "glass":
            m.tex, m.filter_flags = checker.tex, checker.filter_flags
    return scene


def bench_engine(scene_path: str, device="cuda", grid: int = BENCH["grid"],
                 width: int = BENCH["width"], height: int = BENCH["height"],
                 scene=None, trilinear: bool = False, **config) -> Engine:
    """An initialised Engine on the bench scene, at the bench camera. With
    no scene given, writes the scene's GLB (demo grid `grid`; trilinear:
    with LINEAR_MIPMAP_LINEAR samplers) to scene_path and loads it;
    otherwise renders the given LoadedScene. The size arguments exist for
    small runs on the CPU; config holds further RendererConfig fields
    (fused=False: the deferred path)."""
    cfg = RendererConfig(width=width, height=height,
                         **{"camera_position": BENCH["camera"], **config})
    eng = Engine(cfg, device=device)
    eng.camera.pitch = np.float32(BENCH["pitch"])
    if scene is None:
        build_demo_glb(scene_path, grid=grid, seed=0, trilinear=trilinear)
        eng.init(scene_path=scene_path)
    else:
        eng.init(scene=scene)
    return eng


def path_engine(path: str, scene_path: str, device="cuda", **size) -> Engine:
    """The engine of one of PATHS on the bench scene (size: grid, width,
    height and camera_position, for small runs on the CPU)."""
    if path in ("bench", "trilinear"):
        return bench_engine(scene_path, device=device, trilinear=path == "trilinear", **size)
    if path == "stress":
        grid = size.pop("grid", 2 * BENCH["grid"])
        return bench_engine(scene_path, device=device, grid=grid,
                            **{"camera_position": (0.0, 6.0, 2.0 * grid), **size})
    grid = size.pop("grid", BENCH["grid"])
    build_demo_glb(scene_path, grid=grid, seed=0)
    scene = load_scene(scene_path)
    if path == "textured-glass":
        return bench_engine(scene_path, device=device, scene=texture_the_glass(scene),
                            **size)
    return bench_engine(scene_path, device=device, scene=scene, fused=False, **size)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def staged(device, record, stages=STAGES):
    """Run every stage function between two synchronize() calls, inside a
    record_function("stage:<name>") range; record(name, ms) receives each
    call's host ms. The functions are restored on exit. Frames inside draw
    eagerly (pipeline.eager()): a frame graph's replay calls no stage."""
    originals = [(mod, attr, getattr(mod, attr)) for _, mod, attr in stages]

    def wrap(name, fn):
        def call(*args, **kwargs):
            _sync(device)
            with torch.profiler.record_function(STAGE_PREFIX + name):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                _sync(device)
                record(name, (time.perf_counter() - t0) * 1000.0)
            return out
        return call

    try:
        for (name, mod, attr), (_, _, fn) in zip(stages, originals):
            setattr(mod, attr, wrap(name, fn))
        with pipeline.eager():
            yield
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)


def mode(name: str):
    """The block for a turn of pass 1: "graphed" draws as the Engine does
    by default, "eager" inside pipeline.eager()."""
    return pipeline.eager() if name == "eager" else contextlib.nullcontext()


class SyncCount:
    """Host syncs inside the block: each call torch finds synchronising
    with the card (torch.cuda.set_sync_debug_mode("warn"): a value read on
    the host, a copy that waits) warns once, and `calls` counts them."""

    def __enter__(self):
        self._catch = warnings.catch_warnings(record=True)
        self._seen = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        self.calls = sum("called a synchronizing CUDA operation" in str(w.message)
                         for w in self._seen)
        return False


def turn_times(eng: Engine, n: int) -> dict:
    """Per frame over n frames: wall ms (a synchronised start to a
    synchronised end), host ms of the draw_device() call, and its host
    syncs (SyncCount)."""
    out = dict(wall=[], host=[], syncs=[])
    for _ in range(n):
        _sync(eng.device)
        t0 = time.perf_counter()
        with SyncCount() as syncs:
            eng.draw_device()
        t1 = time.perf_counter()
        _sync(eng.device)
        out["wall"].append((time.perf_counter() - t0) * 1000.0)
        out["host"].append((t1 - t0) * 1000.0)
        out["syncs"].append(syncs.calls)
    return out


def frame_times(eng: Engine, n: int) -> list:
    """Host ms of n frames, each from a synchronised start to a
    synchronised end."""
    times = []
    for _ in range(n):
        _sync(eng.device)
        t0 = time.perf_counter()
        eng.draw_device()
        _sync(eng.device)
        times.append((time.perf_counter() - t0) * 1000.0)
    return times


def stage_times(eng: Engine, n: int, stages=STAGES, per_call: bool = False,
                before_frame=None) -> dict:
    """Median host ms of each stage (summed within a frame) and of the
    synchronised frame, over n frames. per_call: a stage's k-th call in a
    frame is kept apart, under "name#k". before_frame(eng) runs ahead of
    each frame, outside its time."""
    frames, seen = [], []

    def record(name, ms):
        if per_call:
            k = sum(1 for key in frames[-1] if key.split("#")[0] == name)
            name = f"{name}#{k}"
        if name not in seen:
            seen.append(name)
        frames[-1][name] = frames[-1].get(name, 0.0) + ms

    with staged(eng.device, record, stages):
        for _ in range(n):
            if before_frame is not None:
                before_frame(eng)
            frames.append({})
            frames[-1]["frame"] = frame_times(eng, 1)[0]
    names = (seen if per_call else [s[0] for s in stages]) + ["frame"]
    return {k: statistics.median(f.get(k, 0.0) for f in frames) for k in names}


def _device_intervals(events) -> list:
    """(start_us, end_us, name) of each device operation (kernel, memcpy,
    memset) in a profile's events, sorted; the device copies of
    record_function ranges are left out."""
    out = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith(STAGE_PREFIX)]
    return sorted(out)


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e, _ in intervals:
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def profile_frames(eng: Engine, n: int, out_dir: str, suffix: str = "") -> dict:
    """Pass 3: n unsynchronised frames under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _sync(eng.device)
        t0 = time.perf_counter()
        for _ in range(n):
            eng.draw_device()
        _sync(eng.device)
        wall_ms = (time.perf_counter() - t0) * 1000.0
    dev = _device_intervals(prof.events())
    if not dev:
        raise RuntimeError("the profiler recorded no device time")
    busy_ms = _union_us(dev) / 1000.0
    kernels = sum(1 for *_, name in dev if not name.startswith(("Memcpy", "Memset")))
    hand = {k: sum(e - s for s, e, name in dev if k in name) / 1000.0 / n
            for k in HAND_KERNELS}
    with open(os.path.join(out_dir, f"key_averages{suffix}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=80))
    return dict(frames=n, wall_ms_per_frame=wall_ms / n,
                device_busy_ms_per_frame=busy_ms / n,
                idle_share=1.0 - busy_ms / wall_ms,
                device_ops_per_frame=len(dev) / n,
                kernels_per_frame=kernels / n, hand_kernel_ms_per_frame=hand)


def profile_stages(eng: Engine, n: int, stages=STAGES) -> dict:
    """Pass 4: device ms a frame of each stage, from n synchronised-stage
    frames under torch.profiler; device work outside every stage window
    counts as "other"."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with staged(eng.device, lambda name, ms: None, stages):
            frame_times(eng, n)
    events = prof.events()
    windows = sorted((e.time_range.start, e.time_range.end, e.name[len(STAGE_PREFIX):])
                     for e in events
                     if e.device_type == torch.autograd.DeviceType.CPU
                     and e.name.startswith(STAGE_PREFIX))
    per_stage = {s[0]: 0.0 for s in stages}
    per_stage["other"] = 0.0
    for s, e, _ in _device_intervals(events):
        per_stage[_window_of(windows, s, e)] += (e - s) / 1000.0
    return {k: v / n for k, v in per_stage.items()}


def _window_of(windows, s: float, e: float) -> str:
    """Name of the (start, end, name) window, sorted and disjoint, that
    [s, e] overlaps most; "other" if it overlaps none. The most overlap,
    not the start alone, so a host/device clock offset of a few
    microseconds cannot move a long kernel out of its stage."""
    starts = [w[0] for w in windows]
    lo = max(bisect.bisect_right(starts, s) - 1, 0)
    hi = bisect.bisect_right(starts, e)
    best, name = 0.0, "other"
    for ws, we, wname in windows[lo:hi]:
        overlap = min(e, we) - max(s, ws)
        if overlap > best:
            best, name = overlap, wname
    return name


def _quartiles(times) -> dict:
    q = statistics.quantiles(times, n=4)
    return dict(median=statistics.median(times), p25=q[0], p75=q[2], min=min(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=sorted(PATHS), default="bench")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--profile-frames", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_frame: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(f"[device] {smi}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    eng = path_engine(args.path, os.path.join(args.out, f"bench_scene_{args.path}.glb"))
    stages = PATHS[args.path]
    suffix = "" if args.path == "bench" else f"_{args.path}"
    print(f"[path] {args.path}: fused={eng._fused}, caps {eng._caps}", flush=True)
    eng.draw()                              # warm-up and build; captured; fills eng.stats
    eng.draw()                              # the deferred caps have escalated
    peak_mib = {}
    for name in ("graphed", "eager"):
        with mode(name):
            frame_times(eng, 2)
            torch.cuda.reset_peak_memory_stats()
            frame_times(eng, 1)
        peak_mib[name] = torch.cuda.max_memory_allocated() / 2 ** 20

    turns = {name: dict(wall=[], host=[], syncs=[]) for name in MODES}
    for name in MODES:
        with mode(name):
            got = turn_times(eng, max(args.frames // 2, 1))
        for k, v in got.items():
            turns[name][k] += v
    frame = {}
    for name, t in turns.items():
        frame[name] = dict(wall=_quartiles(t["wall"]), host_median=statistics.median(t["host"]),
                           syncs_per_frame=sum(t["syncs"]) / len(t["syncs"]),
                           peak_mib=peak_mib[name])
        print(f"[frame] {name}: {eng.stats.triangle_count} tris; wall ms over "
              f"{len(t['wall'])} frames in turns {'/'.join(MODES)}: "
              + ", ".join(f"{k} {v:.3f}" for k, v in frame[name]["wall"].items())
              + f"; draw_device() host ms median {frame[name]['host_median']:.3f}; "
              f"{frame[name]['syncs_per_frame']:.1f} host syncs a frame; peak device "
              f"memory {peak_mib[name]:.1f} MiB", flush=True)
    captures = [dict(capture_ms=ms, pool_mib=mib) for ms, mib in eng.frame_graphs.captured]
    print("[graph] captures: " + ", ".join(f"{c['capture_ms']:.1f} ms, pool "
                                          f"{c['pool_mib']:.1f} MiB" for c in captures),
          flush=True)
    stage_ms = stage_times(eng, args.frames, stages)
    print(f"[stages] eager, host ms, synchronised, median of {args.frames}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()), flush=True)
    prof = {}
    for name in ("graphed", "eager"):
        with mode(name):
            prof[name] = p = profile_frames(eng, args.profile_frames, args.out,
                                            suffix + ("_eager" if name == "eager" else ""))
        print(f"[profile] {name}: {p['frames']} frames under the profiler: wall "
              f"{p['wall_ms_per_frame']:.3f} ms/frame, device busy "
              f"{p['device_busy_ms_per_frame']:.3f} ms/frame, idle share "
              f"{p['idle_share']:.3f}, {p['device_ops_per_frame']:.1f} device "
              f"ops/frame ({p['kernels_per_frame']:.1f} kernels); "
              + ", ".join(f"{k} {v:.3f} ms/frame"
                          for k, v in p["hand_kernel_ms_per_frame"].items()), flush=True)
    dev_stages = profile_stages(eng, args.profile_frames, stages)
    print(f"[profile] eager, device ms/frame by stage ({args.profile_frames} frames): "
          + ", ".join(f"{k} {v:.3f}" for k, v in dev_stages.items()), flush=True)
    result = dict(device=smi, path=args.path, caps=eng._caps, frame_ms=frame,
                  captures=captures, stage_host_ms=stage_ms, profile=prof,
                  stage_device_ms=dev_stages)
    with open(os.path.join(args.out, f"bench_frame{suffix}.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

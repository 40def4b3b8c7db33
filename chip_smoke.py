"""Smoke run of the PyTorch + CUDA port on one GPU (sm_90a: an H100).

    python3 chip_smoke.py

Drives tpu_renderer_torch's paths on the card and checks them:

1. without CUDA exits 1 before doing anything else; prints the card's name
   and power limit (nvidia-smi, which must succeed);
2. builds the raster kernels from tpu_renderer_torch/kernels/csrc with nvcc,
   one process per source (or reuses the library an earlier run built from
   the same sources);
3. the bench frame (the demo scene at grid=64, 1920x1080, camera
   (0, 6, 128), pitch -0.18): renders it once and, on the inputs the frame
   gave kernels 2.1 and 2.2, holds each kernel against its plain PyTorch
   version (exact on every output) and times both with CUDA events; then
   resets the launch counters, renders 1 + 20 frames through
   Engine(device="cuda") and fails unless both kernels were launched; the
   same frame rendered through the plain versions must be identical;
4. the textured-glass bench frame (the same scene, its glass sampling the
   checker texture, so its transparency takes the depth peel): kernel 2.3
   against its plain version on the first peel's inputs and a later one's,
   timed; 1 + 5 frames with the counters reset, layers per frame and the
   host's wait at the per-layer syncs; the plain-version frame must be
   identical;
5. the deferred bench frame (fused=False): the caps the escalation reached,
   kernels 2.4 and 2.5 against their plain versions (2.5 on two peels),
   timed; 1 + 5 frames counted; the plain-version frame must be identical;
6. a scene past the dense-bin guard (build_demo_glb(grid=320), default
   config): the engine takes the deferred path by itself; one counted
   frame;
7. renders the structure scene at 480x270 and 1920x1080 and holds it to
   tests/goldens/structure_*.png (at most 0.1% of pixels may differ);
8. prints a JSON line of per-kernel results (launches on its path,
   max_abs_err against the plain version, ms and plain ms, the bound from
   this run's inputs), the nvidia-smi line, and, last,
   {"ok": true, "device": {...}}.

Scene files go to chiprun_out/smoke/ inside the checkout. Any failure raises.
"""

import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "smoke")
FRAME_TOL = 0.001        # whole frame: share of pixels allowed to differ
# Published H100 SXM peaks: fp32 outside
# the tensor cores, and HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FLOPS_PER_TEST = 16      # 3 edge planes + the depth plane, 4 flops each
FLOPS_PER_FRAGMENT = 40  # kernel 2.2's shading of a taken fragment
PIXELS_PER_TILE = 32 * 128

# name -> (plain version, launch counter, source, replaced Pallas kernel)
KERNELS = {
    "raster_fused_kernel": ("rasterize_fused_plain", "fused_counter",
                            "tpu_renderer_torch/kernels/csrc/raster_fused.cu",
                            "tpu_renderer/kernels/raster.py:1128"),
    "raster_accum_kernel": ("rasterize_accum_plain", "accum_counter",
                            "tpu_renderer_torch/kernels/csrc/raster_accum.cu",
                            "tpu_renderer/kernels/raster.py:1690"),
    "raster_peel_fused_kernel": ("rasterize_peel_fused_plain", "peel_fused_counter",
                                 "tpu_renderer_torch/kernels/csrc/raster_peel.cu",
                                 "tpu_renderer/kernels/raster.py:1987"),
    "raster_deferred_kernel": ("rasterize_plain", "deferred_counter",
                               "tpu_renderer_torch/kernels/csrc/raster_deferred.cu",
                               "tpu_renderer/kernels/raster.py:642"),
    "raster_peel_kernel": ("rasterize_peel_plain", "peel_counter",
                           "tpu_renderer_torch/kernels/csrc/raster_deferred.cu",
                           "tpu_renderer/kernels/raster.py:749"),
}


def build_line(nvcc_seconds, load_seconds: float) -> str:
    """The build phase's report; nvcc_seconds is None when the library
    built earlier from the same sources was reused."""
    nvcc = ("cached library reused (no nvcc run)" if nvcc_seconds is None
            else f"nvcc {nvcc_seconds:.2f} s")
    return f"[build] {nvcc}, load {load_seconds:.2f} s"


def cuda_ms(fn, runs: int, warmup: int = 2) -> float:
    """Median milliseconds of fn() over `runs` runs, timed by CUDA events."""
    import torch

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


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def max_abs_err(got, want) -> float:
    """Largest difference over matching output tensors; raises unless they
    are bit-identical (the kernels are exact against their plain versions)."""
    import torch

    err = 0.0
    for g, w in zip(_tuple(got), _tuple(want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        if g.numel():
            err = max(err, float((g.double() - w.double()).abs().max()))
        bits = (lambda t: t.view(torch.int32)) if g.dtype == torch.float32 else (lambda t: t)
        assert torch.equal(bits(g), bits(w)), f"kernel differs from plain version by {err}"
    return err


def capture_kernel_inputs(draw, names):
    """Run draw(), recording the arguments of every launch of the named
    kernels (the path's real inputs): name -> list of (args, kwargs)."""
    from tpu_renderer_torch.kernels import raster

    seen = {n: [] for n in names}
    originals = {n: getattr(raster, n) for n in names}

    def recorder(name):
        def call(*args, **kwargs):
            seen[name].append((args, kwargs))
            return originals[name](*args, **kwargs)
        return call

    for n in names:
        setattr(raster, n, recorder(n))
    try:
        draw()
    finally:
        for n, f in originals.items():
            setattr(raster, n, f)
    missing = [n for n in names if not seen[n]]
    assert not missing, f"kernels not reached: {missing}"
    return seen


def _live_entries(bins, counts):
    """(n_tiles, W) mask of the bin slots inside each tile's count."""
    import torch

    n = counts.clamp(max=bins.shape[1])
    return torch.arange(bins.shape[1], device=bins.device)[None, :] < n[:, None]


def _frame_tiles(plane, tiles_x, tiles_y):
    """(Hp, Wp) -> (n_tiles, 32 * 128) tile-major."""
    return plane.reshape(tiles_y, 32, tiles_x, 128).transpose(1, 2).reshape(
        tiles_x * tiles_y, -1)


def work_tests(name, args, kwargs, out) -> int:
    """Triangle-pixel tests the function needs on these inputs. Dense bins
    hold chunks: each live 8-triangle group of an entry is 8 tests a
    pixel. Per-triangle bins: one test a live entry and pixel. A peel
    needs, for each pixel, the entries up to the one that holds the layer
    it finds (ids ascend along a bin), and every live entry where it finds
    none; the other kernels test every live entry at every pixel."""
    import torch

    from tpu_renderer_torch.kernels import raster

    table, bins, counts = args[0], args[1], args[2]
    live = _live_entries(bins, counts)
    if name in ("raster_fused_kernel", "raster_accum_kernel", "raster_peel_fused_kernel"):
        key = bins >> raster.entry_shift(raster.CHUNK // raster.GROUP)   # chunk id
        live &= (bins >= 0) & (key < table.shape[0] // raster.CHUNK)
        work = sum(((bins >> g) & 1) for g in range(raster.CHUNK // raster.GROUP)) * raster.GROUP
        per_id = raster.CHUNK
    else:
        key = bins
        live &= (bins >= 0) & (bins < table.shape[0])
        work = torch.ones_like(bins)
        per_id = 1
    work = work * live
    if name not in ("raster_peel_fused_kernel", "raster_peel_kernel"):
        return int(work.sum()) * PIXELS_PER_TILE
    layer = _frame_tiles(_tuple(out)[0], kwargs["tiles_x"], kwargs["tiles_y"])
    stop = torch.where(layer < raster.ID_INF, layer // per_id, raster.ID_INF)
    key, order = torch.where(live, key, torch.iinfo(torch.int32).max).sort(dim=1)
    done = torch.cat([torch.zeros_like(work[:, :1]), work.gather(1, order).cumsum(dim=1)], dim=1)
    return int(done.gather(1, torch.searchsorted(key, stop, right=True)).sum())


def bound(name, args, kwargs, out):
    """(bound_ms, bound_by): the larger of the operations at the fp32 peak
    and the bytes at the HBM rate: every input read once, of the bins only
    the live entries, every output written once."""
    import torch

    flops = work_tests(name, args, kwargs, out) * FLOPS_PER_TEST
    if name == "raster_accum_kernel":
        flops += int(out[1].sum()) * FLOPS_PER_FRAGMENT
    bins, counts = args[1], args[2]
    tensors = [a for a in args if isinstance(a, torch.Tensor) and a is not bins] + list(_tuple(out))
    nbytes = (sum(t.numel() * t.element_size() for t in tensors)
              + int(counts.clamp(max=bins.shape[1]).sum()) * bins.element_size())
    alu_ms, hbm_ms = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (alu_ms, "operations") if alu_ms >= hbm_ms else (hbm_ms, "bytes")


def check_kernel(name, calls, label):
    """Hold the kernel against its plain version on each captured call,
    then time both on the first; returns the kernel's JSON entry."""
    import torch

    from tpu_renderer_torch.kernels import raster

    kernel = getattr(raster, name)
    plain_name, _, source, replaces = KERNELS[name]
    plain = getattr(raster, plain_name)
    err = 0.0
    for i, (args, kwargs) in calls:
        got = kernel(*args, **kwargs)
        want = plain(*args, **kwargs)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
        bins, counts = args[1], args[2]
        print(f"[kernel] {name} ({label}, call {i}): bins {tuple(bins.shape)}, "
              f"entries {int(counts.clamp(max=bins.shape[1]).sum())}, max/tile "
              f"{int(counts.max())}; exact vs plain (max_abs_err {err})", flush=True)
    args, kwargs = calls[0][1]
    out = kernel(*args, **kwargs)
    bound_ms, bound_by = bound(name, args, kwargs, out)
    ms = cuda_ms(lambda: kernel(*args, **kwargs), runs=20)
    plain_ms = cuda_ms(lambda: plain(*args, **kwargs), runs=3, warmup=1)
    print(f"[kernel] {name}: {ms:.4f} ms (median of 20), plain {plain_ms:.2f} ms "
          f"(median of 3), bound {bound_ms:.4f} ms by {bound_by}", flush=True)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def reset_counters():
    from tpu_renderer_torch.kernels import raster

    for _, counter, _, _ in KERNELS.values():
        getattr(raster, counter).launches = 0


def read_counters():
    from tpu_renderer_torch.kernels import raster

    return {n: getattr(raster, c).launches for n, (_, c, _, _) in KERNELS.items()}


class SyncTimer:
    """Host ms spent in pipeline._layer_found, the peel loop's one sync a
    layer, and its calls."""

    def __enter__(self):
        from tpu_renderer_torch import pipeline

        self.ms, self.calls = 0.0, 0
        self._orig = pipeline._layer_found

        def timed(found):
            t0 = time.perf_counter()
            v = self._orig(found)
            self.ms += (time.perf_counter() - t0) * 1000.0
            self.calls += 1
            return v

        pipeline._layer_found = timed
        return self

    def __exit__(self, *exc):
        from tpu_renderer_torch import pipeline

        pipeline._layer_found = self._orig


def counted_frames(eng, n, path, expect):
    """The path, counted: counters to 0, one draw() and n timed
    draw_device() frames, counters read. Returns (median ms, image, layers
    per frame, sync ms per frame, launches)."""
    import torch

    reset_counters()
    image = eng.draw()
    times, layers = [], []
    with SyncTimer() as sync:
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _img, aux = eng.draw_device()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1000.0)
            layers.append(int(aux.get("transparent_layers", torch.zeros(()))))
    launches = read_counters()
    for k in expect:
        assert launches[k] > 0, f"{k} was never launched on the {path} path"
    med = statistics.median(times)
    print(f"[frame] {path}: {eng.stats.triangle_count} tris, median {med:.3f} ms over "
          f"{n} frames (min {min(times):.3f}); transparent layers {layers}; "
          f"sync wait {sync.ms / n:.3f} ms/frame over {sync.calls / n:.1f} syncs; "
          f"launches {launches}", flush=True)
    return med, image, layers, sync.ms / n, launches


def plain_frame(eng, names):
    """The same frame with the named kernels replaced by their plain
    versions; must equal the kernel frame."""
    from tpu_renderer_torch.kernels import raster

    originals = {n: getattr(raster, n) for n in names}
    for n in names:
        setattr(raster, n, getattr(raster, KERNELS[n][0]))
    try:
        return eng.draw()
    finally:
        for n, f in originals.items():
            setattr(raster, n, f)


def bench_path(eng, results):
    """Phase 3: the bench frame (kernels 2.1, 2.2)."""
    names = ("raster_fused_kernel", "raster_accum_kernel")
    seen = capture_kernel_inputs(eng.draw_device, names)
    for n in names:
        results[n] = check_kernel(n, [(0, seen[n][-1])], "bench frame")
    frame_ms, image, _, _, launches = counted_frames(eng, 20, "bench frame", names)
    assert np.array_equal(image, plain_frame(eng, names)), "kernel frame differs from plain frame"
    print(f"[frame] bench frame == plain-version frame; frame ms {frame_ms:.3f}", flush=True)
    for n in names:
        results[n]["launches"] = launches[n]


def textured_glass_path(scene_path, results):
    """Phase 4: the textured-glass bench frame (kernel 2.3's peel loop)."""
    from tpu_renderer_torch.scene import load_scene
    from tpu_renderer_torch.utils.bench_frame import bench_engine, texture_the_glass

    t0 = time.perf_counter()
    eng = bench_engine(scene_path, scene=texture_the_glass(load_scene(scene_path)))
    assert eng._fused and eng._transp_textured()
    print(f"[scene] textured-glass bench scene ready in {time.perf_counter() - t0:.2f} s",
          flush=True)
    name = "raster_peel_fused_kernel"
    seen = capture_kernel_inputs(eng.draw_device, (name,))
    calls = seen[name]
    later = len(calls) // 2
    results[name] = check_kernel(name, [(0, calls[0]), (later, calls[later])],
                                 "textured-glass frame")
    frame_ms, image, layers, sync_ms, launches = counted_frames(
        eng, 5, "textured-glass frame", ("raster_fused_kernel", name))
    assert np.array_equal(image, plain_frame(eng, ("raster_fused_kernel", name))), \
        "textured-glass kernel frame differs from plain frame"
    print(f"[frame] textured-glass frame == plain-version frame; frame ms {frame_ms:.3f}, "
          f"{layers[0]} layers, {len(calls)} peel launches a frame", flush=True)
    results[name]["launches"] = launches[name]


def deferred_path(scene_path, results):
    """Phase 5: the deferred bench frame (kernels 2.4 and 2.5)."""
    from tpu_renderer_torch.utils.bench_frame import bench_engine

    eng = bench_engine(scene_path, fused=False)
    assert not eng._fused
    caps0 = dict(eng._caps)
    eng.draw()                             # escalates the caps on overflow
    print(f"[frame] deferred: caps {caps0} -> {eng._caps}", flush=True)
    names = ("raster_deferred_kernel", "raster_peel_kernel")
    seen = capture_kernel_inputs(eng.draw_device, names)
    results[names[0]] = check_kernel(names[0], [(0, seen[names[0]][0])], "deferred frame")
    peels = seen[names[1]]
    later = len(peels) // 2
    results[names[1]] = check_kernel(names[1], [(0, peels[0]), (later, peels[later])],
                                     "deferred frame")
    frame_ms, image, layers, sync_ms, launches = counted_frames(
        eng, 5, "deferred frame", names)
    assert np.array_equal(image, plain_frame(eng, names)), \
        "deferred kernel frame differs from plain frame"
    print(f"[frame] deferred frame == plain-version frame; frame ms {frame_ms:.3f}, "
          f"caps {eng._caps}", flush=True)
    for n in names:
        results[n]["launches"] = launches[n]


def past_the_guard():
    """Phase 6: a scene past dense_bin_max_chunks takes the deferred path
    by itself."""
    import torch

    from tpu_renderer_torch.utils.bench_frame import bench_engine

    path = os.path.join(OUT_DIR, "dense_scene_320.glb")
    t0 = time.perf_counter()
    eng = bench_engine(path, grid=320)
    b = eng.flat.buffers
    print(f"[scene] grid=320 scene: {b.opaque_tri_vidx.shape[0]} opaque + "
          f"{b.transp_tri_vidx.shape[0]} transparent triangle rows, built, loaded "
          f"and flattened in {time.perf_counter() - t0:.2f} s", flush=True)
    assert not eng._fused, "the dense-bin guard did not pick the deferred path"
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = eng.draw()
    ms = (time.perf_counter() - t0) * 1000.0
    launches = read_counters()
    assert launches["raster_deferred_kernel"] > 0, "kernel 2.4 was not launched"
    assert launches["raster_fused_kernel"] == 0
    assert img.shape == (1080, 1920, 4)
    print(f"[frame] past the guard: first draw {ms:.1f} ms (caps escalated to "
          f"{eng._caps}); launches {launches}", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.draw()
    print(f"[frame] past the guard: second draw {(time.perf_counter() - t0) * 1000.0:.1f} ms",
          flush=True)


def structure_goldens():
    """Phase 7: the structure scene against the JAX package's goldens."""
    from tpu_renderer_torch.config import RendererConfig
    from tpu_renderer_torch.engine import Engine
    from tpu_renderer_torch.present import load_png
    from tpu_renderer_torch.utils.demo import build_structure_glb

    path = os.path.join(OUT_DIR, "structure_golden.glb")
    build_structure_glb(path, seed=0)
    for (w, h), name in (((480, 270), "structure_480p"),
                         ((1920, 1080), "structure_1080p")):
        cfg = RendererConfig(width=w, height=h, background_effect=1,
                             camera_position=(0.0, 10.0, 42.0))
        eng = Engine(cfg)
        eng.camera.pitch = np.float32(-0.18)
        eng.init(scene_path=path)
        img = eng.draw()
        golden = load_png(os.path.join(ROOT, "tests", "goldens", f"{name}.png"))
        diff = np.any(img != golden, axis=-1)
        worst = int(np.abs(img.astype(np.int32) - golden).max())
        print(f"[golden] {name}: {int(diff.sum())} of {diff.size} pixels differ "
              f"({diff.mean():.4%}), largest difference {worst}", flush=True)
        assert diff.mean() <= FRAME_TOL, f"{name} beyond the {FRAME_TOL:.1%} tolerance"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tpu_renderer_torch.kernels import _build
    from tpu_renderer_torch.utils.bench_frame import BENCH, bench_engine, nvidia_smi

    smi = nvidia_smi()
    print(f"[device] {smi}", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    _build.load_library(verbose=True)
    print(build_line(_build.build_seconds, time.perf_counter() - t0), flush=True)

    t0 = time.perf_counter()
    scene_path = os.path.join(OUT_DIR, f"bench_scene_{BENCH['grid']}.glb")
    eng = bench_engine(scene_path)
    print(f"[scene] bench scene ready in {time.perf_counter() - t0:.2f} s", flush=True)
    results = {}
    t0 = time.perf_counter()
    bench_path(eng, results)
    del eng
    textured_glass_path(scene_path, results)
    deferred_path(scene_path, results)
    past_the_guard()
    structure_goldens()
    print(f"[smoke] phases took {time.perf_counter() - t0:.1f} s", flush=True)

    print(json.dumps({"kernels": [results[n] for n in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())

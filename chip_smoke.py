"""Smoke run of the PyTorch + CUDA port on one GPU (sm_90a: an H100).

    python3 chip_smoke.py

Drives tpu_renderer_torch's main path on the card and checks it:

1. without CUDA exits 1 before doing anything else; prints the card's name
   and power limit (nvidia-smi, which must succeed);
2. builds both raster kernels from tpu_renderer_torch/kernels/csrc with nvcc
   (or reuses the library an earlier run built from the same sources);
3. renders the bench frame once (the demo scene at grid=64, 1920x1080,
   camera (0, 6, 128), pitch -0.18) and, on the inputs the frame gave each
   kernel, holds the kernel against its plain PyTorch version (exact on
   every output) and times both with CUDA events;
4. resets the launch counters, renders 1 + 20 bench frames through
   Engine(device="cuda"), and fails unless both kernels were launched; the
   same frame rendered through the plain versions must be identical;
5. renders the structure scene at 480x270 and 1920x1080 and holds it to
   tests/goldens/structure_*.png (at most 0.1% of pixels may differ);
6. prints a JSON line of per-kernel results, the nvidia-smi line, and, last,
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


def max_abs_err(got, want) -> float:
    """Largest difference over matching output tensors; raises unless they
    are bit-identical (the kernels are exact against their plain versions)."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        if g.numel():
            err = max(err, float((g.double() - w.double()).abs().max()))
        bits = (lambda t: t.view(torch.int32)) if g.dtype == torch.float32 else (lambda t: t)
        assert torch.equal(bits(g), bits(w)), f"kernel differs from plain version by {err}"
    return err


def capture_kernel_inputs(eng):
    """Render one frame, recording the arguments each kernel is launched
    with (the main path's real inputs)."""
    from tpu_renderer_torch.kernels import raster

    seen = {}
    originals = {n: getattr(raster, n) for n in ("raster_fused_kernel",
                                                 "raster_accum_kernel")}

    def recorder(name):
        def call(*args, **kwargs):
            seen[name] = (args, kwargs)
            return originals[name](*args, **kwargs)
        return call

    for n in originals:
        setattr(raster, n, recorder(n))
    try:
        eng.draw_device()
    finally:
        for n, f in originals.items():
            setattr(raster, n, f)
    assert set(seen) == set(originals), f"kernels not reached: {set(originals) - set(seen)}"
    return seen


def check_kernels(eng):
    """Phase 3: each kernel against its plain version on the frame's inputs."""
    import torch

    from tpu_renderer_torch.kernels import raster

    seen = capture_kernel_inputs(eng)
    results = {}
    pairs = {
        "raster_fused_kernel": (raster.raster_fused_kernel, raster.rasterize_fused_plain,
                                "tpu_renderer_torch/kernels/csrc/raster_fused.cu",
                                "tpu_renderer/kernels/raster.py:1128"),
        "raster_accum_kernel": (raster.raster_accum_kernel, raster.rasterize_accum_plain,
                                "tpu_renderer_torch/kernels/csrc/raster_accum.cu",
                                "tpu_renderer/kernels/raster.py:1690"),
    }
    for name, (kernel, plain, source, replaces) in pairs.items():
        args, kwargs = seen[name]
        got = kernel(*args, **kwargs)
        want = plain(*args, **kwargs)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        bins, counts = args[1], args[2]
        print(f"[kernel] {name}: bins {tuple(bins.shape)}, entries "
              f"{int(counts.sum())}, max/tile {int(counts.max())}; exact vs "
              f"plain (max_abs_err {err})", flush=True)
        ms = cuda_ms(lambda: kernel(*args, **kwargs), runs=20)
        plain_ms = cuda_ms(lambda: plain(*args, **kwargs), runs=3, warmup=1)
        print(f"[kernel] {name}: {ms:.4f} ms (median of 20), plain "
              f"{plain_ms:.2f} ms (median of 3)", flush=True)
        results[name] = dict(name=name, route="cuda", source=source,
                             replaces=replaces, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms)
    return results


def bench_frames(eng, n: int = 20):
    """Phase 4: the main path, counted. Returns (median frame ms, image)."""
    import torch

    from tpu_renderer_torch.kernels import raster
    from tpu_renderer_torch.utils.bench_frame import BENCH

    raster.fused_counter.launches = 0
    raster.accum_counter.launches = 0
    image = eng.draw()                       # one full draw, host image out
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, _aux = eng.draw_device()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
    launches = {"raster_fused_kernel": raster.fused_counter.launches,
                "raster_accum_kernel": raster.accum_counter.launches}
    for k, v in launches.items():
        assert v > 0, f"{k} was never launched on the main path"
    assert image.shape == (BENCH["height"], BENCH["width"], 4)
    print(f"[frame] bench frame {BENCH['width']}x{BENCH['height']}, "
          f"{eng.stats.triangle_count} tris, {eng.stats.drawcall_count} draws: "
          f"median {statistics.median(times):.3f} ms over {n} frames "
          f"(min {min(times):.3f}); launches {launches}", flush=True)
    return statistics.median(times), image, launches


def plain_frame(eng):
    """The same frame with both kernels replaced by their plain versions."""
    from tpu_renderer_torch.kernels import raster

    originals = (raster.raster_fused_kernel, raster.raster_accum_kernel)
    raster.raster_fused_kernel = raster.rasterize_fused_plain
    raster.raster_accum_kernel = raster.rasterize_accum_plain
    try:
        return eng.draw()
    finally:
        raster.raster_fused_kernel, raster.raster_accum_kernel = originals


def structure_goldens():
    """Phase 5: the structure scene against the JAX package's goldens."""
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
        eng = Engine(cfg, device="cuda")
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
    eng = bench_engine(os.path.join(OUT_DIR, f"bench_scene_{BENCH['grid']}.glb"))
    print(f"[scene] bench scene ready in {time.perf_counter() - t0:.2f} s", flush=True)
    kernels = check_kernels(eng)
    frame_ms, image, launches = bench_frames(eng)
    plain = plain_frame(eng)
    assert np.array_equal(image, plain), "kernel frame differs from plain frame"
    print(f"[frame] kernel frame == plain-version frame; frame ms {frame_ms:.3f}",
          flush=True)
    structure_goldens()

    for name, n in launches.items():
        kernels[name]["launches"] = n
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())

"""Benchmark of the port: steady-state FPS at 1080p on a glTF scene,
printed as ONE JSON line with the keys of the JAX package's bench.py.

    python3 -m tpu_renderer_torch.bench [--grid 64] [--frames 60]
        [--render-scale 1.0] [--stress-grid 128] [--device cuda]

vs_baseline is FPS / 60 (the build target is 60 FPS at 1080p). Five
variants, each on its own engine over the demo scene (seed 0), camera
(0, 6, 2 * grid), pitch -0.18, a yaw orbit of 0.002 a frame:

* the headline: grid --grid at 1920x1080, mip-nearest power-of-two textures
  (one tap). The frames' params are staged up front and the whole sequence
  runs through pipeline.render_frames (on the card a replay of the engine's
  frame graph a frame, captured in the untimed pass); the timed window ends
  in one synchronize and the fetch of the per-frame checksums. The 8 MB
  image fetch lies outside it;
* trilinear: the same scene with LINEAR_MIPMAP_LINEAR samplers (the
  reference loader's default mipmap mode), both mip taps paid;
* trilinear under target_fps=60: what the auto quality picks
  (trilinear_auto_scale) and the rate at that extent;
* stress: grid --stress-grid, about 4x the triangles;
* the interactive loop, draw_pipelined with FRAME_OVERLAP frames in flight:
  with the full image fetched every frame (fullfetch_*), and presenting a
  96x24 terminal raster (viewer_fps).

It runs on the CUDA card and exits 1 without one. --device cpu runs small
sizes (640x360, grid 8, 2 frames, stress grid 4) through the plain versions
of the kernels and reports metric "fps_cpu_smoke", backend "cpu": a check of
the program, not a measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from tpu_renderer_torch.engine import Engine
from tpu_renderer_torch.kernels import raster
from tpu_renderer_torch.pipeline import render_frames
from tpu_renderer_torch.utils.bench_frame import _sync, bench_engine

# grid 64: 64x64 cubes, ~46k triangles; stress grid 128: ~184k
CARD_SIZES = dict(width=1920, height=1080, grid=64, frames=60, stress_grid=128)
CPU_SIZES = dict(width=640, height=360, grid=8, frames=2, stress_grid=4)
VIEWER_CELLS = (96, 24)


def frame_statics(eng: Engine) -> dict:
    """render_frame's keyword arguments for this engine's scene and extent
    (the auto-quality scale included)."""
    cfg = eng.config
    return dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w, fp16=cfg.framebuffer_fp16,
                transp_textured=eng._transp_textured(), fused=eng._fused,
                trilinear=eng._trilinear, pot=eng._pot, **eng._extents(), **eng._caps)


def orbit_params(eng: Engine, frames: int) -> list:
    """The frames' params, staged on the device before the timed window."""
    params = []
    for i in range(frames):
        eng.camera.yaw = np.float32(0.002 * i)   # orbit: frames differ
        params.append(eng.update_scene())
    return params


def timed_sequence(eng: Engine, params, kw) -> tuple:
    """(seconds, last image) of one pass of render_frames over params: the
    window ends when the per-frame checksums are on the host, which forces
    every frame. On the card the frames replay the engine's frame graph of
    these statics (captured by the first pass that meets them)."""
    _sync(eng.device)
    t0 = time.perf_counter()
    image, sums = render_frames(eng.flat.buffers, params, frame=eng.render_fn(), **kw)
    sums.cpu()
    return time.perf_counter() - t0, image


def sequence_fps(eng: Engine, frames: int, kw=None) -> tuple:
    """Steady-state FPS of `frames` frames through render_frames, after one
    untimed pass; returns (fps, last image on the device)."""
    kw = frame_statics(eng) if kw is None else kw
    params = orbit_params(eng, frames)
    timed_sequence(eng, params, kw)          # warm: builds, caches, allocator
    dt, image = timed_sequence(eng, params, kw)
    return frames / dt, image


def headline_fields(fps: float) -> tuple:
    """(value, vs_baseline) of the line, from the unrounded headline fps,
    as bench.py writes them: round(fps, 2) and round(fps / 60, 3). So
    vs_baseline is not always value / 60 rounded: for an fps in [2.965,
    2.97) value is 2.97 and vs_baseline 0.049, where 2.97 / 60 rounds to
    0.05."""
    return round(fps, 2), round(fps / 60.0, 3)


def run(args) -> dict:
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    sizes = CARD_SIZES if on_card else CPU_SIZES
    width, height = sizes["width"], sizes["height"]
    grid, frames, stress_grid = (
        sizes[k] if getattr(args, k) is None else getattr(args, k)
        for k in ("grid", "frames", "stress_grid"))

    def engine(tmp, g, **kw):
        """An engine on the demo scene of grid g, at the bench camera."""
        return bench_engine(os.path.join(tmp, f"bench_scene_{g}.glb"), device=device,
                            grid=g, width=width, height=height,
                            camera_position=(0.0, 6.0, g * 2.0),
                            render_scale=args.render_scale, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        eng = engine(tmp, grid)
        eng.draw()    # warm-up: builds the kernels; one steady frame
        fps, image = sequence_fps(eng, frames)
        final = image.cpu()   # the full image fetch, outside the timed window
        assert final.shape == (height, width)

        eng_t = engine(tmp, grid, trilinear=True)
        assert eng_t._trilinear, "the trilinear variant must detect 2-tap samplers"
        fps_tri, _ = sequence_fps(eng_t, frames)

        # the same stock-sampler scene under target_fps=60: what the auto
        # quality picks, and the rate at the extent it picks
        eng_a = engine(tmp, grid, trilinear=True, target_fps=60.0)
        fps_tri_auto, _ = sequence_fps(eng_a, frames)

        eng_s = engine(tmp, stress_grid)
        eng_s.draw()  # warm-up and the live triangle counter
        stress_tris = eng_s.stats.triangle_count
        fps_stress, _ = sequence_fps(eng_s, frames)
        del eng_t, eng_s

    # the interactive loop: per-frame host camera update and dispatch, the
    # frame shown each call submitted FRAME_OVERLAP - 1 calls earlier
    _sync(device)
    t0 = time.perf_counter()
    for i in range(frames):
        eng.camera.yaw = np.float32(0.002 * i)
        eng.draw_pipelined(stats_interval=0)
    eng.flush_pipelined()
    dt_full = time.perf_counter() - t0
    # the terminal viewer's present: only its raster's samples are fetched
    for _ in range(3):
        eng.draw_pipelined(stats_interval=0, present_cells=VIEWER_CELLS)
    t0 = time.perf_counter()
    for i in range(frames):
        eng.camera.yaw = np.float32(0.002 * i)
        eng.draw_pipelined(stats_interval=0, present_cells=VIEWER_CELLS)
    dt_viewer = time.perf_counter() - t0
    eng.flush_pipelined()
    eng._update_stats(eng._last_aux)

    value, vs_baseline = headline_fields(fps)
    return {
        # a run on the CPU must not record a number that reads as the 1080p
        # metric of the card: its own name, and the backend beside it
        "metric": "fps_1080p_gltf_scene" if on_card else "fps_cpu_smoke",
        "value": value,
        "unit": "frames/sec",
        "vs_baseline": vs_baseline,
        "backend": device.type,
        "detail": {
            "frame_ms": round(1000.0 / fps, 2),
            "trilinear_fps": round(fps_tri, 2),
            "trilinear_frame_ms": round(1000.0 / fps_tri, 2),
            "trilinear_auto_fps": round(fps_tri_auto, 2),
            "trilinear_auto_scale": eng_a._auto_scale,
            "stress_fps": round(fps_stress, 2),
            "stress_frame_ms": round(1000.0 / fps_stress, 2),
            "stress_triangles": stress_tris,
            "stress_mtris_per_sec": round(stress_tris * fps_stress / 1e6, 2),
            "fullfetch_fps": round(frames / dt_full, 2),
            "fullfetch_frame_ms": round(1000.0 * dt_full / frames, 2),
            "viewer_fps": round(frames / dt_viewer, 2),
            "triangles": eng.stats.triangle_count,
            "mtris_per_sec": round(eng.stats.triangle_count * fps / 1e6, 2),
            "drawcalls": eng.stats.drawcall_count,
            "render_scale": args.render_scale,
            "resolution": f"{width}x{height}",
            # the engaged static specialisations, so the numbers describe
            # themselves (headline scene: single-tap sampler, AND-wrap)
            "statics": {
                "fused": eng._fused, "trilinear": eng._trilinear, "pot": eng._pot,
                "transp_textured": eng._transp_textured(),
                "raster_chunk": raster.CHUNK, "raster_group": raster.GROUP,
                "raster_sort": eng.config.raster_sort,
            },
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=None,
                    help="demo grid of the headline scene (default 64; 8 on the CPU)")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames per timed sequence (default 60; 2 on the CPU)")
    ap.add_argument("--render-scale", type=float, default=1.0,
                    help="draw-extent scale of every variant (the headline "
                         "metric is 1.0)")
    ap.add_argument("--stress-grid", type=int, default=None,
                    help="demo grid of the stress variant (default 128; 4 on the CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device (pass --device cpu for the small smoke run)",
              file=sys.stderr)
        return 1
    print(json.dumps(run(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

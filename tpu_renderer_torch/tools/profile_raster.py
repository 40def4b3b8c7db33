"""Raster / shade cost split on the bench scene, the twin of the JAX
package's tools/profile_raster.py.

    python3 -m tpu_renderer_torch.tools.profile_raster [--grid 64] [--iters 10]
        [--width 1920] [--height 1080] [--device cuda]

The bench scene goes through the engine's deferred setup (fused=False, two
draws so the bin capacities settle); then five calls are timed on that
frame's own inputs, under the JAX tool's labels:

  A. the row gather rows48[bins.clamp(0, T-1)] at tri_cap width: the block
     the JAX wrappers materialise for the gathered kernels, and the port's
     kernels do not (they read rows by id);
  B. the visibility raster (raster.rasterize, kernel 2.4);
  C. the fused raster over per-triangle bins (raster.rasterize_fused_gathered,
     kernel 2.6, with its epilogue);
  D. shade_fused textured, over the planes C produced;
  E. shade_fused untextured, over the same planes.

The original's D and E call shade_fused with 8 attribute planes, 6 meta
planes and no inv: a signature the JAX package has since dropped, so those
two steps cannot run there as written. This twin uses today's
shade_fused(attrs(6), meta(13), inv, ...), fed with real planes instead of
synthetic ones.

Timing: CUDA events around --iters back-to-back calls on the card (mean ms a
call, after one warm call); time.perf_counter on the CPU. The card's
nvidia-smi name and power limit are printed first. Exits 1 without a card;
--device cpu is for small extents (the plain versions of the kernels).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from tpu_renderer_torch import pipeline
from tpu_renderer_torch.kernels import raster, shade, vertex
from tpu_renderer_torch.kernels.common import pad_extent
from tpu_renderer_torch.utils import bench_frame

LABELS = ("A rows gather (tri_cap wide)", "B visibility raster", "C fused raster",
          "D shade_fused textured", "E shade_fused untextured")


def mean_ms(fn, iters: int, device) -> float:
    """Mean ms a call of fn() over iters calls, after one warm call."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1000.0
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


@torch.no_grad()
def deferred_inputs(eng):
    """The deferred opaque pass's inputs on the engine's current frame, as
    pipeline.render_frame builds them: (packed16, rows48, bins, counts,
    tiles)."""
    cfg, b = eng.config, eng.flat.buffers
    wp, hp = pad_extent(cfg.width, cfg.height, cfg.tile_h, cfg.tile_w)
    tiles = dict(tiles_x=wp // cfg.tile_w, tiles_y=hp // cfg.tile_h,
                 tile_w=cfg.tile_w, tile_h=cfg.tile_h)
    params = eng.update_scene()
    viewproj = vertex.mat4_mul(params.proj, params.view)
    vis = vertex.draw_visibility(viewproj, b.draw_model, b.draw_bounds_origin,
                                 b.draw_bounds_extents)
    setup, rows48 = pipeline._deferred_setup(
        b.opaque_corners, b.opaque_tri_draw, b.opaque_tri_valid, b, vis, viewproj,
        cfg.width, cfg.height, params.sun_dir[:3])
    caabb, cvalid = raster.chunk_aabbs(setup.aabb, setup.valid)
    cbins, _, _ = raster.bin_triangles(caabb, cvalid, bin_cap=eng._caps["bin_cap"],
                                       **tiles)
    bins, counts, _ = raster.refine_bins(cbins, setup.aabb,
                                         tri_cap=eng._caps["tri_cap"], **tiles)
    return setup.packed, rows48.contiguous(), bins, counts, tiles, params


@torch.no_grad()
def profile(eng, iters: int) -> dict:
    """label -> ms a call, in LABELS order."""
    dev = eng.device
    packed16, rows48, bins, counts, tiles, params = deferred_inputs(eng)
    print(f"counts: total {int(counts.sum())} max {int(counts.max())} "
          f"(bins {tuple(bins.shape)}, rows {tuple(rows48.shape)})", flush=True)
    n_rows = rows48.shape[0]
    z, tid, attrs, meta, inv = raster.rasterize_fused_gathered(rows48, bins, counts,
                                                               **tiles)
    look = dict(atlas=eng.flat.buffers.atlas, ambient_rgb=params.ambient[:3],
                sun_power=params.sun_color[3], trilinear=eng._trilinear, pot=eng._pot)
    calls = (
        lambda: rows48[bins.clamp(0, n_rows - 1).long()][:, :, 0].sum(),
        lambda: raster.rasterize(packed16, bins, counts, **tiles),
        lambda: raster.rasterize_fused_gathered(rows48, bins, counts, **tiles),
        lambda: shade.shade_fused(attrs, meta, inv, textured=True, **look),
        lambda: shade.shade_fused(attrs, meta, inv, textured=False, **look),
    )
    out = {}
    for label, fn in zip(LABELS, calls):
        out[label] = mean_ms(fn, iters, dev)
        print(f"{label:<30} {out[label]:8.3f} ms", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("profile_raster: no CUDA device", file=sys.stderr)
            return 1
        print(f"[device] {bench_frame.nvidia_smi()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        eng = bench_frame.bench_engine(
            os.path.join(tmp, "bench_scene.glb"), device=args.device, grid=args.grid,
            width=args.width, height=args.height, fused=False,
            camera_position=(0.0, 6.0, args.grid * 2.0))
    eng.draw()   # the caps escalate on overflow ...
    eng.draw()   # ... and have settled
    print(f"caps: {eng._caps}", flush=True)
    profile(eng, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Raster cost against bin width on the bench scene, the twin of the JAX
package's tools/profile_binwidth.py.

    python3 -m tpu_renderer_torch.tools.profile_binwidth [--grid 64] [--iters 10]
        [--width 1920] [--height 1080] [--device cuda]

The bench frame's opaque set goes through the frame's own setup and sort
(vertex.triangle_setup_rows, raster.spatial_sort); then, on those rows:

* kernel 2.1 over capped chunk bins (raster.bin_triangles over the chunk
  boxes at each of CAPS, rounded up to 8; raster.rasterize_fused_chunks gives
  every entry an all-live group mask): the entries each cap drops beyond
  its width, and ms a call;
* kernel 2.1 over the frame's uncapped dense bins (bin_triangles_full, as
  pipeline._bins builds them; raster.rasterize_fused): ms a call.

It prints the max count a tile of both bin formats first. Timing: on the
card, device ms a call (a CUDA graph of --iters calls replayed between CUDA
events, utils/timing.device_ms) beside ms a call on an idle card (CUDA
events around one call, host time up to the launch included,
utils/timing.event_ms), after the card's nvidia-smi name and power limit;
on the CPU (--device cpu, small extents: a check of the tool, no
measurement) host ms a call. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from tpu_renderer_torch import pipeline
from tpu_renderer_torch.kernels import raster, vertex
from tpu_renderer_torch.kernels.common import pad_extent
from tpu_renderer_torch.utils import bench_frame, timing

CAPS = (512, 1024, 5808)   # the JAX tool's bin caps (each rounded up to 8)


@torch.no_grad()
def opaque_inputs(eng):
    """The bench frame's sorted opaque set as render_frame builds it:
    (rows (T, 48), aabb (T, 4), valid (T,), tiles)."""
    cfg, b = eng.config, eng.flat.buffers
    wp, hp = pad_extent(cfg.width, cfg.height, cfg.tile_h, cfg.tile_w)
    tiles = dict(tiles_x=wp // cfg.tile_w, tiles_y=hp // cfg.tile_h,
                 tile_w=cfg.tile_w, tile_h=cfg.tile_h)
    params = eng.update_scene()
    viewproj = vertex.mat4_mul(params.proj, params.view)
    vis = vertex.draw_visibility(viewproj, b.draw_model, b.draw_bounds_origin,
                                 b.draw_bounds_extents)
    rows, aabb, valid = vertex.triangle_setup_rows(
        b.opaque_corners, b.opaque_tri_draw, b.opaque_tri_valid, b.draw_model, vis,
        viewproj, cfg.width, cfg.height, sun_dir=params.sun_dir[:3])
    aabb, valid, rows = raster.spatial_sort(aabb, valid, rows)
    return rows.contiguous(), aabb, valid, tiles


def call_ms(fn, iters: int, device) -> dict:
    """{"device_ms", "event_ms"} of fn() on the card; {"cpu_ms"} on the CPU."""
    if torch.device(device).type != "cuda":
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return {"cpu_ms": (time.perf_counter() - t0) / iters * 1000.0}
    return {"device_ms": timing.device_ms(fn, launches=iters),
            "event_ms": timing.event_ms(fn, runs=iters)}


def _fmt(ms: dict) -> str:
    return "  ".join(f"{k} {v:8.4f}" for k, v in ms.items())


@torch.no_grad()
def profile(eng, iters: int) -> list:
    """One dict a line: the capped runs at each cap, then the uncapped one."""
    dev = eng.device
    rows, aabb, valid, tiles = opaque_inputs(eng)
    caabb, cvalid = raster.chunk_aabbs(aabb, valid)
    bins, counts = pipeline._bins(aabb, valid, tiles)
    full = raster.bin_triangles(caabb, cvalid, bin_cap=caabb.shape[0], **tiles)[1]
    print(f"max count/tile: {int(full.max())} chunks (capped format, uncapped), "
          f"{int(counts.max())} entries (dense bins); {int(counts.sum())} entries in "
          f"{counts.shape[0]} tiles, {rows.shape[0]} triangle rows", flush=True)
    out = []
    for cap in CAPS:
        cap8 = -(-cap // 8) * 8
        cbins, ccounts, dropped = raster.bin_triangles(caabb, cvalid, bin_cap=cap8, **tiles)
        ms = call_ms(lambda: raster.rasterize_fused_chunks(rows, cbins, ccounts, **tiles),
                     iters, dev)
        line = dict(name=f"fused_chunks capped {cap8}", cap=cap8,
                    dropped=int(dropped), **ms)
        print(f"{line['name']:<28} dropped {line['dropped']:>7}  {_fmt(ms)} ms", flush=True)
        out.append(line)
    ms = call_ms(lambda: raster.rasterize_fused(rows, bins, counts, **tiles), iters, dev)
    line = dict(name="fused uncapped", cap=None, dropped=0, **ms)
    print(f"{line['name']:<28} dropped {0:>7}  {_fmt(ms)} ms", flush=True)
    out.append(line)
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
            print("profile_binwidth: no CUDA device", file=sys.stderr)
            return 1
        print(f"[device] {bench_frame.nvidia_smi()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        eng = bench_frame.bench_engine(
            os.path.join(tmp, "bench_scene.glb"), device=args.device, grid=args.grid,
            width=args.width, height=args.height,
            camera_position=(0.0, 6.0, args.grid * 2.0))
    profile(eng, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Stage-by-stage frame profile on the bench scene, the twin of the JAX
package's tools/profile_stages.py.

    python3 -m tpu_renderer_torch.tools.profile_stages [--grid 64] [--frames 10]
        [--width 1920] [--height 1080] [--device cuda]

Prints the JAX tool's rows as ms a frame: background, cull/setup, chunk bin,
raster_fused, shade_fused, transp setup/bin, transp accum, present. The
stages of a frame are separate calls here, so each is timed on its own
between two synchronize() calls (utils.bench_frame.stage_times, host clock,
median over --frames frames); no cumulative-prefix trick is needed. Two rows
differ from the JAX tool's in what they hold: the port sets up the opaque
and the transparent triangles in one call, so "cull/setup" holds both
setups and "transp setup/bin" only the transparent sort and bins. The
engine caches the background across frames; the tool drops the cache before
each frame so the row shows one launch of its kernel.

Runs on the CUDA card and exits 1 without one; --device cpu is for small
extents (the plain versions of the kernels).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from tpu_renderer_torch import engine as engine_mod
from tpu_renderer_torch.utils import bench_frame

# the JAX tool's row -> the timed stage calls it sums
ROWS = (
    ("background", ("background#0",)),
    ("cull/setup", ("cull#0", "setup#0")),
    ("chunk bin", ("sort+bins#0",)),
    ("raster_fused", ("raster A + epilogue#0",)),
    ("shade_fused", ("shade#0",)),
    ("transp setup/bin", ("sort+bins#1",)),
    ("transp accum", ("accum B#0",)),
    ("present", ("present#0",)),
)
STAGES = (("background", engine_mod, "background_fb"),) + bench_frame.STAGES


def _drop_background(eng) -> None:
    eng._bg_key = None


def profile(eng, frames: int) -> dict:
    """row -> median ms a frame, and "frame": the synchronised frame."""
    times = bench_frame.stage_times(eng, frames, STAGES, per_call=True,
                                    before_frame=_drop_background)
    out = {row: sum(times.get(k, 0.0) for k in keys) for row, keys in ROWS}
    out["frame"] = times["frame"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("profile_stages: no CUDA device", file=sys.stderr)
            return 1
        print(f"[device] {bench_frame.nvidia_smi()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        eng = bench_frame.bench_engine(
            os.path.join(tmp, "bench_scene.glb"), device=args.device, grid=args.grid,
            width=args.width, height=args.height,
            camera_position=(0.0, 6.0, args.grid * 2.0))
    eng.draw()   # warm-up: builds the kernels, fills the caches
    eng.draw()
    rows = profile(eng, args.frames)
    for name, ms in rows.items():
        print(f"{name:<22} {ms:8.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

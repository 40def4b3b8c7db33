"""Refit the auto quality's cost model (Engine._COST_*) from frames measured
on the card.

    python3 -m tpu_renderer_torch.tools.fit_cost_model [--grid 64] [--frames 20]
        [--rounds 5] [--device cuda]

The model is frame_ms(s) = fixed + Mpx * s^2 * (base + taps * tap) + blit
(blit only when s < 1). Five points are measured with the bench's own
sequence timer (tpu_renderer_torch.bench.timed_sequence: params staged,
pipeline.render_frames, one synchronize and the checksum fetch) on the bench
scene at 1920x1080: the trilinear scene (2 taps) at s = 1.0, 0.7 and 0.5 and
the single-tap scene at s = 1.0 and 0.7. Each point is the minimum ms a
frame over --rounds rounds, the rounds interleaved across the points (frame
medians spread by tens of percent on a shared host). The blit is timed
alone, by CUDA events, at the s = 0.7 extent.

The fit uses three points, as the JAX package's did: trilinear at 1.0 and
0.7 split the fixed from the per-pixel cost (0.51 * P = t(1.0) - t(0.7) +
blit), the single-tap point at 1.0 splits base from tap. A constant the fit
makes negative is clamped at 0. The other two points are held out; the
residuals of all five are printed, with the card's name and power limit,
and the constants as the lines Engine carries. Exits 1 without a card
(--device cpu runs tiny sizes to check the tool, not to fit anything).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

from tpu_renderer_torch import bench, pipeline
from tpu_renderer_torch.tools.profile_raster import mean_ms
from tpu_renderer_torch.utils import bench_frame

# (label, trilinear scene, render scale); the first, second and fourth fit
POINTS = (("trilinear s=1.0", True, 1.0), ("trilinear s=0.7", True, 0.7),
          ("trilinear s=0.5", True, 0.5), ("single-tap s=1.0", False, 1.0),
          ("single-tap s=0.7", False, 0.7))


def fit(ms: dict, blit_ms: float, mpx: float) -> dict:
    """The five constants from the three fit points (ms a frame) and the
    blit's own time; 1 ns/px is 1 ms/Mpx."""
    t1, t07, single = ms["trilinear s=1.0"], ms["trilinear s=0.7"], ms["single-tap s=1.0"]
    tap = max(0.0, (t1 - single) / mpx)
    pixel = max(0.0, (t1 - t07 + blit_ms) / 0.51 / mpx)    # base + 2 taps
    base = max(0.0, pixel - 2.0 * tap)
    fixed = max(0.0, t1 - mpx * (base + 2.0 * tap))
    return dict(base_ns=base, tap_ns=tap, fixed_ms=fixed, blit_ms=blit_ms)


def predict(c: dict, taps: int, s: float, mpx: float) -> float:
    t = c["fixed_ms"] + mpx * s * s * (c["base_ns"] + taps * c["tap_ns"])
    return t + (c["blit_ms"] if s < 1.0 else 0.0)


def measure(args) -> dict:
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    width, height = (1920, 1080) if on_card else (256, 64)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, tri, s in POINTS:
            eng = bench_frame.bench_engine(
                os.path.join(tmp, "scene.glb"), device=device, grid=args.grid,
                width=width, height=height, trilinear=tri, render_scale=s,
                camera_position=(0.0, 6.0, args.grid * 2.0))
            assert eng._trilinear == tri
            eng.draw()
            runs[label] = (eng, bench.orbit_params(eng, args.frames),
                           bench.frame_statics(eng))
    for run in runs.values():
        bench.timed_sequence(*run)                       # warm
    ms = {label: float("inf") for label in runs}
    for _ in range(args.rounds):                         # interleaved rounds
        for label, run in runs.items():
            dt, _ = bench.timed_sequence(*run)
            ms[label] = min(ms[label], 1000.0 * dt / args.frames)
    ext = runs["trilinear s=0.7"][0]._extents()
    fb = torch.rand((4, -(-ext["height"] // 32) * 32, -(-ext["width"] // 128) * 128),
                    device=device)
    blit_ms = min(mean_ms(lambda: pipeline.linear_blit(fb, **ext), 10, device)
                  for _ in range(args.rounds))
    mpx = width * height / 1e6
    consts = fit(ms, blit_ms, mpx)
    residuals = {label: ms[label] - predict(consts, 2 if tri else 1, s, mpx)
                 for label, tri, s in POINTS}
    return dict(device=bench_frame.nvidia_smi() if on_card else "cpu",
                resolution=f"{width}x{height}", grid=args.grid, frames=args.frames,
                rounds=args.rounds, points_ms=ms, blit_ms=blit_ms, constants=consts,
                residuals_ms=residuals)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("fit_cost_model: no CUDA device", file=sys.stderr)
        return 1
    result = measure(args)
    c = result["constants"]
    print(f"[device] {result['device']}")
    for label, v in result["points_ms"].items():
        print(f"{label:<20} {v:8.3f} ms/frame (min of {args.rounds} rounds), "
              f"residual {result['residuals_ms'][label]:+.3f} ms")
    print(f"blit alone           {result['blit_ms']:8.3f} ms")
    print(f"    _COST_BASE_NS = {c['base_ns']:.3f}\n    _COST_TAP_NS = {c['tap_ns']:.3f}\n"
          f"    _COST_FIXED_MS = {c['fixed_ms']:.2f}\n    _COST_BLIT_MS = {c['blit_ms']:.2f}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time kernels 2.1-2.8 on the inputs their frames give them.

    python3 -m tpu_renderer_torch.tools.time_stream_kernels [--runs 20]
        [--label NAME] [--frames bench,stress,textured-glass,deferred,gathered]

Renders each frame once and records the arguments the frame gave its
kernels: the bench frame (demo grid 64, 1920x1080, the bench camera) and
the stress frame (grid 128, camera (0, 6, 256)) give
raster.raster_fused_kernel (2.1) and raster.raster_accum_kernel (2.2); the
textured-glass frame (the bench scene, its glass sampling the checker
texture) gives raster.raster_peel_fused_kernel (2.3) a call a peel layer;
the deferred frame (the bench scene, fused=False, caps escalated first)
gives raster.raster_deferred_kernel (2.4) a call and
raster.raster_peel_kernel (2.5) a call a layer; kernel 2.6,
raster.raster_fused_gathered_kernel, which no frame runs, is timed on the
same frame's fat rows and bins as the raster profile tool builds them
(tools.profile_raster.deferred_inputs). The gathered oracles 2.7,
raster.raster_accum_gathered_kernel, and 2.8,
raster.raster_peel_gathered_kernel, which no frame runs either, are timed
on the calls 2.2 and 2.3 get from the bench and the textured-glass frames,
each chunk bin expanded to the per-triangle bin of every member of its
chunks (oracle_call; chip_smoke.py's cross-checks hold them to 2.2 and 2.3
on the same calls). The peels are timed on their first
call and on a later one (the middle layer). Each kernel is
timed on those inputs (ms: CUDA events around one call, the median of
--runs calls after two warm-up calls, the wrapper's host time before the
launch included; device_ms: the card's time alone, CUDA events around the
replay of a CUDA graph of 50 calls, over the count; utils/timing.py's
event_ms and device_ms), then again with every tile's count cut
to 0 entries (what the launch, the merge and the epilogue cost alone) and
to the mean count (the dense tiles' tails cut off). Prints one JSON line
per frame, kernel, call and cut (ms, device_ms, entries, max a tile), then
the card's name and power limit.

It calls only those wrappers, utils.bench_frame's engines and
deferred_inputs, and utils/timing.py, so the same file times another
checkout of the package placed first on PYTHONPATH (copy utils/timing.py
into one that lacks it):

    PYTHONPATH=path/to/other/checkout python3 tpu_renderer_torch/tools/time_stream_kernels.py

which is how two versions of the kernels are compared on one card, in turns.
Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

from tpu_renderer_torch import pipeline
from tpu_renderer_torch.kernels import raster
from tpu_renderer_torch.tools.profile_raster import deferred_inputs
from tpu_renderer_torch.utils.bench_frame import BENCH, bench_engine, nvidia_smi, path_engine
from tpu_renderer_torch.utils.timing import device_ms, event_ms

# frame -> the kernels timed on it
FRAMES = {
    "bench": ("raster_fused_kernel", "raster_accum_kernel"),
    "stress": ("raster_fused_kernel", "raster_accum_kernel"),
    "textured-glass": ("raster_peel_fused_kernel",),
    "deferred": ("raster_deferred_kernel", "raster_peel_kernel", "raster_fused_gathered_kernel"),
    "gathered": ("raster_accum_gathered_kernel", "raster_peel_gathered_kernel"),
}
GATHERED = "raster_fused_gathered_kernel"   # no frame runs it: deferred_inputs
# the gathered oracles of 2.2 and 2.3, on those kernels' calls (oracle_call)
ORACLES = {"raster_accum_gathered_kernel": ("bench", "raster_accum_kernel"),
           "raster_peel_gathered_kernel": ("textured-glass", "raster_peel_fused_kernel")}


def frozen_call(args, kwargs) -> tuple:
    """(args, kwargs) of a launch with every tensor copied as the launch
    sees it: the peel loop updates its `last` in place, so the arguments
    themselves hold the last pass's values once the frame ends."""
    def copy(x):
        return x.clone() if isinstance(x, torch.Tensor) else x
    return tuple(copy(a) for a in args), {k: copy(v) for k, v in kwargs.items()}


def captured_calls(eng, names) -> dict:
    """name -> [(args, kwargs), ...] of every launch of each named kernel in
    one eager draw_device() of eng (a replay of a frame graph calls no
    wrapper), each as the launch saw it (frozen_call)."""
    seen, originals = {n: [] for n in names}, {n: getattr(raster, n) for n in names}

    def recorder(name):
        def call(*args, **kwargs):
            seen[name].append(frozen_call(args, kwargs))
            return originals[name](*args, **kwargs)
        return call

    for n in names:
        setattr(raster, n, recorder(n))
    try:
        with pipeline.eager():
            eng.draw_device()
    finally:
        for n, f in originals.items():
            setattr(raster, n, f)
    missing = [n for n in names if not seen[n]]
    if missing:
        raise RuntimeError(f"the frame did not reach {missing}")
    return seen


def expanded_bins(dense_bins, counts):
    """Dense chunk entries (cid << shift | gmask) -> per-triangle bins of
    every member of each binned chunk (raster.expand_bins), and their
    counts."""
    shift = raster.entry_shift(raster.CHUNK // raster.GROUP)
    n = counts.clamp(0, dense_bins.shape[1])
    live = torch.arange(dense_bins.shape[1], device=dense_bins.device)[None, :] < n[:, None]
    return raster.expand_bins(torch.where(live, dense_bins >> shift, raster.NO_TRI), n)


def frame_tiles(kwargs) -> dict:
    """A frame kernel's tile arguments (tiles_x, tiles_y, tile_w, tile_h)
    without its band's first tile row, as the gathered oracles and the
    binning take them: those cover the whole frame, so the call must be
    one over the whole frame (tile_y0 = 0)."""
    out = dict(kwargs)
    if out.pop("tile_y0", 0):
        raise ValueError(f"a call over a band ({kwargs}) has no whole-frame twin")
    return out


def oracle_call(call):
    """A call (args, kwargs) of kernel 2.2 or 2.3 over the whole frame ->
    the same call of its gathered oracle, 2.7 or 2.8: the same rows and
    planes, the chunk bin expanded (expanded_bins)."""
    (rows, dense, counts, *rest), kwargs = call
    return (rows, *expanded_bins(dense, counts), *rest), frame_tiles(kwargs)


def gathered_calls(tmp: str) -> dict:
    """name -> the calls of 2.7 (2.2's of the bench frame) and 2.8 (2.3's of
    the textured-glass frame, one a layer)."""
    out = {}
    for name, (frame, stream) in ORACLES.items():
        calls = captured_calls(frame_engine(frame, tmp), (stream,))[stream]
        out[name] = [oracle_call(c) for c in calls]
    return out


def frame_engine(frame: str, tmp: str):
    if frame in ("bench", "stress"):
        grid = BENCH["grid"] if frame == "bench" else 2 * BENCH["grid"]
        return bench_engine(os.path.join(tmp, f"scene_{grid}.glb"), grid=grid,
                            camera_position=(0.0, 6.0, 2.0 * grid))
    eng = path_engine(frame, os.path.join(tmp, f"scene_{frame}.glb"))
    if frame == "deferred":
        eng.draw()     # escalates the caps on overflow
    return eng


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--label", default="", help="a name for this run's lines")
    ap.add_argument("--frames", default=",".join(FRAMES),
                    help=f"comma-separated, of {', '.join(FRAMES)}")
    args = ap.parse_args(argv)
    frames = args.frames.split(",")
    unknown = [f for f in frames if f not in FRAMES]
    if unknown:
        ap.error(f"unknown frames {unknown}")
    if not torch.cuda.is_available():
        print("time_stream_kernels: no CUDA device", file=sys.stderr)
        return 1
    card = nvidia_smi()
    with tempfile.TemporaryDirectory() as tmp:
        for frame in frames:
            if frame == "gathered":
                seen = gathered_calls(tmp)
            else:
                eng = frame_engine(frame, tmp)
                names = FRAMES[frame]
                seen = captured_calls(eng, [n for n in names if n != GATHERED])
                if GATHERED in names:
                    _, rows48, bins48, counts48, tiles, _ = deferred_inputs(eng)
                    seen[GATHERED] = [((rows48, bins48, counts48), tiles)]
                del eng
            for name, calls in seen.items():
                # 2.1, 2.2 and 2.4 run once a frame; a peel once a layer:
                # its first call and the middle one
                picks = {"first": 0} if len(calls) == 1 else {"first": 0,
                                                             "later": len(calls) // 2}
                kernel = getattr(raster, name)
                for which, i in picks.items():
                    a, kw = calls[i]
                    bins, counts = a[1], a[2]
                    # the frame's own bins, then the same with every tile's
                    # count cut to `cap` entries: 0 leaves the launch, the
                    # merge and the epilogue; the mean cuts the dense tails
                    mean = -(-int(counts.sum()) // counts.numel())
                    for cap in (None, 0, mean):
                        cut = counts if cap is None else counts.clamp(max=cap)
                        b = (a[0], bins, cut) + tuple(a[3:])
                        print(json.dumps({
                            "label": args.label, "frame": frame, "kernel": name,
                            "call": f"{which} ({i} of {len(calls)})", "counts_cut_to": cap,
                            "ms": event_ms(lambda: kernel(*b, **kw), args.runs),
                            "device_ms": device_ms(lambda: kernel(*b, **kw)),
                            "runs": args.runs,
                            "entries": int(cut.clamp(max=bins.shape[1]).sum()),
                            "max_a_tile": int(cut.max()), "bins": list(bins.shape)}),
                              flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time kernels 2.1 and 2.2 on the bench frame's and the stress frame's own
inputs.

    python3 -m tpu_renderer_torch.tools.time_stream_kernels [--runs 20]
        [--label NAME]

Renders one bench frame (demo grid 64, 1920x1080, the bench camera) and one
stress frame (grid 128, camera (0, 6, 256)), records the arguments the frame
gave raster.raster_fused_kernel (2.1) and raster.raster_accum_kernel (2.2),
and times each kernel on them: CUDA events around one call, the median of
--runs calls after two warm-up calls; then again with every tile's count
cut to 0 entries (what the launch, the merge and the epilogue cost alone)
and to the mean count (the dense tiles' tails cut off). Prints one JSON
line per frame, kernel and cut (ms, entries, max a tile), then the card's
name and power limit.

It calls only those two wrappers and utils.bench_frame.bench_engine, so the
same file times another checkout of the package placed first on PYTHONPATH:

    PYTHONPATH=path/to/other/checkout python3 tpu_renderer_torch/tools/time_stream_kernels.py

which is how two versions of the kernels are compared on one card, in turns.
Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

import torch

from tpu_renderer_torch.kernels import raster
from tpu_renderer_torch.utils.bench_frame import BENCH, bench_engine, nvidia_smi

NAMES = ("raster_fused_kernel", "raster_accum_kernel")


def captured_calls(eng) -> dict:
    """name -> (args, kwargs) of the last launch of each kernel in one
    draw_device() of eng."""
    seen, originals = {}, {n: getattr(raster, n) for n in NAMES}

    def recorder(name):
        def call(*args, **kwargs):
            seen[name] = (args, kwargs)
            return originals[name](*args, **kwargs)
        return call

    for n in NAMES:
        setattr(raster, n, recorder(n))
    try:
        eng.draw_device()
    finally:
        for n, f in originals.items():
            setattr(raster, n, f)
    missing = [n for n in NAMES if n not in seen]
    if missing:
        raise RuntimeError(f"the frame did not reach {missing}")
    return seen


def kernel_ms(fn, runs: int) -> float:
    """Median ms of fn() by CUDA events over `runs` calls."""
    for _ in range(2):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--label", default="", help="a name for this run's lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_stream_kernels: no CUDA device", file=sys.stderr)
        return 1
    card = nvidia_smi()
    with tempfile.TemporaryDirectory() as tmp:
        for frame, grid in (("bench", BENCH["grid"]), ("stress", 2 * BENCH["grid"])):
            eng = bench_engine(os.path.join(tmp, f"scene_{grid}.glb"), grid=grid,
                               camera_position=(0.0, 6.0, 2.0 * grid))
            for name, (a, kw) in captured_calls(eng).items():
                kernel = getattr(raster, name)
                bins, counts = a[1], a[2]
                # the frame's own bins, then the same with every tile's
                # count cut to `cap` entries: 0 leaves the launch, the merge
                # and the epilogue; the mean cuts the dense tiles' tails
                mean = -(-int(counts.sum()) // counts.numel())
                for cap in (None, 0, mean):
                    cut = counts if cap is None else counts.clamp(max=cap)
                    b = (a[0], bins, cut) + tuple(a[3:])
                    print(json.dumps({
                        "label": args.label, "frame": frame, "kernel": name,
                        "counts_cut_to": cap,
                        "ms": kernel_ms(lambda: kernel(*b, **kw), args.runs), "runs": args.runs,
                        "entries": int(cut.clamp(max=bins.shape[1]).sum()),
                        "max_a_tile": int(cut.max()), "bins": list(bins.shape)}), flush=True)
            del eng
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

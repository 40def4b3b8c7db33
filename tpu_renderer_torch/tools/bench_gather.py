"""Row-gather cost on the card: ns per gathered index against table size, row
width and index coherence; the twin of the JAX package's
tools/bench_gather.py.

    python3 -m tpu_renderer_torch.tools.bench_gather [--n 2097152] [--iters 24]
        [--device cuda]

The gather is table[idx] with int64 indices, the op the port's shade
(atlas.quads[flat.long()], one mip tap) and deferred blend (rows[t.long()])
run. Rows of 16 B (one bilinear quad), 32 B and 64 B; random indices, and
coherent ones (neighbouring indices address neighbouring rows, the shade's
pattern over a spatially sorted frame). Each of --iters gathers takes its
indices from the previous gather's checksum, on the device, with no host
sync, so no gather can be elided or overlapped with the next (the JAX
tool's chained scan); one pair of CUDA events spans the --iters chained
steps after a warm run of them, and ns per index is their time over iters
* n (the step's add, modulo and checksum included, as in the JAX tool).
ms/2.1Mpx is that at the 2.09e6 pixels of a 1080p frame. The last column
is the gather alone: --iters back-to-back gathers of the first step's
indices between one pair of events, over iters * n. The last line relates
the 16-byte rows' times to the ~12 ms a frame the second mip tap costs
(PERF.md §5, bottleneck 2), on the card only.

On the card the nvidia-smi name and power limit come first. --device cpu
(small --n, a check of the tool; host clock, no device number). Exits 1
without a card.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from tpu_renderer_torch.utils import bench_frame

FRAME_PX = 2.09e6         # 1920 x 1080
SECOND_TAP_MS = 12.0      # the trilinear second mip tap a frame, PERF.md §5
TABLES_KB = (256, 512, 1024, 2048, 6553)
ROW_U32 = (4, 8, 16)      # 16, 32, 64 B rows


def chain(table, idx0, rows: int, iters: int):
    """iters chained gathers: each step's indices are idx0 shifted by the
    previous gather's checksum. Returns the last checksum (a device scalar)."""
    c = torch.zeros((), dtype=torch.int64, device=table.device)
    for _ in range(iters):
        g = table[(idx0 + c) % rows]                  # the gather
        c = (g[:, 0] & 1).sum()
    return c


def _events_ms(fn, device) -> float:
    """ms of fn(): CUDA events on the card after a warm call; the host
    clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1000.0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def bench(table_kb: int, row_u32: int, coherent: bool, n: int, iters: int,
          device, rng):
    """(ns per index of a chained step, ns per index of the gather alone)."""
    rows = max(table_kb * 1024 // (row_u32 * 4), 8)
    table = torch.as_tensor(rng.integers(-2**31, 2**31, (rows, row_u32), dtype=np.int64)
                            .astype(np.int32), device=device)
    if coherent:
        base = np.linspace(0, rows - 1, n).astype(np.int64)
        idx0 = np.clip(base + rng.integers(-2, 3, n), 0, rows - 1)
    else:
        idx0 = rng.integers(0, rows, n)
    idx0 = torch.as_tensor(idx0.astype(np.int64), device=device)
    chained = _events_ms(lambda: chain(table, idx0, rows, iters), device)

    def gathers():
        for _ in range(iters):
            table[idx0]

    alone = _events_ms(gathers, device)
    return chained / iters / n * 1e6, alone / iters / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2 * 1024 * 1024,
                    help="indices per gather (~one 1080p pass)")
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    unit = "ns/idx"
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("bench_gather: no CUDA device", file=sys.stderr)
            return 1
        print(f"[device] {bench_frame.nvidia_smi()}", flush=True)
    else:
        unit = "cpu ns/idx"     # host clock: a check of the tool, no device time
    rng = np.random.default_rng(0)
    print(f"{'table':>8} {'row B':>6} {'pattern':>9} {unit:>10} {'ms/2.1Mpx':>10} "
          f"{'gather ' + unit:>17}")
    quad = []
    for kb in TABLES_KB:
        for row_u32 in ROW_U32:
            for coherent in (False, True):
                ns, alone = bench(kb, row_u32, coherent, args.n, args.iters, device, rng)
                ms = ns * FRAME_PX / 1e6
                if row_u32 == 4:
                    quad.append((ms, alone * FRAME_PX / 1e6))
                print(f"{kb:>6}KB {row_u32 * 4:>6} "
                      f"{'coherent' if coherent else 'random':>9} {ns:>10.3f} "
                      f"{ms:>10.3f} {alone:>17.3f}", flush=True)
    if device.type != "cuda":
        return 0
    chained, alone = [q[0] for q in quad], [q[1] for q in quad]
    print(f"second mip tap: ~{SECOND_TAP_MS:g} ms a frame (PERF.md §5) against one "
          f"16-byte row gather of a 1080p frame: {min(chained):.3f}-{max(chained):.3f} ms "
          f"chained, {min(alone):.3f}-{max(alone):.3f} ms the gather alone, so the gather "
          f"is {100 * max(alone) / SECOND_TAP_MS:.0f}% of the tap at most", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

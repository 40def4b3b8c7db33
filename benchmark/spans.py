"""The span phase: the program's own spans (tpu_renderer_torch.utils.profiling)
over the cell's loop, read by the span metrics (metrics/frame_span_ms.seq.py
and the others that read t["spans"]).

phase(run, eng) runs after a cell's window and traced extras, on the same
engine: it draws the cell's key once with tracing on (the traced capture:
a graph of its own, holding the device stamps), waits out the slow start
of graph launches on that graph with the harness's own settling loop
(keeping the run's slow_start_s), then traces one batch of PROFILE_FRAMES
frames (sequence) or VIEW_PROFILE_CALLS calls (viewer). Between two
batches with tracing off it records the cost of the stamps: CUDA events
around each frame (sequence), the host clock around each call (viewer).

Run one cell with it, on a machine with the CUDA card:

    python3 benchmark/spans.py --workload grid64.seq --seed 1 --seconds 5

It builds the cell and measures a window of --seconds as run.py's traced
run does, then the phase, and prints one JSON line: each span metric
beside the harness's own readings of the same layers, the traced frames'
device and host ms by span, the ten longest device gaps between traced
frames, the calibration and the cost.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import torch

if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness, traffic  # noqa: E402

# the metrics that read the span phase's record, and the harness's own
# readings of the same layers they are printed beside
SPAN_METRICS = ("frame_span_ms.seq", "setup_span_ms.seq", "bins_span_ms.seq",
                "raster_span_ms.seq", "shade_span_ms.seq", "peel_pass_ms.seq",
                "engine_self_ms.view", "fetch_span_ms.view", "init_span_ms",
                "graph_capture_ms")
BESIDE = ("frame_device_ms.seq", "host_ms_per_frame.view", "fetch_wait_ms.view",
          "capture_ms", "slow_start_s")
GAPS = 10


def _batch(run, eng, first: int, traced: bool, record: list):
    """One batch of the cell's loop from path index `first` (PROFILE_FRAMES
    frames or VIEW_PROFILE_CALLS calls), inside a tracing() block when
    traced (its Trace returned). record gets each frame's event-timed
    device ms (sequence; on the CPU nothing) or each call's host ms
    (viewer)."""
    from tpu_renderer_torch.utils import profiling

    with profiling.tracing() if traced else contextlib.nullcontext() as trace:
        if run.mix["loop"] == "sequence":
            pairs: list = []

            def frame(i, render, *a, **k):
                if run.device.type == "cuda":
                    return harness.timed_call(pairs, render, *a, **k)
                return render(*a, **k)

            traffic.sequence(eng, run.path, dict(run.mix, batch_frames=harness.PROFILE_FRAMES),
                             0.0, frame, first=first, batches=1)
            harness._sync(run.device)
            record.extend(a.elapsed_time(b) for a, b in pairs)
        else:
            win = traffic.viewer(eng, run.path, run.mix, 0.0, lambda i, img: None,
                                 first=first, calls=harness.VIEW_PROFILE_CALLS)
            record.extend((b - a) * 1000.0 for a, b in zip(win["starts"], win["ends"]))
    return trace


def phase(run, eng) -> dict:
    """The span phase on a run's engine after its window. Returns what it
    adds to the readers' record: spans (Trace.summary() of the traced
    batch), setup_spans (the program's set-up record), span_slow_start_s
    (the settling loop's wait on the traced graph; the run's slow_start_s is
    kept), and the stamps' cost: span_cost_pct, the traced batch's mean
    frame (or call) ms over the untraced batches', with both lists."""
    from tpu_renderer_torch.utils import profiling

    first = run.window["next"]
    with profiling.tracing():
        if run.mix["loop"] == "sequence":
            traffic.sequence(eng, run.path, dict(run.mix, batch_frames=1), 0.0,
                             lambda i, render, *a, **k: render(*a, **k), first=first, batches=1)
        else:
            eng.camera.yaw = run.path.yaw(first)
            eng.draw_pipelined(stats_interval=0)
            eng.flush_pipelined()
        harness._sync(run.device)
    kept = run.t.get("slow_start_s")
    with profiling.tracing():
        run.settle(eng)
    waited = run.t.pop("slow_start_s", None)
    if kept is not None:
        run.t["slow_start_s"] = kept
    off: list = []
    on: list = []
    _batch(run, eng, first, False, off)
    trace = _batch(run, eng, first, True, on)
    _batch(run, eng, first, False, off)
    cost = 100.0 * (statistics.mean(on) / statistics.mean(off) - 1.0) if on and off else None
    return {"spans": trace.summary(), "setup_spans": profiling.setup_record(),
            "span_slow_start_s": waited, "span_cost_pct": cost,
            "span_off_ms": off, "span_on_ms": on}


def traced_frames(t: dict, loop: str):
    """The span phase's traced frames in a readers' record of a `loop`
    cell, or None where the phase did not run there or dropped anything."""
    s = t.get("spans")
    if t.get("loop") != loop or not s or s["dropped"] or not s["frames"]:
        return None
    return s["frames"]


def host_spans(t: dict, loop: str):
    """The span phase's host spans by name (ms, self_ms, n) in a readers'
    record of a `loop` cell, or None as traced_frames."""
    return t["spans"]["host"] if traced_frames(t, loop) is not None else None


def setup_record(t: dict) -> list:
    """The program's set-up record (utils/profiling.setup_record) in a
    run's record: the phase's copy, else the program's own, which a program
    without one leaves empty."""
    if "loop" not in t:
        return []
    if "setup_spans" in t:
        return t["setup_spans"]
    try:
        from tpu_renderer_torch.utils.profiling import setup_record as program_record
    except ImportError:
        return []
    return program_record()


def _window_gaps(run, eng):
    """The GAPS longest device gaps between traced frames over two of a
    sequence cell's own batches (their boundary included) or the phase's
    viewer calls again, named by the program's host spans, and those host
    spans by name (ms, self_ms, n)."""
    from tpu_renderer_torch.utils import profiling

    first = run.window["next"]
    with profiling.tracing() as trace:
        if run.mix["loop"] == "sequence":
            traffic.sequence(eng, run.path, run.mix, 0.0, lambda i, render, *a, **k: render(
                *a, **k), first=first, batches=2)
        else:
            traffic.viewer(eng, run.path, run.mix, 0.0, lambda i, img: None, first=first,
                           calls=harness.VIEW_PROFILE_CALLS)
        harness._sync(run.device)
    s = trace.summary()
    return [[n, round(ms, 4)] for n, ms in s["gaps"][:GAPS]], s["host"]


def _rounded(d: dict) -> dict:
    return {k: round(v, 4) for k, v in sorted(d.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one cell's span phase")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("spans: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    _, config, mix = harness.find_cell(bench, args.workload)
    run = harness.Run(args.seed, args.seconds, True, "cuda", config, mix)
    tmp = tempfile.mkdtemp(prefix="bench_scene_")
    try:
        _, eng = harness._build_engine(config, run.device, tmp)
        if mix["loop"] == "sequence":
            run.run_sequence(eng, t0)
        else:
            run.run_viewer(eng, t0)
        run.t.update(phase(run, eng))
        window_gaps, window_host = _window_gaps(run, eng)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    metrics = {}
    for name in SPAN_METRICS + BESIDE:
        value = harness.load_metric(name).read(run.t)
        if value is not None:
            metrics[name] = value
    s = run.t["spans"]
    out = dict(workload=args.workload, seed=args.seed, card=harness.nvidia_smi(),
               metrics=metrics, dropped=s["dropped"], calibration_us=s["calibration_us"],
               clock_drift_us=s["clock_drift_us"], timer_step_ns=s["timer_step_ns"],
               span_slow_start_s=run.t["span_slow_start_s"],
               span_cost_pct=run.t["span_cost_pct"],
               span_off_ms=[round(x, 4) for x in run.t["span_off_ms"]],
               span_on_ms=[round(x, 4) for x in run.t["span_on_ms"]],
               gaps=[[n, round(ms, 4)] for n, ms in s["gaps"][:GAPS]],
               window_gaps=window_gaps, window_host=window_host,
               host=s["host"],
               frames=[dict(frame=f["frame"], device_ms=_rounded(f["device_ms"]),
                            device_self_ms=_rounded(f["device_self_ms"]),
                            host_ms=_rounded(f["host_ms"]), peel_passes=f["peel_passes"],
                            peel_shaded_ms=[round(x, 4) for x in f["peel_shaded_ms"]])
                       for f in s["frames"]],
               setup=[dict(name=r["name"], parent=r["parent"], ms=round(r["ms"], 3),
                           **{k: v for k, v in r.items()
                              if k not in ("name", "parent", "ms", "start_ns")})
                      for r in run.t["setup_spans"]])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

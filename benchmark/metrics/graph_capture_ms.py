"""graph_capture_ms: the host ms of the capture of the run's first frame
graph alone (FrameGraph's capture, without the eager frame before it,
which capture_ms holds too), from the program's set-up record
(utils/profiling.setup_step, always on). Nothing on the CPU or from a
program without the record."""

from benchmark.spans import setup_record


def read(t):
    record = setup_record(t)
    inits = [r["start_ns"] for r in record if r["name"] == "Engine.init"]
    captures = [r for r in record
                if r["name"] == "capture" and (not inits or r["start_ns"] >= inits[-1])]
    return captures[0]["ms"] if captures else None

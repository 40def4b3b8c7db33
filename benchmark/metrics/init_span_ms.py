"""init_span_ms: the host ms of the run's Engine.init (the scene's load,
flatten, upload and caps), from the program's set-up record
(utils/profiling.setup_step, always on). Nothing from a program without
the record."""

from benchmark.spans import setup_record


def read(t):
    steps = [r for r in setup_record(t) if r["name"] == "Engine.init"]
    return steps[-1]["ms"] if steps else None

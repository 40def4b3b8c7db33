"""peel_pass_ms.seq: the device ms of one pass of the peel loop that shaded
a layer (a `peel_pass` span with a `shade` child: every pass but the last,
empty one), stamped inside the WHILE node of the replayed graph, the mean
over the span phase's traced frames (benchmark/spans.py). Nothing on a path
without the peel."""

from benchmark.spans import traced_frames

SPANS = True   # read from the span phase (benchmark/spans.py)


def read(t):
    frames = traced_frames(t, "sequence")
    passes = [ms for f in frames or () for ms in f["peel_shaded_ms"]]
    if not passes:
        return None
    return sum(passes) / len(passes)

"""frame_span_ms.seq: the device ms of a sequence frame by the program's own
`frame` span (utils/profiling.device_frame: the card's global timer at the
frame's first and last stamp, inside the replayed graph), the mean over the
span phase's traced frames (benchmark/spans.py)."""

from benchmark.spans import traced_frames

SPANS = True   # read from the span phase (benchmark/spans.py)


def read(t):
    frames = traced_frames(t, "sequence")
    if frames is None:
        return None
    return sum(f["device_ms"].get("frame", 0.0) for f in frames) / len(frames)

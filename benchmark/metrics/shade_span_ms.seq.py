"""shade_span_ms.seq: the device ms a sequence frame spends in
the shading (the opaque pass's and every peel pass's), by the program's `shade` spans summed over the frame, the mean
over the span phase's traced frames (benchmark/spans.py)."""

from benchmark.spans import traced_frames

SPANS = True   # read from the span phase (benchmark/spans.py)


def read(t):
    frames = traced_frames(t, "sequence")
    if frames is None:
        return None
    return sum(f["device_ms"].get("shade", 0.0) for f in frames) / len(frames)

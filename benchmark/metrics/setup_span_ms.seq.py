"""setup_span_ms.seq: the device ms a sequence frame spends in the cull and
the triangle setup, by the program's `cull` and `setup` spans (every setup
of the frame, the transparent one included), the mean over the span phase's
traced frames (benchmark/spans.py)."""

from benchmark.spans import traced_frames

SPANS = True   # read from the span phase (benchmark/spans.py)


def read(t):
    frames = traced_frames(t, "sequence")
    if frames is None:
        return None
    return sum(f["device_ms"].get("cull", 0.0) + f["device_ms"].get("setup", 0.0)
               for f in frames) / len(frames)

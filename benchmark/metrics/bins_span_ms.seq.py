"""bins_span_ms.seq: the device ms a sequence frame spends in
the tile bins (the spatial sort, the chunk and group boxes, the dense or capped bins, their refine or expansion), opaque and transparent, by the program's `bins` spans summed over the frame, the mean
over the span phase's traced frames (benchmark/spans.py)."""

from benchmark.spans import traced_frames

SPANS = True   # read from the span phase (benchmark/spans.py)


def read(t):
    frames = traced_frames(t, "sequence")
    if frames is None:
        return None
    return sum(f["device_ms"].get("bins", 0.0) for f in frames) / len(frames)

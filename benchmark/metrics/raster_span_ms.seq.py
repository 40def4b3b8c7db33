"""raster_span_ms.seq: the device ms a sequence frame spends in
the raster kernels (2.1, 2.2, 2.4 and every peel pass's 2.3 or 2.5, with their wrappers), by the program's `raster` spans summed over the frame, the mean
over the span phase's traced frames (benchmark/spans.py)."""

from benchmark.spans import traced_frames

SPANS = True   # read from the span phase (benchmark/spans.py)


def read(t):
    frames = traced_frames(t, "sequence")
    if frames is None:
        return None
    return sum(f["device_ms"].get("raster", 0.0) for f in frames) / len(frames)

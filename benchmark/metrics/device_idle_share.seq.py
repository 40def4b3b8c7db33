"""device_idle_share.seq: the share of a traced sequence window in which
the device ran no frame, %: 1 - (the frames' event-timed device ms summed)
/ (the window's ms). The events see the frames whole, the peel loop's
conditional nodes included, where the profiler does not."""


def read(t):
    ms = t.get("frame_ms")
    if t.get("loop") != "sequence" or not ms or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - sum(ms) / 1000.0 / t["window_s"])

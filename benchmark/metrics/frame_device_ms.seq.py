"""frame_device_ms.seq: the device time of a sequence frame, ms: CUDA
events recorded on the stream before and after each frame of a traced
window (the frame graph's replay and its input copies), their mean over
the window. Nothing where the window recorded no events."""


def read(t):
    ms = t.get("frame_ms")
    if t.get("loop") != "sequence" or not ms:
        return None
    return sum(ms) / len(ms)

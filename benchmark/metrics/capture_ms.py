"""capture_ms: the host ms of the first frame of the window's key, which
builds the frame graph (an eager frame, then the capture), from a
synchronised start to a synchronised end during set-up."""


def read(t):
    return t.get("capture_ms")

"""host_ms_per_frame.view: the host ms of a draw_pipelined call without its
wait on frame N-2 (the camera update, the frame's dispatch, the copy's
enqueue): the host clock around each call of a traced viewer window, less
the time inside _InFlight.image() timed from outside; the mean over the
window's calls."""


def read(t):
    ms = t.get("host_ms")
    if t.get("loop") != "viewer" or not ms:
        return None
    return sum(ms) / len(ms)

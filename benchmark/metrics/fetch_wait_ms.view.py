"""fetch_wait_ms.view: the host ms a delivered frame waits for its pinned
copy and is copied out (_InFlight.image(): the event's wait and the
unpacking copy), timed from outside over a traced viewer window; the mean
over the delivered frames."""


def read(t):
    ms = t.get("fetch_ms")
    if t.get("loop") != "viewer" or not ms:
        return None
    return sum(ms) / len(ms)

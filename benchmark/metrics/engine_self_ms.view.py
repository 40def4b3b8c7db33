"""engine_self_ms.view: the host ms of a draw_pipelined call less its
`fetch` child (the wait on frame N-2's copy and the copy-out), by the
program's host spans over the span phase's traced calls
(benchmark/spans.py): what host_ms_per_frame.view reads from outside."""

from benchmark.spans import host_spans

SPANS = True   # read from the span phase (benchmark/spans.py)


def read(t):
    host = host_spans(t, "viewer")
    if not host or "draw_pipelined" not in host:
        return None
    fetch = host.get("fetch", {}).get("ms", 0.0)
    return (host["draw_pipelined"]["ms"] - fetch) / host["draw_pipelined"]["n"]

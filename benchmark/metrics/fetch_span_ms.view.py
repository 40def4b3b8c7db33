"""fetch_span_ms.view: the host ms a delivered frame spends in the program's
`fetch` span (its children: `wait`, the event's synchronise, and
`copy_out`, the unpacking copy), the mean over the span phase's traced
calls (benchmark/spans.py): what fetch_wait_ms.view reads from outside."""

from benchmark.spans import host_spans

SPANS = True   # read from the span phase (benchmark/spans.py)


def read(t):
    host = host_spans(t, "viewer")
    if not host or "fetch" not in host:
        return None
    return host["fetch"]["ms"] / host["fetch"]["n"]

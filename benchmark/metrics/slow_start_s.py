"""slow_start_s: the seconds from the end of set-up until the benchmark's
probe graph (harness.Probe) first reads the process's slow start of graph
launches over, which the program's first frame-graph capture begins. Where
it was not over within the settling phase's limit, that limit's seconds (a
floor). Nothing on the CPU."""


def read(t):
    return t.get("slow_start_s")

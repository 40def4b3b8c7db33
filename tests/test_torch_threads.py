"""torch's intra-op threads in the test processes.

Under pytest-xdist (-n N) the N workers share the host's cores. Left
alone, torch gives every worker all of them as intra-op threads, and the
plain versions' many small operations then wait, at every parallel
region, for threads that another worker's load has descheduled: on an
8-core host with six workers, tests/test_torch_frame.py's 480p structure
frame took 634 s of the run against ~15 s alone. So every
tests/test_torch_*.py module calls share_cores() when it is imported, and
each worker runs torch on its share of the cores; a run without xdist
keeps them all.
"""

import os

import torch


def workers() -> int:
    """The processes sharing the host's cores: pytest-xdist's workers, or 1."""
    return int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))


def share_cores() -> int:
    """Set torch's intra-op threads to this process's share of the cores it
    may run on (at least 1); returns it."""
    n = max(1, len(os.sched_getaffinity(0)) // workers())
    torch.set_num_threads(n)
    return n


share_cores()


def test_each_worker_takes_its_share_of_the_cores():
    cores = len(os.sched_getaffinity(0))
    assert torch.get_num_threads() == max(1, cores // workers())
    if workers() > 1:
        assert torch.get_num_threads() * workers() <= max(cores, workers())

"""On the card: one short run of each cell through the command in
BENCHMARK.json, with correct true and the result line's keys. Marked
`cuda`; it skips where there is no card."""

import json
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = harness.load_benchmark()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run(BENCH["command"] + ["--workload", cell, "--seed", "2718281828459",
                                             "--seconds", "2", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "checks"
    print(sys.executable, line)

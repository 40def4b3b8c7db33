"""Each cell runs end to end on the CPU at a tiny extent, through the
harness's whole run, and yields the result line the benchmark prints."""

import json

import pytest

from benchmark import harness

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_cpu(cell, small):
    seconds = 8.0 if cell.endswith(".view") else 0.0   # a few intervals on a loaded CPU
    result = harness.run_cell(cell, 2 ** 33 + 17, seconds, False, device="cpu", adjust=small)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == KEYS
    assert list(line)[-1] == "checks"        # the compared numbers come last
    assert set(line) == set(KEYS) | {"checks"}
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell, "end_to_end")}
    assert set(line["metrics"]) == e2e
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"} and check["value"] <= check["limit"]


def test_traced_run_on_cpu(small, monkeypatch):
    monkeypatch.setattr(harness, "EAGER_FRAMES", 1)
    result = harness.run_cell("grid64.seq", 5, 0.0, True, device="cpu", adjust=small)
    assert list(result)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU the device readers find nothing; the host clock's do
    assert "capture_ms" in result["metrics"]
    assert result["correct"] is True


def test_a_cell_that_leaves_its_path_fails(small):
    def wrong(config, mix):
        small(config, mix)
        config["path"]["peel"] = True       # grid64's glass is untextured: no peel
    with pytest.raises(harness.CellError, match="does not take its path"):
        harness.run_cell("grid64.seq", 1, 0.0, False, device="cpu", adjust=wrong)

"""BENCHMARK.json keeps the contract's names, units and shape, and every
file it names is found by name."""

import json
import os
import re

from benchmark import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[kind]}) == len(BENCH[kind])
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]] + BENCH["command"]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_file_is_found_by_name():
    for c in BENCH["configs"]:
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
    for w in BENCH["workloads"]:
        cell, config, mix = harness.find_cell(BENCH, w["name"])
        assert mix["loop"] in ("sequence", "viewer") and w["chips"] == 1
    for m in BENCH["per_layer"]:
        mod = harness.load_metric(m["name"])
        assert callable(mod.read) and mod.read({}) is None


def test_metrics_and_cells_fit_together():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in harness.cell_metrics(BENCH, cell,
                                                                          "end_to_end")}
    for cell in cells:
        own = {x["name"] for x in harness.cell_metrics(BENCH, cell, "end_to_end")}
        assert "setup_s" in own and len(own) >= 2
        assert harness.cell_metrics(BENCH, cell, "per_layer")

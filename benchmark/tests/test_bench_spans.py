"""The span metrics' readers on hand-made records, and the span phase
(spans.phase) on the CPU at a tiny size."""

import pytest

from benchmark import harness, spans


def _frame(k, **ms):
    return dict(frame=k, device_ms=ms, device_self_ms={}, host_ms={},
                peel_passes=0, peel_shaded_ms=[])


SEQ = {"loop": "sequence", "spans": {
    "dropped": 0, "host": {},
    "frames": [dict(_frame(1, frame=14.0, cull=0.25, setup=3.75, bins=2.0, raster=1.5,
                           shade=6.0), peel_passes=3, peel_shaded_ms=[7.0, 9.0]),
               dict(_frame(2, frame=16.0, cull=0.25, setup=4.25, bins=1.0, raster=2.5,
                           shade=7.0), peel_passes=2, peel_shaded_ms=[8.0])]}}
VIEW = {"loop": "viewer", "spans": {
    "dropped": 0, "frames": [_frame(1, frame=14.0)],
    "host": {"draw_pipelined": dict(ms=60.0, self_ms=1.0, n=4),
             "fetch": dict(ms=52.0, self_ms=0.5, n=4)}}}
SETUP = [dict(name="Engine.init", parent=None, start_ns=10, ms=900.0),
         dict(name="capture", parent=None, start_ns=5, ms=111.0),
         dict(name="Engine.init", parent=None, start_ns=100, ms=1200.0),
         dict(name="first frame", parent=None, start_ns=200, ms=300.0),
         dict(name="capture", parent=None, start_ns=300, ms=700.0),
         dict(name="capture", parent=None, start_ns=400, ms=50.0)]
WANT = {"frame_span_ms.seq": (SEQ, 15.0), "setup_span_ms.seq": (SEQ, 4.25),
        "bins_span_ms.seq": (SEQ, 1.5), "raster_span_ms.seq": (SEQ, 2.0),
        "shade_span_ms.seq": (SEQ, 6.5), "peel_pass_ms.seq": (SEQ, 8.0),
        "engine_self_ms.view": (VIEW, 2.0), "fetch_span_ms.view": (VIEW, 13.0),
        "init_span_ms": ({"loop": "viewer", "setup_spans": SETUP}, 1200.0),
        "graph_capture_ms": ({"loop": "viewer", "setup_spans": SETUP}, 700.0)}


@pytest.mark.parametrize("name", spans.SPAN_METRICS)
def test_each_reader_reads_its_record(name):
    record, want = WANT[name]
    read = harness.load_metric(name).read
    assert read(record) == pytest.approx(want)
    assert read({}) is None


@pytest.mark.parametrize("name", spans.SPAN_METRICS[:8])
def test_span_readers_read_nothing_where_the_phase_dropped_or_was_elsewhere(name):
    record, _ = WANT[name]
    read = harness.load_metric(name).read
    assert read(dict(record, spans=dict(record["spans"], dropped=1))) is None
    other = "viewer" if record["loop"] == "sequence" else "sequence"
    assert read(dict(record, loop=other)) is None
    assert read({"loop": record["loop"]}) is None


def test_peel_pass_reads_nothing_without_a_peel():
    no_peel = {"loop": "sequence", "spans": dict(SEQ["spans"], frames=[_frame(1, frame=1.0)])}
    assert harness.load_metric("peel_pass_ms.seq").read(no_peel) is None


@pytest.mark.parametrize("cell", ["glass64.seq", "grid64.view"])
def test_the_phase_runs_on_cpu(cell, small, tmp_path):
    bench = harness.load_benchmark()
    _, config, mix = harness.find_cell(bench, cell)
    small(config, mix)
    run = harness.Run(2 ** 33 + 3, 0.0 if cell.endswith(".seq") else 1.0, True, "cpu",
                      config, mix)
    _, eng = harness._build_engine(config, run.device, str(tmp_path))
    (run.run_sequence if mix["loop"] == "sequence" else run.run_viewer)(eng, 0.0)
    run.t.update(spans.phase(run, eng))
    assert "slow_start_s" not in run.t       # no probe on the CPU; the phase adds none
    read = {n: harness.load_metric(n).read(run.t) for n in spans.SPAN_METRICS}
    if cell == "glass64.seq":
        assert read["frame_span_ms.seq"] > 0 and read["peel_pass_ms.seq"] > 0
        assert len(run.t["spans"]["frames"]) == harness.PROFILE_FRAMES
        assert read["engine_self_ms.view"] is None
    else:
        assert read["engine_self_ms.view"] > 0 and read["fetch_span_ms.view"] > 0
        assert read["frame_span_ms.seq"] is None
    assert read["init_span_ms"] > 0 and read["graph_capture_ms"] is None   # no graph on the CPU

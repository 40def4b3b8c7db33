"""The port's span log (tpu_renderer_torch/utils/profiling.py: tracing, span,
device_span, device_frame, the set-up record) on the CPU, where a device
stamp is its plain twin on time.perf_counter_ns: the span tree of a frame
on the fused path with untextured glass (the accumulation), the fused peel
and the deferred path; one frame id a frame; a peel pass a layer and one
more; self times that sum to the frame; what is dropped past the capacity;
the set-up record; the launches of kernel 2.12 that the summary lists; and
tracing off, which stamps nothing, keeps the graph key and leaves every
frame byte for byte the same.

The card's side (stamps inside a replayed graph and its WHILE node, the
calibration) is in tests/test_torch_cuda.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from tpu_renderer_torch import frame_graph, pipeline
from tpu_renderer_torch.config import RendererConfig
from tpu_renderer_torch.engine import Engine
from tpu_renderer_torch.kernels import raster
from tpu_renderer_torch.scene import load_scene
from tpu_renderer_torch.utils import profiling
from tpu_renderer_torch.utils.bench_frame import texture_the_glass
from tpu_renderer_torch.utils.demo import build_demo_glb
from test_torch_threads import share_cores

share_cores()

W, H = 64, 32
PATHS = ("accum", "peel", "deferred")


@pytest.fixture(scope="module")
def glb(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "demo2.glb")
    build_demo_glb(path, grid=2, seed=0)
    return path


def _engine(glb, path):
    """The demo grid 2 at WxH: untextured glass on the fused path (kernel
    2.2's accumulation), its glass textured (the fused peel), or past a
    dense-bin guard of 1 (the deferred path and its peel)."""
    eng = Engine(RendererConfig(width=W, height=H, camera_position=(0.0, 6.0, 8.0),
                                dense_bin_max_chunks=1 if path == "deferred" else 8192),
                 device="cpu")
    eng.camera.pitch = np.float32(-0.18)
    s = load_scene(glb)
    eng.init(scene=s if path == "accum" else texture_the_glass(s))
    return eng


def _tree(spans, root: int, depth: int = 0) -> list:
    """(depth, name) of a span and its descendants, in order."""
    out = [(depth, spans[root][0])]
    for i, s in enumerate(spans):
        if s[3] == root:
            out += _tree(spans, i, depth + 1)
    return out


def _opaque(deferred: bool) -> list:
    """The opaque pass's spans: on the fused path the composite is the
    shading's epilogue (kernel 2.12), so it opens no span of its own; the
    deferred path composites apart and sets up its transparent rows after."""
    head = [(1, "cull"), (1, "setup"), (1, "bins"), (1, "raster"), (1, "shade")]
    return head + ([(1, "composite"), (1, "setup")] if deferred else [])


def _peel(layers: int, deferred: bool) -> list:
    passes = []
    for k in range(layers + 1):
        passes += [(2, "peel_pass"), (3, "raster")]
        if k < layers:
            passes += [(3, "shade")] + ([(3, "composite")] if deferred else [])
    return [(1, "bins"), (1, "peel")] + passes


@pytest.mark.parametrize("path", PATHS)
def test_a_traced_frame_is_a_tree_of_its_stages(glb, path):
    eng = _engine(glb, path)
    eng.draw()
    with profiling.tracing() as trace:
        image = eng.draw()
        again = eng.draw()
    layers = int(eng._last_aux["transparent_layers"])
    assert trace.device == torch.device("cpu")   # the frame's device, card or none
    spans = trace.device_spans()
    roots = [i for i, s in enumerate(spans) if s[3] == -1]
    assert [spans[i][0] for i in roots] == ["frame", "frame"]
    if path == "accum":
        want = _opaque(False) + [(1, "transparent"), (2, "bins"), (2, "raster"),
                                 (2, "composite")]
    else:
        assert layers >= 1
        want = _opaque(path == "deferred") + _peel(layers, path == "deferred")
    want = [(0, "frame")] + want + [(1, "present")]
    for root in roots:
        assert _tree(spans, root) == want
    # one frame id a frame, the host's count and the card's alike
    assert [s[4] for s in spans] == [1] * len(want) + [2] * len(want)
    assert trace.frames == 2
    passes = [s[5] for s in spans if s[0] == "peel_pass" and s[4] == 2]
    assert passes == list(range(layers + 1 if path != "accum" else 0))
    summary = trace.summary()
    assert summary["dropped"] == 0 and len(summary["frames"]) == 2
    for f in summary["frames"]:
        assert sum(f["device_self_ms"].values()) == pytest.approx(f["device_ms"]["frame"])
        assert all(v >= 0 for v in f["device_self_ms"].values())
        assert f["peel_passes"] == (layers + 1 if path != "accum" else 0)
        assert len(f["peel_shaded_ms"]) == (layers if path != "accum" else 0)
        assert set(f["host_ms"]) == {"update_scene", "draw_device"}
    assert [g[0] for g in summary["gaps"]] == ["draw_device"]
    np.testing.assert_array_equal(image, again)


@pytest.mark.parametrize("path", PATHS)
def test_tracing_off_stamps_nothing_and_changes_no_frame(glb, path):
    eng = _engine(glb, path)
    raster.stamp_counter.reset()
    off = eng.draw()
    assert raster.stamp_counter.total() == 0
    assert profiling.span("x") is profiling.device_span("x") is profiling.device_frame("cpu")
    with profiling.tracing() as trace:
        on = eng.draw()
    assert raster.stamp_counter.total() == len(trace.stamps) > 0
    raster.stamp_counter.reset()
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(eng.draw(), off)
    assert raster.stamp_counter.total() == 0
    # a later trace starts from an empty log
    with profiling.tracing() as empty:
        pass
    assert empty.stamps == [] and empty.host == [] and empty.summary()["frames"] == []


def test_the_graph_key_holds_the_trace_flag(glb):
    eng = _engine(glb, "peel")
    params = eng.update_scene()
    bg = eng._bg_fb_cached(params)
    off = frame_graph.graph_key(eng.flat.buffers, bg, {"width": W})
    assert off[-1] is None and frame_graph.graph_key(eng.flat.buffers, bg, {"width": W}) == off
    with profiling.tracing(capacity=512):
        on = frame_graph.graph_key(eng.flat.buffers, bg, {"width": W})
    assert on[:-1] == off[:-1] and on[-1] == 512


def test_entries_past_the_capacity_are_dropped_and_counted(glb):
    eng = _engine(glb, "peel")
    with profiling.tracing() as whole:
        eng.draw()
    n = len(whole.stamps)
    with profiling.tracing(capacity=8) as trace:
        eng.draw()
    assert len(trace.stamps) == 8 and trace.device_dropped == n - 8
    assert len(trace.host) == 2 and trace.host_dropped == 0
    summary = trace.summary()
    assert summary["dropped"] == n - 8 and summary["frames"] == []
    with profiling.tracing(capacity=1) as trace:
        with profiling.span("a"):
            with profiling.span("b"):
                pass
    assert [s[0] for s in trace.host] == ["a"] and trace.host_dropped == 1


def test_host_spans_carry_their_frame(glb):
    """render_frames' spans (a render_frame span a frame); draw_pipelined's
    children, its fetch carrying the frame it delivers (two calls back)."""
    eng = _engine(glb, "accum")
    kw = dict(tile_h=32, tile_w=128, fp16=True, transp_textured=False, fused=True,
              trilinear=eng._trilinear, pot=eng._pot, width=W, height=H, **eng._caps)
    params = [eng.update_scene() for _ in range(3)]
    with profiling.tracing() as trace:
        pipeline.render_frames(eng.flat.buffers, params, frame=eng.render_fn(), **kw)
        for _ in range(4):
            eng.draw_pipelined(stats_interval=1)
    host = trace.host
    assert [(s[0], s[4]) for s in host if s[0] in ("render_frame", "render_frames")] == [
        ("render_frames", 1), ("render_frame", 1), ("render_frame", 2), ("render_frame", 3)]
    assert {s[0] for s in host if s[3] == 0} == {"background", "render_frame", "checksums"}
    calls = [i for i, s in enumerate(host) if s[0] == "draw_pipelined"]
    assert [host[i][4] for i in calls] == [4, 5, 6, 7]
    kids = [[s[0] for s in host if s[3] == i] for i in calls]
    assert kids[:2] == [["update_scene", "draw_device", "submit"]] * 2
    assert kids[2:] == [["update_scene", "draw_device", "submit", "fetch", "update_stats"]] * 2
    fetch = [i for i, s in enumerate(host) if s[0] == "fetch"]
    assert [host[i][4] for i in fetch] == [4, 5]
    assert [[s[0] for s in host if s[3] == i] for i in fetch] == [["wait", "copy_out"]] * 2
    summary = trace.summary()
    assert summary["host"]["draw_pipelined"]["n"] == 4
    assert summary["host"]["fetch"]["ms"] <= summary["host"]["draw_pipelined"]["ms"]
    assert [f["frame"] for f in summary["frames"]] == [1, 2, 3, 4, 5, 6, 7]


def test_the_set_up_record_names_init_and_its_steps(glb):
    _engine(glb, "accum")
    record = profiling.setup_record()
    init = [r for r in record if r["name"] == "Engine.init"][-1]
    steps = [r for r in record
             if r["parent"] == "Engine.init" and r["start_ns"] >= init["start_ns"]]
    assert [r["name"] for r in steps] == ["load", "flatten", "upload", "caps"]
    assert sum(r["ms"] for r in steps) <= init["ms"] and all(r["ms"] >= 0 for r in steps)


def test_the_summary_lists_the_launches_of_kernel_2_12(glb, monkeypatch):
    """The summary counts LAUNCH_COUNTERS over its block: on the CPU the
    frame sets up and shades in the plain versions (no launch); what the
    counters add inside the block is its, what they add after it is not."""
    from tpu_renderer_torch.kernels import shade, vertex

    for counter in (shade.fused_counter, shade.trilinear_counter, vertex.setup_counter):
        monkeypatch.setattr(counter, "launches", counter.launches)
    eng = _engine(glb, "peel")
    eng.draw()
    with profiling.tracing() as trace:
        eng.draw()
    assert trace.summary()["launches"] == {"shade.fused": 0, "shade.trilinear": 0,
                                           "vertex.setup": 0}
    with profiling.tracing() as trace:
        eng.draw()
        shade.fused_counter.launches += 3
        shade.trilinear_counter.launches += 2
        vertex.setup_counter.launches += 1
    shade.fused_counter.launches += 5
    vertex.setup_counter.launches += 4
    assert set(profiling.LAUNCH_COUNTERS) == {"shade.fused", "shade.trilinear", "vertex.setup"}
    assert trace.summary()["launches"] == {"shade.fused": 3, "shade.trilinear": 2,
                                           "vertex.setup": 1}
    assert json.loads(json.dumps(trace.to_json()))["summary"]["launches"]["shade.fused"] == 3


def test_device_trace_writes_the_span_log(glb, tmp_path):
    eng = _engine(glb, "peel")
    with profiling.device_trace(str(tmp_path)):
        eng.draw()
    with open(os.path.join(tmp_path, "spans.json")) as f:
        log = json.load(f)
    assert set(log) == {"host", "device", "setup", "summary", "unix_minus_perf_ns"}
    assert log["device"][0]["name"] == "frame"
    assert [s["name"] for s in log["host"]] == ["update_scene", "draw_device"]
    assert set(log["device"][0]) == {"name", "start_ns", "end_ns", "parent", "frame",
                                     "instance"}
    events = json.load(open(os.path.join(tmp_path, "trace.json")))["traceEvents"]
    assert any(e.get("name") == profiling.HOST_PREFIX + "draw_device" for e in events)


def test_tracing_blocks_do_not_nest():
    with profiling.tracing():
        with pytest.raises(RuntimeError, match="do not nest"):
            with profiling.tracing():
                pass
    assert profiling.graph_flag() is None

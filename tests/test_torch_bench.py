"""The port's bench (python3 -m tpu_renderer_torch.bench) and the
cost-model fit tool, on the CPU: in-process with --device cpu at sizes
below the CPU defaults (256x64, grid 2, one frame: the plain versions of
the kernels take about a second a 640x360 frame, and far longer beside
other test workers), the JSON line's keys against the JAX package's
bench.py, and the refusal without a card. A CPU run is a check of the
program; it measures nothing about the device.
"""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from tpu_renderer_torch import bench
from tpu_renderer_torch.config import RendererConfig
from tpu_renderer_torch.tools import fit_cost_model
from test_torch_threads import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dict_keys(path: str, name: str):
    """The keys of the dict literal assigned to `name` in the source at
    path, and of the dicts nested in it: {key: nested keys or None}."""
    def keys(node):
        return {k.value: keys(v) if isinstance(v, ast.Dict) else None
                for k, v in zip(node.keys, node.values)}

    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == name for t in node.targets)):
            return keys(node.value)
    raise AssertionError(f"no dict {name} in {path}")


@pytest.fixture(scope="module")
def cpu_line():
    """The bench's line from a CPU run at 256x64 (its CPU extent patched
    down), on one thread: small tensors gain nothing from more, and the
    other test workers keep their cores."""
    buf = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as patch, contextlib.redirect_stdout(buf):
            patch.setitem(bench.CPU_SIZES, "width", 256)
            patch.setitem(bench.CPU_SIZES, "height", 64)
            rc = bench.main(["--device", "cpu", "--grid", "2", "--frames", "1",
                             "--stress-grid", "2"])
    finally:
        torch.set_num_threads(threads)
    assert rc == 0
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1, lines          # ONE JSON line
    return json.loads(lines[0])


def test_bench_line_has_every_key_of_the_jax_bench(cpu_line):
    """Same keys, top level, detail and statics, as bench.py's result."""
    want = _dict_keys(os.path.join(ROOT, "bench.py"), "result")
    assert set(cpu_line) == set(want)
    assert set(cpu_line["detail"]) == set(want["detail"])
    assert set(cpu_line["detail"]["statics"]) == set(want["detail"]["statics"])


def test_bench_cpu_run_is_named_a_smoke(cpu_line):
    assert cpu_line["metric"] == "fps_cpu_smoke" and cpu_line["backend"] == "cpu"
    assert cpu_line["unit"] == "frames/sec" and cpu_line["value"] > 0
    # value is round(fps, 2), so fps lies within 0.005 of it, and
    # vs_baseline, round(fps / 60, 3), between the roundings of the ends
    value = cpu_line["value"]
    assert round((value - 0.005) / 60.0, 3) <= cpu_line["vs_baseline"] \
        <= round((value + 0.005) / 60.0, 3)
    d = cpu_line["detail"]
    assert d["resolution"] == "256x64" and d["render_scale"] == 1.0
    assert d["triangles"] > 0 and d["stress_triangles"] > 0 and d["drawcalls"] > 0
    for key in ("frame_ms", "trilinear_fps", "trilinear_auto_fps", "stress_fps",
                "fullfetch_fps", "fullfetch_frame_ms", "viewer_fps"):
        assert d[key] > 0, key
    assert RendererConfig().auto_scale_min <= d["trilinear_auto_scale"] <= 1.0
    assert d["statics"] == dict(fused=True, trilinear=False, pot=True,
                                transp_textured=False, raster_chunk=32, raster_group=8,
                                raster_sort="hilbert")


@pytest.mark.parametrize("fps", [2.9675, 2.9651, 24.58, 60.0, 59.9971])
def test_bench_headline_fields_round_as_bench_py(fps):
    """The line's two fields as bench.py:187-189 writes them, from the
    unrounded fps: in the window [2.965, 2.97) vs_baseline (0.049) is not
    value / 60 rounded (0.05), and the range the line test allows holds
    it."""
    value, vs_baseline = bench.headline_fields(fps)
    assert value == round(fps, 2) and vs_baseline == round(fps / 60.0, 3)
    assert round((value - 0.005) / 60.0, 3) <= vs_baseline <= round((value + 0.005) / 60.0, 3)
    if 2.965 <= fps < 2.97:
        assert (value, vs_baseline) == (2.97, 0.049) and round(value / 60.0, 3) == 0.05


def test_bench_cpu_defaults_are_the_jax_bench_fallback_sizes():
    """bench.py:35-37 and :134-135: 640x360, grid 8, 2 frames, stress 4."""
    assert bench.CPU_SIZES == dict(width=640, height=360, grid=8, frames=2, stress_grid=4)
    assert bench.CARD_SIZES == dict(width=1920, height=1080, grid=64, frames=60,
                                    stress_grid=128)


@pytest.mark.parametrize("module", ["tpu_renderer_torch.bench",
                                    "tpu_renderer_torch.tools.profile_raster",
                                    "tpu_renderer_torch.tools.profile_stages",
                                    "tpu_renderer_torch.tools.fit_cost_model",
                                    "tpu_renderer_torch.tools.time_stream_kernels",
                                    "tpu_renderer_torch.tools.time_background"])
def test_entry_points_refuse_without_cuda(module):
    """Each runs on the card by default and does not carry on on the CPU
    without one: non-zero exit, its message, no result line."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-card refusal")
    out = subprocess.run([sys.executable, "-m", module], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0, out.stdout
    assert "no CUDA device" in out.stderr and out.stdout.strip() == ""


def test_cost_model_fit_recovers_known_constants():
    """Points generated from a model come back as its constants, with zero
    residuals; a fit that would go negative clamps at 0."""
    mpx = 1920 * 1080 / 1e6
    truth = dict(base_ns=1.5, tap_ns=4.0, fixed_ms=30.0, blit_ms=0.5)
    ms = {label: fit_cost_model.predict(truth, 2 if tri else 1, s, mpx)
          for label, tri, s in fit_cost_model.POINTS}
    got = fit_cost_model.fit(ms, truth["blit_ms"], mpx)
    for k, v in truth.items():
        assert got[k] == pytest.approx(v, abs=1e-9), k
    for label, tri, s in fit_cost_model.POINTS:
        assert fit_cost_model.predict(got, 2 if tri else 1, s, mpx) == \
            pytest.approx(ms[label], abs=1e-9)
    # a frame that does not shrink with the extent, and a tap that costs
    # nothing: no constant below 0, everything lands in the fixed term
    flat = {label: 40.0 for label, _, _ in fit_cost_model.POINTS}
    flat["single-tap s=1.0"] = 41.0
    got = fit_cost_model.fit(flat, 0.0, mpx)
    assert got == dict(base_ns=0.0, tap_ns=0.0, fixed_ms=40.0, blit_ms=0.0)


def test_cost_model_fit_tool_runs_on_the_cpu(capsys):
    assert fit_cost_model.main(["--device", "cpu", "--grid", "2", "--frames", "1",
                                "--rounds", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    result = json.loads(lines[-1])
    assert result["device"] == "cpu" and set(result["points_ms"]) == \
        {label for label, _, _ in fit_cost_model.POINTS}
    assert all(v >= 0.0 for v in result["constants"].values())
    assert any(line.strip().startswith("_COST_FIXED_MS = ") for line in lines)

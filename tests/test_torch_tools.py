"""The port's card-side tooling, on the CPU: the kernel library's build
cache, chip_smoke.py's refusals without a card, and the bench-frame stage
timer's wrapping. Nothing here imports JAX or needs nvcc."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_renderer_torch import pipeline
from tpu_renderer_torch.kernels import _build, raster, shade, vertex
from tpu_renderer_torch.utils import bench_frame

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_reuses_cached_library(tmp_path, monkeypatch):
    """A library built from the same sources is reused without nvcc, and
    the build time then reads None (chip_smoke reports the reuse)."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "build_seconds", 5.0)

    def no_nvcc():
        raise AssertionError("nvcc must not run on a cache hit")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    cached = tmp_path / f"libraster_kernels_{_build._digest()}.so"
    cached.write_bytes(b"")
    assert _build.build() == str(cached)
    assert _build.build_seconds is None
    smoke = _chip_smoke()
    assert "cached" in smoke.build_line(_build.build_seconds, 0.01)
    assert "nvcc 5.90 s" in smoke.build_line(5.9, 0.01)


def test_nvidia_smi_failure_raises(tmp_path, monkeypatch):
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\necho 'no devices' >&2\nexit 9\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvidia-smi failed"):
        bench_frame.nvidia_smi()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card refusal")
def test_chip_smoke_refuses_without_cuda():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no CUDA device" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repo, the script fails and prints no result."""
    (tmp_path / "chip_smoke.py").write_bytes(
        open(os.path.join(ROOT, "chip_smoke.py"), "rb").read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_stage_timer_wraps_and_restores(tmp_path):
    """Every stage of the frame is timed, the frame is unchanged by the
    wrapping, and the stage functions are restored afterwards."""
    eng = bench_frame.bench_engine(str(tmp_path / "demo2.glb"), device="cpu",
                                   grid=2, width=256, height=64)
    before = [getattr(mod, attr) for _, mod, attr in bench_frame.STAGES]
    want = eng.draw()
    times = bench_frame.stage_times(eng, 1)
    assert set(times) == {s[0] for s in bench_frame.STAGES} | {"frame"}
    assert all(v > 0.0 for v in times.values()), times
    assert sum(v for k, v in times.items() if k != "frame") <= times["frame"]
    assert [getattr(mod, attr) for _, mod, attr in bench_frame.STAGES] == before
    np.testing.assert_array_equal(eng.draw(), want)
    assert (vertex.draw_visibility, raster.rasterize_fused, shade.shade_fused,
            pipeline._binned) == (before[0], before[3], before[4], before[2])


def test_device_busy_is_a_union():
    iv = [(0.0, 10.0, "a"), (5.0, 12.0, "b"), (20.0, 25.0, "c"), (21.0, 22.0, "d")]
    assert bench_frame._union_us(iv) == 17.0


def test_stage_window_takes_the_largest_overlap():
    w = [(0.0, 10.0, "sort+bins"), (12.0, 40.0, "raster A + epilogue")]
    # a long kernel whose start reads a little early stays in its stage
    assert bench_frame._window_of(w, 11.5, 38.0) == "raster A + epilogue"
    assert bench_frame._window_of(w, 2.0, 3.0) == "sort+bins"
    assert bench_frame._window_of(w, 10.2, 11.0) == "other"
    assert bench_frame._window_of(w, 41.0, 42.0) == "other"

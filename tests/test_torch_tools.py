"""The port's card-side tooling, on the CPU: the kernel library's build
cache, chip_smoke.py's refusals without a card, the bench-frame stage
timer's wrapping, and the two profile tools (tools/profile_raster.py,
tools/profile_stages.py) in-process at a small extent. Nothing here imports JAX or needs nvcc."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_renderer_torch import pipeline
from tpu_renderer_torch.kernels import _build, raster, shade, vertex
from tpu_renderer_torch.tools import profile_raster, profile_stages
from tpu_renderer_torch.utils import bench_frame
from test_torch_threads import share_cores

share_cores()

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


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card refusal")
@pytest.mark.parametrize("command", [
    ["demo", "--grid", "2"], ["milestone", "background_sky"],
    ["view", "--grid", "2", "--frames", "1", "--keys", ""],
    ["benchmark", "--grid", "2", "--frames", "1"]])
def test_cli_refuses_without_cuda(tmp_path, command):
    """The CLI renders on the card by default and does not carry on on the
    CPU without one: it exits non-zero with the engine's message, and
    writes no image."""
    out = subprocess.run(
        [sys.executable, "-m", "tpu_renderer_torch.cli", *command, "--width", "128",
         "--height", "32", "--out", str(tmp_path / "frame.png")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 2, out.stderr
    assert "no CUDA device" in out.stderr and "device=\"cpu\"" in out.stderr
    assert not (tmp_path / "frame.png").exists()


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


@pytest.mark.parametrize("path", ["textured-glass", "deferred"])
def test_stage_timer_covers_the_peel_and_deferred_paths(tmp_path, path):
    """Every stage of the textured-glass and the deferred frame runs and is
    timed; the frame is unchanged by the wrapping."""
    eng = bench_frame.path_engine(path, str(tmp_path / "demo4.glb"), device="cpu",
                                  grid=4, width=256, height=64,
                                  camera_position=(0.0, 6.0, 8.0))
    assert eng._fused == (path != "deferred")
    want = eng.draw()
    stages = bench_frame.PATHS[path]
    times = bench_frame.stage_times(eng, 1, stages)
    assert all(v > 0.0 for v in times.values()), times
    assert sum(v for k, v in times.items() if k != "frame") <= times["frame"]
    np.testing.assert_array_equal(eng.draw(), want)


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


def _peel_inputs(name, seed=0, pad=0):
    """Two 32x128 tiles of seeded peel inputs for chip_smoke's bound: bins
    ascending within each tile's count, junk past it, `pad` dead columns;
    the layer each pixel found (one of its tile's live ids, or ID_INF)."""
    rng = np.random.default_rng(seed)
    dense = name == "raster_peel_fused_kernel"
    n_ids, width, counts = (12, 10, [6, 10]) if dense else (60, 12, [7, 12])
    bins = np.full((2, width + pad), -1, np.int32)
    layer = np.empty((2, 32 * 128), np.int32)
    for t, c in enumerate(counts):
        ids = np.sort(rng.choice(n_ids, size=c, replace=False)).astype(np.int32)
        tris = ids
        if dense:
            gmask = rng.integers(1, 16, size=c)
            bins[t, :c] = (ids << raster.entry_shift(raster.CHUNK // raster.GROUP)) | gmask
            tris = ids * raster.CHUNK + rng.integers(0, raster.CHUNK, size=c)
        else:
            bins[t, :c] = ids
        bins[t, c:width] = rng.integers(0, n_ids, size=width - c)   # past the count
        layer[t] = np.where(rng.random(32 * 128) < 0.3, raster.ID_INF,
                            rng.choice(tris, size=32 * 128))
    plane = layer.reshape(2, 32, 128).transpose(1, 0, 2).reshape(32, 256)
    table = torch.zeros((n_ids * raster.CHUNK, raster.ROW_COLS) if dense
                        else (n_ids, raster.SETUP_COLS))
    frame = torch.zeros((32, 256))
    args = (table, torch.from_numpy(bins), torch.tensor(counts, dtype=torch.int32),
            frame, frame.int())
    return args, dict(tiles_x=2, tiles_y=1, tile_w=128, tile_h=32), torch.from_numpy(plane)


@pytest.mark.parametrize("name", ["raster_peel_kernel", "raster_peel_fused_kernel"])
def test_smoke_bound_counts_the_work_a_peel_needs(name):
    """chip_smoke's bound: each pixel tests the live entries up to the one
    that holds its layer (all of them where it found none), counted here
    entry by entry; dead bin columns add no bytes."""
    smoke = _chip_smoke()
    args, tiles, plane = _peel_inputs(name)
    out = (plane,) if name == "raster_peel_fused_kernel" else plane
    dense = name == "raster_peel_fused_kernel"
    layer = smoke._frame_tiles(plane, 2, 1).numpy()
    want = 0
    for t, c in enumerate(args[2].tolist()):
        for e in args[1][t, :c].tolist():
            if dense:
                key, work = e >> 4, bin(e & 15).count("1") * raster.GROUP
                need = (layer[t] == raster.ID_INF) | (layer[t] // raster.CHUNK >= key)
            else:
                key, work = e, 1
                need = (layer[t] == raster.ID_INF) | (layer[t] >= key)
            want += int(need.sum()) * work
    assert smoke.work_tests(name, args, tiles, out) == want
    padded, _, _ = _peel_inputs(name, pad=50)
    assert smoke.bound(name, padded, tiles, out) == smoke.bound(name, args, tiles, out)


def test_smoke_sync_timer_counts_the_peel_syncs(tmp_path, monkeypatch):
    """The peel syncs chip_smoke counts in an eager frame (SyncCount on the
    card, which took the place of its SyncTimer): the peel loop reads its
    tests on the host, the first one, then two a pass (the layer's IF and
    the loop's next test) over the layers and the last, empty pass; and the
    smoke patches no pipeline function to count them."""
    smoke = _chip_smoke()
    eng = bench_frame.path_engine("textured-glass", str(tmp_path / "demo4.glb"),
                                  device="cpu", grid=4, width=256, height=64,
                                  camera_position=(0.0, 6.0, 8.0))
    reads, test = [], torch.Tensor.__bool__

    def counted(t):
        reads.append(t.shape)
        return test(t)

    monkeypatch.setattr(torch.Tensor, "__bool__", counted)
    _img, aux = eng.draw_device()
    monkeypatch.undo()
    layers = int(aux["transparent_layers"])
    assert layers > 0 and reads == [torch.Size([])] * (2 * layers + 3)
    assert not hasattr(smoke, "SyncTimer")


@pytest.mark.parametrize("recorder", ["chip_smoke", "time_stream_kernels"])
def test_recorded_peel_inputs_are_each_launchs_own(tmp_path, monkeypatch, recorder):
    """The kernel inputs the smoke and time_stream_kernels record are copies
    as each launch saw them: the peel loop updates `last` in place, so the
    first peel's recorded `last` is still all -1 after the frame. (On the
    CPU the frame calls no kernel wrapper: the recorders take 2.3's public
    function, which gets the same arguments.)"""
    from tpu_renderer_torch.tools import time_stream_kernels

    eng = bench_frame.path_engine("textured-glass", str(tmp_path / "demo4.glb"),
                                  device="cpu", grid=4, width=256, height=64,
                                  camera_position=(0.0, 6.0, 8.0))
    name = "rasterize_peel_fused"
    if recorder == "chip_smoke":
        smoke = _chip_smoke()
        monkeypatch.setitem(smoke.KERNELS, name, smoke.KERNELS["raster_peel_fused_kernel"])
        calls = smoke.capture_kernel_inputs(eng.draw_device, (name,))[name]
    else:
        calls = time_stream_kernels.captured_calls(eng, (name,))[name]
    lasts = [args[4] for args, _ in calls]
    assert len(lasts) == int(eng._last_aux["transparent_layers"]) + 1 >= 3
    assert bool((lasts[0] == -1).all())
    assert all(not torch.equal(a, b) for a, b in zip(lasts, lasts[1:]))


SMALL_TOOL = ["--device", "cpu", "--grid", "2", "--width", "256", "--height", "64"]


def test_profile_raster_tool_prints_its_five_lines(capsys):
    """The raster profile tool on the CPU: the settled caps, the live
    entries, then the JAX tool's five labels in order, each with a time."""
    assert profile_raster.main([*SMALL_TOOL, "--iters", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("caps: {") and lines[1].startswith("counts: total ")
    timed = lines[2:]
    assert len(timed) == len(profile_raster.LABELS) == 5
    for line, label in zip(timed, profile_raster.LABELS):
        assert line.startswith(label) and line.endswith(" ms")
        assert float(line[len(label):-3]) > 0.0
    assert [label[0] for label in profile_raster.LABELS] == list("ABCDE")


def test_profile_raster_inputs_are_the_deferred_frames(tmp_path):
    """deferred_inputs rebuilds what render_frame's deferred opaque pass
    feeds kernel 2.4; kernel 2.6's function over the same bins finds the
    same visibility."""
    eng = bench_frame.bench_engine(str(tmp_path / "demo4.glb"), device="cpu", grid=4,
                                   width=256, height=64, fused=False,
                                   camera_position=(0.0, 6.0, 8.0))
    eng.draw()
    seen = []
    rasterize = raster.rasterize

    def record(*args, **kwargs):
        seen.append(args)
        return rasterize(*args, **kwargs)

    raster.rasterize = record
    try:
        eng.draw_device()
    finally:
        raster.rasterize = rasterize
    packed, rows48, bins, counts, tiles, _ = profile_raster.deferred_inputs(eng)
    for got, want in zip((packed, bins, counts), seen[0]):
        assert torch.equal(got, want)
    z, tid = raster.rasterize(packed, bins, counts, **tiles)
    z6, tid6, attrs, meta, inv = raster.rasterize_fused_gathered(rows48, bins, counts, **tiles)
    assert torch.equal(tid6, tid) and int((tid >= 0).sum()) > 100
    assert attrs.shape[0] == 6 and meta.shape[0] == 13 and inv.shape == tid.shape


def test_profile_stages_tool_prints_the_jax_tools_rows(capsys):
    assert profile_stages.main([*SMALL_TOOL, "--frames", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    names = [line[:22].strip() for line in lines]
    assert names == ["background", "cull/setup", "chunk bin", "raster_fused", "shade_fused",
                     "transp setup/bin", "transp accum", "present", "frame"]
    ms = {n: float(line[22:-3]) for n, line in zip(names, lines)}
    assert all(v > 0.0 for v in ms.values()), ms
    assert sum(v for n, v in ms.items() if n != "frame") <= ms["frame"]


def test_stage_timer_keeps_calls_apart_and_runs_the_hook(tmp_path):
    """per_call: the opaque and the transparent sort+bins of one frame are
    two entries; before_frame runs ahead of every frame; the wrapped
    functions are restored."""
    eng = bench_frame.bench_engine(str(tmp_path / "demo2.glb"), device="cpu", grid=2,
                                   width=256, height=64)
    eng.draw()
    hooked = []
    before = pipeline._binned
    times = bench_frame.stage_times(eng, 2, per_call=True, before_frame=hooked.append)
    assert hooked == [eng, eng] and pipeline._binned is before
    assert {"sort+bins#0", "sort+bins#1", "raster A + epilogue#0", "frame"} <= set(times)
    assert "sort+bins" not in times and "sort+bins#2" not in times
    summed = bench_frame.stage_times(eng, 1)
    assert "sort+bins" in summed and "sort+bins#0" not in summed


def test_smoke_bound_of_the_gathered_peel_counts_every_live_entry():
    """Kernel 2.8's rule takes the slots in any order, so its bound counts
    every live entry at every pixel, whatever layer a pixel found."""
    smoke = _chip_smoke()
    args, tiles, plane = _peel_inputs("raster_peel_kernel")
    every = int(args[2].sum()) * 32 * 128
    assert smoke.work_tests("raster_peel_gathered_kernel", args, tiles, (plane,)) == every
    assert smoke.work_tests("raster_fused_gathered_kernel", args, tiles, (plane,)) == every
    assert smoke.work_tests("raster_peel_kernel", args, tiles, plane) < every


@pytest.mark.parametrize("name", ["raster_deferred_kernel", "raster_fused_gathered_kernel"])
def test_smoke_split_line_of_the_visibility_walks(name):
    """chip_smoke's [split] line for kernels 2.4 and 2.6: clusters of
    VIS_SPLIT blocks, the tiles cut as vis_segments cuts them, and the
    busiest tile's live entries (ids that are rows of the table) a
    segment."""
    smoke = _chip_smoke()
    cols = raster.SETUP_COLS if name == "raster_deferred_kernel" else raster.ROW_COLS
    table = torch.zeros((400, cols))
    bins = torch.full((2, 320), -1, dtype=torch.int32)
    bins[0, :5] = torch.arange(5, dtype=torch.int32)
    bins[1, :300] = torch.arange(300, dtype=torch.int32)
    bins[1, 10] = 5000                                    # no row: not live
    counts = torch.tensor([5, 300], dtype=torch.int32)
    tiles = dict(tiles_x=2, tiles_y=1, tile_w=128, tile_h=32)
    line = smoke.decomposition(name, (table, bins, counts), tiles, (1, 1))
    segs = raster.vis_segments(counts, bins.shape[1]).tolist()
    assert segs == [1, raster.VIS_SPLIT], segs
    assert f"{2 * raster.VIS_SPLIT} blocks in 2 clusters of {raster.VIS_SPLIT}" in line, line
    assert f"{1 + raster.VIS_SPLIT} segments walked" in line, line
    assert "busiest tile 300 entries, 299 live entries" in line, line
    held = json.loads(line.split("segments holding ")[1].split(" live")[0])
    want = [e - b for b, e in (raster.segment_bounds(300, raster.VIS_SPLIT, q)
                               for q in range(raster.VIS_SPLIT))]
    want[0] -= 1
    assert held == want, (held, want)


@pytest.mark.parametrize("name", ["raster_peel_kernel", "raster_peel_gathered_kernel"])
def test_smoke_split_line_of_the_triangle_peels(name):
    """chip_smoke's [split] line for kernels 2.5 and 2.8: clusters of
    PEEL_SPLIT blocks, the tiles cut as peel_segments cuts them at
    DEFERRED_SEG_MIN, and how many segments hold strictly ascending ids
    (keys_ascend: a -1 hole after a live id, or a descent, makes one not
    ascend)."""
    smoke = _chip_smoke()
    cols = raster.SETUP_COLS if name == "raster_peel_kernel" else raster.ROW_COLS
    table = torch.zeros((400, cols))
    bins = torch.full((2, 320), -1, dtype=torch.int32)
    bins[0, :5] = torch.arange(5, dtype=torch.int32)
    bins[1, :300] = torch.arange(300, dtype=torch.int32)
    bins[1, 40] = -1                                      # a hole in segment 1
    bins[1, 290:300] = bins[1, 290:300].flip(0)           # a descent in segment 7
    counts = torch.tensor([5, 300], dtype=torch.int32)
    tiles = dict(tiles_x=2, tiles_y=1, tile_w=128, tile_h=32)
    line = smoke.decomposition(name, (table, bins, counts), tiles, (1, 1))
    segs = raster.peel_segments(counts, bins.shape[1], raster.DEFERRED_SEG_MIN).tolist()
    assert segs == [1, raster.PEEL_SPLIT], segs
    assert f"{2 * raster.PEEL_SPLIT} blocks in 2 clusters of {raster.PEEL_SPLIT}" in line, line
    assert f"{1 + raster.PEEL_SPLIT} segments walked" in line, line
    assert "busiest tile 300 entries, 299 live entries" in line, line
    assert f"; {1 + raster.PEEL_SPLIT - 2} of them ascend" in line, line


def test_smoke_kernel_table_names_what_exists():
    """chip_smoke's KERNELS: thirteen kernels, each with its launcher, plain
    version and counter in the port, its source in the checkout, and the
    line of what it replaces in the JAX package: a Pallas kernel for 2.1-2.11,
    the jnp shade_fused for 2.12 (the JAX package shades without one) and
    the jnp triangle_setup_rows for 2.13 (nor sets up with one)."""
    smoke = _chip_smoke()
    assert len(smoke.KERNELS) == 13
    for name, (_, plain, counter, source, replaces) in smoke.KERNELS.items():
        mod = smoke.kernel_module(name)
        assert callable(getattr(mod, name)) and callable(getattr(mod, plain)), name
        assert getattr(mod, counter).launches == 0, name
        text = open(os.path.join(ROOT, source)).read()
        assert "__global__" in text and 'extern "C"' in text, (name, source)
        path, line = replaces.rsplit(":", 1)
        src = open(os.path.join(ROOT, path)).read().splitlines()[int(line) - 1]
        if name == "shade_fused_kernel":
            assert src.startswith("def shade_fused("), (name, src)
        elif name == "triangle_setup_rows_kernel":
            assert src.startswith("def triangle_setup_rows("), (name, src)
        else:
            assert src.startswith("def _") and "kernel" in src or "_loop(" in src, (name, src)


def test_time_background_lerp_computes_the_gradient():
    """tools/time_background's yardstick for 2.9 (one torch.lerp over the
    broadcast row blend, chip_smoke's library_ms) computes 2.9's function:
    within 1e-6 of the plain version, as chip_smoke asserts on the card."""
    from tpu_renderer_torch.kernels import background
    from tpu_renderer_torch.tools import time_background

    d1 = torch.tensor([0.9, 0.3, 0.2, 1.0])
    d2 = torch.tensor([0.1, 0.2, 0.7, 0.5])
    wp, hp = time_background.pad(480, 270)
    assert (wp, hp) == (512, 288)
    a, b, t = time_background.lerp_operands(d1, d2, 270, wp, hp)
    want = background.gradient_plain(d1, d2, height=270, width_pad=wp, height_pad=hp)
    assert float((torch.lerp(a, b, t) - want).abs().max()) < 1e-6


def test_smoke_setup_bound_counts_the_corners_and_the_rows():
    """2.13's bound: each triangle's 160 B of corners, its draw id and flag
    read once, its 192 B fat row, 16 B box and 1 B flag written once, each
    draw's transform and visibility, viewproj and the sun read once, at the
    HBM rate; bytes bound it (grid 64's 46,250 triangles: ~17 MB)."""
    from test_torch_setup import setup_inputs

    smoke = _chip_smoke()
    args = setup_inputs("cpu")
    ms, nbytes = smoke.setup_bound(args)
    T, D = args[0].pos.shape[0], args[3].shape[0]
    assert nbytes == T * (160 + 5 + 209) + D * 65 + 76
    assert sum(t[0].numel() * t.element_size() for t in args[0]) == 160
    assert ms == pytest.approx(nbytes / smoke.PEAK_BYTES * 1e3)
    assert 17.2e6 < 46250 * 374 < 17.4e6


@pytest.mark.parametrize("name", ["background_gradient_kernel", "background_sky_kernel",
                                  "background_grid_kernel"])
def test_smoke_background_bound_counts_the_buffer_and_inputs(name):
    """Each background pass's bound: the (4, 1088, 1920) buffer written once
    and its inputs read once (two colours; the sky's colour and its lattice
    of 1921 + 1089 cosines) at the HBM rate; bytes bound them all."""
    smoke = _chip_smoke()
    args = smoke.background_calls(1920, 1080, torch.device("cpu"))[name][0]
    out = torch.empty((4, 1088, 1920))
    inputs = {"background_gradient_kernel": 32, "background_sky_kernel": 16 + 3010 * 4,
              "background_grid_kernel": 0}[name]
    ms, by = smoke.background_bound(name, args, out)
    assert by == "bytes" and ms == pytest.approx((out.numel() * 4 + inputs) / smoke.PEAK_BYTES
                                                 * 1e3, rel=1e-12)

"""The port's last four tool twins on the CPU at their smallest sizes, each
through its main(): tools/profile_binwidth.py, sweep_tiles.py,
bench_gather.py and make_gallery.py. A check of each tool's plumbing and
printed lines; no number here is a device time. Also sweep_tiles's
constant rewrite: the copy imports the point's values and the shipped
sources keep every byte; a tile point runs the shipped tree."""

import glob
import os
import subprocess
import sys

import pytest

from tpu_renderer_torch.tools import bench_gather, make_gallery, profile_binwidth, sweep_tiles
from test_torch_threads import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "tpu_renderer_torch")
SMALL = ["--device", "cpu", "--grid", "2", "--width", "256", "--height", "64"]


def _shipped_bytes():
    files = sorted(glob.glob(os.path.join(PACKAGE, "**", "*.py"), recursive=True)
                   + glob.glob(os.path.join(PACKAGE, "kernels", "csrc", "*")))
    return {f: open(f, "rb").read() for f in files}


@pytest.mark.parametrize("tool", [profile_binwidth, sweep_tiles, bench_gather])
def test_tools_refuse_without_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert tool.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_profile_binwidth_prints_each_cap(capsys):
    assert profile_binwidth.main([*SMALL, "--iters", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("max count/tile:")
    assert [ln.split()[:3] for ln in lines[1:]] == [
        ["fused_chunks", "capped", "512"], ["fused_chunks", "capped", "1024"],
        ["fused_chunks", "capped", "5808"], ["fused", "uncapped", "dropped"]]
    assert all("cpu_ms" in ln and "device_ms" not in ln for ln in lines[1:])


def test_bench_gather_prints_every_case(capsys):
    assert bench_gather.main(["--device", "cpu", "--n", "1024", "--iters", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split()[:3] == ["table", "row", "B"] and "cpu ns/idx" in lines[0]
    rows = [ln.split() for ln in lines[1:]]
    assert [(r[0], r[1], r[2]) for r in rows] == [
        (f"{kb}KB", b, p) for kb in bench_gather.TABLES_KB for b in ("16", "32", "64")
        for p in ("random", "coherent")]
    assert all(float(r[3]) > 0 and float(r[5]) > 0 for r in rows)


def test_make_gallery_refuses_a_missing_out_and_docs(tmp_path, capsys):
    with pytest.raises(SystemExit):
        make_gallery.main(["--device", "cpu"])
    assert make_gallery.main(["--device", "cpu", "--out",
                              os.path.join(ROOT, "docs", "gallery")]) == 1
    assert "docs/" in capsys.readouterr().err


def test_make_gallery_writes_six_pngs(tmp_path, capsys):
    before = {f: open(f, "rb").read() for f in glob.glob(os.path.join(ROOT, "docs", "gallery", "*"))}
    out = tmp_path / "gallery"
    assert make_gallery.main(["--device", "cpu", "--out", str(out), "--width", "128",
                              "--height", "64"]) == 0
    assert sorted(os.listdir(out)) == sorted(make_gallery.NAMES)
    text = capsys.readouterr().out
    assert text.count("[gallery]") == 6 and "not compared" in text
    assert before == {f: open(f, "rb").read()
                      for f in glob.glob(os.path.join(ROOT, "docs", "gallery", "*"))}


def test_sweep_points_start_at_the_shipped_point():
    pts = sweep_tiles.points(["tile_h", "ahead"])
    assert pts[0] == {"tile_h": 32, "tile_w": 128, "group": 8, "ahead": 2}
    assert pts[1:] == [dict(pts[0], tile_h=8), dict(pts[0], tile_h=16),
                       dict(pts[0], ahead=1), dict(pts[0], ahead=3)]


def test_sweep_rewrite_reads_the_point_and_leaves_the_shipped_tree(tmp_path):
    before = _shipped_bytes()
    point = {"tile_h": 16, "tile_w": 64, "group": 16, "ahead": 3}
    assert sweep_tiles.in_copy(point) and not sweep_tiles.in_copy(
        dict(sweep_tiles.shipped_point(), tile_h=16, tile_w=64))
    root = sweep_tiles.make_variant(point, str(tmp_path))
    assert _shipped_bytes() == before
    copy = os.path.join(root, "tpu_renderer_torch")
    assert sweep_tiles.point_of(copy) == {"group": 16, "ahead": 3}
    cuh = open(os.path.join(copy, "kernels", "csrc", "raster_common.cuh")).read()
    for name, value in (("GROUP", 16), ("AHEAD", 3)):
        assert f"\nconstexpr int {name} = {value};" in cuh
    # the tile is no constant of the sources: the kernels take it at launch
    assert "constexpr int TILE_H" not in cuh and "with_tile" in cuh
    # 2.1's shared array is the larger of its merge buffer and the ring
    # (at 16x64 and AHEAD 3, the ring's 5 slots of 1536 floats): no rewrite
    fused = open(os.path.join(copy, "kernels", "csrc", "raster_fused.cu")).read()
    assert "smem[MERGE > RING ? MERGE : RING]" in fused
    assert fused == open(os.path.join(PACKAGE, "kernels", "csrc", "raster_fused.cu")).read()
    assert not os.path.exists(os.path.join(copy, "kernels", "build"))
    # what a process importing the copy sees
    out = subprocess.run(
        [sys.executable, "-c", "from tpu_renderer_torch.kernels import raster; "
         "print(raster.__file__, raster.TILE_H, raster.TILE_W, raster.GROUP, "
         "raster.accum_split(64), (16, 64) in raster.TILES)"], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    path, *values = out.stdout.split()
    assert path.startswith(root) and values == ["32", "128", "16", "2", "True"]


def test_sweep_tiles_runs_each_point_in_its_copy(capsys):
    """Tile points in the shipped tree, a GROUP point in its copy."""
    before = _shipped_bytes()
    assert sweep_tiles.main([*SMALL, "--axes", "tile_h,group"]) == 0
    assert _shipped_bytes() == before
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:-1]] == [
        "[sweep] tile 32x128 group 8 ahead 2", "[sweep] tile 8x128 group 8 ahead 2",
        "[sweep] tile 16x128 group 8 ahead 2", "[sweep] tile 32x128 group 16 ahead 2",
        "[sweep] tile 32x128 group 32 ahead 2"]
    import json

    rows = json.loads(lines[-1])["sweep"]
    assert [r["tiles"] for r in rows] == [2 * 2, 2 * 8, 2 * 4, 2 * 2, 2 * 2]
    assert all(r["module"].startswith(PACKAGE) for r in rows[:3])
    assert all(not r["module"].startswith(PACKAGE) for r in rows[3:])
    # the planes depend on neither the tile nor GROUP
    assert all(r["opaque_same"] and r["transparent_same"] for r in rows)
    assert not sweep_tiles.failed(rows)

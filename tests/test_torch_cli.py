"""The port's CLI (python -m tpu_renderer_torch.cli) on the CPU, at small
extents: every command through main(argv) with --device cpu, its printed
lines, and its PNGs against the JAX package's CLI where that renders in a
few seconds (the background-only milestones) and against the goldens.

Tolerance (PERF.md): PNGs are exact (0 differing pixels).
"""

import json
import os

import numpy as np
import pytest

from tpu_renderer import cli as jcli
from tpu_renderer_torch import cli
from tpu_renderer_torch.engine import Engine
from tpu_renderer_torch.present import load_png
from tpu_renderer_torch.utils.demo import build_demo_glb
from test_torch_threads import share_cores

share_cores()

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
SMALL = ["--width", "256", "--height", "64", "--device", "cpu"]
MILESTONES = ["colored_triangle", "colored_quad", "textured_quad",
              "background_gradient", "background_sky"]


def test_demo_command(tmp_path, capsys):
    out = str(tmp_path / "demo.png")
    assert cli.main(["demo", "--grid", "2", *SMALL, "--out", out]) == 0
    img = load_png(out)
    assert img.shape == (64, 256, 4)
    assert len(np.unique(img.reshape(-1, 4), axis=0)) > 10
    line = capsys.readouterr().out.strip()
    assert line.startswith(f"wrote {out}  (") and " tris, " in line and " draws, " in line
    assert line.endswith(" ms)")


def test_demo_command_sky_and_render_scale(tmp_path):
    native, scaled = str(tmp_path / "native.png"), str(tmp_path / "scaled.png")
    args = ["demo", "--grid", "2", *SMALL, "--background", "1"]
    assert cli.main([*args, "--out", native]) == 0
    assert cli.main([*args, "--render-scale", "0.65", "--out", scaled]) == 0
    a, b = load_png(native), load_png(scaled)
    assert a.shape == b.shape == (64, 256, 4) and not np.array_equal(a, b)
    assert a[0, 0, 2] < 100                       # the sky's dark top rows
    # the same picture, coarsely: 8x8 box averages
    box = lambda im: im[..., :3].astype(np.float32).reshape(8, 8, 32, 8, 3).mean((1, 3))  # noqa: E731
    assert np.abs(box(a) - box(b)).max() < 48


def test_render_command(tmp_path, capsys):
    glb = str(tmp_path / "s.glb")
    build_demo_glb(glb, grid=2)
    out = str(tmp_path / "frame.png")
    assert cli.main(["render", glb, *SMALL, "--camera", "0", "2", "12", "--out", out]) == 0
    assert load_png(out).shape == (64, 256, 4)
    assert capsys.readouterr().out.startswith(f"wrote {out}  (")


@pytest.mark.parametrize("name", MILESTONES)
def test_milestone_command(tmp_path, name):
    out = str(tmp_path / f"{name}.png")
    assert cli.main(["milestone", name, "--width", "128", "--height", "64",
                     "--device", "cpu", "--out", out]) == 0
    img = load_png(out)
    assert img.shape == (64, 128, 4)
    if name == "colored_triangle":
        assert img[62, 125, 0] > 150     # red corner of the hardcoded NDC triangle
        np.testing.assert_array_equal(img, load_png(os.path.join(GOLDEN_DIR, "triangle.png")))
    elif name == "background_gradient":
        assert (img == 255).all()
    elif name == "background_sky":
        assert img[0, 0, 2] < 100 and (img[..., 3] == 255).all()


@pytest.mark.parametrize("name", ["background_gradient", "background_sky"])
def test_background_milestone_png_equals_the_jax_cli(tmp_path, name):
    """A non-aligned extent through both CLIs: the padded render, cropped."""
    got, want = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    size = ["--width", "333", "--height", "222"]
    assert cli.main(["milestone", name, *size, "--device", "cpu", "--out", got]) == 0
    assert jcli.main(["milestone", name, *size, "--out", want]) == 0
    diff = np.any(load_png(got) != load_png(want), axis=-1)
    print(f"{name} 333x222: {int(diff.sum())} of {diff.size} pixels differ")
    assert not diff.any()


def test_milestone_bad_name_and_list(tmp_path, capsys):
    assert cli.main(["milestone", "nope", "--device", "cpu"]) == 1
    assert "unknown milestone nope" in capsys.readouterr().out
    assert cli.main(["milestone", "list", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.split() == MILESTONES


def test_benchmark_command_json(capsys):
    assert cli.main(["benchmark", "--grid", "2", "--frames", "2", *SMALL]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(result) == ["fps", "frame_ms", "triangles", "mtris_per_sec",
                            "drawcalls", "width", "height", "backend"]
    assert result["backend"] == "cpu" and result["width"] == 256
    assert result["triangles"] > 0 and result["drawcalls"] > 0 and result["fps"] > 0


def test_view_command_runs_the_pipelined_loop(capsys):
    assert cli.main(["view", "--grid", "2", "--frames", "4", "--keys", "wd",
                     "--cols", "16", "--rows", "4", *SMALL]) == 0
    text = capsys.readouterr().out
    assert text.rstrip().endswith("4 frames") and "▀" in text
    # two calls fill the pipeline; frames 2 and 3 present
    assert "frame 2" in text and "frame 3" in text and "frame 1 " not in text


@pytest.mark.parametrize("target,scale", [("60", 0.5), ("1", 1.0)])
def test_target_fps_flag_runs(tmp_path, monkeypatch, target, scale):
    """--target-fps engages the auto quality: with the cost model's fixed
    term above a 60 fps budget (30.8 ms, the fit to the eager frame; the
    shipped fit to the graphed frame is below it) the draw extent floors at
    auto_scale_min and the frame blits up to the window extent; 1 fps is
    under budget natively. Either way the PNG has the window extent."""
    monkeypatch.setattr(Engine, "_COST_FIXED_MS", 30.8)
    native, out = str(tmp_path / "native.png"), str(tmp_path / "auto.png")
    args = ["demo", "--grid", "2", *SMALL, "--background", "1"]
    assert cli.main([*args, "--out", native]) == 0
    assert cli.main([*args, "--target-fps", target, "--out", out]) == 0
    a, b = load_png(native), load_png(out)
    assert a.shape == b.shape == (64, 256, 4)
    assert np.array_equal(a, b) == (scale == 1.0)
    if scale < 1.0:     # the same frame as --render-scale at the floor
        scaled = str(tmp_path / "scaled.png")
        assert cli.main([*args, "--render-scale", str(scale), "--out", scaled]) == 0
        np.testing.assert_array_equal(b, load_png(scaled))


def test_bad_multichip_spec_exits():
    with pytest.raises(SystemExit, match="ROWSxTRI"):
        cli.main(["demo", "--grid", "2", *SMALL, "--multichip", "fast"])


def test_flags_equal_the_jax_cli():
    """Every flag of the JAX CLI's commands parses here too, plus --device."""
    import argparse

    def flags(add_common):
        p = argparse.ArgumentParser()
        add_common(p)
        return {a.dest: (a.default, a.type) for a in p._actions if a.dest != "help"}

    ours, theirs = flags(cli._add_common), flags(jcli._add_common)
    assert ours.pop("device") == ("cuda", None)
    assert ours == theirs

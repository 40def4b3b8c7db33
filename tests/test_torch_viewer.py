"""The port's terminal viewer (scripted input, no tty) over the port's
Engine on the CPU: the four cases of tests/test_viewer.py, with the pure
functions held to the JAX package's outputs."""

import io

import numpy as np

from tpu_renderer import viewer as jviewer
from tpu_renderer_torch import milestones
from tpu_renderer_torch.config import RendererConfig
from tpu_renderer_torch.engine import Engine
from tpu_renderer_torch.viewer import frame_to_halfblocks, parse_events, run_viewer
from test_torch_threads import share_cores

share_cores()


def _engine():
    cfg = RendererConfig(width=128, height=64, camera_position=(0.0, 0.0, 2.0))
    eng = Engine(cfg, device="cpu")
    eng.init(scene=milestones.colored_quad_scene(z0=0.5, z1=0.5))
    return eng


def test_scripted_keys_drive_camera_and_render():
    eng = _engine()
    out = io.StringIO()
    pos0 = eng.camera.position.copy()
    yaw0 = float(eng.camera.yaw)
    # frame 0: move forward; frame 1: arrow-right look; frame 2: idle
    n = run_viewer(eng, n_frames=3, keys=["w", "\x1b[C", ""],
                   cols=32, rows=8, out=out, fps_cap=0)
    assert n == 3
    assert eng.camera.position[2] < pos0[2]  # 'w' moved forward (-z)
    assert float(eng.camera.yaw) != yaw0     # arrow changed yaw
    text = out.getvalue()
    assert "▀" in text and "frame 2" in text
    # the frame shown at call 2 is frame 0, presented as the cells of draw()
    twin = _engine()
    cells = frame_to_halfblocks(twin.draw(), 32, 8)
    assert cells in text
    assert len(eng._inflight) == Engine.FRAME_OVERLAP - 1


def test_quit_key_stops_loop():
    eng = _engine()
    out = io.StringIO()
    n = run_viewer(eng, n_frames=10, keys=["", "q"], cols=16, rows=4,
                   out=out, fps_cap=0)
    assert n == 2


def test_parse_events_arrows_and_escape():
    assert parse_events("w\x1b[Ad") == ["w", "A", "d"]
    assert parse_events("\x1b") == ["\x1b"]
    for raw in ("w\x1b[Ad", "\x1b", "\x1b[", "ab\x1b[Cq\x1b"):
        assert parse_events(raw) == jviewer.parse_events(raw)


def test_halfblocks_shape_and_colors():
    img = np.zeros((8, 16, 4), np.uint8)
    img[:4] = [255, 0, 0, 255]
    img[4:] = [0, 0, 255, 255]
    text = frame_to_halfblocks(img, cols=8, rows=2)
    lines = text.split("\n")
    assert len(lines) == 2
    assert "38;2;255;0;0" in lines[0]   # red upper pixels in row 0 fg
    assert "48;2;0;0;255" in lines[1]   # blue lower pixels in row 1 bg
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, size=(37, 53, 4), dtype=np.uint8)
    assert frame_to_halfblocks(noise, 11, 5) == jviewer.frame_to_halfblocks(noise, 11, 5)

"""The port's viewer over a mesh of ranks (cli view --multichip) on the CPU:
rank 0 reads the launching process's terminal and leads, rank 1 follows.

- on a pseudo-terminal: keys, then q, end the run with exit 0, and both
  ranks presented the same frames (the count and a digest of every frame,
  in order, as the CLI prints them);
- scripted (--keys, --frames): the follower presents as many frames as
  rank 0, the same ones, and they are the frames the single-device viewer
  presents for the same input (byte for byte, by the same digest).

Small: the demo scene at grid 2, 256x64, two gloo ranks.
"""

import os
import pty
import re
import signal
import subprocess
import sys
import time

import numpy as np

from tpu_renderer_torch import cli
from tpu_renderer_torch.engine import Engine
from test_torch_threads import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIEW = ["view", "--grid", "2", "--width", "256", "--height", "64", "--cols", "20",
        "--rows", "4", "--device", "cpu"]
RANK_LINE = re.compile(r"\[multichip\] view rank (\d+): (\d+) frames presented, "
                       r"digest (\w+); kernel 2\.1 launched (\d+), 2\.2 (\d+), "
                       r"2\.9 (\d+), 2\.10 (\d+)")


def _env():
    return dict(os.environ, PYTHONPATH=ROOT)


def _ranks(text):
    return [(int(r), int(n), d) for r, n, d, *_ in RANK_LINE.findall(text)]


def test_view_multichip_reads_the_terminal_and_quits_on_q(tmp_path):
    master, slave = pty.openpty()
    out_path = tmp_path / "out.txt"
    with open(out_path, "wb") as out, open(tmp_path / "err.txt", "wb") as err:
        proc = subprocess.Popen([sys.executable, "-m", "tpu_renderer_torch.cli", *VIEW,
                                 "--multichip", "2x1"], stdin=slave, stdout=out,
                                stderr=err, cwd=ROOT, env=_env(), start_new_session=True)
        os.close(slave)
        try:
            deadline = time.monotonic() + 120
            while b"frame " not in out_path.read_bytes():
                assert proc.poll() is None, (tmp_path / "err.txt").read_text()
                assert time.monotonic() < deadline, "no frame within 120 s"
                time.sleep(0.1)
            for key in ("w", "d", "\x1b[C", "s", "q"):
                os.write(master, key.encode())
                time.sleep(0.3)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:     # the launcher and its ranks
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            os.close(master)
    text = out_path.read_text(errors="replace")
    assert rc == 0, (tmp_path / "err.txt").read_text()[-2000:]
    ranks = _ranks(text)
    assert [r for r, _, _ in ranks] == [0, 1], text[-1000:]
    assert ranks[0][1] > 0 and ranks[0][1:] == ranks[1][1:], ranks


def test_view_multichip_scripted_follows_rank0_and_equals_one_device():
    script = ["--frames", "6", "--keys", "wwdjk"]
    out = subprocess.run([sys.executable, "-m", "tpu_renderer_torch.cli", *VIEW, *script,
                          "--multichip", "2x1"], cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=300, stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stderr[-2000:]
    ranks = _ranks(out.stdout)
    assert [r for r, _, _ in ranks] == [0, 1]
    assert ranks[0][1:] == ranks[1][1:], ranks
    # the pipeline fills over FRAME_OVERLAP - 1 draws, then each draw presents
    assert ranks[0][1] == 6 - (Engine.FRAME_OVERLAP - 1)
    assert out.stdout.rstrip().splitlines()[-3] == "6 frames"

    presented = cli._Presented()
    draw_pipelined = Engine.draw_pipelined

    def recording(self, *args, **kwargs):
        img = draw_pipelined(self, *args, **kwargs)
        presented.add(img)
        return img

    Engine.draw_pipelined = recording
    try:
        assert cli.main([*VIEW, *script]) == 0
    finally:
        Engine.draw_pipelined = draw_pipelined
    assert (presented.frames, presented.digest()) == ranks[0][1:]


def test_camera_message_round_trips_exactly():
    """The float64 message carries the camera's float32 and float fields
    exactly, and the go flag."""
    import torch

    from tpu_renderer_torch.camera import Camera

    a, b = Camera(position=(0.1, -2.7, 1e-3)), Camera()
    a.velocity = np.asarray([0.8, 0.0, -0.8], np.float32)
    a.yaw, a.pitch = np.float32(0.123456789), np.float32(-0.3)
    a.process_cursor(-24.0, 48.0)
    for go in (True, False):
        assert cli._set_camera(b, cli._camera_message(a, go, torch.device("cpu"))) is go
    assert b.position.dtype == np.float32 and np.array_equal(b.position, a.position)
    assert np.array_equal(b.velocity, a.velocity)
    assert (b.yaw, b.pitch, b.cursor_x, b.cursor_y) == (a.yaw, a.pitch, a.cursor_x, a.cursor_y)
    assert np.array_equal(b.get_view_matrix(), a.get_view_matrix())

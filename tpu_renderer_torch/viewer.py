"""Interactive terminal viewer — the live windowed loop of the reference
(GLFW window + key/cursor callbacks, vk_engine.cpp:1161-1203, camera.h:33-41)
re-homed onto a terminal: frames render on the engine's device, present as
24-bit-color half-block cells, and WASD/arrow keys drive the same Camera the
reference's GLFW callbacks drive.

No GUI toolkit exists in this environment, so "the window" is the terminal
raster (two pixels per character cell via the upper-half-block glyph). The
input path reads raw bytes in cbreak mode without blocking the render loop.
Scripted input (``keys=...``) replaces the tty for tests and headless runs.
"""

from __future__ import annotations

import select
import sys
import time
from typing import Iterable, Optional

import numpy as np

ESC = "\x1b"


def frame_to_halfblocks(img: np.ndarray, cols: int, rows: int) -> str:
    """(H, W, 4) u8 -> ANSI string of cols x rows half-block cells.

    Each cell shows two vertically stacked samples: fg color = upper pixel
    (the '▀' glyph), bg color = lower pixel.
    """
    h, w = img.shape[:2]
    ys = (np.arange(rows * 2) * (h / (rows * 2))).astype(int).clip(0, h - 1)
    xs = (np.arange(cols) * (w / cols)).astype(int).clip(0, w - 1)
    s = img[np.ix_(ys, xs)][..., :3]  # (rows*2, cols, 3)
    top = s[0::2]
    bot = s[1::2]
    out = []
    for r in range(rows):
        line = []
        for c in range(cols):
            tr, tg, tb = top[r, c]
            br, bg_, bb = bot[r, c]
            line.append(f"{ESC}[38;2;{tr};{tg};{tb}m"
                        f"{ESC}[48;2;{br};{bg_};{bb}m▀")
        out.append("".join(line) + f"{ESC}[0m")
    return "\n".join(out)


class _TtyInput:
    """Non-blocking single-key reads in cbreak mode (restores on exit)."""

    def __enter__(self):
        import termios
        import tty

        self._fd = sys.stdin.fileno()
        self._saved = termios.tcgetattr(self._fd)
        tty.setcbreak(self._fd)
        return self

    def __exit__(self, *exc):
        import termios

        termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)

    def poll_keys(self) -> str:
        keys = ""
        while select.select([sys.stdin], [], [], 0)[0]:
            keys += sys.stdin.read(1)
        return keys


def parse_events(raw: str) -> list:
    """Raw tty bytes -> key events. Arrow keys arrive as ESC [ A..D; a bare
    ESC (no bracket following) is the quit key."""
    events = []
    i = 0
    while i < len(raw):
        ch = raw[i]
        if ch == ESC and i + 2 < len(raw) and raw[i + 1] == "[":
            events.append(raw[i + 2])  # A/B/C/D
            i += 3
        elif ch == ESC and i + 1 < len(raw) and raw[i + 1] == "[":
            i += 2  # truncated escape; drop
        else:
            events.append(ch)
            i += 1
    return events


def _apply_key(eng, key: str, cursor: list) -> bool:
    """One input event -> camera state; returns False to quit.

    WASD = the reference's GLFW_KEY_W/A/S/D velocity keys (camera.h:33-37);
    arrow keys/ijkl = cursor deltas (camera.h:39-41, process_cursor).
    """
    step = 24.0  # cursor pixels per arrow tap
    if key in ("q", ESC):
        return False
    if key in "wasd":
        # tap = press for one frame (the tty gives no key-up events)
        eng.camera.process_key(key, True)
    elif key in ("A", "i"):   # up arrow tail / i
        cursor[1] -= step
        eng.camera.process_cursor(cursor[0], cursor[1])
    elif key in ("B", "k"):
        cursor[1] += step
        eng.camera.process_cursor(cursor[0], cursor[1])
    elif key in ("C", "l"):
        cursor[0] += step
        eng.camera.process_cursor(cursor[0], cursor[1])
    elif key in ("D", "j"):
        cursor[0] -= step
        eng.camera.process_cursor(cursor[0], cursor[1])
    return True


def run_viewer(eng, n_frames: Optional[int] = None,
               keys: Optional[Iterable[str]] = None,
               cols: int = 96, rows: int = 24,
               out=None, fps_cap: float = 30.0) -> int:
    """Drive the engine loop with live (or scripted) input.

    keys: if given, an iterable of per-frame key strings (scripted input —
    no tty needed); otherwise read the real tty. Returns frames rendered.
    """
    out = out if out is not None else sys.stdout
    cursor = [eng.camera.cursor_x, eng.camera.cursor_y]
    scripted = keys is not None
    key_list = list(keys) if scripted else None

    def loop(poll):
        frames = 0
        while n_frames is None or frames < n_frames:
            t0 = time.perf_counter()
            # pipelined present: dispatch this frame, show the frame
            # submitted FRAME_OVERLAP-1 calls ago (the reference's
            # 3-frames-in-flight loop, vk_engine.cpp:1226-1240); the first
            # couple of calls fill the pipeline and present nothing yet
            img = eng.draw_pipelined(hud=False, present_cells=(cols, rows))
            if img is not None:
                text = frame_to_halfblocks(img, cols, rows)
                out.write(f"{ESC}[H" + text + "\n")
                out.write(f"frame {frames}  "
                          f"{eng.stats.mesh_draw_time:6.1f} ms  "
                          f"tris {eng.stats.triangle_count}  "
                          f"[wasd move, arrows/ijkl look, q quit]\n")
                out.flush()
            # release the one-frame key taps, then apply this frame's input
            # (terminal autorepeat re-presses held keys every frame)
            for k in "wasd":
                eng.camera.process_key(k, False)
            for key in parse_events(poll(frames)):
                if not _apply_key(eng, key, cursor):
                    return frames + 1
            dt = time.perf_counter() - t0
            if fps_cap > 0 and dt < 1.0 / fps_cap:
                time.sleep(1.0 / fps_cap - dt)
            frames += 1
        return frames

    if scripted:
        return loop(lambda i: key_list[i] if i < len(key_list) else "")
    out.write(f"{ESC}[2J")  # clear once
    try:
        tty_ctx = _TtyInput().__enter__()
    except Exception:  # stdin is not a tty: render-only loop
        return loop(lambda i: "")
    try:
        return loop(lambda i: tty_ctx.poll_keys())
    finally:
        tty_ctx.__exit__()

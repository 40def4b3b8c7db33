"""Stats HUD — the ImGui overlay analog (init_imgui vk_engine.cpp:1053-1108,
stats window :1175-1191, draw_imgui :1205-1216).

The reference draws an ImGui window with frametime / draw time / update time
/ triangles / draws onto the swapchain image after the 3D scene. Headless,
the equivalent burns the same five lines into the presented frame with a
tiny built-in 5x7 bitmap font (host-side, on the transferred image).
"""

from __future__ import annotations

import numpy as np

# 5x7 bitmap font covering the glyphs the stats window needs
_FONT = {
    "0": ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    "1": ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    "2": ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    "3": ["11110", "00001", "00001", "01110", "00001", "00001", "11110"],
    "4": ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    "5": ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    "6": ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    "7": ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    "8": ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    "9": ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
    ".": ["00000", "00000", "00000", "00000", "00000", "01100", "01100"],
    " ": ["00000", "00000", "00000", "00000", "00000", "00000", "00000"],
    "f": ["00110", "01000", "11110", "01000", "01000", "01000", "01000"],
    "r": ["00000", "00000", "10110", "11000", "10000", "10000", "10000"],
    "a": ["00000", "00000", "01110", "00001", "01111", "10001", "01111"],
    "m": ["00000", "00000", "11010", "10101", "10101", "10101", "10101"],
    "e": ["00000", "00000", "01110", "10001", "11111", "10000", "01110"],
    "t": ["01000", "01000", "11110", "01000", "01000", "01001", "00110"],
    "i": ["00100", "00000", "01100", "00100", "00100", "00100", "01110"],
    "d": ["00001", "00001", "01111", "10001", "10001", "10001", "01111"],
    "w": ["00000", "00000", "10101", "10101", "10101", "10101", "01010"],
    "u": ["00000", "00000", "10001", "10001", "10001", "10011", "01101"],
    "p": ["00000", "00000", "11110", "10001", "11110", "10000", "10000"],
    "n": ["00000", "00000", "10110", "11001", "10001", "10001", "10001"],
    "g": ["00000", "00000", "01111", "10001", "01111", "00001", "01110"],
    "l": ["01100", "00100", "00100", "00100", "00100", "00100", "01110"],
    "s": ["00000", "00000", "01111", "10000", "01110", "00001", "11110"],
    "c": ["00000", "00000", "01110", "10001", "10000", "10001", "01110"],
    "o": ["00000", "00000", "01110", "10001", "10001", "10001", "01110"],
    "v": ["00000", "00000", "10001", "10001", "10001", "01010", "00100"],
    "h": ["10000", "10000", "11110", "10001", "10001", "10001", "10001"],
    "y": ["00000", "00000", "10001", "10001", "01111", "00001", "01110"],
}


def draw_text(img: np.ndarray, x: int, y: int, text: str,
              color=(255, 255, 255), scale: int = 2) -> None:
    """Draws text in place on an (H, W, 4) uint8 image."""
    h, w = img.shape[:2]
    cx = x
    for ch in text.lower():
        rows = _FONT.get(ch, _FONT[" "])
        for ry, rowbits in enumerate(rows):
            for rx, bit in enumerate(rowbits):
                if bit == "1":
                    y0 = y + ry * scale
                    x0 = cx + rx * scale
                    if y0 + scale <= h and x0 + scale <= w:
                        img[y0:y0 + scale, x0:x0 + scale, :3] = color
                        img[y0:y0 + scale, x0:x0 + scale, 3] = 255
        cx += 6 * scale


def draw_stats(img: np.ndarray, stats, x: int = 8, y: int = 8,
               scale: int = 2) -> np.ndarray:
    """Burns the EngineStats window (vk_engine.cpp:1186-1190) into the frame."""
    lines = [
        f"frametime {stats.frame_time:.3f} ms",
        f"drawtime {stats.mesh_draw_time:.3f} ms",
        f"update time {stats.scene_update_time:.3f} ms",
        f"triangles {stats.triangle_count}",
        f"draws {stats.drawcall_count}",
    ]
    lh = 9 * scale
    # dim backdrop
    bh = lh * len(lines) + 2 * scale
    bw = 24 * 6 * scale
    h, w = img.shape[:2]
    y1, x1 = min(y + bh, h), min(x + bw, w)
    img[y:y1, x:x1, :3] = (img[y:y1, x:x1, :3] // 2)
    for i, line in enumerate(lines):
        draw_text(img, x + scale, y + scale + i * lh, line, scale=scale)
    return img

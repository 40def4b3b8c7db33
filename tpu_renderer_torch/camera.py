"""FPS camera — semantics of the reference camera (camera.cpp:8-66).

* WASD press/release sets velocity components to ±CAMERA_SPEED / 0
  (camera.cpp:13-42).
* Mouse deltas feed yaw/pitch at 1/1000 rad per pixel, with
  ``yaw -= rel_x/1000`` and ``pitch += rel_y/1000`` where rel = old - new
  (camera.cpp:44-52).
* ``update()`` integrates ``position += R @ (velocity * 0.5)`` (camera.cpp:8-11).
* View matrix = inverse(translate(position) @ R) (camera.cpp:54-59) where
  R = yawQuat(yaw about (0,-1,0)) @ pitchQuat(pitch about (1,0,0))
  (camera.cpp:61-66).

Unlike the reference (whose state is ``inline static`` — a de-facto
singleton, camera.h:20-24), instances here carry their own state.
"""

from __future__ import annotations

import numpy as np

from tpu_renderer_torch import math3d


class Camera:
    def __init__(self, position=(0.0, 0.0, 0.0), speed: float = 0.8):
        self.velocity = np.zeros(3, dtype=np.float32)
        self.position = np.asarray(position, dtype=np.float32).copy()
        self.pitch = np.float32(0.0)
        self.yaw = np.float32(0.0)
        self.cursor_x = 0.0
        self.cursor_y = 0.0
        self.speed = np.float32(speed)

    # -- input ingestion (camera.cpp:13-52) --------------------------------

    def process_key(self, key: str, pressed: bool) -> None:
        key = key.lower()
        if pressed:
            if key == "w":
                self.velocity[2] = -self.speed
            elif key == "a":
                self.velocity[0] = -self.speed
            elif key == "s":
                self.velocity[2] = self.speed
            elif key == "d":
                self.velocity[0] = self.speed
        else:
            if key in ("w", "s"):
                self.velocity[2] = 0.0
            elif key in ("a", "d"):
                self.velocity[0] = 0.0

    def process_cursor(self, xpos: float, ypos: float) -> None:
        rel_x = self.cursor_x - xpos
        rel_y = self.cursor_y - ypos
        self.cursor_x = xpos
        self.cursor_y = ypos
        self.yaw -= np.float32(rel_x) / np.float32(1000.0)
        self.pitch += np.float32(rel_y) / np.float32(1000.0)

    # -- integration / matrices (camera.cpp:8-11, 54-66) -------------------

    def update(self) -> None:
        rot = self.get_rotation_matrix()
        delta = math3d.transform_dir(rot, self.velocity * np.float32(0.5))
        self.position = (self.position + delta).astype(np.float32)

    def get_rotation_matrix(self) -> np.ndarray:
        pitch_q = math3d.angle_axis(float(self.pitch), (1.0, 0.0, 0.0))
        yaw_q = math3d.angle_axis(float(self.yaw), (0.0, -1.0, 0.0))
        return math3d.quat_to_mat4(yaw_q) @ math3d.quat_to_mat4(pitch_q)

    def get_view_matrix(self) -> np.ndarray:
        t = math3d.translate(self.position)
        r = self.get_rotation_matrix()
        return math3d.inverse(t @ r)

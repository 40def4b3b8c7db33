"""GLM-convention 3D math on the host (numpy, float32).

The reference uses glm with ``GLM_FORCE_DEPTH_ZERO_TO_ONE`` (vk_engine.cpp:5),
right-handed eye space, and column-major matrices. We express the same
matrices in conventional numpy row-major layout where ``M[row, col]`` and
points transform as ``M @ v`` (column vectors) — numerically identical to
glm's ``M * v``.

Everything is float32 to match glm.
"""

from __future__ import annotations

import numpy as np


def mat4() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def perspective_zo(fov_y_rad: float, aspect: float, z_near: float, z_far: float) -> np.ndarray:
    """glm::perspectiveRH_ZO — depth mapped to [0, 1].

    Matches glm's definition exactly (the reference calls it with near=10000,
    far=0.1 at vk_engine.cpp:1492-1493, which yields a reversed-Z depth range).
    """
    tan_half = np.float32(np.tan(np.float32(fov_y_rad) / np.float32(2.0)))
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = np.float32(1.0) / (np.float32(aspect) * tan_half)
    m[1, 1] = np.float32(1.0) / tan_half
    m[2, 2] = np.float32(z_far) / np.float32(z_near - z_far)
    m[3, 2] = np.float32(-1.0)
    m[2, 3] = -(np.float32(z_far) * np.float32(z_near)) / np.float32(z_far - z_near)
    return m


def vulkan_perspective(fov_y_rad: float, aspect: float, z_near: float, z_far: float) -> np.ndarray:
    """perspective_zo with the Vulkan y-flip ``proj[1][1] *= -1`` (vk_engine.cpp:1494)."""
    m = perspective_zo(fov_y_rad, aspect, z_near, z_far)
    m[1, 1] *= np.float32(-1.0)
    return m


def translate(v) -> np.ndarray:
    m = mat4()
    m[:3, 3] = np.asarray(v, dtype=np.float32)
    return m


def scale(v) -> np.ndarray:
    m = mat4()
    m[0, 0], m[1, 1], m[2, 2] = np.asarray(v, dtype=np.float32)
    return m


def quat(w: float, x: float, y: float, z: float) -> np.ndarray:
    """Quaternion stored (w, x, y, z) — glm::quat constructor order."""
    return np.array([w, x, y, z], dtype=np.float32)


def angle_axis(angle_rad: float, axis) -> np.ndarray:
    """glm::angleAxis — axis is assumed normalized by the caller (as in glm)."""
    a = np.asarray(axis, dtype=np.float32)
    half = np.float32(angle_rad) * np.float32(0.5)
    s = np.float32(np.sin(half))
    return np.array([np.cos(half), a[0] * s, a[1] * s, a[2] * s], dtype=np.float32)


def quat_mul(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dtype=np.float32,
    )


def quat_to_mat4(q) -> np.ndarray:
    """glm::toMat4 — rotation matrix from a (w, x, y, z) quaternion."""
    w, x, y, z = np.asarray(q, dtype=np.float32)
    m = mat4()
    m[0, 0] = 1 - 2 * (y * y + z * z)
    m[0, 1] = 2 * (x * y - w * z)
    m[0, 2] = 2 * (x * z + w * y)
    m[1, 0] = 2 * (x * y + w * z)
    m[1, 1] = 1 - 2 * (x * x + z * z)
    m[1, 2] = 2 * (y * z - w * x)
    m[2, 0] = 2 * (x * z - w * y)
    m[2, 1] = 2 * (y * z + w * x)
    m[2, 2] = 1 - 2 * (x * x + y * y)
    return m.astype(np.float32)


def rotate(m: np.ndarray, angle_rad: float, axis) -> np.ndarray:
    """glm::rotate(m, angle, axis) = m @ R(angle, axis)."""
    a = np.asarray(axis, dtype=np.float32)
    a = a / np.float32(np.linalg.norm(a))
    r = quat_to_mat4(angle_axis(angle_rad, a))
    return (m @ r).astype(np.float32)


def inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m.astype(np.float64)).astype(np.float32)


def transform_point(m: np.ndarray, p) -> np.ndarray:
    """M @ (p, 1), returning the full vec4."""
    v = np.append(np.asarray(p, dtype=np.float32), np.float32(1.0))
    return (m @ v).astype(np.float32)


def transform_dir(m: np.ndarray, d) -> np.ndarray:
    """M @ (d, 0), returning the vec3 part."""
    v = np.append(np.asarray(d, dtype=np.float32), np.float32(0.0))
    return (m @ v)[:3].astype(np.float32)


def radians(deg: float) -> float:
    return float(np.float32(deg) * np.float32(np.pi) / np.float32(180.0))

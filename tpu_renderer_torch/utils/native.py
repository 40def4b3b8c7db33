"""ctypes binding for the native asset library (native/assetlib.cpp) — the
TPU build's C++ tier for host asset work, mirroring the reference's
fastgltf/stb/vkCmdBlitImage pipeline. Builds on first use (g++); every
entry point has a numpy fallback with identical semantics.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libassetlib.so"))
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("TPU_RENDERER_NO_NATIVE"):
            return None
        try:
            if not os.path.exists(_LIB_PATH):
                subprocess.run(
                    ["make", "-C", os.path.abspath(_NATIVE_DIR)],
                    check=True, capture_output=True, timeout=120)
            lib = ctypes.CDLL(_LIB_PATH)
            lib.decode_accessor_f32.restype = ctypes.c_int
            lib.decode_indices_u32.restype = ctypes.c_int
            lib.assetlib_version.restype = ctypes.c_int
            assert lib.assetlib_version() == 1
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _cptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def decode_accessor_f32(raw: bytes, count: int, n: int, component_type: int,
                        stride: int, normalized: bool) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((count, n), np.float32)
    rc = lib.decode_accessor_f32(
        _cptr(src), ctypes.c_int64(count), ctypes.c_int(n),
        ctypes.c_int(component_type), ctypes.c_int(stride),
        ctypes.c_int(1 if normalized else 0), _cptr(out))
    return out if rc == 0 else None


def decode_indices_u32(raw: bytes, count: int, component_type: int,
                       stride: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(raw, np.uint8)
    out = np.empty(count, np.uint32)
    rc = lib.decode_indices_u32(
        _cptr(src), ctypes.c_int64(count), ctypes.c_int(component_type),
        ctypes.c_int(stride), _cptr(out))
    return out if rc == 0 else None


def downsample_blit_rgba8(img: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    h, w = img.shape[:2]
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((max(h // 2, 1), max(w // 2, 1), 4), np.uint8)
    lib.downsample_blit_rgba8(_cptr(img), ctypes.c_int(h), ctypes.c_int(w), _cptr(out))
    return out


def blit_quad_rows_u32(level: np.ndarray, atlas: np.ndarray,
                       ox: int, oy: int) -> bool:
    """Writes level's prebaked quad rows into atlas[(oy:, ox:)]. atlas is
    (H, W, 4) u32, C-contiguous."""
    lib = _load()
    if lib is None:
        return False
    h, w = level.shape[:2]
    level = np.ascontiguousarray(level, np.uint8)
    assert atlas.dtype == np.uint32 and atlas.flags.c_contiguous
    lib.blit_quad_rows_u32(
        _cptr(level), ctypes.c_int(h), ctypes.c_int(w),
        _cptr(atlas), ctypes.c_int64(atlas.shape[1]),
        ctypes.c_int(ox), ctypes.c_int(oy))
    return True

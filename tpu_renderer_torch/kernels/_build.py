"""Build and load the CUDA raster kernels (csrc/*.cu).

The sources are compiled with nvcc for sm_90a into one shared library with
a plain C interface, at first use, and loaded with ctypes. The library's
name carries a hash of the sources and flags, so an edit rebuilds it and an
unchanged tree reuses it. Nothing here runs at import time: the CPU tests
import every module on a machine with no nvcc.

Flags: -fmad=false, so nvcc contracts no multiply-add on its own; the
sources spell out each fused multiply-add the reference has (__fmaf_rn),
so the kernels round like their plain PyTorch twins. No --use_fast_math:
1/den is the IEEE divide and subnormals are kept (the explicit fill rule
stays exact with them).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
# wall time of this process's nvcc run; None while none ran (the library
# is not loaded yet, or build() found it already built)
build_seconds = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA raster kernels need the CUDA "
                       "toolkit (sm_90a) to build")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(glob.glob(os.path.join(CSRC_DIR, "*"))):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into BUILD_DIR (if not built yet); return the path
    of the shared library. build_seconds is None after a cache hit."""
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"libraster_kernels_{_digest()}.so")
    if os.path.exists(out):
        build_seconds = None
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build(verbose=verbose))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.raster_fused_launch.argtypes = [p, p, p, i, i, i, i, p, p, p, p, p]
        lib.raster_fused_launch.restype = i
        lib.raster_accum_launch.argtypes = [p, p, p, i, i, i, i, p, p, p, p, p]
        lib.raster_accum_launch.restype = i
        lib.raster_error_string.argtypes = [i]
        lib.raster_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def error_string(err: int) -> str:
    return f"CUDA error {err}: {load_library().raster_error_string(err).decode()}"

"""Build and load the CUDA kernels (csrc/*.cu: the raster passes, the
background passes, and the conditional nodes of a captured frame).

The sources are compiled with nvcc for sm_90a, one nvcc process per source,
all started together, and linked into one shared library with a plain C
interface, at first use; it is loaded with ctypes. The library's
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
              "-fmad=false", "-Xcompiler", "-fPIC")

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


def _sources(csrc_dir: str):
    return sorted(glob.glob(os.path.join(csrc_dir, "*.cu")))


def _digest(csrc_dir: str = None) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(glob.glob(os.path.join(csrc_dir or CSRC_DIR, "*"))):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into BUILD_DIR (if not built yet); return the path
    of the shared library. build_seconds is None after a cache hit."""
    global build_seconds
    out, build_seconds = build_from(CSRC_DIR, BUILD_DIR, verbose)
    return out


def build_from(csrc_dir: str, build_dir: str, verbose: bool = False):
    """Compile csrc_dir/*.cu into build_dir, as build() does the shipped
    sources (tools/sweep_tiles.py builds rewritten copies with it). Returns
    (library path, nvcc wall seconds, or None when it was already built)."""
    os.makedirs(build_dir, exist_ok=True)
    out = os.path.join(build_dir, f"libraster_kernels_{_digest(csrc_dir)}.so")
    if os.path.exists(out):
        return out, None
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    nvcc = _nvcc()
    flags = [*NVCC_FLAGS, "-Xptxas=-v"] if verbose else list(NVCC_FLAGS)
    t0 = time.perf_counter()
    objs, procs = [], []
    sources = _sources(csrc_dir)
    for src in sources:
        obj = f"{tmp}.{os.path.basename(src)}.o"
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *flags, "-c", "-o", obj, src],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    errors = []
    for src, proc in zip(sources, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{os.path.basename(src)} ({proc.returncode}):\n{err}")
        elif verbose and err:
            print(err, end="")
    if not errors:
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            errors.append(f"link ({link.returncode}):\n{link.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    seconds = time.perf_counter() - t0
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    os.replace(tmp, out)
    return out, seconds


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build(verbose=verbose))
        p, i = ctypes.c_void_p, ctypes.c_int
        # every raster launcher takes tiles_x, tiles_y, tile_h, tile_w after
        # its bins (t4); a tile outside the library's set returns an error
        t4 = [i, i, i, i]
        lib.raster_fused_launch.argtypes = [p, p, p, i, i, *t4, p, p, p, p, p]
        lib.raster_fused_launch.restype = i
        lib.raster_accum_launch.argtypes = [p, p, p, i, i, *t4, p, p, p, p, p]
        lib.raster_accum_launch.restype = i
        lib.raster_peel_fused_launch.argtypes = [p, p, p, i, i, *t4, p, p, p, p, p, p]
        lib.raster_peel_fused_launch.restype = i
        lib.raster_deferred_launch.argtypes = [p, i, p, p, i, *t4, p, p, p]
        lib.raster_deferred_launch.restype = i
        lib.raster_peel_deferred_launch.argtypes = [p, i, p, p, i, *t4, p, p, p, p]
        lib.raster_peel_deferred_launch.restype = i
        # rows, n_tris, bins, counts, bin_width, the tiles, then the pass's
        # own planes and the stream
        lib.raster_fused_gathered_launch.argtypes = [p, i, p, p, i, *t4, p, p, p, p, p]
        lib.raster_fused_gathered_launch.restype = i
        lib.raster_accum_gathered_launch.argtypes = [p, i, p, p, i, *t4, p, p, p, p, p]
        lib.raster_accum_gathered_launch.restype = i
        lib.raster_peel_gathered_launch.argtypes = [p, i, p, p, i, *t4, p, p, p, p, p, p]
        lib.raster_peel_gathered_launch.restype = i
        lib.background_gradient_launch.argtypes = [p, p, i, i, i, p, p]
        lib.background_gradient_launch.restype = i
        # data1, the lattice's column and row cosines, height, wp, hp, out, stream
        lib.background_sky_launch.argtypes = [p, p, p, i, i, i, p, p]
        lib.background_sky_launch.restype = i
        lib.background_grid_launch.argtypes = [i, i, i, i, p, p]
        lib.background_grid_launch.restype = i
        # the conditional nodes of a captured frame (csrc/conditional.cu)
        lib.graph_conditional_begin.argtypes = [p, p, i, p,
                                                ctypes.POINTER(ctypes.c_ulonglong)]
        lib.graph_conditional_begin.restype = i
        lib.graph_conditional_set.argtypes = [p, ctypes.c_ulonglong, p]
        lib.graph_conditional_set.restype = i
        lib.graph_conditional_end.argtypes = [p]
        lib.graph_conditional_end.restype = i
        lib.graph_body_stream.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        lib.graph_body_stream.restype = i
        lib.raster_error_string.argtypes = [i]
        lib.raster_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def error_string(err: int) -> str:
    return f"CUDA error {err}: {load_library().raster_error_string(err).decode()}"

"""Build and load the CUDA kernels (csrc/*.cu: the raster passes, the
background passes, the fused path's triangle setup and shading, the
conditional nodes of a captured frame, and the trace's stamps).

The sources are compiled with nvcc for sm_90a, one nvcc process per source,
all started together, and linked into one shared library with a plain C
interface, at first use; it is loaded with ctypes. The library's
name carries a hash of the sources and flags, so an edit rebuilds it and an
unchanged tree reuses it. Nothing here runs at import time: the CPU tests
import every module on a machine with no nvcc.

The main library holds the raster kernels at every tile of raster.TILES.
Any other tile the raster takes (raster.tile_rule) gets a library of its
own at its first use (load_tile_library): the raster sources alone,
compiled with -DTR_TILE_H and -DTR_TILE_W (with_tile in
csrc/raster_common.cuh then holds that tile alone), named by the tile and
the hash of the sources and flags. A build holds a lock on its library's
name, so processes that ask for the same library at once (the ranks of a
mesh) build it once. Loading a tile's library sets its kernels up on the
device (setup_tile), so a tile whose clusters do not fit the card is
refused there, before any of its kernels launches.

Flags: -fmad=false, so nvcc contracts no multiply-add on its own; the
sources spell out each fused multiply-add the reference has (__fmaf_rn),
so the kernels round like their plain PyTorch twins. No --use_fast_math:
1/den is the IEEE divide and subnormals are kept (the explicit fill rule
stays exact with them).
"""

from __future__ import annotations

import ctypes
import fcntl
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
_tile_libs = {}   # (tile_h, tile_w) -> the tile's loaded library


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA raster kernels need the CUDA "
                       "toolkit (sm_90a) to build")


def _sources(csrc_dir: str, pattern: str = "*.cu"):
    return sorted(glob.glob(os.path.join(csrc_dir, pattern)))


def _digest(csrc_dir: str = None, flags=NVCC_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
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


def build_tile(tile_h: int, tile_w: int, verbose: bool = False):
    """Compile the raster sources (csrc/raster_*.cu) for the one tile
    tile_h x tile_w into BUILD_DIR, if not built yet. Returns (library path,
    nvcc wall seconds, or None when it was already built); a failed build
    raises."""
    flags = (*NVCC_FLAGS, f"-DTR_TILE_H={tile_h}", f"-DTR_TILE_W={tile_w}")
    name = f"libraster_tile_{tile_h}x{tile_w}_{_digest(CSRC_DIR, flags)}.so"
    return _compile(_sources(CSRC_DIR, "raster_*.cu"), flags, os.path.join(BUILD_DIR, name),
                    verbose)


def build_from(csrc_dir: str, build_dir: str, verbose: bool = False):
    """Compile csrc_dir/*.cu into build_dir, as build() does the shipped
    sources (tools/sweep_tiles.py builds rewritten copies with it). Returns
    (library path, nvcc wall seconds, or None when it was already built)."""
    out = os.path.join(build_dir, f"libraster_kernels_{_digest(csrc_dir)}.so")
    return _compile(_sources(csrc_dir), NVCC_FLAGS, out, verbose)


def _compile(sources, flags, out: str, verbose: bool):
    """nvcc each source with flags, all at once, and link the objects into
    the shared library out, under a lock on out (another process building
    it is waited for). Returns (out, nvcc wall seconds, or None when out
    was already built)."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        return out, None
    with open(f"{out}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out, None
        return out, _compile_locked(sources, flags, out, verbose)


def _compile_locked(sources, flags, out: str, verbose: bool) -> float:
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    nvcc = _nvcc()
    flags = [*flags, "-Xptxas=-v"] if verbose else list(flags)
    t0 = time.perf_counter()
    objs, procs = [], []
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
    return seconds


def _bind_raster(lib: ctypes.CDLL) -> None:
    """The argument and result types of the raster launchers."""
    p, i = ctypes.c_void_p, ctypes.c_int
    # every raster launcher takes tiles_x, tiles_y, tile_h, tile_w after
    # its bins (t4); a tile the library is not built for returns an error.
    # The frame's passes 2.1-2.5 then take the band's first tile row
    # (tile_y0, csrc/raster_common.cuh Band)
    t4 = [i, i, i, i]
    lib.raster_fused_launch.argtypes = [p, p, p, i, i, *t4, i, p, p, p, p, p]
    lib.raster_fused_launch.restype = i
    lib.raster_accum_launch.argtypes = [p, p, p, i, i, *t4, i, p, p, p, p, p]
    lib.raster_accum_launch.restype = i
    lib.raster_peel_fused_launch.argtypes = [p, p, p, i, i, *t4, i, p, p, p, p, p, p]
    lib.raster_peel_fused_launch.restype = i
    lib.raster_deferred_launch.argtypes = [p, i, p, p, i, *t4, i, p, p, p]
    lib.raster_deferred_launch.restype = i
    lib.raster_peel_deferred_launch.argtypes = [p, i, p, p, i, *t4, i, p, p, p, p]
    lib.raster_peel_deferred_launch.restype = i
    # rows, n_tris, bins, counts, bin_width, the tiles, then the pass's
    # own planes and the stream
    lib.raster_fused_gathered_launch.argtypes = [p, i, p, p, i, *t4, p, p, p, p, p]
    lib.raster_fused_gathered_launch.restype = i
    lib.raster_accum_gathered_launch.argtypes = [p, i, p, p, i, *t4, p, p, p, p, p]
    lib.raster_accum_gathered_launch.restype = i
    lib.raster_peel_gathered_launch.argtypes = [p, i, p, p, i, *t4, p, p, p, p, p, p]
    lib.raster_peel_gathered_launch.restype = i
    lib.raster_error_string.argtypes = [i]
    lib.raster_error_string.restype = ctypes.c_char_p
    lib.raster_max_clusters.argtypes = [i]
    lib.raster_max_clusters.restype = i
    for fn in SETUP.values():
        getattr(lib, fn).argtypes = [i, i, ctypes.POINTER(i)]
        getattr(lib, fn).restype = i


# Kernel -> the entry that sets it up at a tile before any launch and
# reports the shared memory a block of it takes (csrc/ raster_*_setup).
SETUP = {"2.1": "raster_fused_setup", "2.2": "raster_accum_setup",
         "2.3": "raster_peel_fused_setup", "2.4": "raster_deferred_setup",
         "2.5": "raster_peel_deferred_setup", "2.6": "raster_fused_gathered_setup",
         "2.7": "raster_accum_gathered_setup", "2.8": "raster_peel_gathered_setup"}
# the CUDA error a setup returns where no cluster of the kernel fits
NO_CLUSTER_FITS = 9   # cudaErrorInvalidConfiguration


def setup_tile(lib: ctypes.CDLL, tile_h: int, tile_w: int) -> dict:
    """Run every raster kernel's setup at the tile on the current device
    (the opt-in to its shared memory, and room for a cluster of a tile
    walked in passes, cudaOccupancyMaxActiveClusters): kernel -> the bytes
    of shared memory a block takes. Raises ValueError where no cluster of
    a kernel fits on the card (the tile is refused before any of its
    kernels launch), RuntimeError on another CUDA error."""
    out = {}
    for k, fn in SETUP.items():
        n = ctypes.c_int(0)
        err = getattr(lib, fn)(tile_h, tile_w, ctypes.byref(n))
        if err == NO_CLUSTER_FITS:
            raise ValueError(
                f"the CUDA raster kernels refuse the tile: at {tile_h}x{tile_w} no cluster of "
                f"kernel {k}'s blocks ({n.value:,} bytes of shared memory each) fits on this "
                f"card (cudaOccupancyMaxActiveClusters)")
        if err != 0:
            raise RuntimeError(f"{fn} failed: {error_string(err, lib)}")
        out[k] = n.value
    return out


def load_tile_library(tile_h: int, tile_w: int, verbose: bool = False) -> ctypes.CDLL:
    """The loaded library of the raster kernels at the one tile tile_h x
    tile_w, built on first use (build_tile) and set up on the current
    device before it is handed out (setup_tile: a tile whose clusters do
    not fit raises there, before any launch)."""
    with _lock:
        lib = _tile_libs.get((tile_h, tile_w))
        if lib is None:
            lib = ctypes.CDLL(build_tile(tile_h, tile_w, verbose)[0])
            _bind_raster(lib)
            setup_tile(lib, tile_h, tile_w)
            _tile_libs[tile_h, tile_w] = lib
        return lib


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    from tpu_renderer_torch.utils.profiling import setup_step

    with _lock:
        if _lib is not None:
            return _lib
        with setup_step("kernel library"):
            lib = ctypes.CDLL(build(verbose=verbose))
        _bind_raster(lib)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.background_gradient_launch.argtypes = [p, p, i, i, i, p, p]
        lib.background_gradient_launch.restype = i
        # data1, the lattice's column and row cosines, height, wp, hp, out, stream
        lib.background_sky_launch.argtypes = [p, p, p, i, i, i, p, p]
        lib.background_sky_launch.restype = i
        lib.background_grid_launch.argtypes = [i, i, i, i, p, p]
        lib.background_grid_launch.restype = i
        # kernel 2.12 (csrc/shade.cu): attrs, meta, inv, quads, n_quads,
        # atlas width, ambient, sun power, fb, hit, out, pixels, textured,
        # trilinear, pot, blend, fp16, stream
        lib.shade_fused_launch.argtypes = [p, p, p, p, i, i, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.shade_fused_launch.restype = i
        # kernel 2.13 (csrc/setup.cu): pos, nrm, col, uv, mat, meta6,
        # tri_draw, tri_valid, draw_model, draw_visible, n_draws, viewproj,
        # sun, triangles, width, height, rows, aabb, valid, stream
        lib.triangle_setup_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, i, p, p, i, i, i,
                                              p, p, p, p]
        lib.triangle_setup_launch.restype = i
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
        # the trace's stamps (csrc/trace.cu): log, state, capacity, tag,
        # instance, new_frame, stream; the calibration's clock; the timer's step
        ll = ctypes.c_longlong
        lib.trace_stamp.argtypes = [p, p, ll, ll, p, i, p]
        lib.trace_stamp.restype = i
        lib.trace_clock.argtypes = [p, p]
        lib.trace_clock.restype = i
        lib.trace_timer_step.argtypes = [p, i, p]
        lib.trace_timer_step.restype = i
        _lib = lib
        return _lib


def error_string(err: int, lib: ctypes.CDLL = None) -> str:
    """A CUDA error's text, by `lib` (the main library by default)."""
    lib = lib or load_library()
    return f"CUDA error {err}: {lib.raster_error_string(err).decode()}"

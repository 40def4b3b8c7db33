"""Smoke run of the PyTorch + CUDA port on one GPU (sm_90a: an H100).

    python3 chip_smoke.py

Drives tpu_renderer_torch's paths on the card and checks them, in this
order but for two: phase 17 runs right after phase 6, and phase 5b right
after phase 11, so that the first torch.profiler session of the process
(5b's), after which its eager launches are slower, comes after phase 17's
long plain-version loops:

1. without CUDA exits 1 before doing anything else; prints the card's name
   and power limit (nvidia-smi, which must succeed);
2. builds the raster kernels from tpu_renderer_torch/kernels/csrc with nvcc,
   one process per source (or reuses the library an earlier run built from
   the same sources);
3. the bench frame (the demo scene at grid=64, 1920x1080, camera
   (0, 6, 128), pitch -0.18): renders it once and, on the inputs the frame
   gave kernels 2.1, 2.2, 2.12 (the opaque pass's shading and its
   composite) and 2.13 (the triangle setup, opaque ++ transparent), holds
   each kernel against its plain PyTorch version (exact on every output)
   and times both with CUDA events; then resets the launch counters,
   renders 1 + 20 frames through Engine(device="cuda") and fails unless
   the four kernels were launched; the same frame rendered through the
   plain versions must be identical;
3b. the stress frame (grid 128, the bench's stress variant): 2.1 and 2.2
   on its captured inputs against their plain versions, timed;
3c. the adversarial rows of tpu_renderer_torch/utils/hazards.py (equal-z
   copies across every segment boundary of 2.1, -0.0 / +0.0 depth ties,
   edges on region borders, full-screen and dead rows; for the peels an
   opaque depth equal to the fragments' depths) on one tile of 64
   entries and on 2x2 tiles: 2.1 and 2.2 exact against their plain
   versions; 2.7 over per-triangle bins of every member of each binned
   chunk with -1 holes (hazards.hazard_holes, expand_bins), in slot order
   and each tile's reversed, on rows with negative depths under an opaque
   depth negative over half the frame, where only 2.7's 0 <= z decides,
   exact against its plain version; 2.3, 2.5 and 2.8 (on those holed
   bins) over three peels with `last` fed back, on the ascending bins and
   on each tile's reversed, exact against theirs; 2.4 and 2.6 on the
   visibility hazard rows (depths past 1, NaN and infinite coefficients
   besides) on the same tiles, ascending and reversed, and on a bin whose
   segments hold no winner beside zero-depth winners of either sign,
   exact against theirs;
4. the textured-glass bench frame (the same scene, its glass sampling the
   checker texture, so its transparency takes the depth peel): kernel 2.3
   against its plain version on the first peel's inputs and a later one's,
   timed; kernel 2.12 on the first peeled layer's shading and additive
   blend, against its plain version, timed; 1 + 5 graphed frames with the
   counters reset, layers per frame and the host syncs inside each
   draw_device(); the plain-version frame must be identical;
5. the deferred bench frame (fused=False): the caps the escalation reached,
   kernels 2.4 and 2.5 against their plain versions (2.5 on two peels),
   timed; 1 + 5 frames counted; the plain-version frame must be
   identical;
5b. how 2.1, 2.2 (the bench frame's call), 2.3, 2.5 (the first peel's),
   2.4 and 2.6 (the deferred frame's bins), 2.7 and 2.8 (phase 11's
   inputs: 2.2's and 2.3's first calls, the chunk bins expanded), and 2.4
   on phase 6's grid=320 frame (phases 6-11 run before this one) spread their
   work, one [split] line each: the wrapper's launches and the device's
   kernels for one call (one torch.profiler session), the blocks and
   clusters, the busiest tile's entries and live groups (per-triangle
   bins: live entries) and the segments it is cut into (2.5, 2.8: how
   many ascend, so may stop early);
6. a scene past the dense-bin guard (build_demo_glb(grid=320), default
   config): the engine takes the deferred path by itself; one counted
   frame; then 2.4 on that frame's inputs (tri_cap 16384), timed (no
   plain-version comparison at that size);
7. renders the structure scene at 480x270 and 1920x1080 and holds it to
   tests/goldens/structure_*.png (at most 0.1% of pixels may differ);
8. the background passes (kernels 2.9, 2.10, 2.11): each against its plain
   version at 480x270, 1700x900 and 1920x1080, exact on every element of
   the padded buffer, timed at 1920x1080 over four rounds, three readings a
   round (device ms, host ms, batched ms; tools/time_background.py), 2.9
   in turns with one torch.lerp (kernel, lerp, lerp, kernel, ...);
   how many of the sky's lattice cosines the card's own cos would get
   wrong; 2.11, which no engine loads, through its public function into a
   frame;
9. the CLI, in-process through tpu_renderer_torch.cli.main with the
   counters reset: demo --grid 64 at 1920x1080 with the sky (2.1 and 2.10
   must launch), the same at --render-scale 0.65, the background_gradient
   and background_sky milestones (2.9 and 2.10 must launch); each PNG must
   equal the one the same command writes through the plain versions; view
   (the pipelined loop: no frame missing after the fill) and benchmark
   (its JSON line);
10. the render scale and the pipelined draw on the bench frame: scale 0.65
   against native, draw() against draw_pipelined() over one orbit (equal
   byte for byte with a lag of two), medians printed; then an effect
   switch and a resize on one engine with the launches they cause;
11. the gathered oracles (kernels 2.6, 2.7, 2.8, per-triangle bins over the
   fat rows): 2.6 against its plain version on the deferred bench frame's
   own rows and refined bins at the settled caps, timed; then, with the
   counters reset, the cross-checks, each on the very rows its stream
   kernel ran on: triangle bins built over the fused bench frame's sorted
   rows (bin_triangles + refine_bins, caps doubled until nothing
   overflows) and 2.6's z, tid, attrs, metas, inv equal 2.1's; 2.7 on
   expand_bins of the frame's transparent chunk bins equals 2.2 (cnt
   exact; acc exact, or within 1e-6 with the maximum printed); 2.8 equals
   2.3 over the first three peels of the textured-glass frame, `last` fed
   back. 2.7 and 2.8 are also held to their plain versions and timed;
12. the raster profile tool (tpu_renderer_torch.tools.profile_raster.main)
   in-process: its five lines; 2.4 and 2.6 must launch;
13. the bench (tpu_renderer_torch.bench.main --frames 20) in-process: its
   JSON line; 2.1 and 2.2 must launch in every frame of every variant,
   kernel 2.12's two-tap instance in every frame of the two trilinear
   variants and in no other, and trilinear_auto_scale must lie in
   [auto_scale_min, 1];
14. the multi-device frame (tpu_renderer_torch/parallel/multichip.py)
   on the bench scene at 1920x1080, each mesh's ranks started by
   multichip.launch after the kernel library is built here: (1, 1) over
   nccl on the bench, textured-glass and deferred paths, its frames graphed
   (the mesh frame one CUDA graph, its collectives and the peel's WHILE
   node inside) and drawn eagerly, in turns; (2, 1), (1, 2) and (2, 2)
   over gloo with the ranks sharing the one card, drawn eagerly: the bench
   and deferred paths, and the textured-glass frame at (2, 2). Each rank
   zeroes its counters before a path and reports them after: the path's
   kernels (2.1 and 2.2; 2.1 and 2.3; 2.4 and 2.5; and 2.9, the
   background) must have launched on every rank. Every image is byte for
   byte the single-device frame of its path, and a graphed frame makes no
   host sync inside draw_device(); frame ms, draw_device() host ms, host
   syncs, the capture's ms and the collectives' share of a frame are
   printed; at each gloo mesh every rank's band, the device ms of its
   2.1-2.5 launches (over the band's tiles alone) and its peak MiB, and on
   the first rank of the last band each of 2.1-2.5, once in the phase
   (BAND_CHECKS), held to its plain version at its tile_y0 > 0; all
   collected on a {"multichip": [...]} line;
15. the rest of the port's surface: `cli view --multichip 2x1` on the
   bench scene at 1920x1080 in a subprocess whose stdin is a
   pseudo-terminal, keys typed and then q: it must exit 0, both ranks must
   have presented the same frames (count and digest, as the CLI prints
   them) and launched 2.1, 2.2 and, once, 2.9; utils.profiling.debug_mode around a
   first bench frame (2.9, 2.1, 2.2) and a warm one: each passes, equals
   the frame without it byte for byte, and its ms is printed;
   tools.profile_binwidth, tools.bench_gather and tools.make_gallery (into
   chiprun_out/smoke/gallery) in-process, their lines echoed; and
   tools.sweep_tiles at the shipped point of the tile_h axis (SWEEP_ARGS;
   the tool's default sweeps every axis, and phase 17 runs every tile),
   whose every check must pass;
16. the graphed frame (tpu_renderer_torch/frame_graph.py: each key of
   statics captured as a CUDA graph at its first frame, the peel loop a
   WHILE node inside it, then replayed) against the same frames drawn
   eagerly (pipeline.eager()) on the bench, trilinear, stress,
   textured-glass and deferred paths: over a 10-frame orbit each graphed
   frame equals the eager one byte for byte, with the same aux and the same
   launches of every kernel (the peels counted on the card; kernel 2.12's
   two-tap instance as often as 2.12 on the trilinear path, never on the
   others), and no host
   sync inside a graphed draw_device() (torch.cuda.set_sync_debug_mode); the
   textured-glass graph is captured looking away from the glass, so its
   replays peel every layer they find on the card; each capture's ms and
   memory pool, wall and host ms in turns (graphed, eager, eager, graphed),
   the eager frame's syncs; then draw_pipelined() on the graphed bench
   engine against eager draws, a lag of 2;
17. the raster tile: Engine(RendererConfig(tile_h, tile_w)) at every tile
   of raster.TILES, the default (32x128) first, then at NEW_TILES (8x32,
   16x32, 64x128, 8x256, 32x256, 128x128: tiles the shipped library does
   not hold, each built into a library of its own at the phase's start,
   all at once, its nvcc seconds printed), on the bench, textured-glass
   and deferred frames at 1920x1080: kernels 2.1-2.5 on the inputs each
   frame gives them at that tile, and 2.6-2.8 on inputs made from them as
   phases 5 and 11 make them, each timed (device ms) with its bound, and
   held to its plain version bit for bit on those same inputs (at the
   default tile phases 3-11 hold them); the path's graphed frames counted
   (20 at the default tile, 3 at the other shipped tiles, 10 at the new
   ones; the path's kernels must launch), each image byte for byte the
   default tile's, and their median ms; 2.9-2.11 against their plain versions at 1920x1080 and 1700x900
   padded to the tile (1728 wide at 64-pixel tiles, a half row segment),
   device ms at 1920x1080; at a tile walked in passes the clusters
   cudaOccupancyMaxActiveClusters found room for; then REFUSED_TILES
   (12x128: not whole 32x8 regions; 128x256: past the shared memory a
   block can opt into) must raise before any build or launch, in the
   wrapper and the Engine; a {"tiles": [...]} line collects them;
18. prints each phase's seconds as it ends ([time] lines), then a JSON
   line of per-kernel results (launches on its path, max_abs_err against
   the plain version, ms and plain ms, the bound from this run's inputs,
   the library call's ms where there is one; besides, device_ms and
   host_ms) after phase 14's and phase 17's lines, the nvidia-smi line,
   and, last, {"ok": true, "device": {...}}.

Frames on the card are graphed (a replay of a captured CUDA graph) unless
pipeline.eager() is entered: every check that patches or wraps a kernel
function (capture_kernel_inputs, plain_versions) sees only what runs
eagerly, so each runs its frames under pipeline.eager(), and a graph's
replay inside plain_versions raises. The
launch counters count replays: a replay adds the launches its graph holds,
and the launches inside its peel loop count on the card
(raster._Counter.total).

Kernel times: "ms" is 2.1-2.8's CUDA events around one call of the
wrapper on an idle card (its host time up to the launch, then the kernel),
2.9-2.11's one event pair around 50 back-to-back calls (the larger of the
host's enqueue and the card's time); "device_ms" is the card's time alone,
one event pair around the replay of a CUDA graph that captured 50 calls,
over the count; "host_ms" the host's time a call, time.perf_counter around
50 calls with no synchronise (utils/timing.py's event_ms, batched_ms,
device_ms, host_ms). Launches made to time a kernel are not counted: each
path's counters are zeroed before it.

Scene files go to chiprun_out/smoke/ inside the checkout. Any failure raises.
"""

import contextlib
import importlib
import io
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "smoke")
FRAME_TOL = 0.001        # whole frame: share of pixels allowed to differ
# Published H100 SXM peaks: fp32 outside
# the tensor cores, and HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FLOPS_PER_TEST = 16      # 3 edge planes + the depth plane, 4 flops each
FLOPS_PER_FRAGMENT = 40  # kernels 2.2 and 2.7: shading a taken fragment

# Float operations a pixel of the background passes: 2.9 a multiply, a
# fused multiply-add and an add a plane; 2.10 four stars of ~10, the two
# fracts, the blend's 3 fused multiply-adds and 5 multiplies, 2 a colour
# plane; 2.11 two multiplies and the grid test.
BACKGROUND_FLOPS_PER_PIXEL = {"background_gradient_kernel": 16,
                              "background_sky_kernel": 60,
                              "background_grid_kernel": 4}
BACKGROUND_EXTENTS = ((480, 270), (1700, 900), (1920, 1080))

# name -> (module under tpu_renderer_torch.kernels, plain version, launch
# counter, source, replaced Pallas kernel)
KERNELS = {
    "raster_fused_kernel": ("raster", "rasterize_fused_plain", "fused_counter",
                            "tpu_renderer_torch/kernels/csrc/raster_fused.cu",
                            "tpu_renderer/kernels/raster.py:1128"),
    "raster_accum_kernel": ("raster", "rasterize_accum_plain", "accum_counter",
                            "tpu_renderer_torch/kernels/csrc/raster_accum.cu",
                            "tpu_renderer/kernels/raster.py:1690"),
    "raster_peel_fused_kernel": ("raster", "rasterize_peel_fused_plain",
                                 "peel_fused_counter",
                                 "tpu_renderer_torch/kernels/csrc/raster_peel.cu",
                                 "tpu_renderer/kernels/raster.py:1987"),
    "raster_deferred_kernel": ("raster", "rasterize_plain", "deferred_counter",
                               "tpu_renderer_torch/kernels/csrc/raster_deferred.cu",
                               "tpu_renderer/kernels/raster.py:642"),
    "raster_peel_kernel": ("raster", "rasterize_peel_plain", "peel_counter",
                           "tpu_renderer_torch/kernels/csrc/raster_deferred.cu",
                           "tpu_renderer/kernels/raster.py:749"),
    "raster_fused_gathered_kernel": ("raster", "rasterize_fused_gathered_plain",
                                     "fused_gathered_counter",
                                     "tpu_renderer_torch/kernels/csrc/raster_gathered.cu",
                                     "tpu_renderer/kernels/raster.py:868"),
    "raster_accum_gathered_kernel": ("raster", "rasterize_accum_gathered_plain",
                                     "accum_gathered_counter",
                                     "tpu_renderer_torch/kernels/csrc/raster_gathered.cu",
                                     "tpu_renderer/kernels/raster.py:1551"),
    "raster_peel_gathered_kernel": ("raster", "rasterize_peel_gathered_plain",
                                    "peel_gathered_counter",
                                    "tpu_renderer_torch/kernels/csrc/raster_gathered.cu",
                                    "tpu_renderer/kernels/raster.py:1865"),
    "background_gradient_kernel": ("background", "gradient_plain", "gradient_counter",
                                   "tpu_renderer_torch/kernels/csrc/background.cu",
                                   "tpu_renderer/kernels/background.py:44"),
    "background_sky_kernel": ("background", "sky_plain", "sky_counter",
                              "tpu_renderer_torch/kernels/csrc/background.cu",
                              "tpu_renderer/kernels/background.py:127"),
    "background_grid_kernel": ("background", "grid_gradient_plain", "grid_counter",
                               "tpu_renderer_torch/kernels/csrc/background.cu",
                               "tpu_renderer/kernels/background.py:171"),
    # no Pallas kernel: the JAX package's shade_fused is jnp, which XLA fuses
    "shade_fused_kernel": ("shade", "shade_fused_plain", "fused_counter",
                           "tpu_renderer_torch/kernels/csrc/shade.cu",
                           "tpu_renderer/kernels/shade.py:296"),
    # no Pallas kernel: the JAX package's triangle_setup_rows is jnp, which
    # XLA fuses
    "triangle_setup_rows_kernel": ("vertex", "triangle_setup_rows_plain", "setup_counter",
                                   "tpu_renderer_torch/kernels/csrc/setup.cu",
                                   "tpu_renderer/kernels/vertex.py:292"),
}
# kernel 2.12's two-tap instance, counted apart from the kernel (read_counters)
TWO_TAP = "shade_fused_kernel.two_tap"
# the CUDA kernel's own name where it is not its wrapper's
DEVICE_NAMES = {"raster_peel_kernel": "raster_peel_deferred_kernel"}
BACKGROUND_KERNELS = tuple(n for n in KERNELS if n.startswith("background_"))
# kernels over dense chunk bins (entries cid << shift | gmask); the other
# raster kernels walk per-triangle bins
CHUNK_BIN_KERNELS = ("raster_fused_kernel", "raster_accum_kernel", "raster_peel_fused_kernel")
# peels that may stop at the entry holding the layer (their bins ascend);
# 2.8's rule takes the slots in any order, so it needs every live entry
EARLY_EXIT_PEELS = ("raster_peel_fused_kernel", "raster_peel_kernel")
# the visibility walks over per-triangle bins, split over a cluster and
# folded in order (vis_tile in raster_common.cuh)
VIS_KERNELS = ("raster_deferred_kernel", "raster_fused_gathered_kernel")
ACCUM_KERNELS = ("raster_accum_kernel", "raster_accum_gathered_kernel")
# the peels over per-triangle bins (peel_tile in raster_common.cuh)
TRIANGLE_PEELS = ("raster_peel_kernel", "raster_peel_gathered_kernel")


def kernel_module(name):
    """The module that holds kernel `name`, its plain version and counter."""
    return importlib.import_module(f"tpu_renderer_torch.kernels.{KERNELS[name][0]}")


def build_line(nvcc_seconds, load_seconds: float) -> str:
    """The build phase's report; nvcc_seconds is None when the library
    built earlier from the same sources was reused."""
    nvcc = ("cached library reused (no nvcc run)" if nvcc_seconds is None
            else f"nvcc {nvcc_seconds:.2f} s")
    return f"[build] {nvcc}, load {load_seconds:.2f} s"


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def max_abs_err(got, want) -> float:
    """Largest difference over matching output tensors; raises unless they
    are bit-identical (the kernels are exact against their plain versions)."""
    import torch

    err = 0.0
    for g, w in zip(_tuple(got), _tuple(want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        if g.numel():
            err = max(err, float((g.double() - w.double()).abs().max()))
        bits = (lambda t: t.view(torch.int32)) if g.dtype == torch.float32 else (lambda t: t)
        assert torch.equal(bits(g), bits(w)), f"kernel differs from plain version by {err}"
    return err


def capture_kernel_inputs(draw, names):
    """Run draw() eagerly (pipeline.eager(): a frame graph's replay calls no
    wrapper), recording the arguments of every launch of the named kernels
    (the path's real inputs, copied as each launch saw them): name -> list
    of (args, kwargs)."""
    from tpu_renderer_torch import pipeline
    from tpu_renderer_torch.tools.time_stream_kernels import frozen_call

    seen = {n: [] for n in names}
    originals = {n: getattr(kernel_module(n), n) for n in names}

    def recorder(name):
        def call(*args, **kwargs):
            seen[name].append(frozen_call(args, kwargs))
            return originals[name](*args, **kwargs)
        return call

    for n in names:
        setattr(kernel_module(n), n, recorder(n))
    try:
        with pipeline.eager():
            draw()
    finally:
        for n, f in originals.items():
            setattr(kernel_module(n), n, f)
    missing = [n for n in names if not seen[n]]
    assert not missing, f"kernels not reached: {missing}"
    return seen


def _live_entries(bins, counts):
    """(n_tiles, W) mask of the bin slots inside each tile's count."""
    import torch

    n = counts.clamp(max=bins.shape[1])
    return torch.arange(bins.shape[1], device=bins.device)[None, :] < n[:, None]


def _frame_tiles(plane, tiles_x, tiles_y, tile_h=32, tile_w=128):
    """(Hp, Wp) -> (n_tiles, tile_h * tile_w) tile-major (by default the
    default tile's)."""
    return plane.reshape(tiles_y, tile_h, tiles_x, tile_w).transpose(1, 2).reshape(
        tiles_x * tiles_y, -1)


def work_tests(name, args, kwargs, out) -> int:
    """Triangle-pixel tests the function needs on these inputs. Dense bins
    hold chunks: each live 8-triangle group of an entry is 8 tests a
    pixel. Per-triangle bins: one test a live entry and pixel. A peel
    needs, for each pixel, the entries up to the one that holds the layer
    it finds (ids ascend along a bin), and every live entry where it finds
    none; the other kernels (the gathered peel 2.8 among them, whose slots
    need not ascend) test every live entry at every pixel."""
    import torch

    from tpu_renderer_torch.kernels import raster

    table, bins, counts = args[0], args[1], args[2]
    live = _live_entries(bins, counts)
    if name in CHUNK_BIN_KERNELS:
        key = bins >> raster.entry_shift(raster.CHUNK // raster.GROUP)   # chunk id
        live &= (bins >= 0) & (key < table.shape[0] // raster.CHUNK)
        work = sum(((bins >> g) & 1) for g in range(raster.CHUNK // raster.GROUP)) * raster.GROUP
        per_id = raster.CHUNK
    else:
        key = bins
        live &= (bins >= 0) & (bins < table.shape[0])
        work = torch.ones_like(bins)
        per_id = 1
    work = work * live
    if name not in EARLY_EXIT_PEELS:
        return int(work.sum()) * kwargs["tile_h"] * kwargs["tile_w"]
    layer = _frame_tiles(_tuple(out)[0], kwargs["tiles_x"], kwargs["tiles_y"],
                         kwargs["tile_h"], kwargs["tile_w"])
    stop = torch.where(layer < raster.ID_INF, layer // per_id, raster.ID_INF)
    key, order = torch.where(live, key, torch.iinfo(torch.int32).max).sort(dim=1)
    done = torch.cat([torch.zeros_like(work[:, :1]), work.gather(1, order).cumsum(dim=1)], dim=1)
    return int(done.gather(1, torch.searchsorted(key, stop, right=True)).sum())


def bound(name, args, kwargs, out):
    """(bound_ms, bound_by): the larger of the operations at the fp32 peak
    and the bytes at the HBM rate: every input read once, of the bins only
    the live entries, every output written once."""
    import torch

    flops = work_tests(name, args, kwargs, out) * FLOPS_PER_TEST
    if name in ACCUM_KERNELS:
        flops += int(out[1].sum()) * FLOPS_PER_FRAGMENT
    bins, counts = args[1], args[2]
    tensors = [a for a in args if isinstance(a, torch.Tensor) and a is not bins] + list(_tuple(out))
    nbytes = (sum(t.numel() * t.element_size() for t in tensors)
              + int(counts.clamp(max=bins.shape[1]).sum()) * bins.element_size())
    alu_ms, hbm_ms = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (alu_ms, "operations") if alu_ms >= hbm_ms else (hbm_ms, "bytes")


def check_kernel(name, calls, label):
    """Hold the kernel against its plain version on each captured call,
    then time the kernel on the first; the plain version's time is its
    call on the first, in the check. Returns the kernel's JSON entry."""
    import torch

    from tpu_renderer_torch.kernels import raster
    from tpu_renderer_torch.utils.timing import device_ms, event_ms, host_ms

    kernel = getattr(raster, name)
    _, plain_name, _, source, replaces = KERNELS[name]
    plain = getattr(raster, plain_name)
    err, plain_ms = 0.0, None
    for i, (args, kwargs) in calls:
        got = kernel(*args, **kwargs)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(*args, **kwargs)
        end.record()
        end.synchronize()
        if plain_ms is None:
            plain_ms = start.elapsed_time(end)
        err = max(err, max_abs_err(got, want))
        bins, counts = args[1], args[2]
        print(f"[kernel] {name} ({label}, call {i}): bins {tuple(bins.shape)}, "
              f"entries {int(counts.clamp(max=bins.shape[1]).sum())}, max/tile "
              f"{int(counts.max())}; exact vs plain (max_abs_err {err})", flush=True)
    args, kwargs = calls[0][1]
    out = kernel(*args, **kwargs)
    bound_ms, bound_by = bound(name, args, kwargs, out)
    fn = lambda: kernel(*args, **kwargs)  # noqa: E731
    ms = event_ms(fn, runs=20)
    device = device_ms(fn)
    host = host_ms(fn)
    print(f"[kernel] {name}: {ms:.4f} ms (median of 20), device {device:.4f} ms (a graph of "
          f"50), host {host:.4f} ms a call, plain {plain_ms:.2f} ms (one call), bound "
          f"{bound_ms:.4f} ms by {bound_by} ({bound_ms / device:.1%} of the device time)",
          flush=True)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, device_ms=device, host_ms=host)


def device_kernels(calls) -> dict:
    """Kernels the device ran in the wrapper calls `calls`, a list of
    (kernel name, (args, kwargs)), made in one torch.profiler session (a
    later session in the same process recorded no device event on the
    card). Returns name -> (the wrapper's launches by its counter over its
    calls, the device kernels of that name), and "all" -> every device
    kernel of the session."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_renderer_torch.kernels import raster

    launches = {name: 0 for name, _ in calls}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for name, (args, kwargs) in calls:
            counter = getattr(raster, KERNELS[name][2])
            before = counter.launches
            getattr(raster, name)(*args, **kwargs)
            launches[name] += counter.launches - before
        torch.cuda.synchronize()
    events = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {n: (k, sum(1 for e in events if DEVICE_NAMES.get(n, n) in e))
           for n, k in launches.items()}
    out["all"] = len(events)
    return out


def peel_segments(name, bins, counts):
    """The segments peel kernel `name` (2.3, 2.5 or 2.8) cuts each tile's
    entries into."""
    from tpu_renderer_torch.kernels import raster

    seg_min = raster.PEEL_SEG_MIN if name == "raster_peel_fused_kernel" else raster.DEFERRED_SEG_MIN
    return raster.peel_segments(counts, bins.shape[1], seg_min)


def tile_split(name, bins, counts):
    """(blocks a tile, the segments each tile's entries are cut into) of a
    kernel that spreads a tile over a cluster: 2.1, 2.3-2.6, 2.8."""
    from tpu_renderer_torch.kernels import raster

    if name == "raster_fused_kernel":
        return raster.FUSED_SPLIT, raster.fused_segments(counts, bins.shape[1])
    if name in VIS_KERNELS:
        return raster.VIS_SPLIT, raster.vis_segments(counts, bins.shape[1])
    return raster.PEEL_SPLIT, peel_segments(name, bins, counts)


def decomposition(name, args, kwargs, launched, label="") -> str:
    """How kernel 2.1-2.8 spread this call's work: launched is its (wrapper
    launches, device kernels) for one call (device_kernels); the blocks,
    and the busiest tile's entries and live groups (per-triangle bins: live
    entries), and the segments it is cut into (the peels over per-triangle
    bins: how many ascend). label follows the name."""
    import torch

    from tpu_renderer_torch.kernels import raster

    launches, kernels = launched
    assert launches == 1 and kernels == 1, (name, launches, kernels)
    table, bins, counts = args[0], args[1], args[2]
    live = _live_entries(bins, counts) & (bins >= 0)
    if name in CHUNK_BIN_KERNELS:
        live &= (bins >> raster.entry_shift(raster.CHUNK // raster.GROUP)) \
            < table.shape[0] // raster.CHUNK
        work = sum(((bins >> g) & 1) for g in range(raster.CHUNK // raster.GROUP)) * live
        unit = "live groups"
    else:
        live &= bins < table.shape[0]
        work = live.to(torch.int64)
        unit = "live entries"
    busiest = int(work.sum(1).argmax())
    n_tiles = bins.shape[0]
    line = (f"[split] {name}{label}: {launches} launch a call ({kernels} device kernel); busiest "
            f"tile {int(counts[busiest])} entries, {int(work[busiest].sum())} {unit}")
    if name in ACCUM_KERNELS:
        split = raster.accum_split(kwargs["tile_w"])
        blocks = (f"{n_tiles * split} blocks ({split} 32-column strips a tile)"
                  if name == "raster_accum_kernel" else
                  f"{n_tiles * raster.gathered_accum_blocks(kwargs['tile_h'], kwargs['tile_w'])} "
                  f"blocks (one a 32x8 region)")
        return (f"{line}; {blocks}, each walking its tile's whole list; "
                f"{int(torch.count_nonzero(live))} live entries")
    split, segs = tile_split(name, bins, counts)
    n = int(counts[busiest].clamp(0, bins.shape[1]))
    s = int(segs[busiest])
    seg_work = [int(work[busiest, b:e].sum())
                for b, e in (raster.segment_bounds(n, s, q) for q in range(s))]
    line = (f"{line}; {n_tiles * split} blocks in {n_tiles} clusters of {split}, "
            f"{int(segs.sum())} segments walked, the busiest tile's {s} segments holding "
            f"{seg_work} {unit}")
    if name in TRIANGLE_PEELS:
        line += f"; {ascending_segments(bins, counts, segs)} of them ascend (keys_ascend)"
    return line


def ascending_segments(bins, counts, segs) -> int:
    """How many of the segments of per-triangle bins a peel cuts (segs a
    tile) hold strictly ascending ids, as keys_ascend checks them: the
    segments whose walk may stop early."""
    from tpu_renderer_torch.kernels import raster

    n = counts.clamp(0, bins.shape[1]).tolist()
    rows = bins.cpu()
    out = 0
    for tile, s in enumerate(segs.tolist()):
        for q in range(s):
            b, e = raster.segment_bounds(n[tile], s, q)
            ids = rows[tile, b:e]
            out += bool((ids[1:] > ids[:-1]).all())
    return out


def _counters():
    """name -> launch counter, of each kernel and of TWO_TAP."""
    out = {n: getattr(kernel_module(n), c) for n, (_, _, c, _, _) in KERNELS.items()}
    out[TWO_TAP] = kernel_module("shade_fused_kernel").trilinear_counter
    return out


def reset_counters():
    for counter in _counters().values():
        counter.reset()


def read_counters():
    """Each kernel's and TWO_TAP's launches since reset_counters(): the
    wrappers' host counts, the launches graph replays added, and those
    counted on the card inside the graphs' peel loops (a sync)."""
    return {n: c.total() for n, c in _counters().items()}


def counted_frames(eng, n, path, expect):
    """The path as a user runs it (graphed: frame_graph.py), counted:
    counters to 0, one draw() and n timed draw_device() frames, counters
    read. Returns (median ms, image, layers per frame, host syncs per frame
    inside draw_device(), launches)."""
    import torch

    from tpu_renderer_torch.utils.bench_frame import SyncCount

    reset_counters()
    image = eng.draw()
    times, layers, syncs = [], [], 0
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with SyncCount() as sync:
            _img, aux = eng.draw_device()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
        syncs += sync.calls
        layers.append(int(aux.get("transparent_layers", torch.zeros(()))))
    launches = read_counters()
    for k in expect:
        assert launches[k] > 0, f"{k} was never launched on the {path} path"
    med = statistics.median(times)
    print(f"[frame] {path} (graphed): {eng.stats.triangle_count} tris, median {med:.3f} ms "
          f"over {n} frames (min {min(times):.3f}); transparent layers {layers}; "
          f"{syncs / n:.1f} host syncs a frame; launches {launches}", flush=True)
    return med, image, layers, syncs / n, launches


def _no_replay(*args, **kwargs):
    raise AssertionError("a frame graph replayed inside plain_versions: the check "
                         "would compare the graph's kernels with themselves")


def _as_launcher(name):
    """Kernel `name`'s plain version, called as its launcher is: a
    background launcher takes the tile its extent is whole tiles of, which
    the plain version, at any extent, does not."""
    plain = getattr(kernel_module(name), KERNELS[name][1])
    if name not in BACKGROUND_KERNELS:
        return plain

    def call(*args, tile_h=None, tile_w=None, **kwargs):
        return plain(*args, **kwargs)
    return call


@contextlib.contextmanager
def plain_versions(names):
    """Inside the block the named kernels are their plain versions, and
    frames draw eagerly (pipeline.eager()); a frame graph's replay raises
    (it would launch the captured kernels, not the plain versions)."""
    from tpu_renderer_torch import frame_graph, pipeline

    originals = {n: getattr(kernel_module(n), n) for n in names}
    replay = frame_graph.FrameGraph.replay
    for n in names:
        setattr(kernel_module(n), n, _as_launcher(n))
    frame_graph.FrameGraph.replay = _no_replay
    try:
        with pipeline.eager():
            yield
    finally:
        frame_graph.FrameGraph.replay = replay
        for n, f in originals.items():
            setattr(kernel_module(n), n, f)


def plain_frame(eng, names):
    """The same frame with the named kernels replaced by their plain
    versions; must equal the kernel frame."""
    with plain_versions(names):
        return eng.draw()


def shade_bound(args, kwargs):
    """(bound_ms, bytes) of a kernel 2.12 call: the bytes at the HBM rate.
    Read once: the planes of each pixel it shades (attrs, meta and inv, 20
    f32 a pixel, textured; light and rgb, 4, untextured), in the epilogue
    form only the pixels hit, and the atlas; the epilogue form also reads
    the hit byte and the framebuffer's 4 f32 of every pixel and writes 4;
    the rgb form writes 3."""
    attrs, atlas, textured = args[0], args[3], args[6]
    n = attrs.shape[1] * attrs.shape[2]
    plane = 4 * (20 if textured else 4)
    nbytes = atlas.quads.numel() * atlas.quads.element_size()
    if kwargs.get("blend") is None:
        nbytes += n * (plane + 12)
    else:
        nbytes += int(kwargs["hit"].sum()) * plane + n * (1 + 16 + 16)
    return nbytes / PEAK_BYTES * 1e3, nbytes


def check_shade(calls, label):
    """Kernel 2.12 against its plain version on each captured call (out
    left to each, so the two write apart), then timed on the first as
    check_kernel times the raster kernels. Returns its JSON entry."""
    import torch

    from tpu_renderer_torch.kernels import shade
    from tpu_renderer_torch.utils.timing import device_ms, event_ms, host_ms

    name = "shade_fused_kernel"
    _, _, _, source, replaces = KERNELS[name]
    err, plain_ms = 0.0, None
    for i, (args, kwargs) in calls:
        kwargs = dict(kwargs, out=None)
        got = shade.shade_fused_kernel(*args, **kwargs)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = shade.shade_fused_plain(*args, **kwargs)
        end.record()
        end.synchronize()
        if plain_ms is None:
            plain_ms = start.elapsed_time(end)
        err = max(err, max_abs_err(got, want))
        print(f"[kernel] {name} ({label}, call {i}): blend {kwargs.get('blend')}, textured "
              f"{args[6]}, trilinear {args[7]}, pot {args[8]}; exact vs plain (max_abs_err "
              f"{err})", flush=True)
    args, kwargs = calls[0][1]
    kwargs = dict(kwargs, out=None)
    fn = lambda: shade.shade_fused_kernel(*args, **kwargs)  # noqa: E731
    ms = event_ms(fn, runs=20)
    device = device_ms(fn)
    host = host_ms(fn)
    bound_ms, nbytes = shade_bound(args, kwargs)
    n = args[0].shape[1] * args[0].shape[2]
    hit = int(kwargs["hit"].sum()) if kwargs.get("hit") is not None else n
    print(f"[kernel] {name} ({label}): {hit} of {n} pixels shaded; {ms:.4f} ms (median of "
          f"20), device {device:.4f} ms (a graph of 50), host {host:.4f} ms a call, plain "
          f"{plain_ms:.2f} ms (one call), bound {bound_ms:.4f} ms by bytes ({nbytes} B; "
          f"{bound_ms / device:.1%} of the device time)", flush=True)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None, device_ms=device, host_ms=host,
                pixels_shaded=hit, label=label)


def setup_bound(args):
    """(bound_ms, bytes) of a kernel 2.13 call: the bytes at the HBM rate.
    Read once: a triangle's 160 B of corners (CornerData), its draw id and
    flag, each draw's transform and visibility, viewproj and the sun;
    written once: its 192 B fat row, 16 B box and 1 B flag."""
    corners, draw_model = args[0], args[3]
    n_tris, n_draws = corners.pos.shape[0], draw_model.shape[0]
    nbytes = n_tris * (160 + 4 + 1 + 192 + 16 + 1) + n_draws * (64 + 1) + 64 + 12
    return nbytes / PEAK_BYTES * 1e3, nbytes


def check_setup(args, kwargs, label):
    """Kernel 2.13 against its plain version on a captured call, then timed
    as check_shade times 2.12. Returns its JSON entry."""
    import torch

    from tpu_renderer_torch.kernels import vertex
    from tpu_renderer_torch.utils.timing import device_ms, event_ms, host_ms

    name = "triangle_setup_rows_kernel"
    _, _, _, source, replaces = KERNELS[name]
    got = vertex.triangle_setup_rows_kernel(*args, **kwargs)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = vertex.triangle_setup_rows_plain(*args, **kwargs)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = max_abs_err(got, want)
    fn = lambda: vertex.triangle_setup_rows_kernel(*args, **kwargs)  # noqa: E731
    ms = event_ms(fn, runs=20)
    device = device_ms(fn)
    host = host_ms(fn)
    bound_ms, nbytes = setup_bound(args)
    n = args[0].pos.shape[0]
    live = int(got[2].sum())
    print(f"[kernel] {name} ({label}): {n} triangles ({live} live), exact vs plain "
          f"(max_abs_err {err}); {ms:.4f} ms (median of 20), device {device:.4f} ms (a graph "
          f"of 50), host {host:.4f} ms a call, plain {plain_ms:.2f} ms (one call), bound "
          f"{bound_ms:.4f} ms by bytes ({nbytes} B; {bound_ms / device:.1%} of the device "
          f"time)", flush=True)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None, device_ms=device, host_ms=host,
                triangles=n, live=live, label=label)


def bench_path(eng, results, inputs):
    """Phase 3: the bench frame (kernels 2.1, 2.2, 2.12, the opaque shade,
    and 2.13, the setup). inputs keeps 2.1's and 2.2's calls, and 2.2's as
    2.7 takes it, for phases 5b and 11."""
    from tpu_renderer_torch.tools.time_stream_kernels import oracle_call

    raster_names = ("raster_fused_kernel", "raster_accum_kernel")
    setup_name = "triangle_setup_rows_kernel"
    names = (*raster_names, "shade_fused_kernel", setup_name)
    seen = capture_kernel_inputs(eng.draw_device, names)
    for n in raster_names:
        results[n] = check_kernel(n, [(0, seen[n][-1])], "bench frame")
        inputs[n] = seen[n][-1]
    assert len(seen["shade_fused_kernel"]) == 1, "one shade launch a bench frame"
    results["shade_fused_kernel"] = check_shade([(0, seen["shade_fused_kernel"][0])],
                                                "bench frame, opaque planes")
    assert len(seen[setup_name]) == 1, "one setup launch a bench frame"
    results[setup_name] = check_setup(*seen[setup_name][0],
                                      "bench frame, opaque ++ transparent")
    inputs["raster_accum_gathered_kernel"] = oracle_call(inputs["raster_accum_kernel"])
    frame_ms, image, _, _, launches = counted_frames(eng, 20, "bench frame", names)
    assert np.array_equal(image, plain_frame(eng, names)), "kernel frame differs from plain frame"
    print(f"[frame] bench frame == plain-version frame; frame ms {frame_ms:.3f}", flush=True)
    for n in names:
        results[n]["launches"] = launches[n]


def stress_path(scene_path):
    """Phase 3b: kernels 2.1 and 2.2 on the stress frame (the bench's
    stress variant: grid 128, about 4x the entries), each against its plain
    version once and timed."""
    from tpu_renderer_torch.kernels import raster
    from tpu_renderer_torch.utils.timing import device_ms, event_ms
    from tpu_renderer_torch.utils.bench_frame import BENCH, bench_engine

    grid = 2 * BENCH["grid"]
    t0 = time.perf_counter()
    eng = bench_engine(scene_path, grid=grid, camera_position=(0.0, 6.0, 2.0 * grid))
    print(f"[scene] stress scene (grid {grid}) ready in {time.perf_counter() - t0:.2f} s",
          flush=True)
    names = ("raster_fused_kernel", "raster_accum_kernel")
    seen = capture_kernel_inputs(eng.draw_device, names)
    for n in names:
        args, kwargs = seen[n][-1]
        kernel, plain = getattr(raster, n), getattr(raster, KERNELS[n][1])
        err = max_abs_err(kernel(*args, **kwargs), plain(*args, **kwargs))
        ms = event_ms(lambda: kernel(*args, **kwargs), runs=20)
        device = device_ms(lambda: kernel(*args, **kwargs))
        bound_ms, bound_by = bound(n, args, kwargs, kernel(*args, **kwargs))
        bins, counts = args[1], args[2]
        print(f"[kernel] {n} (stress frame): bins {tuple(bins.shape)}, entries "
              f"{int(counts.clamp(max=bins.shape[1]).sum())}, max/tile {int(counts.max())}; "
              f"exact vs plain (max_abs_err {err}); {ms:.4f} ms (median of 20), device "
              f"{device:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}", flush=True)
        print(decomposition(n, args, kwargs, (1, 1)), flush=True)


def hazard_path():
    """Phase 3c: kernels 2.1-2.8 on the adversarial rows of
    utils/hazards.py (equal-z copies across every segment boundary, -0.0
    and +0.0 depth ties, edges on region borders that only the reject's
    rounding margin keeps, full-screen and dead rows; for the peels an
    opaque depth equal to the fragments' depths, and per-triangle bins over
    the packed rows for 2.5): one tile of 64 entries, cut 8 ways by 2.1,
    2.3, 2.5 and 2.8, and 2x2 tiles; exact against the plain versions, the
    peels over three peels on the ascending and on the reversed bins. 2.7
    and 2.8 over every member of each binned chunk with -1 holes; 2.7 on
    rows at negative depths over a negative opaque depth (hazard_accum_rows,
    hazard_accum_z_base), in slot order and reversed. 2.4 and 2.6 on the
    visibility hazard rows (hazard_vis_rows: depths past 1, NaN and
    infinite coefficients besides) over the same tiles, ascending and
    reversed, and on hazard_fold_bin's segments."""
    import torch

    from tpu_renderer_torch.kernels import raster
    from tpu_renderer_torch.utils import hazards

    dev = torch.device("cuda")
    light = torch.tensor([0.2, 0.8, 0.5, 1.0, 0.1, 0.15, 0.2, 0.0], device=dev)
    for n_chunks, tx, ty in ((64, 1, 1), (48, 2, 2)):
        tiles = dict(tiles_x=tx, tiles_y=ty, tile_w=128, tile_h=32)
        w, h = 128 * tx, 32 * ty
        rows_np = hazards.hazard_rows(n_chunks, w, h, seed=n_chunks)
        box, valid = (torch.from_numpy(a).to(dev) for a in hazards.hazard_boxes(rows_np))
        caabb, cvalid = raster.chunk_aabbs(box, valid)
        gaabb, gvalid = raster.group_aabbs(box, valid)
        bins, counts = raster.bin_triangles_full(caabb, cvalid, gaabb, gvalid, **tiles)
        rows = torch.from_numpy(rows_np).to(dev)
        z_base = torch.from_numpy(hazards.hazard_z_base(w, h)).to(dev)
        fused = raster.raster_fused_kernel(rows, bins, counts, **tiles)
        err = max_abs_err(fused, raster.rasterize_fused_plain(rows, bins, counts, **tiles))
        z, tid = fused[:2]
        zero = (z == 0) & (tid >= 0)
        signs = (int((zero & torch.signbit(z)).sum()), int((zero & ~torch.signbit(z)).sum()))
        acc = raster.raster_accum_kernel(rows, bins, counts, z_base, light, **tiles)
        err = max(err, max_abs_err(
            acc, raster.rasterize_accum_plain(rows, bins, counts, z_base, light, **tiles)))
        segs = raster.fused_segments(counts, bins.shape[1])
        print(f"[hazards] {tx}x{ty} tiles, {n_chunks} chunks, entries a tile "
              f"{counts.tolist()}, 2.1 segments {segs.tolist()}: 2.1 and 2.2 exact vs "
              f"plain (max_abs_err {err}); zero-depth winners -0.0 / +0.0: {signs}; "
              f"fragments summed {int(acc[1].sum())}", flush=True)

        # 2.7 over per-triangle bins of every member of each binned chunk,
        # with -1 holes, in slot order and each tile's reversed, on
        # hazard_accum_rows (the same triangles, rows 5 and 6 of each chunk
        # at negative depths) under hazard_accum_z_base (2.2's opaque depth
        # with a negative right half, where only 0 <= z drops them)
        name = "raster_accum_gathered_kernel"
        kernel, plain = getattr(raster, name), getattr(raster, KERNELS[name][1])
        hbins, hcounts = holed_bins(bins, counts)
        arows = torch.from_numpy(hazards.hazard_accum_rows(n_chunks, w, h, seed=n_chunks)).to(dev)
        z_neg = torch.from_numpy(hazards.hazard_accum_z_base(w, h)).to(dev)
        summed = []
        for b in (hbins, reversed_bins(hbins, hcounts)):
            want = plain(arows, b, hcounts, z_neg, light, **tiles)
            err = max(err, max_abs_err(kernel(arows, b, hcounts, z_neg, light, **tiles), want))
            summed.append(int(want[1].sum()))
        X, Y = raster._frame_planes(h, w, dev)
        cov, zv = raster._coverage(torch.cat([arows[5::32], arows[6::32]])[:, :, None, None], X, Y)
        negative = int((cov & (zv < 0.0) & (zv >= z_neg)).sum())
        assert negative > 0
        print(f"[hazards] {tx}x{ty} tiles: {name}, entries a tile {hcounts.tolist()} with "
              f"{int((hbins < 0).sum())} -1 holes: the slot-order and the reversed bins exact vs "
              f"plain (max_abs_err {err}); fragments summed {summed}; fragments at a negative "
              f"depth over the negative opaque depth, which only 0 <= z drops: {negative}",
              flush=True)

        # the peels 2.3 and 2.5 on the same triangles, three peels with
        # `last` fed back, the bins ascending and each tile's reversed
        z_peel = torch.from_numpy(hazards.hazard_peel_z_base(w, h)).to(dev)
        tbins, tcounts, _ = raster.bin_triangles(box, valid, bin_cap=rows.shape[0], **tiles)
        packed = torch.from_numpy(hazards.hazard_packed(rows_np)).to(dev)
        peels = (("raster_peel_fused_kernel", rows, bins, counts),
                 ("raster_peel_kernel", packed, tbins, tcounts),
                 ("raster_peel_gathered_kernel", rows, hbins, hcounts))
        for name, table, pbins, pcounts in peels:
            kernel, plain = getattr(raster, name), getattr(raster, KERNELS[name][1])
            seg = peel_segments(name, pbins, pcounts)
            rev = reversed_bins(pbins, pcounts)
            last = torch.full((h, w), -1, dtype=torch.int32, device=dev)
            found = []
            for _ in range(3):
                # the plain version's layer is a min, the same in any bin
                # order: the kernel must give it on both orders
                want = plain(table, pbins, pcounts, z_peel, last, **tiles)
                for b in (pbins, rev):
                    err = max(err, max_abs_err(kernel(table, b, pcounts, z_peel, last, **tiles),
                                               want))
                layer = _tuple(want)[0]
                found.append(int((layer < raster.ID_INF).sum()))
                last = torch.where(layer < raster.ID_INF, layer, raster.ID_INF)
            assert min(found) > 0, found
            holes = f" with {int((pbins < 0).sum())} -1 holes" if pbins is hbins else ""
            asc = (f" ({ascending_segments(pbins, pcounts, seg)} ascending)"
                   if name in TRIANGLE_PEELS else "")
            print(f"[hazards] {tx}x{ty} tiles: {name}, entries a tile {pcounts.tolist()}{holes}, "
                  f"segments {seg.tolist()}{asc}: 3 peels on the ascending and the reversed bins "
                  f"exact vs plain (max_abs_err {err}); pixels with a layer {found}",
                  flush=True)

        # the visibility walks 2.4 and 2.6 on the visibility hazard rows,
        # the bins ascending and each tile's reversed
        vrows = hazards.hazard_vis_rows(n_chunks, w, h, seed=n_chunks)
        vbox, vvalid = (torch.from_numpy(a).to(dev) for a in hazards.hazard_boxes(vrows))
        vbins, vcounts, _ = raster.bin_triangles(vbox, vvalid, bin_cap=vrows.shape[0], **tiles)
        for name in VIS_KERNELS:
            table = torch.from_numpy(vis_table(name, vrows)).to(dev)
            kernel, plain = getattr(raster, name), getattr(raster, KERNELS[name][1])
            won = []
            for b in (vbins, reversed_bins(vbins, vcounts)):
                want = plain(table, b, vcounts, **tiles)
                err = max(err, max_abs_err(kernel(table, b, vcounts, **tiles), want))
                won.append(int((want[1] >= 0).sum()))
            print(f"[hazards] {tx}x{ty} tiles: {name}, entries a tile {vcounts.tolist()}, "
                  f"segments {raster.vis_segments(vcounts, vbins.shape[1]).tolist()}: the "
                  f"ascending and the reversed bins exact vs plain (max_abs_err {err}); pixels "
                  f"won {won}", flush=True)

    # segments with no winner beside zero-depth winners of either sign
    tiles = dict(tiles_x=1, tiles_y=1, tile_w=128, tile_h=32)
    vrows = hazards.hazard_vis_rows(3, 128, 32)
    fold = torch.from_numpy(hazards.hazard_fold_bin(3, raster.VIS_SEG_MIN)).to(dev)
    fcounts = torch.tensor([fold.shape[1]], dtype=torch.int32, device=dev)
    for name in VIS_KERNELS:
        table = torch.from_numpy(vis_table(name, vrows)).to(dev)
        kernel, plain = getattr(raster, name), getattr(raster, KERNELS[name][1])
        for b in (fold, fold.flip(1).contiguous()):
            err = max(err, max_abs_err(kernel(table, b, fcounts, **tiles),
                                       plain(table, b, fcounts, **tiles)))
        z, tid = kernel(table, fold, fcounts, **tiles)[:2]
        assert (tid[:, :64] == 22).all() and (tid[:, 64:] == 15).all()
        assert not torch.signbit(z[:, :64]).any() and torch.signbit(z[:, 64:]).all()
        print(f"[hazards] {name} on the fold bin (4 segments: none, a -0.0 winner, none, a "
              f"+0.0 winner), in order and reversed: exact vs plain (max_abs_err {err}); in "
              f"order +0.0 on the left half, -0.0 on the right", flush=True)


def holed_bins(dense_bins, counts):
    """Per-triangle bins of every member of each binned chunk, with -1
    holes: hazards.hazard_holes over the chunk ids, then raster.expand_bins
    (each hole a chunk's CHUNK entries inside the count)."""
    import torch

    from tpu_renderer_torch.kernels import raster
    from tpu_renderer_torch.utils import hazards

    n = counts.clamp(0, dense_bins.shape[1])
    live = _live_entries(dense_bins, n)
    shift = raster.entry_shift(raster.CHUNK // raster.GROUP)
    cbins = torch.where(live, dense_bins >> shift, raster.NO_TRI).cpu().numpy()
    holed = torch.from_numpy(hazards.hazard_holes(cbins, n.cpu().numpy()))
    return raster.expand_bins(holed.to(dense_bins.device), n)


def vis_table(name, rows):
    """Hazard fat rows as kernel 2.4 (packed setup rows) or 2.6 (fat rows)
    takes them."""
    from tpu_renderer_torch.utils import hazards

    return hazards.hazard_packed(rows) if name == "raster_deferred_kernel" else rows


def reversed_bins(bins, counts):
    """Each tile's entries inside its count in reverse order."""
    import torch

    n = counts.clamp(0, bins.shape[1])
    k = torch.arange(bins.shape[1], device=bins.device)[None, :]
    return bins.gather(1, torch.where(k < n[:, None], n[:, None] - 1 - k, k)).contiguous()


def textured_glass_path(scene_path, results, inputs):
    """Phase 4: the textured-glass bench frame (kernel 2.3's peel loop).
    inputs keeps the first peel's call, and the same as 2.8 takes it, for
    phases 5b and 11."""
    from tpu_renderer_torch.scene import load_scene
    from tpu_renderer_torch.tools.time_stream_kernels import oracle_call
    from tpu_renderer_torch.utils.bench_frame import bench_engine, texture_the_glass

    t0 = time.perf_counter()
    eng = bench_engine(scene_path, scene=texture_the_glass(load_scene(scene_path)))
    assert eng._fused and eng._transp_textured()
    print(f"[scene] textured-glass bench scene ready in {time.perf_counter() - t0:.2f} s",
          flush=True)
    name, shade_name = "raster_peel_fused_kernel", "shade_fused_kernel"
    seen = capture_kernel_inputs(eng.draw_device, (name, shade_name))
    calls = seen[name]
    inputs[name] = calls[0]
    inputs["raster_peel_gathered_kernel"] = oracle_call(calls[0])
    later = len(calls) // 2
    results[name] = check_kernel(name, [(0, calls[0]), (later, calls[later])],
                                 "textured-glass frame")
    # the opaque pass's shade, then one a shaded layer (every peel but the last)
    shades = seen[shade_name]
    assert len(shades) == len(calls), (len(shades), len(calls))
    layer = check_shade([(1, shades[1])], "textured-glass frame, first peeled layer")
    results[shade_name]["peel_layer"] = {k: layer[k] for k in (
        "device_ms", "host_ms", "ms", "plain_ms", "bound_ms", "pixels_shaded")}
    frame_ms, image, layers, _, launches = counted_frames(
        eng, 5, "textured-glass frame", ("raster_fused_kernel", name, shade_name))
    assert np.array_equal(image, plain_frame(eng, ("raster_fused_kernel", name, shade_name))), \
        "textured-glass kernel frame differs from plain frame"
    print(f"[frame] textured-glass frame == plain-version frame; frame ms {frame_ms:.3f}, "
          f"{layers[0]} layers, {len(calls)} peel launches a frame, 2.12 launched "
          f"{launches[shade_name]} times over 6 frames", flush=True)
    results[name]["launches"] = launches[name]
    results[shade_name]["peel_layer"]["launches"] = launches[shade_name]


def deferred_path(scene_path, results, inputs):
    """Phase 5: the deferred bench frame (kernels 2.4 and 2.5). inputs
    keeps the frame's fat rows and refined bins for kernel 2.6, and 2.4's
    call and 2.5's first for phase 5b."""
    from tpu_renderer_torch.tools.profile_raster import deferred_inputs
    from tpu_renderer_torch.utils.bench_frame import bench_engine

    eng = bench_engine(scene_path, fused=False)
    assert not eng._fused
    caps0 = dict(eng._caps)
    eng.draw()                             # escalates the caps on overflow
    print(f"[frame] deferred: caps {caps0} -> {eng._caps}", flush=True)
    _, rows48, bins, counts, tiles, _ = deferred_inputs(eng)
    inputs["raster_fused_gathered_kernel"] = ((rows48, bins, counts), tiles)
    names = ("raster_deferred_kernel", "raster_peel_kernel")
    seen = capture_kernel_inputs(eng.draw_device, names)
    results[names[0]] = check_kernel(names[0], [(0, seen[names[0]][0])], "deferred frame")
    inputs[names[0]] = seen[names[0]][0]
    peels = seen[names[1]]
    later = len(peels) // 2
    results[names[1]] = check_kernel(names[1], [(0, peels[0]), (later, peels[later])],
                                     "deferred frame")
    inputs[names[1]] = peels[0]
    frame_ms, image, layers, _, launches = counted_frames(
        eng, 5, "deferred frame", names)
    assert np.array_equal(image, plain_frame(eng, names)), \
        "deferred kernel frame differs from plain frame"
    print(f"[frame] deferred frame == plain-version frame; frame ms {frame_ms:.3f}, "
          f"caps {eng._caps}", flush=True)
    for n in names:
        results[n]["launches"] = launches[n]


def split_phase(inputs):
    """Phase 5b: how kernels 2.1-2.8 spread their frames' work: one
    torch.profiler session runs each once on its frame's inputs (2.1, 2.2
    the bench frame's; 2.3, 2.5 the first peel of the textured-glass and
    the deferred frames; 2.4 the deferred frame's, 2.6 its fat rows and
    bins; 2.7 and 2.8 2.2's and 2.3's, the chunk bins expanded, as phase 11
    runs them), and 2.4 again on the grid=320 frame's (phase 6, which runs
    first); each call is one launch and one device kernel, and nothing
    else runs on the device."""
    names = ("raster_fused_kernel", "raster_accum_kernel", "raster_peel_fused_kernel",
             "raster_peel_kernel", *VIS_KERNELS, "raster_accum_gathered_kernel",
             "raster_peel_gathered_kernel")
    guard = ("raster_deferred_kernel", inputs["past the guard"])
    calls = [(n, inputs[n]) for n in names] + [guard]
    launched = device_kernels(calls)
    assert launched["all"] == len(calls), launched
    for n in names:
        k = sum(1 for name, _ in calls if name == n)
        assert launched[n] == (k, k), (n, launched[n])
        print(decomposition(n, *inputs[n], (1, 1)), flush=True)
    name, (args, kwargs) = guard
    print(decomposition(name, args, kwargs, (1, 1), " (past the guard)"), flush=True)


def past_the_guard(inputs):
    """Phase 6: a scene past dense_bin_max_chunks takes the deferred path
    by itself; kernel 2.4 on its inputs, timed; inputs keeps that call
    for the [split] line of phase 5b."""
    import torch

    from tpu_renderer_torch.utils.timing import device_ms, event_ms
    from tpu_renderer_torch.utils.bench_frame import bench_engine

    path = os.path.join(OUT_DIR, "dense_scene_320.glb")
    t0 = time.perf_counter()
    eng = bench_engine(path, grid=320)
    b = eng.flat.buffers
    print(f"[scene] grid=320 scene: {b.opaque_tri_vidx.shape[0]} opaque + "
          f"{b.transp_tri_vidx.shape[0]} transparent triangle rows, built, loaded "
          f"and flattened in {time.perf_counter() - t0:.2f} s", flush=True)
    assert not eng._fused, "the dense-bin guard did not pick the deferred path"
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = eng.draw()
    ms = (time.perf_counter() - t0) * 1000.0
    launches = read_counters()
    assert launches["raster_deferred_kernel"] > 0, "kernel 2.4 was not launched"
    assert launches["raster_fused_kernel"] == 0
    assert img.shape == (1080, 1920, 4)
    print(f"[frame] past the guard: first draw {ms:.1f} ms (caps escalated to "
          f"{eng._caps}); launches {launches}; frame graphs captured (one a cap "
          f"step): " + ", ".join(f"{c:.1f} ms, pool {m:.1f} MiB"
                                 for c, m in eng.frame_graphs.captured), flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.draw()
    print(f"[frame] past the guard: second draw {(time.perf_counter() - t0) * 1000.0:.1f} ms",
          flush=True)

    # 2.4 on this frame's inputs, timed
    name = "raster_deferred_kernel"
    args, kwargs = inputs["past the guard"] = \
        capture_kernel_inputs(eng.draw_device, (name,))[name][0]
    kernel = getattr(kernel_module(name), name)
    bound_ms, bound_by = bound(name, args, kwargs, kernel(*args, **kwargs))
    ms = event_ms(lambda: kernel(*args, **kwargs), runs=20)
    device = device_ms(lambda: kernel(*args, **kwargs))
    bins, counts = args[1], args[2]
    print(f"[kernel] {name} (past the guard): bins {tuple(bins.shape)}, entries "
          f"{int(counts.clamp(max=bins.shape[1]).sum())}, max/tile {int(counts.max())}; "
          f"{ms:.4f} ms (median of 20), device {device:.4f} ms, bound {bound_ms:.4f} ms by "
          f"{bound_by}; not held to "
          f"the plain version at this size (it walks {bins.shape[1]} slots a tile)",
          flush=True)


def structure_goldens():
    """Phase 7: the structure scene against the JAX package's goldens."""
    from tpu_renderer_torch.config import RendererConfig
    from tpu_renderer_torch.engine import Engine
    from tpu_renderer_torch.present import load_png
    from tpu_renderer_torch.utils.demo import build_structure_glb

    path = os.path.join(OUT_DIR, "structure_golden.glb")
    build_structure_glb(path, seed=0)
    for (w, h), name in (((480, 270), "structure_480p"),
                         ((1920, 1080), "structure_1080p")):
        cfg = RendererConfig(width=w, height=h, background_effect=1,
                             camera_position=(0.0, 10.0, 42.0))
        eng = Engine(cfg)
        eng.camera.pitch = np.float32(-0.18)
        eng.init(scene_path=path)
        img = eng.draw()
        golden = load_png(os.path.join(ROOT, "tests", "goldens", f"{name}.png"))
        diff = np.any(img != golden, axis=-1)
        worst = int(np.abs(img.astype(np.int32) - golden).max())
        print(f"[golden] {name}: {int(diff.sum())} of {diff.size} pixels differ "
              f"({diff.mean():.4%}), largest difference {worst}", flush=True)
        assert diff.mean() <= FRAME_TOL, f"{name} beyond the {FRAME_TOL:.1%} tolerance"


def _pad(w, h):
    return -(-w // 128) * 128, -(-h // 32) * 32


def background_calls(w, h, device):
    """name -> (args, kwargs) of each background kernel at extent w x h."""
    import torch

    wp, hp = _pad(w, h)
    ext = dict(height=h, width_pad=wp, height_pad=hp)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return {
        "background_gradient_kernel": ((f((0.9, 0.3, 0.2, 1.0)), f((0.1, 0.2, 0.7, 0.5))), ext),
        "background_sky_kernel": ((f((0.1, 0.2, 0.4, 0.97)),), ext),
        "background_grid_kernel": ((), dict(width=w, device=device, **ext)),
    }


def background_bound(name, args, out):
    """(bound_ms, bound_by) of a background pass: the buffer written once
    and the inputs read once (the parameters; for the sky its lattice
    cosines, wp + 1 and hp + 1) at the HBM rate, against its float
    operations at the fp32 peak."""
    hp, wp = out.shape[1:]
    nbytes = out.numel() * out.element_size() + sum(a.numel() * 4 for a in args)
    if name == "background_sky_kernel":
        nbytes += (wp + 1 + hp + 1) * 4
    alu_ms = hp * wp * BACKGROUND_FLOPS_PER_PIXEL[name] / PEAK_FLOPS * 1e3
    hbm_ms = nbytes / PEAK_BYTES * 1e3
    return (alu_ms, "operations") if alu_ms >= hbm_ms else (hbm_ms, "bytes")


def background_phase(results):
    """Phase 8: kernels 2.9-2.11 against their plain versions at three
    extents, timed at the last."""
    import torch

    from tpu_renderer_torch.kernels import background
    from tpu_renderer_torch.present import to_packed_u32, unpack_u8
    from tpu_renderer_torch.tools.time_background import lerp_operands, readings
    from tpu_renderer_torch.utils.timing import batched_ms

    dev = torch.device("cuda")
    for name in BACKGROUND_KERNELS:
        mod = kernel_module(name)
        _, plain_name, _, source, replaces = KERNELS[name]
        kernel, plain = getattr(mod, name), getattr(mod, plain_name)
        err = 0.0
        for w, h in BACKGROUND_EXTENTS:
            args, kwargs = background_calls(w, h, dev)[name]
            got, want = kernel(*args, **kwargs), plain(*args, **kwargs)
            torch.cuda.synchronize()
            assert got.shape == (4, *_pad(w, h)[::-1])
            err = max(err, max_abs_err(got, want))
            print(f"[kernel] {name} ({w}x{h}, buffer {tuple(got.shape)}): exact vs plain "
                  f"(max_abs_err {err})", flush=True)
        out = got
        bound_ms, bound_by = background_bound(name, args, out)
        plain_ms = batched_ms(lambda: plain(*args, **kwargs), launches=10, warmup=3)
        sides = {"kernel": lambda: kernel(*args, **kwargs)}
        order = ("kernel",) * 4
        if name == "background_gradient_kernel":
            # one torch.lerp over the broadcast row blend computes the same mix
            hp, wp = out.shape[1:]
            a, b, t = lerp_operands(*args, kwargs["height"], wp, hp)
            assert float((torch.lerp(a, b, t) - out).abs().max()) < 1e-6
            sides["torch.lerp"] = lambda: torch.lerp(a, b, t)
            order = ("kernel", "torch.lerp", "torch.lerp", "kernel") * 2
        # four rounds a side, in turns; three readings a round
        turns = {side: [] for side in sides}
        for side in order:
            turns[side].append(readings(sides[side], launches=50))
        med = {side: {k: statistics.median(r[k] for r in rounds) for k in rounds[0]}
               for side, rounds in turns.items()}
        for side, rounds in turns.items():
            print(f"[kernel] {name} at 1920x1080, {side} in turns (ms; device: a graph of 50 "
                  f"launches, host: a call, batched: 50 calls between events): "
                  + "; ".join(f"{k} {[round(r[k], 4) for r in rounds]}" for k in rounds[0]),
                  flush=True)
        lerp = med.get("torch.lerp")
        m = med["kernel"]
        print(f"[kernel] {name}: device {m['device_ms']:.4f} ms a launch "
              f"({bound_ms / m['device_ms']:.1%} of its bound), host {m['host_ms']:.4f} ms a "
              f"call, batched {m['batched_ms']:.4f} ms (medians of 4 rounds), plain "
              f"{plain_ms:.4f} ms (5 batches of 10), bound "
              f"{bound_ms:.4f} ms by {bound_by}, library "
              + ("none" if lerp is None else
                 f"torch.lerp device {lerp['device_ms']:.4f} / host {lerp['host_ms']:.4f} / "
                 f"batched {lerp['batched_ms']:.4f} ms"), flush=True)
        results[name] = dict(name=name, route="cuda", source=source, replaces=replaces,
                             max_abs_err=err, ms=m["batched_ms"], plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=None if lerp is None else lerp["batched_ms"],
                             device_ms=m["device_ms"], host_ms=m["host_ms"])
        if lerp is not None:
            results[name]["library_device_ms"] = lerp["device_ms"]

    # could the card take the lattice cosines itself? Its cos against the
    # C library's, on every lattice value of each extent
    for w, h in BACKGROUND_EXTENTS:
        wp, hp = _pad(w, h)
        tables = background._sky_tables(hp, wp, dev)
        wrong = 0
        for n, offset, freq, (c0, c1) in ((wp, 0.2, 37.0, tables[:2]),
                                          (hp, -0.06, 57.0, tables[2:])):
            i0 = torch.floor(torch.arange(n, dtype=torch.float32, device=dev) + offset)
            wrong += int((torch.cos(i0 * freq) != c0).sum())
            wrong += int((torch.cos((i0 + 1.0) * freq) != c1).sum())
        print(f"[kernel] sky lattice at {w}x{h}: the card's cos differs from the C "
              f"library's cosf on {wrong} of {2 * wp + 2 * hp} values (the kernel "
              f"reads the host's)", flush=True)

    # 2.11 is loaded by no engine: drive it through its public function into
    # a frame, counted, and hold the frame to the plain version's
    reset_counters()
    w, h = BACKGROUND_EXTENTS[1]
    wp, hp = _pad(w, h)
    ext = dict(height=h, width=w, width_pad=wp, height_pad=hp)
    frame = unpack_u8(to_packed_u32(background.grid_gradient(device=dev, **ext),
                                    width=w, height=h))
    launches = read_counters()["background_grid_kernel"]
    want = unpack_u8(to_packed_u32(background.grid_gradient_plain(device=dev, **ext),
                                   width=w, height=h))
    assert launches == 1 and np.array_equal(frame, want)
    assert frame.shape == (h, w, 4) and not frame[:, ::16, :3].any() \
        and not frame[::16, :, :3].any() and frame[h - 1, w - 1, 0] > 250
    print(f"[frame] grid gradient {w}x{h} through background.grid_gradient: "
          f"{launches} launch, frame == plain-version frame", flush=True)
    results["background_grid_kernel"]["launches"] = launches


def run_cli(argv):
    """tpu_renderer_torch.cli.main(argv) in-process; returns what it printed."""
    from tpu_renderer_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    assert rc == 0, f"cli {argv} exited {rc}"
    return buf.getvalue()


def cli_png(argv, name, kernels):
    """Run a CLI command that writes a PNG, then again through the plain
    versions of `kernels`; the two images must be equal. Returns the image
    and the command's printed line."""
    from tpu_renderer_torch.present import load_png

    out = os.path.join(OUT_DIR, f"{name}.png")
    line = run_cli([*argv, "--out", out]).strip()
    with plain_versions(kernels):
        run_cli([*argv, "--out", os.path.join(OUT_DIR, f"{name}_plain.png")])
    img = load_png(out)
    assert np.array_equal(img, load_png(os.path.join(OUT_DIR, f"{name}_plain.png"))), \
        f"cli {name}: the kernel frame differs from the plain-version frame"
    print(f"[cli] {' '.join(argv)}: {line}; == plain-version PNG", flush=True)
    return img


def cli_phase(results):
    """Phase 9: the CLI on the card, counted as one path."""
    from tpu_renderer_torch.engine import Engine

    reset_counters()
    full = ["--width", "1920", "--height", "1080"]
    frame_kernels = ("raster_fused_kernel", "raster_accum_kernel", "background_sky_kernel")
    demo = ["demo", "--grid", "64", *full, "--background", "1"]
    native = cli_png(demo, "cli_demo", frame_kernels)
    after_demo = read_counters()
    assert after_demo["background_sky_kernel"] == 1 and after_demo["raster_fused_kernel"] == 1, \
        after_demo
    scaled = cli_png([*demo, "--render-scale", "0.65"], "cli_demo_scale065", frame_kernels)
    assert native.shape == scaled.shape == (1080, 1920, 4)
    assert not np.array_equal(native, scaled)
    # the same picture, coarsely: 40x40 box averages (a blurred checker or
    # star moves a box a little; another picture moves it by 100 and more)
    box = lambda im: im[..., :3].astype(np.float32).reshape(27, 40, 48, 40, 3).mean((1, 3))  # noqa: E731
    coarse = float(np.abs(box(native) - box(scaled)).max())
    print(f"[cli] render scale 0.65 against native: 40x40 box means differ by at most "
          f"{coarse:.2f} of 255", flush=True)
    assert coarse < 64, "the scaled frame is another picture"

    before = read_counters()
    grad = cli_png(["milestone", "background_gradient", *full], "cli_gradient",
                   ("background_gradient_kernel",))
    sky = cli_png(["milestone", "background_sky", *full], "cli_sky",
                  ("background_sky_kernel",))
    now = read_counters()
    assert now["background_gradient_kernel"] == before["background_gradient_kernel"] + 1
    assert now["background_sky_kernel"] == before["background_sky_kernel"] + 1
    assert (grad == 255).all() and sky[0, 0, 2] < 100 and (sky[..., 3] == 255).all()

    # view: the pipelined loop; every call after the fill returns a frame
    returned = []
    draw_pipelined = Engine.draw_pipelined

    def recording(self, *args, **kwargs):
        frame = draw_pipelined(self, *args, **kwargs)
        returned.append(None if frame is None else frame.shape)
        return frame

    Engine.draw_pipelined = recording
    try:
        text = run_cli(["view", "--grid", "64", "--frames", "8", "--keys", "wwddwwdd", *full])
    finally:
        Engine.draw_pipelined = draw_pipelined
    assert returned == [None, None] + [(48, 96, 4)] * 6, returned
    assert "frame 7" in text and text.rstrip().endswith("8 frames")
    print(f"[cli] view --grid 64 --frames 8: draw_pipelined returned {returned}", flush=True)

    line = run_cli(["benchmark", "--grid", "64", "--frames", "20"]).strip().splitlines()[-1]
    bench = json.loads(line)
    assert bench["backend"] == "cuda" and bench["triangles"] > 40000, bench
    print(f"[cli] benchmark --grid 64 --frames 20: {line}", flush=True)

    launches = read_counters()
    print(f"[cli] launches over the CLI path: {launches}", flush=True)
    for n in ("background_gradient_kernel", "background_sky_kernel"):
        assert launches[n] > 0, f"{n} was never launched on the CLI path"
        results[n]["launches"] = launches[n]


def timed_draws(eng, draw, n):
    """Per-call host ms of n calls of draw() over a slow orbit, the device
    drained before the first and after the last; returns (ms list, frames)."""
    import torch

    frames, times = [], []
    torch.cuda.synchronize()
    for i in range(n):
        eng.camera.yaw = np.float32(0.002 * i)
        t0 = time.perf_counter()
        frames.append(draw())
        times.append((time.perf_counter() - t0) * 1000.0)
    torch.cuda.synchronize()
    return times, frames


def scale_and_pipeline_phase(scene_path):
    """Phase 10: the render scale and the pipelined draw on the bench
    frame; an effect switch and a resize."""
    import torch

    from tpu_renderer_torch.utils.bench_frame import bench_engine

    # native against render_scale 0.65, sky background, in turns
    engines = {s: bench_engine(scene_path, render_scale=s, background_effect=1)
               for s in (1.0, 0.65)}
    for eng in engines.values():
        eng.draw()
    med = {s: [] for s in engines}
    for s in (1.0, 0.65, 0.65, 1.0):
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engines[s].draw_device()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1000.0)
        med[s].append(statistics.median(times))
    ext = engines[0.65]._extents()
    print(f"[frame] render scale: native 1920x1080 median {med[1.0][0]:.3f} / {med[1.0][1]:.3f} "
          f"ms; scale 0.65 ({ext['width']}x{ext['height']} blitted to 1920x1080) "
          f"{med[0.65][0]:.3f} / {med[0.65][1]:.3f} ms (2 x 10 frames each, in turns)",
          flush=True)
    del engines

    # draw() against draw_pipelined() over the same orbit, in turns
    n = 12
    eng, twin = bench_engine(scene_path), bench_engine(scene_path)
    for e in (eng, twin):
        e.draw()
    pipelined = lambda: eng.draw_pipelined(stats_interval=30)  # noqa: E731
    sync_med, pipe_med = [], []
    for turn in ("draw", "pipelined", "pipelined", "draw"):
        if turn == "draw":
            ms, want = timed_draws(twin, twin.draw, n)
            sync_med.append(statistics.median(ms))
            continue
        ms, got = timed_draws(eng, pipelined, n)
        pipe_med.append(statistics.median(ms[2:]))
        assert got[0] is None and got[1] is None
        for i in range(2, n):
            assert np.array_equal(got[i], want[i - 2]), f"pipelined frame {i} differs"
        assert np.array_equal(eng.flush_pipelined(), want[n - 1])
    assert all(slot.is_pinned() for slot in eng._slots)
    print(f"[frame] pipelined: draw() median {sync_med[0]:.3f} / {sync_med[1]:.3f} ms a call, "
          f"draw_pipelined() {pipe_med[0]:.3f} / {pipe_med[1]:.3f} ms a call (2 x {n} frames "
          f"of one orbit each, in turns); frames equal byte for byte with a lag of 2",
          flush=True)

    # an effect switch and a resize, with the launches they cause
    steps = []
    reset_counters()

    def step(label):
        eng.draw()
        eng.draw()
        c = read_counters()
        steps.append((label, c["background_gradient_kernel"], c["background_sky_kernel"]))

    eng.resize(1920, 1080)          # drops the cached background
    step("first draws")
    eng.current_background_effect = 1
    step("effect switch")
    eng.resize(1700, 900)
    step("resize")
    assert [s[1:] for s in steps] == [(1, 0), (1, 1), (1, 2)], steps
    assert eng.draw().shape == (900, 1700, 4) and eng._bg_fb.shape == (4, 928, 1792)
    print(f"[frame] background launches (gradient, sky), two draws a step: {steps}",
          flush=True)


def triangle_bins(rows, tiles):
    """Per-triangle bins over fat rows, through the deferred path's own
    binning (bin_triangles over the chunk boxes, refine_bins), each cap
    doubled until nothing overflows. The boxes are the rows' own (columns
    44-47); a dead row carries the empty box."""
    from tpu_renderer_torch.kernels import raster

    aabb = rows[:, 44:48].contiguous()
    valid = (aabb[:, 2] >= aabb[:, 0]) & (aabb[:, 3] >= aabb[:, 1])
    caabb, cvalid = raster.chunk_aabbs(aabb, valid)
    bin_cap, tri_cap = 512, 1024
    while True:
        cbins, _, overflow = raster.bin_triangles(caabb, cvalid, bin_cap=bin_cap, **tiles)
        if int(overflow) == 0:
            break
        bin_cap *= 2
    while True:
        bins, counts, overflow = raster.refine_bins(cbins, aabb, tri_cap=tri_cap, **tiles)
        if int(overflow) == 0:
            break
        tri_cap *= 2
    print(f"[bins] triangle bins over {rows.shape[0]} sorted rows: bin_cap {bin_cap}, "
          f"tri_cap {tri_cap}, {int(counts.sum())} entries, at most {int(counts.max())} "
          f"a tile", flush=True)
    return bins, counts


def equal_outputs(what, got, want, names):
    """Raise unless each tensor of got equals its twin of want, bit for bit."""
    import torch

    for name, g, w in zip(names, got, want):
        same = torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert same, (f"{what}: {name} differs, max abs "
                      f"{float((g.double() - w.double()).abs().max())}")


def gathered_phase(results, inputs):
    """Phase 11: kernels 2.6-2.8 against their plain versions, and the
    stream kernels 2.1-2.3 against them on the same rows."""
    import torch

    from tpu_renderer_torch.kernels import raster
    from tpu_renderer_torch.tools.time_stream_kernels import frame_tiles

    # 2.6 on the deferred bench frame's own rows and refined bins
    name26, name27, name28 = ("raster_fused_gathered_kernel", "raster_accum_gathered_kernel",
                              "raster_peel_gathered_kernel")
    results[name26] = check_kernel(name26, [(0, inputs[name26])], "deferred frame")

    # per-triangle bins over the very rows each stream kernel ran on
    (rows, dense, dcounts), kwargs = inputs["raster_fused_kernel"]
    tiles = frame_tiles(kwargs)
    tbins, tcounts = triangle_bins(rows, tiles)
    (rows_t, dense_t, dcounts_t, z, light), _ = inputs["raster_accum_kernel"]
    (rows_p, dense_p, dcounts_p, z_p, last0), _ = inputs["raster_peel_fused_kernel"]
    (_, abins, acounts, _, _), _ = inputs[name27]
    (_, pbins, pcounts, _, _), _ = inputs[name28]
    results[name27] = check_kernel(name27, [(0, inputs[name27])], "bench frame's glass")
    results[name28] = check_kernel(name28, [(0, inputs[name28])],
                                   "textured-glass frame, first peel")

    reset_counters()
    five = ("z", "tid", "attrs", "metas", "inv")
    equal_outputs("2.6 against 2.1", raster.rasterize_fused_gathered(rows, tbins, tcounts, **tiles),
                  raster.rasterize_fused(rows, dense, dcounts, **tiles), five)
    print("[cross-check] 2.6 == 2.1 on the bench frame's sorted rows: z, tid, attrs, "
          "metas, inv bit for bit", flush=True)

    acc6, cnt6 = raster.rasterize_accum_gathered(rows_t, abins, acounts, z, light, **tiles)
    acc2, cnt2 = raster.rasterize_accum(rows_t, dense_t, dcounts_t, z, light, **tiles)
    assert torch.equal(cnt6, cnt2), "2.7 against 2.2: cnt differs"
    acc_err = float((acc6.double() - acc2.double()).abs().max())
    assert acc_err <= 1e-6, f"2.7 against 2.2: acc differs by {acc_err}"
    print(f"[cross-check] 2.7 == 2.2 on the bench frame's glass: cnt exact "
          f"({int(cnt6.sum())} fragments, at most {int(cnt6.max())} a pixel), acc max abs "
          f"difference {acc_err} (bound 1e-6)", flush=True)

    last6 = last3 = last0
    found = []
    for peel in range(3):
        out6 = raster.rasterize_peel_gathered(rows_p, pbins, pcounts, z_p, last6, **tiles)
        out3 = raster.rasterize_peel_fused(rows_p, dense_p, dcounts_p, z_p, last3, **tiles)
        equal_outputs(f"2.8 against 2.3, peel {peel}", out6, out3,
                      ("layer", "attrs", "metas", "inv"))
        found.append(int((out6[0] < raster.ID_INF).sum()))
        last6 = torch.where(out6[0] < raster.ID_INF, out6[0], raster.ID_INF)
        last3 = torch.where(out3[0] < raster.ID_INF, out3[0], raster.ID_INF)
    assert found[0] > 0
    print(f"[cross-check] 2.8 == 2.3 over three peels of the textured-glass frame, last fed "
          f"back: layer, attrs, metas, inv bit for bit; pixels with a layer {found}",
          flush=True)
    torch.cuda.synchronize()
    launches = read_counters()
    print(f"[cross-check] launches: {launches}", flush=True)
    for n in (name26, name27, name28):
        assert launches[n] > 0, f"{n} was never launched by the cross-checks"
        results[n]["launches"] = launches[n]


def profile_tool_phase(results):
    """Phase 12: the raster profile tool in-process; 2.4 and 2.6 launch."""
    from tpu_renderer_torch.tools import profile_raster

    reset_counters()
    rc = profile_raster.main(["--iters", "10"])
    assert rc == 0, f"profile_raster exited {rc}"
    launches = read_counters()
    for n in ("raster_deferred_kernel", "raster_fused_gathered_kernel"):
        assert launches[n] > 0, f"{n} was never launched by the profile tool"
    print(f"[tool] profile_raster launches: {launches}", flush=True)
    results["raster_fused_gathered_kernel"]["launches"] += \
        launches["raster_fused_gathered_kernel"]


def bench_phase():
    """Phase 13: the bench in-process, its JSON line, and the launches of
    2.1 and 2.2 in each of its variants."""
    from tpu_renderer_torch import bench
    from tpu_renderer_torch.config import RendererConfig

    frames = 20
    variants = []
    sequence_fps = bench.sequence_fps

    def counted(eng, n, kw=None):
        reset_counters()
        out = sequence_fps(eng, n, kw)
        variants.append(read_counters())
        return out

    bench.sequence_fps = counted
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            reset_counters()
            rc = bench.main(["--frames", str(frames)])
    finally:
        bench.sequence_fps = sequence_fps
    assert rc == 0, f"bench exited {rc}"
    line = buf.getvalue().strip().splitlines()[-1]
    print(f"[bench] {line}", flush=True)
    result = json.loads(line)
    assert result["metric"] == "fps_1080p_gltf_scene" and result["backend"] == "cuda", result
    # headline, trilinear, trilinear under target_fps, stress: each runs its
    # sequence twice (warm, timed), and every frame has glass
    assert len(variants) == 4, len(variants)
    for i, launches in enumerate(variants):
        for n in ("raster_fused_kernel", "raster_accum_kernel"):
            assert launches[n] == 2 * frames, f"bench variant {i}: {n} launched {launches[n]}"
        # the two trilinear variants take kernel 2.12's two-tap instance
        assert launches[TWO_TAP] == (2 * frames if i in (1, 2) else 0), (i, launches[TWO_TAP])
    # since the stress variant's reset: its sequences, then the two
    # pipelined loops (frames, and 3 + frames)
    interactive = {n: v - variants[-1][n] for n, v in read_counters().items()}
    for n in ("raster_fused_kernel", "raster_accum_kernel"):
        assert interactive[n] == 2 * frames + 3, (n, interactive[n])
    scale = result["detail"]["trilinear_auto_scale"]
    assert RendererConfig().auto_scale_min <= scale <= 1.0, scale
    print(f"[bench] 2.1 and 2.2 launched {2 * frames} times in each of 4 sequence variants "
          f"and {interactive['raster_fused_kernel']} times over the two interactive loops; "
          f"trilinear_auto_scale {scale}", flush=True)


# Phase 14: each mesh and the paths it runs; every mesh renders the bench
# scene at full width, its ranks sharing the one card. (1, 1) runs nccl, so
# its frames are graphed (frame_graph.FrameGraph with the mesh); the others
# run gloo and draw op by op
MESH_PATHS = {(1, 1): ("bench", "textured-glass", "deferred"),
              (2, 1): ("bench", "deferred"), (1, 2): ("bench", "deferred"),
              (2, 2): ("bench", "textured-glass", "deferred")}
# the kernels each path must launch on every rank (2.9: the background, at
# the first frame)
MESH_KERNELS = {"bench": ("raster_fused_kernel", "raster_accum_kernel",
                          "background_gradient_kernel"),
                "textured-glass": ("raster_fused_kernel", "raster_peel_fused_kernel",
                                   "background_gradient_kernel"),
                "deferred": ("raster_deferred_kernel", "raster_peel_kernel",
                             "background_gradient_kernel")}
# frames a path: a graphed mesh MESH_TURN a turn in turns graphed, eager,
# eager, graphed; a gloo mesh MESH_FRAMES; then MESH_FRAMES eager frames
# with the collectives timed, on every mesh
MESH_FRAMES = 3
MESH_TURN = 2
MESH_TURNS = ("graphed", "eager", "eager", "graphed")
# the kernels the last band's first rank holds to their plain versions at
# its tile_y0 > 0, by mesh: each of 2.1-2.5 once (a plain version over half
# the 1080p frame takes seconds)
BAND_CHECKS = {(2, 1): ("raster_fused_kernel", "raster_accum_kernel",
                        "raster_deferred_kernel", "raster_peel_kernel"),
               (2, 2): ("raster_peel_fused_kernel",)}


def mesh_engine(path, scene_path, **config):
    """The engine of a path on the bench scene (its GLB already written)."""
    from tpu_renderer_torch.scene import load_scene
    from tpu_renderer_torch.utils.bench_frame import bench_engine, texture_the_glass

    scene = load_scene(scene_path)
    if path == "textured-glass":
        scene = texture_the_glass(scene)
    return bench_engine(scene_path, scene=scene, fused=path != "deferred", **config)


def band_kernels(eng, path, mesh, check=()):
    """Each raster kernel of the path (2.1-2.5) on this rank's band, on the
    first call one eager frame gives it: device ms, timed one rank at a
    time while the others wait (they share the card); those named in
    `check` also held to their plain versions bit for bit (max_abs_err; a
    band below the first has tile_y0 > 0). Returns name -> (device ms, err
    or None)."""
    import torch
    import torch.distributed as dist

    from tpu_renderer_torch.kernels import raster
    from tpu_renderer_torch.utils.timing import device_ms

    names = [n for n in MESH_KERNELS[path] if n.startswith("raster_")]
    seen = capture_kernel_inputs(eng.draw_device, names)
    out = {}
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            for n in names:
                args, kwargs = seen[n][0]
                kernel = getattr(raster, n)
                err = None
                if n in check:
                    assert kwargs["tile_y0"] > 0, kwargs
                    got = kernel(*args, **kwargs)
                    want = getattr(raster, KERNELS[n][1])(*args, **kwargs)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want)
                out[n] = (device_ms(lambda: kernel(*args, **kwargs)), err)
        dist.barrier()
    return out


def mesh_rank(rank, scene_path, mesh_shape, paths):
    """One rank of phase 14: for each path, the counters zeroed, one draw()
    (the background kernel and the caps settle here; on nccl the frame's
    graph is captured), then the frames drawn by draw_device(): a graphed
    mesh's in turns graphed and eager (pipeline.eager()), a gloo mesh's
    eager, each timed with its host ms and, on nccl, host syncs (SyncCount); then
    MESH_FRAMES eager frames with the collectives timed; the counters and
    the peak memory read. On a gloo mesh the band's raster kernels are
    timed, and on the first rank of the last band those of BAND_CHECKS
    held to their plain versions at its tile_y0 (band_kernels). Returns, from rank 0, each
    path's images and every rank's launches and times."""
    import torch
    import torch.distributed as dist

    from tpu_renderer_torch import pipeline
    from tpu_renderer_torch.parallel.multichip import band_extent
    from tpu_renderer_torch.present import unpack_u8
    from tpu_renderer_torch.utils.bench_frame import SyncCount

    out = []
    for path in paths:
        eng = mesh_engine(path, scene_path, multichip=mesh_shape)
        mesh = eng.mesh
        graphed = mesh.backend == "nccl"
        torch.cuda.reset_peak_memory_stats(mesh.device)
        reset_counters()
        image = eng.draw()
        capture = eng.frame_graphs.captured[-1] if graphed else None
        turns = MESH_TURNS if graphed else ("eager",)
        ms = {t: dict(wall=[], host=[], syncs=[]) for t in turns}
        last = {}
        for turn in turns:
            for _ in range(MESH_TURN if graphed else MESH_FRAMES):
                # gloo's collectives on CUDA tensors sync the host by design:
                # the syncs are counted on nccl alone
                count = SyncCount() if graphed else contextlib.nullcontext()
                with pipeline.eager() if turn == "eager" else contextlib.nullcontext():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with count:
                        img, _aux = eng.draw_device()
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                ms[turn]["wall"].append((time.perf_counter() - t0) * 1000.0)
                ms[turn]["host"].append((t1 - t0) * 1000.0)
                ms[turn]["syncs"].append(count.calls if graphed else None)
                last[turn] = img
        timed, coll = [], []
        mesh.timing = True
        with pipeline.eager():
            for _ in range(MESH_FRAMES):
                c0 = mesh.collective_ms
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.draw_device()
                torch.cuda.synchronize()
                timed.append((time.perf_counter() - t0) * 1000.0)
                coll.append(mesh.collective_ms - c0)
        mesh.timing = False
        launches = read_counters()
        peak_mib = torch.cuda.max_memory_allocated(mesh.device) / 2 ** 20
        cfg = eng.config
        wp, hp, band_h = band_extent(cfg.width, cfg.height, cfg.tile_h, cfg.tile_w,
                                     mesh.n_rows)
        band = dict(y0=mesh.row * band_h, rows=band_h, tile_rows=band_h // cfg.tile_h,
                    tile_y0=mesh.row * band_h // cfg.tile_h)
        kernels = {} if graphed else band_kernels(
            eng, path, mesh, check=BAND_CHECKS.get(mesh_shape, ()) if mesh.row == mesh.n_rows - 1
            and mesh.tri == 0 else ())
        mine = dict(launches=launches, band=band, peak_mib=peak_mib, kernels=kernels,
                    frame_ms={t: statistics.median(v["wall"]) for t, v in ms.items()},
                    host_ms={t: statistics.median(v["host"]) for t, v in ms.items()},
                    syncs={t: max(v["syncs"]) if graphed else None for t, v in ms.items()},
                    capture_ms=None if capture is None else capture[0],
                    timed_ms=statistics.median(timed),
                    collective_ms=statistics.median(coll),
                    collectives=mesh.collectives // MESH_FRAMES,
                    backend=mesh.backend, device=str(mesh.device),
                    caps=dict(eng._caps))
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
        images = None
        if rank == 0:
            images = dict(first=image, **{t: unpack_u8(v) for t, v in last.items()})
        out.append(dict(path=path, images=images, ranks=ranks))
        del eng, mesh
    return out


def multichip_phase(scene_path, lines):
    """Phase 14: the multi-device frame (tpu_renderer_torch/parallel/
    multichip.py) on the bench scene at 1920x1080, each mesh started by
    multichip.launch with the kernel library built here: (1, 1) over nccl
    on the bench, textured-glass and deferred paths, its frames graphed
    (the mesh frame captured as one CUDA graph, collectives and the peel's
    WHILE node inside) and drawn eagerly in turns; (2, 1), (1, 2) and
    (2, 2) over gloo with the ranks sharing the one card, eager: the bench
    and deferred paths, and at (2, 2) textured glass (2.3 under the MIN
    election). Each path's kernels must have launched on every rank; every
    image (the first frame, and at (1, 1) a graphed and an eager frame) is
    byte for byte the single-device frame of its path; a graphed frame
    makes no host sync inside draw_device(). Printed: frame ms (median,
    rank 0; at (1, 1) graphed and eager),
    draw_device() host ms, host syncs a frame, the capture's ms, the
    collectives' share of MESH_FRAMES eager frames with the card
    synchronised around each collective; at a gloo mesh each rank's band,
    the device ms of its 2.1-2.5 launches (one band's over the band's
    tiles alone) and its peak MiB, and on the first rank of the last band
    each of 2.1-2.5, once in the phase (BAND_CHECKS), held to its plain
    version at tile_y0 > 0."""
    import torch
    from tpu_renderer_torch.parallel import multichip

    single = {}
    for path in ("bench", "textured-glass", "deferred"):
        eng = mesh_engine(path, scene_path)
        single[path] = eng.draw()      # deferred: escalates the caps and redraws
        del eng
    torch.cuda.empty_cache()
    for shape, paths in MESH_PATHS.items():
        n = shape[0] * shape[1]
        t0 = time.perf_counter()
        results = multichip.launch(mesh_rank, n, device="cuda",
                                   args=(scene_path, shape, paths))
        for r in results:
            path, ranks = r["path"], r["ranks"]
            for i, rk in enumerate(ranks):
                for k in MESH_KERNELS[path]:
                    assert rk["launches"][k] > 0, \
                        f"mesh {shape} {path}: {k} never launched on rank {i}"
            want = single[path]
            differ = {k: int(np.any(v != want, axis=-1).sum()) for k, v in r["images"].items()}
            lead = ranks[0]
            share = lead["collective_ms"] / lead["timed_ms"]
            line = dict(mesh=f"{shape[0]}x{shape[1]}", path=path, ranks=n,
                        backend=lead["backend"], devices=sorted({k["device"] for k in ranks}),
                        ranks_share_one_card=n > torch.cuda.device_count(),
                        differing_pixels=differ, frame_ms=lead["frame_ms"],
                        host_ms=lead["host_ms"], host_syncs=lead["syncs"],
                        capture_ms=lead["capture_ms"], timed_frame_ms=lead["timed_ms"],
                        collective_ms=lead["collective_ms"], collective_share=share,
                        collectives_a_frame=lead["collectives"], caps=lead["caps"],
                        launches=[{k: rk["launches"][k] for k in MESH_KERNELS[path]}
                                  for rk in ranks],
                        bands=[dict(rk["band"], peak_mib=rk["peak_mib"],
                                    device_ms={k: v[0] for k, v in rk["kernels"].items()},
                                    max_abs_err={k: v[1] for k, v in rk["kernels"].items()
                                                 if v[1] is not None})
                               for rk in ranks])
            lines.append(line)
            frames = ", ".join(f"{t} {v:.3f}" for t, v in lead["frame_ms"].items())
            hosts = ", ".join(f"{t} {v:.3f}" for t, v in lead["host_ms"].items())
            syncs = ", ".join(f"{t} {'not counted' if v is None else v}"
                              for t, v in lead["syncs"].items())
            print(f"[multichip] {line['mesh']} {path}: {lead['backend']} on "
                  f"{line['devices']}" + (f", {n} ranks sharing one card (not a scaling "
                                          f"number)" if line["ranks_share_one_card"] else "")
                  + f"; pixels differing from the single-device frame {differ}; frame ms "
                  f"(median, rank 0) {frames}"
                  + f"; draw_device() host ms {hosts}; host syncs a frame {syncs}"
                  + ("" if lead["capture_ms"] is None else
                     f"; captured in {lead['capture_ms']:.1f} ms")
                  + f"; collectives {lead['collective_ms']:.3f} of {lead['timed_ms']:.3f} ms "
                  f"timed eager ({100 * share:.1f}%, {lead['collectives']} a frame); launches "
                  f"a rank {line['launches']}", flush=True)
            for i, b in enumerate(line["bands"]):
                if b["device_ms"]:
                    ms = ", ".join(f"{k} {v:.4f}" for k, v in b["device_ms"].items())
                    print(f"[multichip] {line['mesh']} {path} rank {i}: band rows "
                          f"{b['y0']}-{b['y0'] + b['rows'] - 1} ({b['tile_rows']} tile rows "
                          f"from tile row {b['tile_y0']}); device ms {ms}; peak "
                          f"{b['peak_mib']:.1f} MiB"
                          + (f"; exact vs plain at tile_y0 {b['tile_y0']} "
                             f"{b['max_abs_err']}" if b["max_abs_err"] else ""), flush=True)
            assert all(v == 0 for v in differ.values()), (shape, path, differ)
            if shape == (1, 1):
                assert lead["backend"] == "nccl", lead["backend"]
                assert lead["syncs"]["graphed"] == 0, (path, lead["syncs"])
            else:
                assert lead["backend"] == "gloo", lead["backend"]
                want = set(BAND_CHECKS.get(shape, ())) & set(MESH_KERNELS[path])
                errs = {k: v for b in line["bands"] for k, v in b["max_abs_err"].items()}
                assert set(errs) == want and all(v == 0.0 for v in errs.values()), \
                    (shape, path, line["bands"])
        print(f"[multichip] mesh {shape} took {time.perf_counter() - t0:.1f} s", flush=True)


# Phase 15: the viewer over a mesh on a terminal, debug_mode on the card,
# the tool twins; the sweep's arguments in the smoke: the tile_h axis at
# the shipped point alone (the tool's default sweeps every axis,
# tools/sweep_tiles.py; phase 17 runs 2.1 and 2.2 at every tile)
VIEW_KEYS = ("w", "w", "d", "\x1b[C", "s")
SWEEP_ARGS = ("--axes", "tile_h", "--tile_hs", "32")


def view_on_terminal(argv, keys, timeout=300.0):
    """tpu_renderer_torch.cli with argv in a subprocess whose stdin is a
    pseudo-terminal: once its first frame is out, each key (then q) is
    typed 0.3 s apart. Returns (exit code, its standard output)."""
    import pty
    import signal
    import subprocess

    master, slave = pty.openpty()
    out_path = os.path.join(OUT_DIR, "view_multichip.txt")
    with open(out_path, "wb") as out, open(out_path + ".err", "wb") as err:
        proc = subprocess.Popen([sys.executable, "-m", "tpu_renderer_torch.cli", *argv],
                                stdin=slave, stdout=out, stderr=err, cwd=ROOT,
                                env=dict(os.environ, PYTHONPATH=ROOT),
                                start_new_session=True)
        os.close(slave)
        try:
            deadline = time.monotonic() + timeout
            while b"frame " not in open(out_path, "rb").read():
                assert proc.poll() is None, f"cli {argv} exited {proc.returncode} before a frame"
                assert time.monotonic() < deadline, f"cli {argv}: no frame in {timeout} s"
                time.sleep(0.2)
            for k in (*keys, "q"):
                os.write(master, k.encode())
                time.sleep(0.3)
            rc = proc.wait(timeout=max(deadline - time.monotonic(), 10.0))
        finally:
            if proc.poll() is None:     # the launcher and its ranks
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            os.close(master)
    with open(out_path, "rb") as f:
        return rc, f.read().decode("utf-8", errors="replace")


def view_ranks(text):
    """The [multichip] view rank lines of a mesh view's output: one dict a
    rank (frames, digest, launches of 2.1, 2.2, 2.9 and 2.10)."""
    import re

    pat = (r"\[multichip\] view rank (\d+): (\d+) frames presented, digest (\w+); "
           r"kernel 2\.1 launched (\d+), 2\.2 (\d+), 2\.9 (\d+), 2\.10 (\d+)")
    return [dict(rank=int(m[0]), frames=int(m[1]), digest=m[2], fused=int(m[3]),
                 accum=int(m[4]), gradient=int(m[5]), sky=int(m[6]))
            for m in re.findall(pat, text)]


def run_tool(module, argv):
    """A tool's main(argv) in-process; its printed lines, echoed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    text = buf.getvalue()
    for line in text.strip().splitlines():
        print(f"[tool] {module.__name__.rsplit('.', 1)[-1]}: {line}", flush=True)
    assert rc == 0, f"{module.__name__} exited {rc}"
    return text


def surface_phase(scene_path):
    """Phase 15: view --multichip 2x1 on a pseudo-terminal (keys, then q:
    exit 0, every rank the same frames, 2.1 and 2.2 launched on every
    rank); debug_mode around bench frames (a first frame, so 2.9 too, and
    a warm one: each passes and equals the frame without it byte for byte;
    the cost printed); profile_binwidth, bench_gather and make_gallery
    in-process; sweep_tiles with SWEEP_ARGS (every check must pass)."""
    import torch
    from tpu_renderer_torch.tools import bench_gather, make_gallery, profile_binwidth, sweep_tiles
    from tpu_renderer_torch.utils.bench_frame import bench_engine
    from tpu_renderer_torch.utils.profiling import debug_mode

    t0 = time.perf_counter()
    argv = ["view", "--multichip", "2x1", "--grid", "64", "--width", "1920", "--height",
            "1080", "--cols", "48", "--rows", "12"]
    rc, text = view_on_terminal(argv, VIEW_KEYS)
    ranks = view_ranks(text)
    print(f"[view] {' '.join(argv)} on a pseudo-terminal, keys {list(VIEW_KEYS)} then q: "
          f"exit {rc}; {ranks}; {time.perf_counter() - t0:.1f} s", flush=True)
    assert rc == 0 and len(ranks) == 2, (rc, text[-2000:])
    assert ranks[0]["frames"] > 0 and all(
        (r["frames"], r["digest"]) == (ranks[0]["frames"], ranks[0]["digest"]) for r in ranks)
    assert all(r["fused"] > 0 and r["accum"] > 0 and r["gradient"] == 1 for r in ranks), ranks

    eng = bench_engine(scene_path)
    want = eng.draw()
    times = {}
    for label, e, debug in (("first frame", bench_engine(scene_path), False),
                            ("first frame, debug_mode", bench_engine(scene_path), True),
                            ("warm frame", eng, False), ("warm frame, debug_mode", eng, True)):
        reset_counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with debug_mode() if debug else contextlib.nullcontext():
            got = e.draw()
        times[label] = (time.perf_counter() - t) * 1000.0
        launches = read_counters()
        assert np.array_equal(got, want), f"{label}: the frame differs"
        kernels = ("raster_fused_kernel", "raster_accum_kernel") + (
            ("background_gradient_kernel",) if label.startswith("first") else ())
        assert all(launches[k] == 1 for k in kernels), (label, launches)
        del e
    print(f"[debug] debug_mode on the bench frame: a first frame (2.9, 2.1, 2.2 checked) and "
          f"a warm one pass and equal the frame without it byte for byte; host ms a draw() "
          + ", ".join(f"{k} {v:.1f}" for k, v in times.items()), flush=True)
    del eng

    run_tool(profile_binwidth, ["--iters", "10"])
    run_tool(bench_gather, [])
    gallery = os.path.join(OUT_DIR, "gallery")
    run_tool(make_gallery, ["--out", gallery])
    assert sorted(os.listdir(gallery)) == sorted(make_gallery.NAMES), os.listdir(gallery)
    t = time.perf_counter()
    text = run_tool(sweep_tiles, list(SWEEP_ARGS))
    rows = json.loads(text.strip().splitlines()[-1])["sweep"]
    assert len(rows) == 1 and not sweep_tiles.failed(rows), rows
    print(f"[sweep] {' '.join(SWEEP_ARGS)} (the tool sweeps every axis by default): "
          f"{len(rows)} points in {time.perf_counter() - t:.1f} s", flush=True)


# Phase 16: the paths whose graphed frames are held to the eager ones, the
# orbit, and the frames a turn of the in-turn timing
GRAPH_PATHS = ("bench", "trilinear", "stress", "textured-glass", "deferred")
GRAPH_FRAMES = 10
GRAPH_TURN = 5


def graph_engine(path, scene_path):
    """Phase 16's engine of a path: the bench scene (its GLB already
    written) as phase 14 takes it, the stress scene of phase 3b, or the
    bench scene with trilinear samplers."""
    from tpu_renderer_torch.scene import load_scene
    from tpu_renderer_torch.utils.bench_frame import BENCH, bench_engine

    if path == "trilinear":
        return bench_engine(os.path.join(OUT_DIR, "bench_scene_trilinear.glb"), trilinear=True)
    if path == "stress":
        glb = os.path.join(OUT_DIR, f"bench_scene_{2 * BENCH['grid']}.glb")
        return bench_engine(glb, scene=load_scene(glb),
                            camera_position=(0.0, 6.0, 4.0 * BENCH["grid"]))
    return mesh_engine(path, scene_path)


def graphed_eager_frame(eng):
    """One frame of eng graphed and the same frame eager (pipeline.eager()),
    each counted: ((image, aux, launches, host syncs) graphed, the same
    eager)."""
    from tpu_renderer_torch import pipeline
    from tpu_renderer_torch.utils.bench_frame import SyncCount

    out = []
    params = eng.update_scene()
    for eager in (False, True):
        reset_counters()
        with pipeline.eager() if eager else contextlib.nullcontext(), \
                SyncCount() as syncs:
            image, aux = eng.draw_device(params)
        out.append((image, {k: int(v) for k, v in aux.items()}, read_counters(),
                    syncs.calls))
    return out[0], out[1]


def graphed_turns(eng):
    """Wall ms (synchronised) and draw_device() host ms of GRAPH_TURN frames
    a turn, in turns graphed, eager, eager, graphed, over a slow orbit."""
    import torch

    from tpu_renderer_torch import pipeline

    ms = {m: dict(wall=[], host=[]) for m in ("graphed", "eager")}
    for turn in ("graphed", "eager", "eager", "graphed"):
        with pipeline.eager() if turn == "eager" else contextlib.nullcontext():
            for i in range(GRAPH_TURN):
                eng.camera.yaw = np.float32(0.002 * i)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.draw_device()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                ms[turn]["wall"].append((time.perf_counter() - t0) * 1000.0)
                ms[turn]["host"].append((t1 - t0) * 1000.0)
    return ms


def graphed_phase(scene_path):
    """Phase 16: the graphed frame (frame_graph.py) against the eager one
    on the bench, trilinear, stress, textured-glass and deferred paths:
    over a GRAPH_FRAMES-frame orbit each graphed frame equals the same
    frame drawn eagerly byte for byte, with the same aux and the same
    launches of every kernel (the peels counted on the card), and no host
    sync inside the graphed draw_device(); the textured-glass graph is
    captured looking away from the glass (no layer), so its replays peel
    every layer they find on the card; the capture's ms and memory pool;
    wall and host ms in turns; then draw_pipelined() on the graphed bench
    engine against eager draws, a lag of 2."""
    import torch

    from tpu_renderer_torch import pipeline

    for path in GRAPH_PATHS:
        t0 = time.perf_counter()
        eng = graph_engine(path, scene_path)
        if path == "textured-glass":
            eng.camera.yaw = np.float32(np.pi)       # the glass behind the camera
        eng.draw()
        captured_layers = int(eng._last_aux.get("transparent_layers", torch.zeros(())))
        (capture_ms, pool_mib), = eng.frame_graphs.captured[-1:]
        layers, syncs, eager_syncs = [], [], []
        for i in range(GRAPH_FRAMES):
            eng.camera.yaw = np.float32(0.02 * i)
            (g_img, g_aux, g_n, g_syncs), (e_img, e_aux, e_n, e_syncs) = \
                graphed_eager_frame(eng)
            assert torch.equal(g_img, e_img), f"{path} frame {i}: graphed != eager"
            assert g_aux == e_aux, (path, i, g_aux, e_aux)
            assert g_n == e_n, (path, i, g_n, e_n)
            # kernel 2.12's two-tap instance runs on the trilinear path alone
            assert g_n[TWO_TAP] == (g_n["shade_fused_kernel"] if path == "trilinear" else 0), \
                (path, i, g_n)
            assert g_syncs == 0, f"{path} frame {i}: {g_syncs} host syncs in a graphed frame"
            layers.append(g_aux.get("transparent_layers", 0))
            syncs.append(g_syncs)
            eager_syncs.append(e_syncs)
        launched = {k: v for k, v in g_n.items() if v}
        ms = graphed_turns(eng)
        med = {m: (statistics.median(v["wall"]), min(v["wall"]), statistics.median(v["host"]))
               for m, v in ms.items()}
        print(f"[graph] {path}: captured at its first frame in {capture_ms:.1f} ms, pool "
              f"{pool_mib:.1f} MiB ({captured_layers} layers in view); {GRAPH_FRAMES}-frame "
              f"orbit: graphed == eager byte for byte, aux and launches equal (a frame "
              f"{launched}); transparent layers {layers}; host syncs a frame graphed "
              f"{max(syncs)}, eager {statistics.mean(eager_syncs):.1f}; wall ms median/min "
              f"graphed {med['graphed'][0]:.3f}/{med['graphed'][1]:.3f}, eager "
              f"{med['eager'][0]:.3f}/{med['eager'][1]:.3f}, draw_device() host ms graphed "
              f"{med['graphed'][2]:.3f}, eager {med['eager'][2]:.3f} (turns graphed, eager, "
              f"eager, graphed of {GRAPH_TURN} frames); {time.perf_counter() - t0:.1f} s",
              flush=True)
        if path == "bench":
            want, got = [], []
            for i in range(8):
                eng.camera.yaw = np.float32(0.02 * i)
                with pipeline.eager():
                    want.append(eng.draw())
                got.append(eng.draw_pipelined(stats_interval=0))
            assert got[0] is None and got[1] is None
            for i in range(2, 8):
                assert np.array_equal(got[i], want[i - 2]), f"pipelined frame {i} differs"
            print("[graph] bench: draw_pipelined() (graphed) over 8 frames equals the eager "
                  "draws with a lag of 2, byte for byte", flush=True)
        del eng


# Phase 17: the raster tile. Every tile of raster.TILES, the default
# first, then NEW_TILES (built at the phase's start, each into a library of
# its own): the paths each tile renders and the kernels each path's frame
# gives its inputs to, the background extents, and the graphed frames a
# path (the default tile's as many as phase 3's, OLD_TILE_FRAMES at the
# other shipped tiles, whose instances phase 17 has held since they
# shipped). At every tile but the default the kernels are timed and held
# to their plain versions on the 1080p frames' own inputs (at the default
# tile phases 3-11 hold them). REFUSED_TILES must raise before any build
# or launch.
TILE_PATHS = {"bench": ("raster_fused_kernel", "raster_accum_kernel"),
              "textured-glass": ("raster_peel_fused_kernel",),
              "deferred": ("raster_deferred_kernel", "raster_peel_kernel")}
TILE_BACKGROUND_EXTENTS = ((1920, 1080), (1700, 900))
TILE_FRAMES = 10
OLD_TILE_FRAMES = 3
NEW_TILES = ((8, 32), (16, 32), (64, 128), (8, 256), (32, 256), (128, 128))
REFUSED_TILES = ((12, 128), (128, 256))


def tile_calls(eng, path):
    """name -> (args, kwargs): the first call of each kernel of the path's
    frame at the engine's tile (one eager frame), and the gathered oracles'
    calls made from them, as phases 5 and 11 make them: 2.7 from 2.2's
    call, 2.8 from 2.3's, 2.6 on the deferred frame's fat rows and bins."""
    from tpu_renderer_torch.tools.profile_raster import deferred_inputs
    from tpu_renderer_torch.tools.time_stream_kernels import oracle_call

    seen = capture_kernel_inputs(eng.draw_device, TILE_PATHS[path])
    calls = {n: c[0] for n, c in seen.items()}
    if path == "bench":
        calls["raster_accum_gathered_kernel"] = oracle_call(calls["raster_accum_kernel"])
    elif path == "textured-glass":
        calls["raster_peel_gathered_kernel"] = oracle_call(calls["raster_peel_fused_kernel"])
    else:
        _, rows48, bins, counts, tiles, _ = deferred_inputs(eng)
        calls["raster_fused_gathered_kernel"] = ((rows48, bins, counts), tiles)
    return calls


def tile_background_calls(w, h, tile_h, tile_w, device):
    """name -> (args, kwargs) of each background kernel at extent w x h
    padded to whole tile_h x tile_w tiles (hold_at_tile adds the tile)."""
    import torch

    ext = dict(height=h, width_pad=-(-w // tile_w) * tile_w,
               height_pad=-(-h // tile_h) * tile_h)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return {
        "background_gradient_kernel": ((f((0.9, 0.3, 0.2, 1.0)), f((0.1, 0.2, 0.7, 0.5))), ext),
        "background_sky_kernel": ((f((0.1, 0.2, 0.4, 0.97)),), ext),
        "background_grid_kernel": ((), dict(width=w, device=device, **ext)),
    }


def hold_at_tile(name, call, tile, check: bool) -> dict:
    """Kernel `name` on one call at the tile: bit for bit against its plain
    version on the same call (when check; plain_s, the seconds that took),
    its device ms (utils/timing.device_ms) and its bound from these
    inputs."""
    import torch

    from tpu_renderer_torch.utils.timing import device_ms

    kernel, plain = getattr(kernel_module(name), name), _as_launcher(name)
    args, kwargs = call
    if name in BACKGROUND_KERNELS:
        kwargs = dict(kwargs, tile_h=tile[0], tile_w=tile[1])
    out = kernel(*args, **kwargs)
    err = plain_s = None
    if check:
        t0 = time.perf_counter()
        want = plain(*args, **kwargs)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = max_abs_err(out, want)
    bound_ms, bound_by = (background_bound(name, args, out) if name in BACKGROUND_KERNELS
                          else bound(name, args, kwargs, out))
    return dict(max_abs_err=err, plain_s=plain_s,
                device_ms=device_ms(lambda: kernel(*args, **kwargs)),
                bound_ms=bound_ms, bound_by=bound_by)


def build_new_tiles() -> dict:
    """Each new tile's library, all built at once (one thread a tile, one
    nvcc a source): tile -> nvcc seconds (None: found built)."""
    import concurrent.futures

    from tpu_renderer_torch.kernels import _build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(NEW_TILES)) as ex:
        futures = {t: ex.submit(_build.build_tile, *t) for t in NEW_TILES}
        seconds = {t: f.result()[1] for t, f in futures.items()}
    for t, secs in seconds.items():
        print(f"[build] tile {t[0]}x{t[1]}: "
              + ("cached library reused" if secs is None else f"nvcc {secs:.2f} s"), flush=True)
    print(f"[build] the {len(NEW_TILES)} new tiles' libraries in "
          f"{time.perf_counter() - t0:.2f} s (built at once)", flush=True)
    return seconds


def refused_tiles() -> list:
    """Each of REFUSED_TILES raises before anything runs: the wrapper
    ValueError naming the rule or the bytes, the Engine NotImplementedError
    naming ROADMAP Queue 1 item 17; no launch, no library built."""
    import torch

    from tpu_renderer_torch.config import RendererConfig
    from tpu_renderer_torch.engine import Engine
    from tpu_renderer_torch.kernels import _build, raster

    out = []
    dev = torch.device("cuda")
    rows = torch.zeros((raster.CHUNK, raster.ROW_COLS), dtype=torch.float32, device=dev)
    bins = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    counts = torch.zeros((1,), dtype=torch.int32, device=dev)
    for tile in REFUSED_TILES:
        reset_counters()
        why = raster.tile_rule(*tile)
        assert why is not None, tile
        try:
            raster.rasterize_fused(rows, bins, counts, tiles_x=1, tiles_y=1,
                                   tile_h=tile[0], tile_w=tile[1])
            raise AssertionError(f"tile {tile} launched")
        except ValueError as e:
            wrapper = str(e)
        try:
            Engine(RendererConfig(tile_h=tile[0], tile_w=tile[1]))
            raise AssertionError(f"the Engine took tile {tile}")
        except NotImplementedError as e:
            engine = str(e)
        assert why in wrapper and "Queue 1 item 17" in engine, (wrapper, engine)
        assert not any(read_counters().values()) and tile not in _build._tile_libs
        print(f"[tile] {tile[0]}x{tile[1]} refused before any build or launch: {wrapper}; "
              f"Engine: {engine}", flush=True)
        out.append(dict(tile=f"{tile[0]}x{tile[1]}", refused=why))
    return out


def tile_phase(scene_path, lines):
    """Phase 17: RendererConfig(tile_h, tile_w) at every tile of
    raster.TILES, the default first, then at NEW_TILES (their libraries
    built first, at once). For each tile, on the bench, textured-glass and
    deferred frames at 1920x1080: each kernel the frame runs (2.1-2.5) and
    the oracles on inputs made from them (2.6-2.8), timed on those inputs
    with its bound, and held to its plain version bit for bit on the same
    inputs (at the default tile phases 3-11 hold them); then the path's
    graphed frames counted (counted_frames: counters to 0, a draw, the
    timed frames, counters read; the path's kernels must launch), each
    image byte for byte the default tile's; the background kernels
    2.9-2.11 against their plain versions at 1920x1080 and 1700x900 padded
    to that tile's whole tiles (1728 wide at 64-pixel tiles: a half row
    segment). Then REFUSED_TILES. Appends a line a tile to `lines`."""
    import gc

    import torch

    from tpu_renderer_torch.kernels import raster

    default = (raster.TILE_H, raster.TILE_W)
    built = build_new_tiles()
    images = {}
    for tile in [default] + [t for t in raster.TILES if t != default] + list(NEW_TILES):
        t0 = time.perf_counter()
        label = f"{tile[0]}x{tile[1]}"
        check = tile != default
        warps, passes = raster.tile_blocks(*tile)
        entry = dict(tile=label, warps=warps, passes=passes,
                     smem_bytes=max(raster.tile_smem(*tile).values()),
                     nvcc_s=built.get(tile), frame_ms={}, launches={}, kernels={})
        plain_s = frames_s = 0.0
        for path, names in TILE_PATHS.items():
            eng = mesh_engine(path, scene_path, tile_h=tile[0], tile_w=tile[1])
            if path == "deferred":
                eng.draw()          # escalates the caps (a capture a step)
            for name, call in tile_calls(eng, path).items():
                r = entry["kernels"][name] = hold_at_tile(name, call, tile, check)
                plain_s += r["plain_s"] or 0.0
                bins, counts = call[0][1], call[0][2]
                print(f"[tile] {label} {name} ({path} frame): bins {tuple(bins.shape)}, "
                      f"entries {int(counts.clamp(max=bins.shape[1]).sum())}, max/tile "
                      f"{int(counts.max())}; "
                      + (f"exact vs plain (max_abs_err {r['max_abs_err']}; plain "
                         f"{r['plain_s']:.1f} s)" if check
                         else "held to its plain version in phases 3-11")
                      + f"; device {r['device_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
                      f"{r['bound_by']}", flush=True)
            n = (2 * TILE_FRAMES if tile == default
                 else OLD_TILE_FRAMES if tile in raster.TILES else TILE_FRAMES)
            t = time.perf_counter()
            ms, image, layers, _, launches = counted_frames(eng, n, f"{path} at {label}", names)
            frames_s += time.perf_counter() - t
            if tile == default:
                images[path] = image
            assert np.array_equal(image, images[path]), \
                f"the {path} frame at {label} differs from the {default[0]}x{default[1]} frame"
            entry["frame_ms"][path] = ms
            entry["launches"][path] = {k: v for k, v in launches.items() if v}
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        for name in BACKGROUND_KERNELS:
            for w, h in TILE_BACKGROUND_EXTENTS:
                call = tile_background_calls(w, h, *tile, torch.device("cuda"))[name]
                r = hold_at_tile(name, call, tile, True)
                print(f"[tile] {label} {name} at {w}x{h} (buffer "
                      f"{call[1]['height_pad']}x{call[1]['width_pad']}): exact vs plain "
                      f"(max_abs_err {r['max_abs_err']}); device {r['device_ms']:.4f} ms, "
                      f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}", flush=True)
                if (w, h) == TILE_BACKGROUND_EXTENTS[0]:
                    entry["kernels"][name] = r
        smem = raster.block_smem(*tile)
        assert smem == raster.tile_smem(*tile), (label, smem, raster.tile_smem(*tile))
        if passes > 1:
            entry["clusters"] = raster.max_clusters(*tile)
        entry["seconds"] = time.perf_counter() - t0
        print(f"[tile] {label} ({warps} warps a block, {passes} pass(es), "
              f"{entry['smem_bytes']} B of shared memory a block at most, each kernel's as "
              f"the compiler laid it out"
              + (f", clusters of 8 that fit at once {entry['clusters']}" if passes > 1 else "")
              + f"): the bench, textured-glass and deferred frames equal the "
              f"{default[0]}x{default[1]} frames byte for byte; graphed frame ms (median of "
              f"{n}) " + ", ".join(f"{p} {v:.3f}" for p, v in entry["frame_ms"].items())
              + f"; {entry['seconds']:.1f} s (2.1-2.8's plain versions {plain_s:.1f} s, the "
              f"graphed frames {frames_s:.1f} s)", flush=True)
        lines.append(entry)
    lines.extend(refused_tiles())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tpu_renderer_torch.kernels import _build
    from tpu_renderer_torch.utils.bench_frame import BENCH, bench_engine, nvidia_smi

    smi = nvidia_smi()
    print(f"[device] {smi}", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    _build.load_library(verbose=True)
    print(build_line(_build.build_seconds, time.perf_counter() - t0), flush=True)

    t0 = time.perf_counter()
    scene_path = os.path.join(OUT_DIR, f"bench_scene_{BENCH['grid']}.glb")
    eng = bench_engine(scene_path)
    print(f"[scene] bench scene ready in {time.perf_counter() - t0:.2f} s", flush=True)
    results = {}
    t0 = time.perf_counter()
    inputs = {}    # frames' own kernel calls, kept for the gathered oracles

    def phase(fn, *args):
        t = time.perf_counter()
        fn(*args)
        print(f"[time] {fn.__name__}: {time.perf_counter() - t:.1f} s", flush=True)

    phase(bench_path, eng, results, inputs)
    del eng
    phase(stress_path, os.path.join(OUT_DIR, f"bench_scene_{2 * BENCH['grid']}.glb"))
    phase(hazard_path)
    phase(textured_glass_path, scene_path, results, inputs)
    phase(deferred_path, scene_path, results, inputs)
    phase(past_the_guard, inputs)
    # phase 17, whose plain versions loop longest, before the first
    # torch.profiler session (phase 5b's, moved after phase 11): after one,
    # the process's eager launches are slower, and phase 17's plain versions
    # took 39% longer run last
    tile_lines = []
    phase(tile_phase, scene_path, tile_lines)
    phase(structure_goldens)
    phase(background_phase, results)
    phase(cli_phase, results)
    phase(scale_and_pipeline_phase, scene_path)
    phase(gathered_phase, results, inputs)
    phase(split_phase, inputs)
    del inputs
    phase(profile_tool_phase, results)
    phase(bench_phase)
    multichip_lines = []
    phase(multichip_phase, scene_path, multichip_lines)
    phase(surface_phase, scene_path)
    phase(graphed_phase, scene_path)
    print(f"[smoke] phases took {time.perf_counter() - t0:.1f} s", flush=True)

    print(json.dumps({"multichip": multichip_lines}))
    print(json.dumps({"tiles": tile_lines}))
    print(json.dumps({"kernels": [results[n] for n in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())

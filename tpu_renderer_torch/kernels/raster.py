"""Tile rasterizer: screen sort, tile binning, and the raster passes of the
frame, each a hand-written CUDA kernel beside its plain PyTorch twin.

Fused path (dense chunk bins, 48-column fat rows):

* ``rasterize_fused``: the opaque pass. Per tile, walk the tile's
  binned CHUNK-triangle chunks in ascending chunk id; for each live
  GROUP-triangle group (the entry's gmask bit) evaluate the 3 edge planes
  with the top-left fill rule and the depth plane; reversed-Z ``>=`` with
  later-wins into z/tid. The winner's attribute-numerator planes and
  per-triangle constants come out with it (csrc/raster_fused.cu).
* ``rasterize_accum``: the untextured transparent pass. Every covered
  fragment with z >= the opaque z adds its shaded color, in ascending
  triangle order, and counts (csrc/raster_accum.cu).
* ``rasterize_peel_fused``: one textured-transparency peel. Per pixel the
  smallest triangle id > last that covers it with z >= the opaque z, and
  that triangle's planes (csrc/raster_peel.cu).

``rasterize_fused_chunks`` / ``rasterize_accum_chunks`` take capped chunk
bins (bin_triangles) instead: every entry gets an all-live group mask and
goes through the same two kernels.

Deferred path (capped per-triangle bins, 16-column packed setup rows):
``bin_triangles`` / ``refine_bins`` / ``expand_bins`` build the bins;
``rasterize`` is the visibility pass (z, tid) and ``rasterize_peel`` the
peel (layer id), both in csrc/raster_deferred.cu.

Gathered-row oracles (per-triangle bins over the 48-column fat rows, walked
in slot order; csrc/raster_gathered.cu): ``rasterize_fused_gathered``,
``rasterize_accum_gathered`` and ``rasterize_peel_gathered`` compute what
the three fused-path passes compute from another bin format. No frame runs
them: tools/profile_raster.py times the first, and the cross-checks hold
each stream kernel to its oracle bit for bit.

Names, this module <-> tpu_renderer/kernels/raster.py of the JAX package
(there the unsuffixed ``*_fused`` names are the gathered oracles):

    rasterize_fused            <-> rasterize_fused_slabs    (kernel 2.1)
    rasterize_accum            <-> rasterize_accum_slabs    (kernel 2.2)
    rasterize_peel_fused       <-> rasterize_peel_slabs     (kernel 2.3)
    rasterize_fused_chunks     <-> rasterize_fused_chunks   (kernel 2.1)
    rasterize_accum_chunks     <-> rasterize_accum_chunks   (kernel 2.2)
    rasterize                  <-> rasterize                (kernel 2.4)
    rasterize_peel             <-> rasterize_peel           (kernel 2.5)
    rasterize_fused_gathered   <-> rasterize_fused          (kernel 2.6)
    rasterize_accum_gathered   <-> rasterize_accum_fused    (kernel 2.7)
    rasterize_peel_gathered    <-> rasterize_peel_fused     (kernel 2.8)

On a CPU tensor each wrapper runs the plain version; on a CUDA tensor it
launches the kernel (and raises if it cannot). The kernels take every tile
that tile_rule takes, chosen at launch: those of TILES from the main
library, any other from a library built for it at its first use
(_build.load_tile_library); the plain versions take any tile. The plain
versions loop over bin slots, vectorised across tiles, and evaluate
triangles in the same per-pixel order as the kernels, so both agree bit
for bit. Inside utils.profiling.debug_mode each kernel launcher's float
outputs are checked for NaN (``checked``), as torch's own operations are.

``pad_for_raster`` and ``full_bins`` are the JAX package's helpers for
small scenes and tests: inert padding rows to a chunk multiple, and bins
in which every tile tests every chunk.

Dense bin entries are ``cid << entry_shift | gmask`` (bin_triangles_full),
the JAX package's layout, so bins from either package read the same.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpu_renderer_torch.kernels import _build
from tpu_renderer_torch.kernels.common import cdiv, fma
from tpu_renderer_torch.utils.profiling import checked

DEPTH_CLEAR = 0.0  # vk_initializers.cpp:144 (reversed-Z)
NO_TRI = -1
ID_INF = 0x7FFFFFF  # the peels' "no fragment" marker (> any triangle id)
# Triangles per binning chunk and per gmask skip group. The kernels stage
# one chunk's fat rows in shared memory (CHUNK x 48 f32 = 6 KB) and test one
# gmask bit per group; csrc/raster_common.cuh fixes both at compile time.
# The plain versions also take other values (the JAX tests bin at CHUNK=8).
CHUNK = 32
GROUP = 8
TILE_H, TILE_W = 32, 128  # the default tile (RendererConfig's)
# The tiles the main kernel library ships built (with_tile in
# csrc/raster_common.cuh); every other tile tile_rule takes is built on
# demand, into a library of its own.
TILES = ((8, 64), (8, 128), (16, 64), (16, 128), (32, 64), (32, 128))
ROW_COLS = 48        # fat-row width (shade.py layout)
SETUP_COLS = 16      # packed setup-row width (vertex.triangle_setup_c)
_EMPTY_AABB = (-1.0, -1.0, -2.0, -2.0)

# Kernel A's per-winner constant planes, read straight off the fat row:
# [C_TEX x6 (31-36), C_GRAD x6 (37-42), den_c (43), nu_c (29), nv_c (30)]
META_COLS = tuple(range(31, 44)) + (29, 30)
N_NUMS = 4   # interpolated numerator planes: light_num, r, g, b
# How kernels 2.1 and 2.2 spread a tile's work (csrc/raster_fused.cu,
# raster_accum.cu and raster_common.cuh fix these at compile time). A warp
# owns a REGION_W x REGION_H pixel region and skips the triangles whose
# edge planes miss it, and the region rows they miss (region_rows). 2.1
# cuts a tile's entries into contiguous segments, one for every
# FUSED_SEG_MIN entries and at most FUSED_SPLIT, one a block of the tile's
# thread-block cluster, and folds the segments' winners in order
# (fused_segments); 2.2 keeps the walk whole and gives each of
# accum_split(tile_w) blocks a 32-column strip of the tile.
REGION_W, REGION_H = 32, 8
FUSED_SPLIT = 8
FUSED_SEG_MIN = 4
# The peels 2.3, 2.5 and 2.8 (csrc/raster_peel.cu, raster_deferred.cu,
# raster_gathered.cu, raster_common.cuh) cut a tile's entries the same way,
# into at most PEEL_SPLIT segments of a cluster, one for every PEEL_SEG_MIN
# chunk entries (2.3) or DEFERRED_SEG_MIN triangle entries (2.5, 2.8), and
# merge the segments' layers by a min (peel_segments). 2.7 splits the
# pixels as 2.2 does, finer: gathered_accum_blocks(tile_h, tile_w) blocks a
# tile, one a region, each walking the tile's whole per-triangle list.
PEEL_SPLIT = 8
PEEL_SEG_MIN = 4
DEFERRED_SEG_MIN = 32
# The visibility walks 2.4 and 2.6 (vis_tile in csrc/raster_common.cuh)
# cut a tile's per-triangle entries into at most VIS_SPLIT segments of a
# cluster, one for every VIS_SEG_MIN entries, and fold the segments'
# winners in order, as 2.1 does (vis_segments).
VIS_SPLIT = 8
VIS_SEG_MIN = 32
# The blocks' shape and shared memory (Tile, FusedSmem, VisSmem, ... in
# csrc/): a block is at most MAX_WARPS warps, a warp a 32x8 region a pass;
# the cp.async ring holds AHEAD + 2 chunks of fat rows; the batches of
# 2.4-2.6 and 2.8 keep 13 floats an entry (COEF_STRIDE). SMEM_OPT_IN is the
# shared memory an H100 block can opt into (227 KB).
MAX_WARPS = 16
AHEAD = 2
COEF_STRIDE = 13
SMEM_OPT_IN = 232_448
# The JAX package's gathered kernels carry the triangle id as a float in
# column 47, exact below 2^24; the port's take the bin entry itself and
# refuse larger tables, so the two cannot diverge silently.
MAX_GATHERED_TRIS = 1 << 24


def accum_split(tile_w: int) -> int:
    """Kernel 2.2's blocks a tile: one a 32-column strip."""
    return tile_w // REGION_W


def gathered_accum_blocks(tile_h: int, tile_w: int) -> int:
    """Kernel 2.7's blocks a tile: one a 32x8 region."""
    return (tile_w // REGION_W) * (tile_h // REGION_H)


def _largest_divisor(n: int, cap: int) -> int:
    return next(d for d in range(min(n, cap), 0, -1) if n % d == 0)


def tile_blocks(tile_h: int, tile_w: int) -> tuple:
    """(warps, passes) of a kernel block at a tile of whole 32x8 regions
    (Tile in csrc/raster_common.cuh): a warp a region, at most MAX_WARPS;
    a tile of more regions is walked in passes of the largest divisor of
    its regions up to MAX_WARPS."""
    regions = (tile_h // REGION_H) * (tile_w // REGION_W)
    warps = _largest_divisor(regions, MAX_WARPS)
    return warps, regions // warps


def tile_smem(tile_h: int, tile_w: int) -> dict:
    """Bytes of shared memory a block of each raster kernel takes at the
    tile (the layouts of csrc/): a tile of one pass aliases its walk's
    buffer and its merge buffer, a tile of several keeps both."""
    warps, passes = tile_blocks(tile_h, tile_w)
    pix, threads = tile_h * tile_w, warps * 32
    ring = (AHEAD + 2) * CHUNK * ROW_COLS
    batch = threads * COEF_STRIDE
    one = passes == 1
    floats = {
        "2.1": max(ring, 2 * pix) if one else ring + 2 * pix,
        "2.2": ring,
        "2.3": ring if one else ring + pix,
        "2.4": 2 * pix + threads if one else batch + 2 * pix + threads,
        "2.5": batch + threads if one else batch + threads + pix,
        "2.7": ring,
    }
    floats["2.6"], floats["2.8"] = floats["2.4"], floats["2.5"]
    return {k: 4 * floats[k] for k in sorted(floats)}


def tile_rule(tile_h: int, tile_w: int):
    """Why the CUDA raster kernels refuse the tile, or None if they take
    it. The rule: whole 32x8 warp regions (tile_h % 8 == 0, tile_w % 32 ==
    0), and every kernel's block within the SMEM_OPT_IN bytes of shared
    memory an H100 block can opt into. Pure and host-side: it reads no
    device, so it cannot see whether each cluster of 8 blocks (2.1,
    2.3-2.6, 2.8) can be scheduled. On a whole H100 one can: a block then
    fits an SM (at most 512 threads, 64 registers a thread) and the 8
    blocks go on 8 SMs of one GPC, which holds 16 or more. Where the card
    offers less (a MIG slice, an MPS limit), the card's own check refuses
    the tile: loading a tile's library runs cudaOccupancyMaxActiveClusters
    for each clustered kernel (_build.setup_tile), after the tile's build
    and before any of its kernels launches, and raises ValueError where no
    cluster fits. A tile of TILES is one pass a block, 24-35 KB, and needs
    no such check."""
    if tile_h < REGION_H or tile_w < REGION_W or tile_h % REGION_H or tile_w % REGION_W:
        return (f"a tile is whole {REGION_W}x{REGION_H} warp regions (tile_h % {REGION_H} "
                f"== 0, tile_w % {REGION_W} == 0); got {tile_h}x{tile_w}")
    smem = tile_smem(tile_h, tile_w)
    worst = max(smem, key=smem.get)
    if smem[worst] > SMEM_OPT_IN:
        return (f"tile {tile_h}x{tile_w} needs {smem[worst]:,} bytes of shared memory a "
                f"block (kernel {worst}), past the {SMEM_OPT_IN:,} an H100 block can opt into")
    return None


def check_tile(tile_h: int, tile_w: int, what: str = "raster kernels") -> None:
    """Raise ValueError unless the CUDA kernels take the tile (tile_rule)."""
    why = tile_rule(tile_h, tile_w)
    if why is not None:
        raise ValueError(f"the CUDA {what} refuse the tile: {why}")


def entry_shift(n_groups: int) -> int:
    """Bits below the chunk id in a bin entry: 4 hold up to 4 group bits."""
    assert 1 <= n_groups <= 8
    return 4 if n_groups <= 4 else 8


def pad_tris(n: int, chunk: int = CHUNK) -> int:
    return cdiv(n, chunk) * chunk


def _empty_box(dtype, device):
    """_EMPTY_AABB as a (4,) tensor, made on the device (a host value copied
    in would wait for the card, and cannot be captured in a CUDA graph)."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device)
                        for v in _EMPTY_AABB])


def pad_for_raster(packed, aabb, valid, chunk: int = CHUNK):
    """Triangle arrays padded to a chunk multiple with inert rows (the JAX
    package's raster.pad_for_raster): zero rows (zero edge planes, never
    covered), the empty box (binned nowhere) and False validity."""
    n = packed.shape[0]
    pad = pad_tris(n, chunk) - n
    if pad:
        packed = torch.nn.functional.pad(packed, (0, 0, 0, pad))
        aabb = torch.cat([aabb, _empty_box(aabb.dtype, aabb.device).expand(pad, 4)])
        valid = torch.nn.functional.pad(valid, (0, pad))
    return packed, aabb, valid


# ---------------------------------------------------------------------------
# Screen sort and binning (plain PyTorch)
# ---------------------------------------------------------------------------


def sort_order(aabb, valid):
    """Spatial-sort permutation: Hilbert order over 8-px screen cells of
    each box's min corner. The sort is stable, so same-cell triangles keep
    submission order (exact z-ties keep their winners); invalid triangles
    sort to the end."""
    x = torch.clamp(torch.floor(aabb[:, 0]).to(torch.int32) >> 3, 0, 4095)
    y = torch.clamp(torch.floor(aabb[:, 1]).to(torch.int32) >> 3, 0, 4095)
    key = torch.zeros_like(x)
    for i in range(11, -1, -1):
        s = 1 << i
        rx = ((x & s) > 0).to(torch.int32)
        ry = ((y & s) > 0).to(torch.int32)
        key = key + s * s * ((3 * rx) ^ ry)
        # rotate the quadrant
        swap = ry == 0
        flip = swap & (rx == 1)
        fx = torch.where(flip, s - 1 - x, x)
        fy = torch.where(flip, s - 1 - y, y)
        x = torch.where(swap, fy, fx)
        y = torch.where(swap, fx, fy)
    key = torch.where(valid, key, torch.full_like(key, 2 ** 31 - 1))
    return torch.argsort(key, stable=True)


def spatial_sort(aabb, valid, *payloads):
    """Reorder triangles along the Hilbert curve so CHUNK groups get tight
    chunk boxes. Returns (aabb, valid, *payloads), all permuted alike."""
    order = sort_order(aabb, valid)
    return (aabb[order], valid[order]) + tuple(p[order] for p in payloads)


def _box_unions(aabb, valid, n: int):
    """(T, 4) boxes -> (T/n, 4) unions of n consecutive valid boxes
    (+ validity); a block with no valid box gets the empty box."""
    assert aabb.shape[0] % n == 0, "pad triangle arrays to the block size first"
    a = aabb.reshape(-1, n, 4)
    v = valid.reshape(-1, n)
    big = torch.full((), 1e30, dtype=torch.float32, device=aabb.device)
    xmin = torch.where(v, a[..., 0], big).amin(-1)
    ymin = torch.where(v, a[..., 1], big).amin(-1)
    xmax = torch.where(v, a[..., 2], -big).amax(-1)
    ymax = torch.where(v, a[..., 3], -big).amax(-1)
    any_valid = v.any(-1)
    out = torch.stack([xmin, ymin, xmax, ymax], -1)
    empty = _empty_box(torch.float32, aabb.device)
    return torch.where(any_valid[:, None], out, empty[None]), any_valid


def chunk_aabbs(aabb, valid, chunk: int = CHUNK):
    """(T, 4) per-triangle boxes -> (T/chunk, 4) chunk boxes + validity."""
    return _box_unions(aabb, valid, chunk)


def group_aabbs(aabb, valid, group: int = GROUP):
    """(T, 4) per-triangle boxes -> (T/group, 4) skip-group boxes + validity.
    Group i of chunk c covers triangles [c*CHUNK + i*GROUP, ... + GROUP)."""
    return _box_unions(aabb, valid, group)


def _pack_tile_aabb(aabb, tiles_x: int, tiles_y: int, tile_w: int, tile_h: int):
    """Tile-coordinate box packed into one int (tx0 | ty0<<8 | tx1<<16 |
    ty1<<24); empty boxes pack to tx0 > tx1. Needs tiles_x, tiles_y <= 255."""
    tx0 = torch.clamp(torch.floor(aabb[:, 0] / tile_w).to(torch.int32), 0, tiles_x - 1)
    ty0 = torch.clamp(torch.floor(aabb[:, 1] / tile_h).to(torch.int32), 0, tiles_y - 1)
    tx1 = torch.floor(aabb[:, 2] / tile_w).to(torch.int32)
    ty1 = torch.floor(aabb[:, 3] / tile_h).to(torch.int32)
    empty = ((aabb[:, 2] < aabb[:, 0]) | (aabb[:, 3] < aabb[:, 1])
             | (tx1 < 0) | (ty1 < 0))
    tx1 = torch.clamp(tx1, 0, tiles_x - 1)
    ty1 = torch.clamp(ty1, 0, tiles_y - 1)
    tx0 = torch.where(empty, 1, tx0)
    tx1 = torch.where(empty, 0, tx1)
    return tx0 | (ty0 << 8) | (tx1 << 16) | (ty1 << 24)


def _tile_overlap(packed, tiles_x: int, tiles_y: int):
    """(n,) packed tile boxes -> (n_tiles, n) bool overlap matrix."""
    tiles = torch.arange(tiles_x * tiles_y, dtype=torch.int32,
                         device=packed.device)
    tx = (tiles % tiles_x)[:, None]
    ty = (tiles // tiles_x)[:, None]
    x0 = (packed & 0xFF)[None, :]
    y0 = ((packed >> 8) & 0xFF)[None, :]
    x1 = ((packed >> 16) & 0xFF)[None, :]
    y1 = ((packed >> 24) & 0xFF)[None, :]
    return (x0 <= x1) & (x0 <= tx) & (x1 >= tx) & (y0 <= ty) & (y1 >= ty)


def bin_triangles_full(caabb, cvalid, gaabb, gvalid, *, tiles_x: int,
                       tiles_y: int, tile_w: int, tile_h: int):
    """Dense tile binning with no capacity: every (tile, chunk) overlap is
    kept, in ascending chunk id.

    caabb/cvalid: chunk boxes (chunk_aabbs); gaabb/gvalid: the chunks'
    group boxes (group_aabbs). An entry is ``cid << entry_shift | gmask``,
    where gmask marks the groups whose boxes overlap the tile; a chunk no
    group touches is not binned at all.

    Returns (bins (n_tiles, round_up(C, 8)) i32 padded with -1, counts
    (n_tiles,) i32 exact).
    """
    C = caabb.shape[0]
    n_groups = gaabb.shape[0] // max(C, 1)
    assert gaabb.shape[0] == C * n_groups
    shift = entry_shift(n_groups)
    n_tiles = tiles_x * tiles_y
    dev = caabb.device
    pg = _pack_tile_aabb(gaabb, tiles_x, tiles_y, tile_w, tile_h).reshape(C, n_groups)
    gv = gvalid.reshape(C, n_groups)
    gm = torch.zeros((n_tiles, C), dtype=torch.int32, device=dev)
    for g in range(n_groups):
        hg = gv[None, :, g] & _tile_overlap(pg[:, g].contiguous(), tiles_x, tiles_y)
        gm = gm | (hg.to(torch.int32) << g)
    hit = gm > 0
    counts = hit.sum(dim=1, dtype=torch.int32)
    slot = torch.arange(C, dtype=torch.int32, device=dev)[None, :] << shift
    key = torch.where(hit, slot + gm, torch.full_like(gm, 1 << 30))
    key_sorted = torch.sort(key, dim=1).values
    in_bin = torch.arange(C, dtype=torch.int32, device=dev)[None, :] < counts[:, None]
    bins = torch.where(in_bin, key_sorted, torch.full_like(key_sorted, NO_TRI))
    width = cdiv(C, 8) * 8
    if width != C:
        bins = torch.nn.functional.pad(bins, (0, width - C), value=NO_TRI)
    return bins.contiguous(), counts


def full_bins(n_chunks: int, n_tiles: int, bin_cap: int, device="cuda"):
    """Trivial binning, every tile testing every chunk (small scenes and
    tests; the JAX package's raster.full_bins): (bins (n_tiles, bin_cap)
    i32 holding 0..n_chunks-1 then -1, counts (n_tiles,) i32 n_chunks)."""
    if bin_cap < n_chunks:
        raise ValueError(f"bin_cap {bin_cap} < n_chunks {n_chunks}")
    slot = torch.arange(bin_cap, dtype=torch.int32, device=device)
    row = torch.where(slot < n_chunks, slot, NO_TRI)
    bins = row.expand(n_tiles, bin_cap).contiguous()
    counts = torch.full((n_tiles,), n_chunks, dtype=torch.int32, device=device)
    return bins, counts


# ---------------------------------------------------------------------------
# Shared raster arithmetic (the plain versions and the epilogue)
# ---------------------------------------------------------------------------


def _tile_planes(tiles_x: int, tiles_y: int, tile_w: int, tile_h: int, device,
                 tile_y0: int = 0):
    """Pixel-center planes per tile, (n_tiles, tile_h, tile_w) f32 each, of
    the tiles_y tile rows from the frame's tile row tile_y0 (a band: its
    centers are the frame's)."""
    ty = torch.arange(tile_y0, tile_y0 + tiles_y, device=device).repeat_interleave(tiles_x)
    tx = torch.arange(tiles_x, device=device).repeat(tiles_y)
    yy = torch.arange(tile_h, device=device)[None, :, None] + (ty * tile_h)[:, None, None]
    xx = torch.arange(tile_w, device=device)[None, None, :] + (tx * tile_w)[:, None, None]
    X = xx.to(torch.float32) + 0.5
    Y = yy.to(torch.float32) + 0.5
    n = tiles_x * tiles_y
    return X.expand(n, tile_h, tile_w), Y.expand(n, tile_h, tile_w)


def _tiles_to_frame(t, tiles_x: int, tiles_y: int):
    """(..., n_tiles, th, tw) tile-major planes -> (..., Hp, Wp)."""
    lead = t.shape[:-3]
    th, tw = t.shape[-2:]
    t = t.reshape(*lead, tiles_y, tiles_x, th, tw)
    t = t.transpose(-3, -2)
    return t.reshape(*lead, tiles_y * th, tiles_x * tw)


def _plane(a, b, c, X, Y):
    """fma(a, X, b*Y) + c: the JAX reference's a*X + b*Y + c as XLA on the
    CPU contracts it (measured; the CUDA kernels write the same with
    __fmaf_rn/__fmul_rn/__fadd_rn)."""
    return fma(a, X, b * Y) + c


def _edge_cov(a, b, c, X, Y):
    """Top-left fill rule in its explicit form: a zero edge value counts as
    covered iff the interior lies in +x, or below for a horizontal edge.
    Adjacent triangles have exactly negated coefficients on a shared edge,
    so every boundary pixel is covered exactly once."""
    val = _plane(a, b, c, X, Y)
    tl = (a > 0.0) | ((a == 0.0) & (b > 0.0))
    return (val > 0.0) | ((val == 0.0) & tl)


def _coverage(c, X, Y):
    """Coverage of triangle rows c (..., >= 12 columns first, then 1, 1)
    at the pixel centers, with its depth: (covered & zv <= 1, zv)."""
    zv = _plane(c[:, 9], c[:, 10], c[:, 11], X, Y)
    cov = (_edge_cov(c[:, 0], c[:, 1], c[:, 2], X, Y)
           & _edge_cov(c[:, 3], c[:, 4], c[:, 5], X, Y)
           & _edge_cov(c[:, 6], c[:, 7], c[:, 8], X, Y)
           & (zv <= 1.0))
    return cov, zv


def _frame_to_tiles(t, tiles_x: int, tiles_y: int, tile_w: int, tile_h: int):
    """(Hp, Wp) plane -> (n_tiles, tile_h, tile_w) tile-major planes."""
    return t.reshape(tiles_y, tile_h, tiles_x, tile_w).transpose(1, 2) \
        .reshape(tiles_x * tiles_y, tile_h, tile_w)


def _slot_rows(rows, bins, counts, k: int, chunk: int, group: int):
    """One bin slot across all tiles: the chunk's rows (n_tiles, chunk, 48),
    the triangle-id base (n_tiles,) and a per-(tile, triangle) liveness mask
    from the entry's gmask bit (dead past the tile's count)."""
    n_groups = chunk // group
    shift = entry_shift(n_groups)
    live = k < counts
    entry = torch.where(live, bins[:, k], 0)
    cid = (entry >> shift).long()
    gmask = entry & ((1 << n_groups) - 1)
    grp = torch.arange(chunk, device=rows.device) // group
    on = ((gmask[:, None] >> grp[None, :]) & 1).bool() & live[:, None]
    r = rows.reshape(-1, chunk, ROW_COLS)[cid]
    return r, cid * chunk, on


def _visibility_plain(rows, bins, counts, X, Y, chunk: int, group: int):
    """Opaque visibility walk: (z, tid) per tile pixel, later-wins on ties."""
    n_tiles = X.shape[0]
    z = torch.full(X.shape, DEPTH_CLEAR, dtype=torch.float32, device=X.device)
    tid = torch.full(X.shape, NO_TRI, dtype=torch.int32, device=X.device)
    for k in range(int(counts.max()) if n_tiles else 0):
        r, base, on = _slot_rows(rows, bins, counts, k, chunk, group)
        for t in range(chunk):
            c = r[:, t, :, None, None]   # (n_tiles, 48, 1, 1)
            cov, zv = _coverage(c, X, Y)
            # zv >= 0 is subsumed by zv >= z (z starts at 0)
            take = cov & (zv >= z) & on[:, t, None, None]
            z = torch.where(take, zv, z)
            tid = torch.where(take, (base + t).to(torch.int32)[:, None, None], tid)
    return z, tid


def _winner_planes(rows, tid, X, Y):
    """The winner's numerator planes (4, ...) evaluated at the pixel centers
    and its constant planes (15, ...) in META_COLS order; zero where no
    triangle won."""
    won = tid >= 0
    cols = (list(range(13, 17)) + list(range(19, 23)) + list(range(25, 29))
            + list(META_COLS))
    w = rows[:, cols][tid.clamp(min=0).long()]          # (..., 27)
    w = torch.where(won[..., None], w, torch.zeros((), device=w.device))
    nums = torch.stack([_plane(w[..., a], w[..., 4 + a], w[..., 8 + a], X, Y)
                        for a in range(N_NUMS)])
    nums = torch.where(won[None], nums, torch.zeros((), device=w.device))
    metas = w[..., 12:].movedim(-1, 0)
    return nums, metas


def reconstruct_outputs(nums, metas, X, Y):
    """Public fused-raster contract from the carried planes, shared by the
    kernel and the plain version (the JAX package's _reconstruct_outputs).

    nums: (4, Hp, Wp) pre-divide [light_num, r, g, b] numerators; metas:
    (15, Hp, Wp) [tex6, nu_a, nu_b, nv_a, nv_b, den_a, den_b, den_c, nu_c,
    nv_c]. Returns (attrs (6, Hp, Wp), metas (13, Hp, Wp), inv (Hp, Wp)).
    Winnerless pixels have zero metas -> den 0 -> inv 0 -> attrs 0.
    """
    g = metas[6:]
    den = _plane(g[4], g[5], g[6], X, Y)
    inv = torch.where(den != 0.0, 1.0 / den, torch.zeros((), device=den.device))
    u_num = _plane(g[0], g[1], g[7], X, Y)
    v_num = _plane(g[2], g[3], g[8], X, Y)
    attrs = torch.cat([nums, u_num[None], v_num[None]]) * inv[None]
    return attrs, metas[:13], inv


def _frame_planes(hp: int, wp: int, device, y0: int = 0):
    """Pixel-center planes (hp, wp) of the frame's rows y0 .. y0 + hp."""
    X = torch.arange(wp, device=device, dtype=torch.int32).to(torch.float32) + 0.5
    Y = torch.arange(y0, y0 + hp, device=device, dtype=torch.int32).to(torch.float32) + 0.5
    return X[None, :].expand(hp, wp), Y[:, None].expand(hp, wp)


def fused_segments(counts, bin_width: int, split: int = FUSED_SPLIT,
                   seg_min: int = FUSED_SEG_MIN):
    """Per tile, the segments kernel 2.1 cuts its n = clamp(count, 0,
    bin_width) entries into: ceil(n / seg_min), at least 1 and at most
    split. Segment q of s covers entries [n q // s, n (q + 1) // s)
    (segment_bounds); the kernel computes the same from counts itself."""
    n = counts.clamp(0, bin_width)
    return ((n + seg_min - 1) // seg_min).clamp(1, split)


def peel_segments(counts, bin_width: int, seg_min: int = PEEL_SEG_MIN):
    """Per tile, the segments kernel 2.3 (seg_min=PEEL_SEG_MIN) or 2.5 and
    2.8 (seg_min=DEFERRED_SEG_MIN) cut their entries into: fused_segments'
    cut at PEEL_SPLIT."""
    return fused_segments(counts, bin_width, PEEL_SPLIT, seg_min)


def vis_segments(counts, bin_width: int):
    """Per tile, the segments kernels 2.4 and 2.6 cut their entries into:
    fused_segments' cut at VIS_SPLIT and VIS_SEG_MIN."""
    return fused_segments(counts, bin_width, VIS_SPLIT, VIS_SEG_MIN)


def segment_bounds(n, segs, q):
    """Entries [start, end) of segment q of segs over n entries."""
    return n * q // segs, n * (q + 1) // segs


def region_rows(rows, x0, y0, w: int = REGION_W, h: int = REGION_H):
    """The per-region reject of kernels 2.1-2.8 (edge_rows in
    csrc/raster_common.cuh), in float64: for each row r of the w x h region
    at pixel (x0, y0), False only where some edge plane of the triangle row
    is negative, as the kernels evaluate it in float32, at every pixel
    center of that region row — then the triangle covers none of them. The
    exact maximum over the row's centers plus a margin of 2^-21 of
    |a| max|x| + |b| max|y| + |c| over the region (three float roundings
    stay below 2^-22 of it) and 2^-140 (subnormals) must stay below 0;
    coefficients of 2^100 and more, inf and NaN reject no row.

    rows: (..., >= 9) edge planes; x0, y0: ints or tensors broadcasting
    against rows[..., 0]. Returns a bool tensor of that shape + (h,)."""
    c = rows[..., :9].double()
    xc, hw, xa = x0 + 0.5 * w, 0.5 * (w - 1), x0 + w - 0.5
    ya = y0 + h - 0.5
    ys = torch.as_tensor(y0, dtype=torch.float64)[..., None] + 0.5 + torch.arange(
        h, dtype=torch.float64)
    ok = True
    for e in range(3):
        a, b, k = c[..., 3 * e], c[..., 3 * e + 1], c[..., 3 * e + 2]
        mag = a.abs() * xa + b.abs() * ya + k.abs()
        top = a * xc + a.abs() * hw + k + (mag * 2.0 ** -21 + 2.0 ** -140)
        ok = ok & (~(mag < 2.0 ** 100)[..., None] | ~(top[..., None] + b[..., None] * ys < 0.0))
    return ok


# ---------------------------------------------------------------------------
# Kernel A: opaque fused raster
# ---------------------------------------------------------------------------


def rasterize_fused_plain(rows, bins, counts, *, tiles_x: int, tiles_y: int,
                          tile_w: int, tile_h: int, chunk: int = CHUNK,
                          group: int = GROUP, tile_y0: int = 0):
    """Plain PyTorch twin of the raster_fused kernel: (z (Hp, Wp) f32,
    tid (Hp, Wp) i32, nums (4, Hp, Wp) f32, metas (15, Hp, Wp) f32) over
    the band of tiles_y tile rows from the frame's tile row tile_y0."""
    X, Y = _tile_planes(tiles_x, tiles_y, tile_w, tile_h, rows.device, tile_y0)
    z, tid = _visibility_plain(rows, bins, counts, X, Y, chunk, group)
    nums, metas = _winner_planes(rows, tid, X, Y)
    f = lambda t: _tiles_to_frame(t, tiles_x, tiles_y).contiguous()  # noqa: E731
    return f(z), f(tid), f(nums), f(metas)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(rows, bins, counts, tiles_x, tiles_y, tile_w, tile_h,
                  chunk, group, z_base=None, light=None, last=None,
                  cols: int = ROW_COLS, tile_y0: int = 0):
    """Validate a raster pass's tensors (device, dtype, shape, contiguity)
    before they reach the plain version or, as pointers, a kernel. rows
    are (T, 48) fat rows in whole chunks, (T, 48) fat rows of any T < 2^24
    under per-triangle bins (chunk=None, the gathered oracles), or (T, 16)
    packed setup rows (cols=SETUP_COLS, the deferred path). The bins and
    planes are the band's: tiles_y tile rows from the frame's tile row
    tile_y0."""
    dev = rows.device
    if tile_y0 < 0:
        raise ValueError(f"tile_y0 must be >= 0, got {tile_y0}")
    chunked = cols == ROW_COLS and chunk is not None
    whole = not chunked or rows.shape[0] % chunk == 0
    if rows.dim() != 2 or rows.shape[1] != cols or not whole:
        need = f" with T % {chunk} == 0" if chunked else ""
        raise ValueError(f"rows must be (T, {cols}){need}, got {tuple(rows.shape)}")
    if chunk is None and rows.shape[0] >= MAX_GATHERED_TRIS:
        raise ValueError(f"the gathered raster passes take fewer than 2^24 "
                         f"triangles, got {rows.shape[0]}")
    _check("rows", rows, torch.float32, rows.shape, dev)
    n_tiles = tiles_x * tiles_y
    if bins.dim() != 2:
        raise ValueError("bins must be (n_tiles, width)")
    _check("bins", bins, torch.int32, (n_tiles, bins.shape[1]), dev)
    _check("counts", counts, torch.int32, (n_tiles,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no raster for device type {dev.type}")
    if dev.type == "cuda":
        check_tile(tile_h, tile_w)
        if chunked and (chunk, group) != (CHUNK, GROUP):
            raise ValueError(f"the CUDA raster kernels are built for chunk="
                             f"{CHUNK}, group={GROUP}; got chunk={chunk}, "
                             f"group={group}")
    frame = (tiles_y * tile_h, tiles_x * tile_w)
    if z_base is not None:
        _check("z_base", z_base, torch.float32, frame, dev)
    if light is not None:
        _check("light", light, torch.float32, (8,), dev)
    if last is not None:
        _check("last", last, torch.int32, frame, dev)


def _check_aligned(rows):
    """Kernels 2.1-2.3 and 2.7 copy fat rows 16 bytes at a time
    (cp.async)."""
    if rows.data_ptr() % 16:
        raise ValueError("rows must start on a 16-byte boundary")


def tile_library(tile_h: int, tile_w: int):
    """The loaded library that holds the raster kernels at the tile: the
    main one for a tile of TILES, else the tile's own, built at its first
    use (a failed build raises; no other tile stands in)."""
    if (tile_h, tile_w) in TILES:
        return _build.load_library()
    return _build.load_tile_library(tile_h, tile_w)


@functools.cache
def _entry(fn_name, tile=None):
    """The C entry point `fn_name` of the main library, or of the tile's
    library (tile_library) where a raster tile is given, looked up once
    (the library is built and loaded at the first lookup)."""
    return getattr(_build.load_library() if tile is None else tile_library(*tile), fn_name)


def _launch(fn_name, *args, tile=None):
    """Call one C entry point (_entry); raise on a CUDA error."""
    err = _entry(fn_name, tile)(*args)
    if err != 0:
        lib = None if tile is None else tile_library(*tile)
        raise RuntimeError(f"{fn_name} failed: {_build.error_string(err, lib)}")


def block_smem(tile_h: int, tile_w: int) -> dict:
    """Kernel (2.1-2.8) -> the bytes of shared memory a block of its
    instance at the tile takes, as the compiler laid the instance out
    (cudaFuncGetAttributes, and the dynamic bytes its launch asks for;
    _build.setup_tile). tile_smem, which the rule reads before any build,
    must equal it."""
    return _build.setup_tile(tile_library(tile_h, tile_w), tile_h, tile_w)


def max_clusters(tile_h: int, tile_w: int) -> dict:
    """Kernel (2.1, 2.3-2.6, 2.8) -> the clusters of 8 blocks that
    cudaOccupancyMaxActiveClusters found room for at the tile, as the
    setup at the load of the tile's library checked it (_build.setup_tile;
    0 at a tile of one pass, which needs no check)."""
    lib = tile_library(tile_h, tile_w)
    return {f"2.{k}": lib.raster_max_clusters(k) for k in (1, 3, 4, 5, 6, 8)}


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _tile_args(tiles_x, tiles_y, tile_h, tile_w):
    """The tile grid and the tile, as every raster launcher takes them."""
    return (ctypes.c_int(tiles_x), ctypes.c_int(tiles_y), ctypes.c_int(tile_h),
            ctypes.c_int(tile_w))


def _raw_stream(device) -> int:
    """The handle of the current CUDA stream of `device`, by torch's own
    raw query (a few hundred ns; torch.cuda.current_stream builds a Stream
    object first, 5-10 us a call on the H100's host)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def _stream(device):
    return ctypes.c_void_p(_raw_stream(device))


class _Counter:
    """Launch counter of one kernel wrapper (chip_smoke reads it to show
    the main path went through the kernel).

    launches counts on the host: the wrapper adds one where it launches
    its kernel, and a CUDA graph replay adds the launches its graph holds
    (frame_graph.FrameGraph). A launch inside a conditional node of a graph
    runs as many times as the node's test lets it, so it counts on the
    card instead, in a tally the node's body adds to
    (kernels/conditional.py); total() adds the tallies in."""

    registry: list = []   # every counter, in the order made

    def __init__(self):
        self.launches = 0
        self._tallies = {}
        _Counter.registry.append(self)

    def tally(self, device):
        """The int64 count on `device` that conditional bodies add this
        kernel's launches to (made at the first call, which must come
        before a capture: a tensor made during one would live in the
        graph's memory and read garbage)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._tallies:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a launch tally is made before the capture "
                                   "that adds to it")
            self._tallies[device] = torch.zeros((), dtype=torch.int64, device=device)
        return self._tallies[device]

    def total(self) -> int:
        """Every launch: the host's count and the tallies (a sync a tally)."""
        return self.launches + sum(int(t) for t in self._tallies.values())

    def reset(self) -> None:
        self.launches = 0
        for t in self._tallies.values():
            t.zero_()

    # what a capture counted: a CUDA graph capture or a conditional body
    # takes a snapshot() before it, restore()s it after (a capture launches
    # nothing) and keeps what moved, which each replay add()s on the host or
    # the body counts on the card (to_device)

    @classmethod
    def snapshot(cls) -> list:
        return [c.launches for c in cls.registry]

    @classmethod
    def restore(cls, snap: list) -> list:
        """Set every count back to `snap`; returns [(counter, launches)]
        counted since."""
        moved = []
        for c, n in zip(cls.registry, snap):
            if c.launches != n:
                moved.append((c, c.launches - n))
                c.launches = n
        return moved

    @staticmethod
    def add(moved: list) -> None:
        for c, n in moved:
            c.launches += n

    @staticmethod
    def to_device(moved: list, device) -> None:
        """Add `moved` to the tallies on `device`: inside a capture, an
        operation each replay of it runs."""
        for c, n in moved:
            c.tally(device).add_(n)

    @classmethod
    def make_tallies(cls, device) -> None:
        """Every counter's tally on `device`, made before a capture adds to
        them."""
        for c in cls.registry:
            c.tally(device)


fused_counter = _Counter()
accum_counter = _Counter()
peel_fused_counter = _Counter()
deferred_counter = _Counter()
peel_counter = _Counter()
fused_gathered_counter = _Counter()
accum_gathered_counter = _Counter()
peel_gathered_counter = _Counter()
# the trace's stamps (utils/profiling.device_span; csrc/trace.cu), on the
# card and in their CPU twin: 0 while tracing is off
stamp_counter = _Counter()


@checked
def raster_fused_kernel(rows, bins, counts, *, tiles_x: int, tiles_y: int,
                        tile_w: int, tile_h: int, tile_y0: int = 0):
    """Launch the raster_fused CUDA kernel (csrc/raster_fused.cu) on CUDA
    tensors: the same (z, tid, nums, metas) as rasterize_fused_plain at
    CHUNK/GROUP. One launch of n_tiles clusters of FUSED_SPLIT blocks over
    the band's tiles (tile_y0); the kernel reads counts itself, so nothing
    here waits on the device."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"raster_fused_kernel takes CUDA tensors, got {dev}")
    _check_inputs(rows, bins, counts, tiles_x, tiles_y, tile_w, tile_h, CHUNK,
                  GROUP, tile_y0=tile_y0)
    _check_aligned(rows)
    hp, wp = tiles_y * tile_h, tiles_x * tile_w
    z = torch.empty((hp, wp), dtype=torch.float32, device=dev)
    tid = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    nums = torch.empty((N_NUMS, hp, wp), dtype=torch.float32, device=dev)
    metas = torch.empty((len(META_COLS), hp, wp), dtype=torch.float32, device=dev)
    _launch("raster_fused_launch", _ptr(rows), _ptr(bins), _ptr(counts),
            ctypes.c_int(bins.shape[1]), ctypes.c_int(rows.shape[0] // CHUNK),
            *_tile_args(tiles_x, tiles_y, tile_h, tile_w), ctypes.c_int(tile_y0),
            _ptr(z), _ptr(tid), _ptr(nums), _ptr(metas), _stream(dev), tile=(tile_h, tile_w))
    fused_counter.launches += 1
    return z, tid, nums, metas


def rasterize_fused(rows, bins, counts, *, tiles_x: int, tiles_y: int,
                    tile_w: int, tile_h: int, chunk: int = CHUNK,
                    group: int = GROUP, tile_y0: int = 0):
    """Opaque fused raster over dense bins (bin_triangles_full).

    rows: (T, 48) f32 fat rows, T % chunk == 0; bins: (n_tiles, W) i32
    entries; counts: (n_tiles,) i32. Returns (z (Hp, Wp) f32, tid (Hp, Wp)
    i32, attrs (6, Hp, Wp), metas (13, Hp, Wp), inv (Hp, Wp)) — the
    contract of the JAX package's rasterize_fused_slabs. CPU tensors take
    the plain version, CUDA tensors the kernel.

    tile_y0: the band's first tile row in the frame (a mesh rank's band;
    0 for the whole frame). The bins and every output are the band's
    tiles_y tile rows, and the pixel centers the frame's, so the band's
    outputs equal the frame's rows tile_y0 * tile_h onward bit for bit.
    """
    dev = rows.device
    tiles = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
                 tile_y0=tile_y0)
    _check_inputs(rows, bins, counts, chunk=chunk, group=group, **tiles)
    if dev.type == "cuda":
        z, tid, nums, metas = raster_fused_kernel(rows, bins, counts, **tiles)
    else:
        z, tid, nums, metas = rasterize_fused_plain(rows, bins, counts, chunk=chunk,
                                                    group=group, **tiles)
    X, Y = _frame_planes(tiles_y * tile_h, tiles_x * tile_w, dev, tile_y0 * tile_h)
    attrs, metas13, inv = reconstruct_outputs(nums, metas, X, Y)
    return z, tid, attrs, metas13, inv


# ---------------------------------------------------------------------------
# Kernel B: untextured transparent accumulation
# ---------------------------------------------------------------------------


def _add_fragments(acc, cnt, c, take, X, Y, light):
    """Add the shaded fragments of triangle rows c (n_tiles, 48, 1, 1) to
    the sums acc (3 planes, in place) where take; returns the new count.
    acc + col * (max(light, 0.1) * power + ambient) (mesh.frag:12-18),
    contracted as XLA does."""
    power, amb = light[3], light[4:7]
    zero = torch.zeros((), device=X.device)
    floor = torch.tensor(0.1, dtype=torch.float32, device=X.device)
    den = _plane(c[:, 41], c[:, 42], c[:, 43], X, Y)
    inv = torch.where(den != 0.0, 1.0 / den, zero)
    ln = _plane(c[:, 13], c[:, 19], c[:, 25], X, Y) * inv
    lit = torch.maximum(ln, floor)
    for ch in range(3):
        col = _plane(c[:, 14 + ch], c[:, 20 + ch], c[:, 26 + ch], X, Y) * inv
        add = fma(col, fma(lit, power, amb[ch]), acc[ch])
        acc[ch] = torch.where(take, add, acc[ch])
    return torch.where(take, cnt + 1, cnt)


def rasterize_accum_plain(rows, bins, counts, z_base, light, *, tiles_x: int,
                          tiles_y: int, tile_w: int, tile_h: int,
                          chunk: int = CHUNK, group: int = GROUP, tile_y0: int = 0):
    """Plain PyTorch twin of the raster_accum kernel: (acc (3, Hp, Wp) f32,
    cnt (Hp, Wp) i32) over the band from tile row tile_y0. Adds per pixel
    in ascending triangle order."""
    X, Y = _tile_planes(tiles_x, tiles_y, tile_w, tile_h, rows.device, tile_y0)
    n_tiles = X.shape[0]
    zb = _frame_to_tiles(z_base, tiles_x, tiles_y, tile_w, tile_h)
    acc = [torch.zeros(X.shape, dtype=torch.float32, device=X.device)
           for _ in range(3)]
    cnt = torch.zeros(X.shape, dtype=torch.int32, device=X.device)
    for k in range(int(counts.max()) if n_tiles else 0):
        r, _, on = _slot_rows(rows, bins, counts, k, chunk, group)
        for t in range(chunk):
            c = r[:, t, :, None, None]
            cov, zv = _coverage(c, X, Y)
            # zv >= 0 is subsumed by zv >= z_base (opaque depth, >= 0)
            take = cov & (zv >= zb) & on[:, t, None, None]
            cnt = _add_fragments(acc, cnt, c, take, X, Y, light)
    return (_tiles_to_frame(torch.stack(acc), tiles_x, tiles_y).contiguous(),
            _tiles_to_frame(cnt, tiles_x, tiles_y).contiguous())


@checked
def raster_accum_kernel(rows, bins, counts, z_base, light, *, tiles_x: int,
                        tiles_y: int, tile_w: int, tile_h: int, tile_y0: int = 0):
    """Launch the raster_accum CUDA kernel (csrc/raster_accum.cu) on CUDA
    tensors: the same (acc, cnt) as rasterize_accum_plain at CHUNK/GROUP.
    One launch of n_tiles x accum_split(tile_w) blocks, with no wait on
    the device."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"raster_accum_kernel takes CUDA tensors, got {dev}")
    _check_inputs(rows, bins, counts, tiles_x, tiles_y, tile_w, tile_h, CHUNK,
                  GROUP, z_base=z_base, light=light, tile_y0=tile_y0)
    _check_aligned(rows)
    hp, wp = tiles_y * tile_h, tiles_x * tile_w
    acc = torch.empty((3, hp, wp), dtype=torch.float32, device=dev)
    cnt = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    _launch("raster_accum_launch", _ptr(rows), _ptr(bins), _ptr(counts),
            ctypes.c_int(bins.shape[1]), ctypes.c_int(rows.shape[0] // CHUNK),
            *_tile_args(tiles_x, tiles_y, tile_h, tile_w), ctypes.c_int(tile_y0),
            _ptr(z_base), _ptr(light), _ptr(acc), _ptr(cnt), _stream(dev), tile=(tile_h, tile_w))
    accum_counter.launches += 1
    return acc, cnt


def rasterize_accum(rows, bins, counts, z_base, light, *, tiles_x: int,
                    tiles_y: int, tile_w: int, tile_h: int,
                    chunk: int = CHUNK, group: int = GROUP, tile_y0: int = 0):
    """Sum-shade every untextured transparent fragment with z >= z_base.

    light: (8,) f32 [sun_dir xyz, sun_power, ambient rgb, 0]. Returns
    (acc (3, Hp, Wp) f32 summed colors, cnt (Hp, Wp) i32 fragments per
    pixel) — the contract of the JAX package's rasterize_accum_slabs. CPU
    tensors take the plain version, CUDA tensors the kernel. tile_y0: the
    band's first tile row, as rasterize_fused takes it (z_base is the
    band's).
    """
    tiles = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
                 tile_y0=tile_y0)
    _check_inputs(rows, bins, counts, chunk=chunk, group=group, z_base=z_base,
                  light=light, **tiles)
    if rows.device.type == "cuda":
        return raster_accum_kernel(rows, bins, counts, z_base, light, **tiles)
    return rasterize_accum_plain(rows, bins, counts, z_base, light, chunk=chunk,
                                 group=group, **tiles)


# ---------------------------------------------------------------------------
# Kernels 2.1 and 2.2 from capped chunk bins
# ---------------------------------------------------------------------------


def _all_live_entries(cbins, n_chunks: int, chunk: int, group: int):
    """Capped chunk bins (raw chunk ids, -1 padding past the count) -> dense
    bin entries with every group live: (cid << entry_shift) | ALL. Padding
    clips onto a real chunk; it lies past the count and is never walked."""
    n_groups = chunk // group
    ids = torch.clamp(cbins, 0, max(n_chunks - 1, 0))
    return ((ids << entry_shift(n_groups)) | ((1 << n_groups) - 1)).contiguous()


def rasterize_fused_chunks(rows, cbins, ccounts, *, tiles_x: int, tiles_y: int,
                           tile_w: int, tile_h: int, chunk: int = CHUNK,
                           group: int = GROUP):
    """Opaque fused raster from capped chunk bins (the JAX package's
    rasterize_fused_chunks): cbins/ccounts are bin_triangles' output over
    the chunk boxes; each entry gets an all-live group mask and the walk is
    rasterize_fused's (kernel 2.1). Same returns."""
    entries = _all_live_entries(cbins, rows.shape[0] // chunk, chunk, group)
    return rasterize_fused(rows, entries, ccounts, tiles_x=tiles_x, tiles_y=tiles_y,
                           tile_w=tile_w, tile_h=tile_h, chunk=chunk, group=group)


def rasterize_accum_chunks(rows, cbins, ccounts, z_base, light, *, tiles_x: int,
                           tiles_y: int, tile_w: int, tile_h: int,
                           chunk: int = CHUNK, group: int = GROUP):
    """Untextured transparent accumulation from capped chunk bins (the JAX
    package's rasterize_accum_chunks), through rasterize_accum (kernel
    2.2). Same returns."""
    entries = _all_live_entries(cbins, rows.shape[0] // chunk, chunk, group)
    return rasterize_accum(rows, entries, ccounts, z_base, light, tiles_x=tiles_x,
                           tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
                           chunk=chunk, group=group)


# ---------------------------------------------------------------------------
# Kernel 2.3: the textured-transparency peel over dense bins
# ---------------------------------------------------------------------------


def rasterize_peel_fused_plain(rows, bins, counts, z_base, last, *,
                               tiles_x: int, tiles_y: int, tile_w: int,
                               tile_h: int, chunk: int = CHUNK,
                               group: int = GROUP, tile_y0: int = 0):
    """Plain PyTorch twin of the raster_peel kernel: (best (Hp, Wp) i32,
    ID_INF where the pixel has no further layer, nums (4, Hp, Wp) f32,
    metas (15, Hp, Wp) f32 of the triangle `best`) over the band from tile
    row tile_y0."""
    X, Y = _tile_planes(tiles_x, tiles_y, tile_w, tile_h, rows.device, tile_y0)
    n_tiles = X.shape[0]
    zb = _frame_to_tiles(z_base, tiles_x, tiles_y, tile_w, tile_h)
    lt = _frame_to_tiles(last, tiles_x, tiles_y, tile_w, tile_h)
    best = torch.full(X.shape, ID_INF, dtype=torch.int32, device=X.device)
    for k in range(int(counts.max()) if n_tiles else 0):
        r, base, on = _slot_rows(rows, bins, counts, k, chunk, group)
        for t in range(chunk):
            cov, zv = _coverage(r[:, t, :, None, None], X, Y)
            idx = (base + t).to(torch.int32)[:, None, None]
            # zv >= 0 is subsumed by zv >= z_base (opaque depth, >= 0); the
            # smallest eligible id stays, whatever the bin order
            take = (cov & (zv >= zb) & (idx > lt) & (idx < best)
                    & on[:, t, None, None])
            best = torch.where(take, idx, best)
    tid = torch.where(best < ID_INF, best, NO_TRI)
    nums, metas = _winner_planes(rows, tid, X, Y)
    f = lambda t: _tiles_to_frame(t, tiles_x, tiles_y).contiguous()  # noqa: E731
    return f(best), f(nums), f(metas)


@checked
def raster_peel_fused_kernel(rows, bins, counts, z_base, last, *,
                             tiles_x: int, tiles_y: int, tile_w: int,
                             tile_h: int, tile_y0: int = 0):
    """Launch the raster_peel CUDA kernel (csrc/raster_peel.cu) on CUDA
    tensors: the same (best, nums, metas) as rasterize_peel_fused_plain at
    CHUNK/GROUP, for bins in any order. One launch of n_tiles clusters of
    PEEL_SPLIT blocks, with no wait on the device."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"raster_peel_fused_kernel takes CUDA tensors, got {dev}")
    _check_inputs(rows, bins, counts, tiles_x, tiles_y, tile_w, tile_h, CHUNK,
                  GROUP, z_base=z_base, last=last, tile_y0=tile_y0)
    _check_aligned(rows)
    hp, wp = tiles_y * tile_h, tiles_x * tile_w
    best = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    nums = torch.empty((N_NUMS, hp, wp), dtype=torch.float32, device=dev)
    metas = torch.empty((len(META_COLS), hp, wp), dtype=torch.float32, device=dev)
    _launch("raster_peel_fused_launch", _ptr(rows), _ptr(bins), _ptr(counts),
            ctypes.c_int(bins.shape[1]), ctypes.c_int(rows.shape[0] // CHUNK),
            *_tile_args(tiles_x, tiles_y, tile_h, tile_w), ctypes.c_int(tile_y0), _ptr(z_base),
            _ptr(last), _ptr(best), _ptr(nums), _ptr(metas), _stream(dev), tile=(tile_h, tile_w))
    peel_fused_counter.launches += 1
    return best, nums, metas


def rasterize_peel_fused(rows, bins, counts, z_base, last, *, tiles_x: int,
                         tiles_y: int, tile_w: int, tile_h: int,
                         chunk: int = CHUNK, group: int = GROUP, tile_y0: int = 0):
    """One transparency peel over dense chunk bins (the JAX package's
    rasterize_peel_slabs): per pixel the smallest triangle id > last that
    covers it and passes z >= z_base, in submission order.

    rows: (T, 48) fat rows in submission order (not sorted: the id is the
    peel order); bins/counts: bin_triangles_full over them; z_base: (Hp, Wp)
    opaque depth; last: (Hp, Wp) i32 previous layer (-1 before the first).
    Returns (best (Hp, Wp) i32, ID_INF where no layer, attrs (6, Hp, Wp),
    metas (13, Hp, Wp), inv (Hp, Wp)). CPU tensors take the plain version,
    CUDA tensors the kernel. tile_y0: the band's first tile row, as
    rasterize_fused takes it (z_base and last are the band's).

    Bin order: the result is a min over the entries, the same for bins in
    any order. The kernel stops a walk early only where a segment's chunk
    ids strictly ascend, as bin_triangles_full writes them; other orders
    cost the early stop, never the result.
    """
    dev = rows.device
    tiles = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
                 tile_y0=tile_y0)
    _check_inputs(rows, bins, counts, chunk=chunk, group=group, z_base=z_base,
                  last=last, **tiles)
    if dev.type == "cuda":
        best, nums, metas = raster_peel_fused_kernel(rows, bins, counts, z_base,
                                                     last, **tiles)
    else:
        best, nums, metas = rasterize_peel_fused_plain(
            rows, bins, counts, z_base, last, chunk=chunk, group=group, **tiles)
    X, Y = _frame_planes(tiles_y * tile_h, tiles_x * tile_w, dev, tile_y0 * tile_h)
    attrs, metas13, inv = reconstruct_outputs(nums, metas, X, Y)
    return best, attrs, metas13, inv


# ---------------------------------------------------------------------------
# The deferred path: capped per-triangle bins (plain PyTorch)
# ---------------------------------------------------------------------------


def _dense_sorted_hits(aabb, valid, *, tiles_x: int, tiles_y: int,
                       tile_w: int, tile_h: int):
    """Dense (n_tiles, T) box-overlap matrix compacted by a row-wise sort:
    each row holds its hits' ids ascending, then the misses. Returns
    (key_sorted (n_tiles, T) i32, counts (n_tiles,) i32 exact)."""
    T = aabb.shape[0]
    packed = _pack_tile_aabb(aabb, tiles_x, tiles_y, tile_w, tile_h)
    hit = valid[None, :] & _tile_overlap(packed, tiles_x, tiles_y)
    counts = hit.sum(dim=1, dtype=torch.int32)
    slot = torch.arange(T, dtype=torch.int32, device=aabb.device)[None, :]
    key = torch.where(hit, slot, slot + T)
    return torch.sort(key, dim=1).values, counts


def bin_triangles(aabb, valid, *, tiles_x: int, tiles_y: int, tile_w: int,
                  tile_h: int, bin_cap: int):
    """Capped tile bins of items (chunk boxes on the deferred path), the JAX
    package's raster.bin_triangles. Returns (bins (n_tiles, bin_cap) i32
    ids ascending, padded with -1; counts (n_tiles,) i32 clamped to the
    cap; overflow () i32, the entries dropped beyond it)."""
    T = aabb.shape[0]
    key_sorted, full_counts = _dense_sorted_hits(
        aabb, valid, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w,
        tile_h=tile_h)
    eff_cap = min(bin_cap, T)
    counts = torch.clamp(full_counts, max=eff_cap)
    in_bin = torch.arange(eff_cap, device=aabb.device)[None, :] < counts[:, None]
    bins = torch.where(in_bin, key_sorted[:, :eff_cap], NO_TRI)
    if eff_cap < bin_cap:
        bins = torch.nn.functional.pad(bins, (0, bin_cap - eff_cap), value=NO_TRI)
    overflow = (full_counts - counts).sum(dtype=torch.int32)
    return bins.contiguous(), counts, overflow


def _chunk_members(chunk_bins, chunk: int):
    """Chunk bins -> every member triangle id (n_tiles, bcap * chunk) and
    which slots hold a binned chunk."""
    n_tiles, bcap = chunk_bins.shape
    members = torch.arange(chunk, dtype=torch.int32, device=chunk_bins.device)
    tri = (torch.where(chunk_bins >= 0, chunk_bins, 0)[:, :, None] * chunk
           + members[None, None, :]).reshape(n_tiles, bcap * chunk)
    slot_ok = (chunk_bins >= 0).repeat_interleave(chunk, dim=1)
    return tri, slot_ok


def expand_bins(chunk_bins, chunk_counts, chunk: int = CHUNK):
    """Chunk bins -> per-triangle bins without the tightening pass (the JAX
    package's raster.expand_bins): each binned chunk becomes its chunk
    member ids, in order."""
    tri, slot_ok = _chunk_members(chunk_bins, chunk)
    return (torch.where(slot_ok, tri, NO_TRI).contiguous(),
            (chunk_counts * chunk).to(torch.int32))


def refine_bins(chunk_bins, aabb, *, tiles_x: int, tiles_y: int, tile_w: int,
                tile_h: int, tri_cap: int, chunk: int = CHUNK):
    """Chunk bins -> tight per-triangle bins (the JAX package's
    raster.refine_bins): the members of each binned chunk whose own box
    overlaps the tile, ascending, compacted by a row-wise sort. Returns
    (tri_bins (n_tiles, min(tri_cap, candidates)) i32, tri_counts
    (n_tiles,) i32 clamped, overflow () i32)."""
    n_tiles, bcap = chunk_bins.shape
    ncand = bcap * chunk
    dev = chunk_bins.device
    tri, slot_ok = _chunk_members(chunk_bins, chunk)
    packed = _pack_tile_aabb(aabb, tiles_x, tiles_y, tile_w, tile_h)
    chunk_rows = packed.reshape(-1, chunk)
    safe = torch.clamp(chunk_bins, 0, chunk_rows.shape[0] - 1).long()
    cand = chunk_rows[safe].reshape(n_tiles, ncand)
    tile_id = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    tx = (tile_id % tiles_x)[:, None]
    ty = (tile_id // tiles_x)[:, None]
    x0, y0 = cand & 0xFF, (cand >> 8) & 0xFF
    x1, y1 = (cand >> 16) & 0xFF, (cand >> 24) & 0xFF
    hit = (slot_ok & (x0 <= tx) & (x1 >= tx) & (y0 <= ty) & (y1 >= ty)
           & (x0 <= x1))
    full_counts = hit.sum(dim=1, dtype=torch.int32)
    eff_cap = min(tri_cap, ncand)
    counts = torch.clamp(full_counts, max=eff_cap)
    # candidate ids ascend within a tile, so sorting the id keeps
    # submission order; misses sort behind every real id
    slot = torch.arange(ncand, dtype=torch.int32, device=dev)[None, :]
    key = torch.where(hit, tri, (1 << 29) + slot)
    key_sorted = torch.sort(key, dim=1).values
    in_bin = torch.arange(eff_cap, device=dev)[None, :] < counts[:, None]
    tri_bins = torch.where(in_bin, key_sorted[:, :eff_cap], NO_TRI)
    overflow = (full_counts - counts).sum(dtype=torch.int32)
    return tri_bins.contiguous(), counts, overflow


# ---------------------------------------------------------------------------
# Kernels 2.4 and 2.5: the deferred raster and peel over per-triangle bins
# ---------------------------------------------------------------------------


def _triangle_slot(packed, bins, counts, k: int):
    """Bin slot k across all tiles: the triangles' packed rows (n_tiles, 16,
    1, 1), their ids (n_tiles, 1, 1) and which tiles hold a real one (k
    inside the count, the id inside the table)."""
    T = packed.shape[0]
    ids = bins[:, k]
    ok = (k < counts) & (ids >= 0) & (ids < T)
    r = packed[torch.clamp(ids, 0, max(T - 1, 0)).long()]
    return r[:, :, None, None], ids[:, None, None], ok[:, None, None]


def _slots(bins, counts) -> int:
    n = int(counts.max()) if counts.numel() else 0
    return min(n, bins.shape[1])


def rasterize_plain(packed, bins, counts, *, tiles_x: int, tiles_y: int,
                    tile_w: int, tile_h: int, tile_y0: int = 0):
    """Plain PyTorch twin of the raster_deferred kernel: (z (Hp, Wp) f32,
    tid (Hp, Wp) i32) over the band from tile row tile_y0, later bin
    entries winning ties."""
    X, Y = _tile_planes(tiles_x, tiles_y, tile_w, tile_h, packed.device, tile_y0)
    z = torch.full(X.shape, DEPTH_CLEAR, dtype=torch.float32, device=X.device)
    tid = torch.full(X.shape, NO_TRI, dtype=torch.int32, device=X.device)
    for k in range(_slots(bins, counts)):
        c, ids, ok = _triangle_slot(packed, bins, counts, k)
        cov, zv = _coverage(c, X, Y)
        take = cov & (zv >= 0.0) & (zv >= z) & ok
        z = torch.where(take, zv, z)
        tid = torch.where(take, ids, tid)
    f = lambda t: _tiles_to_frame(t, tiles_x, tiles_y).contiguous()  # noqa: E731
    return f(z), f(tid)


@checked
def raster_deferred_kernel(packed, bins, counts, *, tiles_x: int, tiles_y: int,
                           tile_w: int, tile_h: int, tile_y0: int = 0):
    """Launch the raster_deferred CUDA kernel (csrc/raster_deferred.cu) on
    CUDA tensors: the same (z, tid) as rasterize_plain, for bins in any
    order. One launch of n_tiles clusters of VIS_SPLIT blocks, with no wait
    on the device."""
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"raster_deferred_kernel takes CUDA tensors, got {dev}")
    _check_inputs(packed, bins, counts, tiles_x, tiles_y, tile_w, tile_h, CHUNK,
                  GROUP, cols=SETUP_COLS, tile_y0=tile_y0)
    hp, wp = tiles_y * tile_h, tiles_x * tile_w
    z = torch.empty((hp, wp), dtype=torch.float32, device=dev)
    tid = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    _launch("raster_deferred_launch", _ptr(packed), ctypes.c_int(packed.shape[0]),
            _ptr(bins), _ptr(counts), ctypes.c_int(bins.shape[1]),
            *_tile_args(tiles_x, tiles_y, tile_h, tile_w), ctypes.c_int(tile_y0), _ptr(z),
            _ptr(tid), _stream(dev), tile=(tile_h, tile_w))
    deferred_counter.launches += 1
    return z, tid


def rasterize(packed, bins, counts, *, tiles_x: int, tiles_y: int, tile_w: int,
              tile_h: int, tile_y0: int = 0):
    """Deferred visibility raster (the JAX package's raster.rasterize).

    packed: (T, 16) f32 setup rows (vertex.triangle_setup_c); bins:
    (n_tiles, W) i32 per-triangle ids in ascending order (refine_bins /
    expand_bins); counts: (n_tiles,) i32. Returns (z (Hp, Wp) f32, tid
    (Hp, Wp) i32, -1 where no triangle). Reversed-Z >=, later bin entries
    win ties. CPU tensors take the plain version, CUDA tensors the kernel.
    tile_y0: the band's first tile row, as rasterize_fused takes it.
    """
    tiles = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
                 tile_y0=tile_y0)
    _check_inputs(packed, bins, counts, chunk=CHUNK, group=GROUP,
                  cols=SETUP_COLS, **tiles)
    if packed.device.type == "cuda":
        return raster_deferred_kernel(packed, bins, counts, **tiles)
    return rasterize_plain(packed, bins, counts, **tiles)


def rasterize_peel_plain(packed, bins, counts, z_base, last, *, tiles_x: int,
                         tiles_y: int, tile_w: int, tile_h: int, tile_y0: int = 0):
    """Plain PyTorch twin of the raster_peel_deferred kernel: layer
    (Hp, Wp) i32 over the band from tile row tile_y0, ID_INF where the
    pixel has no further fragment."""
    X, Y = _tile_planes(tiles_x, tiles_y, tile_w, tile_h, packed.device, tile_y0)
    zb = _frame_to_tiles(z_base, tiles_x, tiles_y, tile_w, tile_h)
    lt = _frame_to_tiles(last, tiles_x, tiles_y, tile_w, tile_h)
    best = torch.full(X.shape, ID_INF, dtype=torch.int32, device=X.device)
    for k in range(_slots(bins, counts)):
        c, ids, ok = _triangle_slot(packed, bins, counts, k)
        cov, zv = _coverage(c, X, Y)
        take = (cov & (zv >= 0.0) & (zv >= zb) & (ids > lt) & (ids < best)
                & ok)
        best = torch.where(take, ids, best)
    return _tiles_to_frame(best, tiles_x, tiles_y).contiguous()


@checked
def raster_peel_kernel(packed, bins, counts, z_base, last, *, tiles_x: int,
                       tiles_y: int, tile_w: int, tile_h: int, tile_y0: int = 0):
    """Launch the raster_peel_deferred CUDA kernel (csrc/raster_deferred.cu)
    on CUDA tensors: the same layer plane as rasterize_peel_plain, for bins
    in any order. One launch of n_tiles clusters of PEEL_SPLIT blocks, with
    no wait on the device."""
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"raster_peel_kernel takes CUDA tensors, got {dev}")
    _check_inputs(packed, bins, counts, tiles_x, tiles_y, tile_w, tile_h, CHUNK,
                  GROUP, z_base=z_base, last=last, cols=SETUP_COLS, tile_y0=tile_y0)
    hp, wp = tiles_y * tile_h, tiles_x * tile_w
    layer = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    _launch("raster_peel_deferred_launch", _ptr(packed),
            ctypes.c_int(packed.shape[0]), _ptr(bins), _ptr(counts),
            ctypes.c_int(bins.shape[1]), *_tile_args(tiles_x, tiles_y, tile_h, tile_w),
            ctypes.c_int(tile_y0), _ptr(z_base), _ptr(last), _ptr(layer), _stream(dev),
            tile=(tile_h, tile_w))
    peel_counter.launches += 1
    return layer


def rasterize_peel(packed, bins, counts, z_base, last, *, tiles_x: int,
                   tiles_y: int, tile_w: int, tile_h: int, tile_y0: int = 0):
    """One deferred transparency peel (the JAX package's
    raster.rasterize_peel): per pixel the smallest triangle id > last that
    covers it with 0 <= z <= 1 and z >= z_base. bins: per-triangle ids
    (refine_bins / expand_bins). Returns (Hp, Wp) i32, ID_INF where no
    fragment. CPU tensors take the plain version, CUDA tensors the kernel.
    tile_y0: the band's first tile row, as rasterize_fused takes it.

    Bin order: the result is a min over the entries, the same for bins in
    any order. The kernel stops a walk early only where a segment's ids
    strictly ascend, as refine_bins and expand_bins write them; other
    orders cost the early stop, never the result.
    """
    tiles = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
                 tile_y0=tile_y0)
    _check_inputs(packed, bins, counts, chunk=CHUNK, group=GROUP, z_base=z_base,
                  last=last, cols=SETUP_COLS, **tiles)
    if packed.device.type == "cuda":
        return raster_peel_kernel(packed, bins, counts, z_base, last, **tiles)
    return rasterize_peel_plain(packed, bins, counts, z_base, last, **tiles)


# ---------------------------------------------------------------------------
# Kernels 2.6, 2.7 and 2.8: the gathered-row oracles over per-triangle bins
# of fat rows. Contract of the bins: counts <= bin width, and every entry
# inside a tile's count is a row of the table. Entries past the count are
# never read; an entry inside it that is no row (negative, >= T) is
# dropped, by the kernels and the plain versions alike (the JAX wrappers
# clip it onto row 0 or T-1 instead). Slots are walked in order and need
# not ascend.
# ---------------------------------------------------------------------------


def _check_gathered(rows, bins, counts, tiles, **planes):
    _check_inputs(rows, bins, counts, chunk=None, group=None, **tiles, **planes)


def rasterize_fused_gathered_plain(rows, bins, counts, *, tiles_x: int,
                                   tiles_y: int, tile_w: int, tile_h: int):
    """Plain PyTorch twin of the raster_fused_gathered kernel: (z (Hp, Wp)
    f32, tid (Hp, Wp) i32, nums (4, Hp, Wp) f32, metas (15, Hp, Wp) f32);
    a later slot wins an equal z."""
    X, Y = _tile_planes(tiles_x, tiles_y, tile_w, tile_h, rows.device)
    z = torch.full(X.shape, DEPTH_CLEAR, dtype=torch.float32, device=X.device)
    tid = torch.full(X.shape, NO_TRI, dtype=torch.int32, device=X.device)
    for k in range(_slots(bins, counts)):
        c, ids, ok = _triangle_slot(rows, bins, counts, k)
        cov, zv = _coverage(c, X, Y)
        take = cov & (zv >= 0.0) & (zv >= z) & ok
        z = torch.where(take, zv, z)
        tid = torch.where(take, ids, tid)
    # the planes are a pure function of (row, pixel): the last taker's,
    # evaluated once, equal a select at every take
    nums, metas = _winner_planes(rows, tid, X, Y)
    f = lambda t: _tiles_to_frame(t, tiles_x, tiles_y).contiguous()  # noqa: E731
    return f(z), f(tid), f(nums), f(metas)


def _gathered_launch_args(rows, bins, counts, tiles):
    return (_ptr(rows), ctypes.c_int(rows.shape[0]), _ptr(bins), _ptr(counts),
            ctypes.c_int(bins.shape[1]), *_tile_args(**tiles))


@checked
def raster_fused_gathered_kernel(rows, bins, counts, *, tiles_x: int, tiles_y: int,
                                 tile_w: int, tile_h: int):
    """Launch the raster_fused_gathered CUDA kernel (csrc/raster_gathered.cu)
    on CUDA tensors: the same (z, tid, nums, metas) as
    rasterize_fused_gathered_plain. One launch of n_tiles clusters of
    VIS_SPLIT blocks (kernel 2.4's walk), with no wait on the device."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"raster_fused_gathered_kernel takes CUDA tensors, got {dev}")
    tiles = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h)
    _check_gathered(rows, bins, counts, tiles)
    hp, wp = tiles_y * tile_h, tiles_x * tile_w
    z = torch.empty((hp, wp), dtype=torch.float32, device=dev)
    tid = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    nums = torch.empty((N_NUMS, hp, wp), dtype=torch.float32, device=dev)
    metas = torch.empty((len(META_COLS), hp, wp), dtype=torch.float32, device=dev)
    _launch("raster_fused_gathered_launch",
            *_gathered_launch_args(rows, bins, counts, tiles),
            _ptr(z), _ptr(tid), _ptr(nums), _ptr(metas), _stream(dev), tile=(tile_h, tile_w))
    fused_gathered_counter.launches += 1
    return z, tid, nums, metas


def rasterize_fused_gathered(rows, bins, counts, *, tiles_x: int, tiles_y: int,
                             tile_w: int, tile_h: int):
    """Fused visibility + attribute raster over per-triangle bins (the JAX
    package's raster.rasterize_fused, the oracle of rasterize_fused).

    rows: (T, 48) f32 fat rows, T < 2^24; bins: (n_tiles, W) i32 triangle
    ids in slot order (refine_bins / expand_bins); counts: (n_tiles,) i32.
    Returns (z (Hp, Wp) f32, tid (Hp, Wp) i32, attrs (6, Hp, Wp), metas
    (13, Hp, Wp), inv (Hp, Wp)). Reversed-Z >= with 0 <= z <= 1; a later
    slot wins an equal z. CPU tensors take the plain version, CUDA tensors
    the kernel.
    """
    dev = rows.device
    tiles = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h)
    _check_gathered(rows, bins, counts, tiles)
    if dev.type == "cuda":
        z, tid, nums, metas = raster_fused_gathered_kernel(rows, bins, counts, **tiles)
    else:
        z, tid, nums, metas = rasterize_fused_gathered_plain(rows, bins, counts, **tiles)
    X, Y = _frame_planes(tiles_y * tile_h, tiles_x * tile_w, dev)
    attrs, metas13, inv = reconstruct_outputs(nums, metas, X, Y)
    return z, tid, attrs, metas13, inv


def rasterize_accum_gathered_plain(rows, bins, counts, z_base, light, *,
                                   tiles_x: int, tiles_y: int, tile_w: int,
                                   tile_h: int):
    """Plain PyTorch twin of the raster_accum_gathered kernel: (acc (3, Hp,
    Wp) f32, cnt (Hp, Wp) i32). Adds per pixel in slot order."""
    X, Y = _tile_planes(tiles_x, tiles_y, tile_w, tile_h, rows.device)
    zb = _frame_to_tiles(z_base, tiles_x, tiles_y, tile_w, tile_h)
    acc = [torch.zeros(X.shape, dtype=torch.float32, device=X.device)
           for _ in range(3)]
    cnt = torch.zeros(X.shape, dtype=torch.int32, device=X.device)
    for k in range(_slots(bins, counts)):
        c, _, ok = _triangle_slot(rows, bins, counts, k)
        cov, zv = _coverage(c, X, Y)
        take = cov & (zv >= 0.0) & (zv >= zb) & ok
        cnt = _add_fragments(acc, cnt, c, take, X, Y, light)
    return (_tiles_to_frame(torch.stack(acc), tiles_x, tiles_y).contiguous(),
            _tiles_to_frame(cnt, tiles_x, tiles_y).contiguous())


@checked
def raster_accum_gathered_kernel(rows, bins, counts, z_base, light, *,
                                 tiles_x: int, tiles_y: int, tile_w: int,
                                 tile_h: int):
    """Launch the raster_accum_gathered CUDA kernel (csrc/raster_gathered.cu)
    on CUDA tensors: the same (acc, cnt) as rasterize_accum_gathered_plain.
    One launch of gathered_accum_blocks blocks a tile, one a 32x8 region,
    each walking the tile's entries in slot order, their rows gathered by
    id; no wait on the device."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"raster_accum_gathered_kernel takes CUDA tensors, got {dev}")
    tiles = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h)
    _check_gathered(rows, bins, counts, tiles, z_base=z_base, light=light)
    _check_aligned(rows)
    hp, wp = tiles_y * tile_h, tiles_x * tile_w
    acc = torch.empty((3, hp, wp), dtype=torch.float32, device=dev)
    cnt = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    _launch("raster_accum_gathered_launch",
            *_gathered_launch_args(rows, bins, counts, tiles),
            _ptr(z_base), _ptr(light), _ptr(acc), _ptr(cnt), _stream(dev), tile=(tile_h, tile_w))
    accum_gathered_counter.launches += 1
    return acc, cnt


def rasterize_accum_gathered(rows, bins, counts, z_base, light, *, tiles_x: int,
                             tiles_y: int, tile_w: int, tile_h: int):
    """Sum-shade every untextured transparent fragment with 0 <= z <= 1 and
    z >= z_base over per-triangle bins (the JAX package's
    raster.rasterize_accum_fused, the oracle of rasterize_accum), adding in
    slot order. light: (8,) f32 [sun_dir xyz, sun_power, ambient rgb, 0].
    Returns (acc (3, Hp, Wp) f32, cnt (Hp, Wp) i32). CPU tensors take the
    plain version, CUDA tensors the kernel.
    """
    tiles = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h)
    _check_gathered(rows, bins, counts, tiles, z_base=z_base, light=light)
    if rows.device.type == "cuda":
        return raster_accum_gathered_kernel(rows, bins, counts, z_base, light, **tiles)
    return rasterize_accum_gathered_plain(rows, bins, counts, z_base, light, **tiles)


def rasterize_peel_gathered_plain(rows, bins, counts, z_base, last, *,
                                  tiles_x: int, tiles_y: int, tile_w: int,
                                  tile_h: int):
    """Plain PyTorch twin of the raster_peel_gathered kernel: (best (Hp, Wp)
    i32, ID_INF where the pixel has no further layer, nums (4, Hp, Wp) f32,
    metas (15, Hp, Wp) f32 of the triangle `best`). Every live slot is
    walked: the rule needs no order of the ids."""
    X, Y = _tile_planes(tiles_x, tiles_y, tile_w, tile_h, rows.device)
    zb = _frame_to_tiles(z_base, tiles_x, tiles_y, tile_w, tile_h)
    lt = _frame_to_tiles(last, tiles_x, tiles_y, tile_w, tile_h)
    best = torch.full(X.shape, ID_INF, dtype=torch.int32, device=X.device)
    for k in range(_slots(bins, counts)):
        c, ids, ok = _triangle_slot(rows, bins, counts, k)
        cov, zv = _coverage(c, X, Y)
        take = (cov & (zv >= 0.0) & (zv >= zb) & (ids > lt) & (ids < best)
                & ok)
        best = torch.where(take, ids, best)
    tid = torch.where(best < ID_INF, best, NO_TRI)
    nums, metas = _winner_planes(rows, tid, X, Y)
    f = lambda t: _tiles_to_frame(t, tiles_x, tiles_y).contiguous()  # noqa: E731
    return f(best), f(nums), f(metas)


@checked
def raster_peel_gathered_kernel(rows, bins, counts, z_base, last, *,
                                tiles_x: int, tiles_y: int, tile_w: int,
                                tile_h: int):
    """Launch the raster_peel_gathered CUDA kernel (csrc/raster_gathered.cu)
    on CUDA tensors: the same (best, nums, metas) as
    rasterize_peel_gathered_plain, for bins in any order. One launch of
    n_tiles clusters of PEEL_SPLIT blocks (kernel 2.5's walk), with no
    wait on the device."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"raster_peel_gathered_kernel takes CUDA tensors, got {dev}")
    tiles = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h)
    _check_gathered(rows, bins, counts, tiles, z_base=z_base, last=last)
    hp, wp = tiles_y * tile_h, tiles_x * tile_w
    best = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    nums = torch.empty((N_NUMS, hp, wp), dtype=torch.float32, device=dev)
    metas = torch.empty((len(META_COLS), hp, wp), dtype=torch.float32, device=dev)
    _launch("raster_peel_gathered_launch",
            *_gathered_launch_args(rows, bins, counts, tiles),
            _ptr(z_base), _ptr(last), _ptr(best), _ptr(nums), _ptr(metas),
            _stream(dev), tile=(tile_h, tile_w))
    peel_gathered_counter.launches += 1
    return best, nums, metas


def rasterize_peel_gathered(rows, bins, counts, z_base, last, *, tiles_x: int,
                            tiles_y: int, tile_w: int, tile_h: int):
    """One transparency peel over per-triangle bins of fat rows (the JAX
    package's raster.rasterize_peel_fused, the oracle of
    rasterize_peel_fused): per pixel the smallest binned id > last that
    covers it with 0 <= z <= 1 and z >= z_base, and its planes.

    Returns (best (Hp, Wp) i32, ID_INF where no layer, attrs (6, Hp, Wp),
    metas (13, Hp, Wp), inv (Hp, Wp)). CPU tensors take the plain version,
    CUDA tensors the kernel.
    """
    dev = rows.device
    tiles = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h)
    _check_gathered(rows, bins, counts, tiles, z_base=z_base, last=last)
    if dev.type == "cuda":
        best, nums, metas = raster_peel_gathered_kernel(rows, bins, counts, z_base,
                                                        last, **tiles)
    else:
        best, nums, metas = rasterize_peel_gathered_plain(rows, bins, counts, z_base,
                                                          last, **tiles)
    X, Y = _frame_planes(tiles_y * tile_h, tiles_x * tile_w, dev)
    attrs, metas13, inv = reconstruct_outputs(nums, metas, X, Y)
    return best, attrs, metas13, inv


# ---------------------------------------------------------------------------
# Reference rasterizer (numpy, per-pixel loop): the unit tests' oracle
# ---------------------------------------------------------------------------


def rasterize_reference(packed, width: int, height: int):
    """Direct per-pixel evaluation of the deferred raster's rule over every
    valid row of packed (T, 16), in order, in plain float32 numpy (no fused
    multiply-add: z agrees with the kernels to rounding, not bit for bit).
    Tiny inputs only. Returns (z (H, W) f32, tid (H, W) i32) arrays."""
    packed = np.asarray(packed, np.float32)
    z = np.full((height, width), DEPTH_CLEAR, np.float32)
    tid = np.full((height, width), NO_TRI, np.int32)
    for t, row in enumerate(packed):
        if row[12] == 0.0:   # the valid column
            continue
        for y in range(height):
            for x in range(width):
                X, Y = np.float32(x + 0.5), np.float32(y + 0.5)
                cov = True
                for e in range(3):
                    a, b, c = row[3 * e], row[3 * e + 1], row[3 * e + 2]
                    val = a * X + b * Y + c
                    tl = (a > 0) or (a == 0 and b > 0)
                    cov &= (val > 0) or (val == 0 and tl)
                if not cov:
                    continue
                zv = row[9] * X + row[10] * Y + row[11]
                if zv < 0.0 or zv > 1.0:
                    continue
                if zv >= z[y, x]:
                    z[y, x] = zv
                    tid[y, x] = t
    return z, tid

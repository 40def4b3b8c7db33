"""Adversarial fat rows for the raster kernels 2.1-2.8: inputs built to hit
each hazard of their decomposition (csrc/raster_fused.cu, raster_accum.cu,
raster_peel.cu, raster_deferred.cu, raster_gathered.cu), at any number of
chunks, from a seed.

Row t of chunk c (CHUNK = 32 rows a chunk) is, by t:

* 7: the tie row, one big triangle with the constant depth 0.6 repeated in
  every chunk: equal z, so the copy latest in the walk must win, across
  every segment boundary kernel 2.1 cuts;
* 15: a full-screen row (edges (0, 0, 1), the setup's box for a vertex with
  w <= 1e-6), its depth plane -0.0 (coefficients -0.0) in chunks c % 3 == 0
  and +0.0 elsewhere: ties at zero whose winner shows in the sign of z;
* 22: the same over the left half of the frame, with the other sign, so
  the left half's zero-depth winners carry one sign and the right half's
  the other;
* 23, and 24-31 in chunks c % 5 == 4: dead rows (edges (0, 0, -1), the
  empty box), inside a live group and as a whole dead group;
* 0: a two-column strip at a region boundary x = 32 k - 0.5 whose left edge
  (1, -1e-8, -x) is negative in exact arithmetic at column 32 k - 1 but
  rounds to 0 there and is covered by the top-left rule: a reject without
  its rounding margin drops that column;
* 1: a two-row strip starting exactly on a region row boundary (edge
  value exactly 0 on the boundary row's centers);
* the rest: random triangles of 2 to 24 pixels, random depth in (0.05,
  0.95), reaching past the frame's edges but not above y = 4, so that
  however many chunks there are the top rows keep zero-depth winners.

Columns 12-43 hold seeded random attribute planes (2.2 shades with them;
the texture constants 31-36 small integers, as the JAX kernel packs them),
44-47 each row's screen box, as the setup writes it: clamped to the frame,
the whole frame for a full-screen row, (-1, -1, -2, -2) for a dead one.

For the sum 2.7: hazard_accum_rows and hazard_accum_z_base put fragments
at negative depths over a negative opaque depth; hazard_holes punches -1
holes into chunk bins, which expand_bins turns into per-triangle holes.

For the peels: hazard_peel_z_base puts the opaque depth exactly at the
fragments' depths (the tie rows' 0.6, and -0.0 and +0.0 under the
zero-depth rows of either sign), so every segment of a tile has a
candidate at the pixels the full-screen rows cover; hazard_last makes a
`last` plane of ids at the segments' boundaries; hazard_packed gives the
same triangles as (T, 16) packed rows for kernels 2.4 and 2.5.

For the visibility walks 2.4 and 2.6: hazard_vis_rows adds, in every
chunk, rows whose depth crosses 1 (z > 1 is clipped, z == 1 is kept), rows
of NaN coefficients and rows with an infinite edge constant, which the
reject must keep and the per-pixel test decide; hazard_fold_bin is one
tile's bin whose segments hold no winner beside a zero-depth winner of
either sign.
"""

from __future__ import annotations

import numpy as np

CHUNK = 32
ROW_COLS = 48
TIE_Z = 0.6
ID_INF = 0x7FFFFFF   # the peels' "no fragment" marker
_EMPTY_BOX = (-1.0, -1.0, -2.0, -2.0)


def _planes(v):
    """Barycentric edge planes (3, 3) of triangle v (3, 2), float64:
    lambda_k = a x + b y + c is 1 at vertex k and 0 on the opposite edge,
    positive inside whatever the winding; None if degenerate."""
    area2 = (v[1, 0] - v[0, 0]) * (v[2, 1] - v[0, 1]) - (v[2, 0] - v[0, 0]) * (v[1, 1] - v[0, 1])
    if abs(area2) < 1.0:
        return None
    out = np.empty((3, 3))
    for k in range(3):
        p, q = v[(k + 1) % 3], v[(k + 2) % 3]
        a = (p[1] - q[1]) / area2
        b = (q[0] - p[0]) / area2
        out[k] = (a, b, -(a * q[0] + b * q[1]))
    return out


def _box(v, width, height, margin=2.0):
    lo = np.clip(v.min(0) - margin, 0.0, [width, height])
    hi = np.clip(v.max(0) + margin, 0.0, [width, height])
    return (lo[0], lo[1], hi[0], hi[1])


def hazard_rows(n_chunks: int, width: int, height: int, seed: int = 0) -> np.ndarray:
    """(n_chunks * 32, 48) float32 fat rows over a width x height frame,
    laid out as the module docstring says."""
    rng = np.random.default_rng(seed)
    T = n_chunks * CHUNK
    rows = np.zeros((T, ROW_COLS), np.float64)
    rows[:, 12:44] = rng.uniform(-1.0, 1.0, size=(T, 32))
    rows[:, 41:44] = rng.uniform(0.5, 2.0, size=(T, 3))   # denominators away from 0
    rows[:, 31:37] = rng.integers(0, 1024, size=(T, 6))  # C_TEX: small integers
    tie = np.asarray([[-10.0, -5.0], [width * 0.8, 2.0], [width * 0.3, height + 5.0]])
    tie_planes = _planes(tie)
    for i in range(T):
        c, t = divmod(i, CHUNK)
        r = rows[i]
        if t == 23 or (t >= 24 and c % 5 == 4):
            r[:12] = 0.0
            r[2] = r[5] = r[8] = -1.0
            r[44:48] = _EMPTY_BOX
            continue
        if t == 15:
            r[:9] = (0.0, 0.0, 1.0) * 3
            r[9:12] = -0.0 if c % 3 == 0 else 0.0
            r[44:48] = (0.0, 0.0, width, height)
            continue
        if t == 22:
            r[:9] = (-1.0, 0.0, width / 2, 0.0, 0.0, 1.0, 0.0, 0.0, 1.0)
            r[9:12] = 0.0 if c % 3 == 0 else -0.0
            r[44:48] = (0.0, 0.0, width / 2, height)
            continue
        if t == 7:
            r[:9] = tie_planes.ravel()
            r[9:12] = (0.0, 0.0, TIE_Z)
            r[44:48] = _box(tie, width, height)
            continue
        if t == 0:
            bx = 32.0 * (1 + c % max(1, width // 32 - 1)) - 0.5
            r[:9] = (1.0, -1e-8, -bx, -1.0, 0.0, bx + 1.5, 0.0, 0.0, 1.0)
            r[9:12] = (0.0, 0.0, 0.7 + 0.001 * (c % 100))
            r[44:48] = (bx - 1.0, 0.0, bx + 2.0, height)
            continue
        if t == 1:
            by = 8.0 * (1 + c % max(1, height // 8 - 1)) + 0.5
            r[:9] = (0.0, 1.0, -by, 0.0, -1.0, by + 1.5, 0.0, 0.0, 1.0)
            r[9:12] = (0.0, 0.0, 0.65 + 0.001 * (c % 100))
            r[44:48] = (0.0, by - 1.0, width, by + 2.0)
            continue
        while True:
            center = rng.uniform([-8.0, 16.0], [width + 8.0, height + 8.0])
            v = center + rng.uniform(-12.0, 12.0, size=(3, 2)) * rng.uniform(0.15, 1.0)
            planes = _planes(v)
            if planes is not None:
                break
        zs = rng.uniform(0.05, 0.95, size=3)
        r[:9] = planes.ravel()
        r[9:12] = zs @ planes
        r[44:48] = _box(v, width, height)
    return rows.astype(np.float32)


def hazard_boxes(rows: np.ndarray):
    """(T, 4) screen boxes (columns 44-47) and their validity, for
    binning."""
    box = np.ascontiguousarray(rows[:, 44:48])
    return box, (box[:, 2] >= box[:, 0]) & (box[:, 3] >= box[:, 1])


def hazard_z_base(width: int, height: int) -> np.ndarray:
    """An opaque depth plane for kernel 2.2: the tie rows' exact depth over
    the left half of the frame (a fragment with z equal to it is taken),
    0 over the right half."""
    z = np.zeros((height, width), np.float32)
    z[:, : width // 2] = TIE_Z
    return z


def hazard_accum_rows(n_chunks: int, width: int, height: int, seed: int = 0) -> np.ndarray:
    """hazard_rows with the depth planes of rows 5 and 6 of every chunk
    (random triangles there) negated: their fragments lie at depths in
    (-0.95, -0.05), so over hazard_accum_z_base's negative half only the
    0 <= z test drops them (kernel 2.7 keeps that test; 2.2's opaque depth
    is never negative)."""
    rows = hazard_rows(n_chunks, width, height, seed=seed)
    for t in (5, 6):
        rows[t::CHUNK, 9:12] = -rows[t::CHUNK, 9:12]
    return rows


def hazard_accum_z_base(width: int, height: int) -> np.ndarray:
    """hazard_z_base with -1 over the right half: a fragment at a negative
    depth passes z >= z_base there, and 0 <= z decides."""
    z = hazard_z_base(width, height)
    z[:, width // 2:] = -1.0
    return z


def hazard_holes(chunk_bins: np.ndarray, counts: np.ndarray, every: int = 16) -> np.ndarray:
    """Chunk bins (n_tiles, W) with every `every`-th slot inside each
    tile's count (from slot 2) set to -1: expand_bins turns each such slot
    into CHUNK -1 holes inside the tile's count, which every walk over
    per-triangle bins must skip without moving another entry. At the
    default, a tile of 48-64 chunk entries cut into 8 segments holds
    segments with a hole and segments without."""
    out = chunk_bins.copy()
    slot = np.arange(out.shape[1])[None, :]
    out[(slot < counts[:, None]) & (slot % every == 2)] = -1
    return out


def hazard_peel_z_base(width: int, height: int) -> np.ndarray:
    """An opaque depth plane for the peels, equal to fragment depths: the
    tie rows' TIE_Z over the left quarter, -0.0 over the second, +0.0 over
    the right half (zero-depth fragments of both signs pass z >= z_base
    there, as >= ties -0.0 and +0.0)."""
    z = np.zeros((height, width), np.float32)
    z[:, : width // 4] = TIE_Z
    z[:, width // 4: width // 2] = -0.0
    return z


def hazard_last(boundary_ids, largest_id: int, width: int, height: int,
                seed: int = 0) -> np.ndarray:
    """A `last` plane for a peel, int32 (height, width): per pixel, drawn
    from a seed, -1, an id on either side of a segment boundary (b - 1 or
    b for each first id b of a segment), the table's largest id or ID_INF
    (nothing can follow either)."""
    cand = [-1, largest_id, ID_INF]
    for b in boundary_ids:
        cand += [int(b) - 1, int(b)]
    rng = np.random.default_rng(seed)
    return np.asarray(cand, np.int32)[rng.integers(0, len(cand), size=(height, width))]


def hazard_packed(rows: np.ndarray) -> np.ndarray:
    """The hazard rows as (T, 16) packed setup rows in
    vertex.triangle_setup_c's layout: the 12 plane coefficients, validity
    (1 where the screen box is not empty), material 0, two zero columns."""
    packed = np.zeros((rows.shape[0], 16), np.float32)
    packed[:, :12] = rows[:, :12]
    packed[:, 12] = hazard_boxes(rows)[1]
    return packed


def hazard_vis_rows(n_chunks: int, width: int, height: int, seed: int = 0) -> np.ndarray:
    """hazard_rows with three more rows in every chunk c, over rows 2-4
    (random triangles there):

    * 2: a two-row strip across the frame at y = 8 k + 3.5 (k >= 1) whose
      depth rises from 0.999 at x = 0 past 1 about x = width / 2: it wins
      left of that and is clipped (z > 1) right of it;
    * 3: every coefficient NaN, box the whole frame: it covers no pixel;
    * 4: a three-column strip at x = 32 k + 8 whose first edge is the
      constant +inf (covered wherever the other two edges are), depth
      0.97: it wins its strip, the reject keeps it (no finite bound).
    """
    rows = hazard_rows(n_chunks, width, height, seed=seed).astype(np.float64)
    for c in range(n_chunks):
        r = rows[c * CHUNK + 2]
        by = 8.0 * (1 + c % max(1, height // 8 - 1)) + 3.0
        r[:9] = (0.0, 1.0, -by, 0.0, -1.0, by + 2.0, 0.0, 0.0, 1.0)
        r[9:12] = (2e-3 / width, 0.0, 0.999)
        r[44:48] = (0.0, by - 1.0, width, by + 3.0)
        r = rows[c * CHUNK + 3]
        r[:12] = np.nan
        r[44:48] = (0.0, 0.0, width, height)
        r = rows[c * CHUNK + 4]
        bx = 32.0 * (c % max(1, width // 32)) + 8.0
        r[:9] = (0.0, 0.0, np.inf, 1.0, 0.0, -bx, -1.0, 0.0, bx + 3.0)
        r[9:12] = (0.0, 0.0, 0.97)
        r[44:48] = (bx - 1.0, 0.0, bx + 4.0, height)
    return rows.astype(np.float32)


def hazard_fold_bin(n_chunks: int, seg_min: int) -> np.ndarray:
    """One tile's bin of 4 * seg_min ids into rows laid out as hazard_rows
    (n_chunks >= 3), cut by the visibility walks into four segments of
    seg_min entries: the first holds dead rows only (no winner anywhere),
    the second dead rows and last a full-screen row of depth -0.0 (row 15
    of chunk 0), the third dead rows only, the fourth first a left-half
    row of depth +0.0 (row 22 of chunk 0) then dead rows. In walk order
    the left half ends
    at +0.0 (an equal z, later), the right half at the -0.0 winner, whose
    bits a fold that let an empty segment win would lose."""
    assert n_chunks >= 3
    dead = [c * CHUNK + 23 for c in range(n_chunks)]
    fill = [dead[k % len(dead)] for k in range(seg_min)]
    # row 15 of chunk 0 is full-screen at -0.0, row 22 the left half at +0.0
    bins = fill + fill[:-1] + [15] + fill + [22] + fill[:-1]
    return np.asarray(bins, np.int32)[None, :]

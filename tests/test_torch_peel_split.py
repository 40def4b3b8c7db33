"""CPU tests of how the peels 2.3, 2.5 and 2.8 spread a tile's work
(csrc/raster_peel.cu, raster_deferred.cu, raster_gathered.cu,
raster_common.cuh): a torch model of each kernel's decomposition — the
tile's entries cut into segments (raster.peel_segments), each walked alone
with the per-region and per-row reject (raster.region_rows), the warp's
smallest `last`, and the exact stops (a pixel that holds a layer is settled
only where the segment's ids strictly ascend), the segments merged by a
min — held bit for bit against the plain versions and the JAX package's
Pallas kernels in interpret mode, on the adversarial rows of
utils/hazards.py, over three peels with `last` fed back, on one dense tile
cut PEEL_SPLIT ways and on 2x2 tiles, on the bins in order and walked in
reverse, where a stop that trusted the order would be wrong. 2.8 walks 2.5's
segments over fat rows (peel_tile); its 2x2 bins are every member of each
binned chunk (expand_bins) with -1 holes, held to the plain version (the
JAX wrapper would clip a hole onto row 0), its dense tile's without holes
also to the JAX kernel.

Tolerance: none; every output is compared bit for bit.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_renderer.kernels import raster as jraster  # noqa: E402
from tpu_renderer_torch.kernels import raster  # noqa: E402
from tpu_renderer_torch.utils import hazards  # noqa: E402
from test_torch_threads import share_cores  # noqa: E402

share_cores()

ONE_TILE = dict(tiles_x=1, tiles_y=1, tile_w=128, tile_h=32)
QUAD = dict(tiles_x=2, tiles_y=2, tile_w=128, tile_h=32)
KINDS = ("fused", "deferred", "gathered")   # kernel 2.3, kernel 2.5, kernel 2.8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: its tensors are a tile or four, too
    small to gain from more, and the other test workers keep their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frame(tiles):
    return tiles["tiles_x"] * tiles["tile_w"], tiles["tiles_y"] * tiles["tile_h"]


def _inputs(kind, n_chunks, tiles, seed, holes=False):
    """Hazard rows over the tiles as the kernel takes them: (table, bins,
    counts, z_base). 2.3: fat rows and dense chunk bins; 2.5: packed rows
    and per-triangle bins, ids ascending; 2.8: fat rows and per-triangle
    bins of every member of each binned chunk, in chunk order, with
    hazard_holes' -1 holes if holes."""
    w, h = _frame(tiles)
    rows = hazards.hazard_rows(n_chunks, w, h, seed=seed)
    box, valid = (torch.from_numpy(a) for a in hazards.hazard_boxes(rows))
    if kind != "deferred":
        caabb, cvalid = raster.chunk_aabbs(box, valid)
        gaabb, gvalid = raster.group_aabbs(box, valid)
        bins, counts = raster.bin_triangles_full(caabb, cvalid, gaabb, gvalid, **tiles)
        table = torch.from_numpy(rows)
        if kind == "gathered":
            live = torch.arange(bins.shape[1])[None, :] < counts[:, None]
            cbins = torch.where(live, bins >> 4, raster.NO_TRI)
            if holes:
                cbins = torch.from_numpy(hazards.hazard_holes(cbins.numpy(), counts.numpy()))
            bins, counts = raster.expand_bins(cbins, counts)
    else:
        bins, counts, _ = raster.bin_triangles(box, valid, bin_cap=rows.shape[0], **tiles)
        table = torch.from_numpy(hazards.hazard_packed(rows))
    return table, bins, counts, torch.from_numpy(hazards.hazard_peel_z_base(w, h))


def _seg_min(kind):
    return raster.PEEL_SEG_MIN if kind == "fused" else raster.DEFERRED_SEG_MIN


def _plain(kind, table, bins, counts, z_base, last, tiles):
    if kind == "fused":
        return raster.rasterize_peel_fused_plain(table, bins, counts, z_base, last, **tiles)[0]
    if kind == "gathered":
        return raster.rasterize_peel_gathered_plain(table, bins, counts, z_base, last,
                                                    **tiles)[0]
    return raster.rasterize_peel_plain(table, bins, counts, z_base, last, **tiles)


def _segment_firsts(kind, bins, counts):
    """The first triangle id of every segment of every tile (of its first
    chunk, for 2.3; none where 2.8's segment starts on a hole)."""
    segs = raster.peel_segments(counts, bins.shape[1], _seg_min(kind))
    firsts = set()
    for tile in range(bins.shape[0]):
        n = int(counts[tile].clamp(0, bins.shape[1]))
        for q in range(int(segs[tile])):
            e0, e1 = raster.segment_bounds(n, int(segs[tile]), q)
            key = int(bins[tile, e0]) if e1 > e0 else -1
            if key >= 0:
                firsts.add((key >> 4) * raster.CHUNK if kind == "fused" else key)
    return sorted(firsts)


def _boundary_last(kind, table, bins, counts, tiles, seed):
    """hazards.hazard_last over the first id of every segment of every
    tile."""
    per_id = raster.CHUNK if kind == "fused" else 1
    largest = table.shape[0] // per_id * per_id - 1
    return torch.from_numpy(hazards.hazard_last(_segment_firsts(kind, bins, counts), largest,
                                                *_frame(tiles), seed=seed))


def _per_region(plane, op):
    """(32, 128) -> the op over each warp's 32x8 region, broadcast back."""
    r = op(plane.reshape(4, raster.REGION_H, 4, raster.REGION_W), (1, 3))
    return r[:, None, :, None].expand(4, raster.REGION_H, 4, raster.REGION_W).reshape(32, 128)


def _region_ok(tri_rows, tx, ty):
    """(k, 32, 128): may triangle k be tested at each pixel of tile (tx,
    ty)? region_rows for its warp's region and row."""
    x0 = tx * 128 + torch.arange(0, 128, raster.REGION_W)
    y0 = ty * 32 + torch.arange(0, 32, raster.REGION_H)
    ok = raster.region_rows(tri_rows[:, None, None, :], x0[None, None, :], y0[None, :, None])
    ok = ok.permute(0, 1, 3, 2).reshape(ok.shape[0], 32, -1)
    return ok.repeat_interleave(raster.REGION_W, 2)


def _walk_units(kind, table, bins, tile, e0, e1):
    """The segment's walk as the kernel takes it, in order: a list of
    units, each a list of (id, row) tested between two stop checks. 2.3:
    one unit a chunk entry (its live groups' triangles), the block's stop
    at each; 2.5 and 2.8: one unit a 32-entry slice, the block's stop
    every 512 entries (returned as the set of unit indices where it is
    checked)."""
    units, block_checks = [], set()
    if kind == "fused":
        n_chunks = table.shape[0] // raster.CHUNK
        for e in range(e0, e1):
            block_checks.add(len(units))
            entry = int(bins[tile, e])
            cid, gmask = entry >> 4, entry & 0xF
            if not (0 <= cid < n_chunks and gmask):
                continue
            units.append([(cid * raster.CHUNK + t, table[cid * raster.CHUNK + t])
                          for t in range(raster.CHUNK) if (gmask >> (t // raster.GROUP)) & 1])
        return units, block_checks
    for base in range(e0, e1, 512):
        block_checks.add(len(units))
        for j0 in range(base, min(e1, base + 512), 32):
            ids = [int(i) for i in bins[tile, j0:min(e1, base + 512, j0 + 32)]]
            units.append([(i, table[i]) for i in ids if 0 <= i < table.shape[0]])
    return units, block_checks


def model_peel(kind, table, bins, counts, z_base, last, tiles, check_order=True):
    """Kernel 2.3's (kind "fused"), 2.5's ("deferred") or 2.8's
    ("gathered") decomposition in torch. check_order=False trusts the bin
    to ascend, as the kernels did before their stops checked it. Returns
    (layer frame, pixels where every one of PEEL_SPLIT segments found a
    candidate)."""
    X, Y = raster._tile_planes(**tiles, device=table.device)
    tx_n, ty_n, tw, th = tiles["tiles_x"], tiles["tiles_y"], tiles["tile_w"], tiles["tile_h"]
    zb = raster._frame_to_tiles(z_base, tx_n, ty_n, tw, th)
    lt = raster._frame_to_tiles(last, tx_n, ty_n, tw, th)
    per_id = raster.CHUNK if kind == "fused" else 1
    max_id = table.shape[0] // per_id * per_id - 1
    width = bins.shape[1]
    segs_all = raster.peel_segments(counts, width, _seg_min(kind))
    out = torch.full(X.shape, raster.ID_INF, dtype=torch.int32)
    all_segs = 0
    for tile in range(X.shape[0]):
        tx, ty = tile % tx_n, tile // tx_n
        n, segs = int(counts[tile].clamp(0, width)), int(segs_all[tile])
        Xt, Yt, zbt, ltt = X[tile:tile + 1], Y[tile:tile + 1], zb[tile], lt[tile]
        lt_min = _per_region(ltt, torch.amin)
        found = torch.zeros(ltt.shape, dtype=torch.int32)
        for q in range(segs):
            e0, e1 = raster.segment_bounds(n, segs, q)
            keys = bins[tile, e0:e1] >> (4 if kind == "fused" else 0)
            ascending = not check_order or bool((keys[1:] > keys[:-1]).all())
            best = torch.full(ltt.shape, raster.ID_INF, dtype=torch.int32)
            units, block_checks = _walk_units(kind, table, bins, tile, e0, e1)
            for u, unit in enumerate(units):
                settled = ((best < raster.ID_INF) & ascending) | (ltt >= max_id)
                if u in block_checks and bool(settled.all()):
                    break                                   # the block leaves its walk
                open_ = ~_per_region(settled, torch.amin)   # warps not yet settled
                if not unit or not bool(open_.any()):
                    continue
                # the min has no order, so a unit's triangles take at once
                tri = torch.stack([r for _, r in unit])
                ids = torch.tensor([i for i, _ in unit], dtype=torch.int32)[:, None, None]
                cov, zv = raster._coverage(tri[:, :, None, None], Xt, Yt)
                take = (open_ & _region_ok(tri, tx, ty) & (ids > lt_min) & cov & (zv >= zbt)
                        & (ids > ltt) & (ids < best))
                if kind != "fused":
                    take &= zv >= 0.0
                best = torch.minimum(best, torch.where(take, ids, raster.ID_INF).amin(0))
            found += best < raster.ID_INF
            out[tile] = torch.minimum(out[tile], best)
        if segs == raster.PEEL_SPLIT:
            all_segs += int((found == segs).sum())
    return raster._tiles_to_frame(out, tx_n, ty_n), all_segs


def _feed(layer):
    return torch.where(layer < raster.ID_INF, layer, raster.ID_INF)


def _jax_peel(kind, table, bins, counts, z_base, last, tiles):
    """The JAX package's peel on the same triangles, in interpret mode:
    rasterize_peel_slabs over its own dense bins (2.3), or rasterize_peel
    (2.5) or rasterize_peel_fused (2.8) over the port's per-triangle
    bins."""
    rows = table.numpy()
    if kind == "gathered":
        out = jraster.rasterize_peel_fused(
            jnp.asarray(rows), jnp.asarray(bins.numpy()), jnp.asarray(counts.numpy()),
            jnp.asarray(z_base.numpy()), jnp.asarray(last.numpy()), **tiles)[0]
        return torch.from_numpy(np.array(out))
    if kind == "fused":
        box, valid = hazards.hazard_boxes(rows)
        caabb, cvalid = jraster.chunk_aabbs(jnp.asarray(box), jnp.asarray(valid))
        gaabb, gvalid = jraster.group_aabbs(jnp.asarray(box), jnp.asarray(valid))
        jb, jc = jraster.bin_triangles_full(caabb, cvalid, gaabb=gaabb, gvalid=gvalid, **tiles)
        out = jraster.rasterize_peel_slabs(jnp.asarray(rows), jb, jc, jnp.asarray(z_base.numpy()),
                                           jnp.asarray(last.numpy()), **tiles)[0]
    else:
        out = jraster.rasterize_peel(jnp.asarray(rows), jnp.asarray(bins.numpy()),
                                     jnp.asarray(counts.numpy()), jnp.asarray(z_base.numpy()),
                                     jnp.asarray(last.numpy()), **tiles)
    return torch.from_numpy(np.array(out))


# -- the models against the plain versions and JAX, three peels ---------------


@pytest.fixture(scope="module", params=KINDS)
def quad(request):
    """2x2 tiles of hazard rows for one kernel, and the JAX package's three
    peels on them (2.8's: the plain version's, its bins holding -1 holes)
    with `last` fed back, from -1 everywhere and from a `last` plane of ids
    at the segments' boundaries."""
    kind = request.param
    table, bins, counts, z_base = _inputs(kind, 8, QUAD, seed=3, holes=True)
    reference = _plain if kind == "gathered" else _jax_peel
    w, h = _frame(QUAD)
    starts = {"none": torch.full((h, w), -1, dtype=torch.int32),
              "boundaries": _boundary_last(kind, table, bins, counts, QUAD, seed=4)}
    peels = {}
    for start, last in starts.items():
        peels[start] = []
        for _ in range(3):
            peels[start].append((last, reference(kind, table, bins, counts, z_base, last, QUAD)))
            last = _feed(peels[start][-1][1])
    return dict(kind=kind, table=table, bins=bins, counts=counts, z_base=z_base, peels=peels)


@pytest.mark.parametrize("start", ["none", "boundaries"])
def test_peel_model_equals_plain_and_jax_over_three_peels(quad, start):
    """Each peel of the model from the reference peel's own `last` (JAX;
    2.8: the plain version): equal to the reference layer bit for bit; the
    first also to the plain version's. 2.8's bins hold -1 holes, a segment
    of each tile whole holes, and its model is held on each tile's reversed
    bin too (a min, the same in any order; 2.3 and 2.5 are on the dense
    tile's)."""
    kind, table, bins, counts, z_base = (quad[k] for k in ("kind", "table", "bins", "counts",
                                                           "z_base"))
    assert int(raster.peel_segments(counts, bins.shape[1], _seg_min(kind)).max()) > 1
    if kind == "gathered":
        assert bool((bins[:, :int(counts.min())] < 0).any()), "no hole inside a count"
    layers = []
    for peel, (last, want) in enumerate(quad["peels"][start]):
        got, _ = model_peel(kind, table, bins, counts, z_base, last, QUAD)
        assert torch.equal(got, want), f"peel {peel}: model against the reference"
        if kind == "gathered":
            got_rev, _ = model_peel(kind, table, _reversed(bins, counts), counts, z_base, last,
                                    QUAD)
            assert torch.equal(got_rev, want), f"peel {peel}: model on the reversed bins"
        if peel == 0:
            assert torch.equal(got, _plain(kind, table, bins, counts, z_base, last, QUAD))
        layers.append(int((got < raster.ID_INF).sum()))
    assert layers[0] > 1000 and layers[2] > 0, layers


# -- one dense tile cut PEEL_SPLIT ways, in order and reversed -----------------


@pytest.fixture(scope="module", params=KINDS)
def dense(request):
    """One tile cut into PEEL_SPLIT segments: 64 chunk entries (2.3), about
    330 triangle entries (2.5) or 384 (2.8, no holes), the plain version's
    first peel on it and, for 2.8, the JAX package's (2.3 and 2.5 are held
    to JAX on the 2x2 tiles)."""
    kind = request.param
    table, bins, counts, z_base = _inputs(kind, 64 if kind == "fused" else 12, ONE_TILE,
                                          seed=5)
    assert int(counts[0]) >= 64
    assert int(raster.peel_segments(counts, bins.shape[1], _seg_min(kind))[0]) == \
        raster.PEEL_SPLIT
    last = torch.full((32, 128), -1, dtype=torch.int32)
    jax = _jax_peel(kind, table, bins, counts, z_base, last, ONE_TILE) \
        if kind == "gathered" else None
    return dict(kind=kind, table=table, bins=bins, counts=counts, z_base=z_base, last=last,
                plain=_plain(kind, table, bins, counts, z_base, last, ONE_TILE), jax=jax)


def _reversed(bins, counts):
    out = bins.clone()
    for tile in range(bins.shape[0]):
        n = int(counts[tile].clamp(0, bins.shape[1]))
        out[tile, :n] = bins[tile, :n].flip(0)
    return out


def test_peel_model_splits_a_dense_tile_eight_ways(dense):
    """Two peels on the dense tile, from -1 and from the boundary `last`:
    the model equals the plain version, and some pixel has a candidate in
    every one of the 8 segments (the merge takes a min of 8)."""
    kind, table, bins, counts, z_base = (dense[k] for k in ("kind", "table", "bins", "counts",
                                                            "z_base"))
    got, all_segs = model_peel(kind, table, bins, counts, z_base, dense["last"], ONE_TILE)
    assert torch.equal(got, dense["plain"]) and all_segs > 0
    if dense["jax"] is not None:
        assert torch.equal(got, dense["jax"]), "model against the JAX package"
    last = _boundary_last(kind, table, bins, counts, ONE_TILE, seed=6)
    got, all_segs = model_peel(kind, table, bins, counts, z_base, last, ONE_TILE)
    assert torch.equal(got, _plain(kind, table, bins, counts, z_base, last, ONE_TILE))
    assert all_segs > 0


def test_peel_model_is_exact_on_a_reversed_bin(dense):
    """The dense tile's bin walked in reverse: the model, whose stops check
    the order, equals the plain version (a min, the same in any order); one
    that trusts the order stops too early and differs."""
    kind, table, counts, z_base = (dense[k] for k in ("kind", "table", "counts", "z_base"))
    rev = _reversed(dense["bins"], counts)
    got, _ = model_peel(kind, table, rev, counts, z_base, dense["last"], ONE_TILE)
    assert torch.equal(got, dense["plain"])
    if kind != "fused":   # the plain version on the reversed bin too
        assert torch.equal(_plain(kind, table, rev, counts, z_base, dense["last"], ONE_TILE),
                           dense["plain"])
    trusting, _ = model_peel(kind, table, rev, counts, z_base, dense["last"], ONE_TILE,
                             check_order=False)
    assert not torch.equal(trusting, dense["plain"]), \
        "a stop that trusts the order is never wrong here"


def test_peel_hazards_are_reached(quad):
    """The peel hazards do what they are for on the 2x2 tiles, over the
    three peels from -1: layers with z equal to z_base are taken, at the
    tie depth and at -0.0 against +0.0 both ways, and the boundary `last`
    plane holds ids on both sides of segment boundaries."""
    table, z_base = quad["table"], quad["z_base"]
    h, w = z_base.shape
    X, Y = raster._frame_planes(h, w, "cpu")
    ties = torch.zeros((3,), dtype=torch.int64)
    for _, layer in quad["peels"]["none"]:
        r = table[layer.clamp(0, table.shape[0] - 1).long()]
        zv = raster._plane(r[..., 9], r[..., 10], r[..., 11], X, Y)
        equal = (layer < raster.ID_INF) & (zv == z_base)
        ties += torch.stack([(equal & (z_base == hazards.TIE_Z)).sum(),
                             (equal & torch.signbit(zv) & ~torch.signbit(z_base)).sum(),
                             (equal & ~torch.signbit(zv) & torch.signbit(z_base)).sum()])
    assert (ties > 0).all(), ties
    firsts = _segment_firsts(quad["kind"], quad["bins"], quad["counts"])
    last = set(quad["peels"]["boundaries"][0][0].unique().tolist())
    assert any(b in last and b - 1 in last for b in firsts if b > 0)

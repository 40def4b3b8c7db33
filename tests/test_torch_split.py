"""CPU tests of how kernels 2.1, 2.2 and 2.7 spread a tile's work
(csrc/raster_fused.cu, raster_accum.cu, raster_gathered.cu): the segment
cut of 2.1 (raster.fused_segments, raster.segment_bounds), the exact
per-region reject (raster.region_rows), and a torch model of each kernel's
decomposition — 2.1's segment walks folded by (z, walk order), 2.2's
pixel regions walking the whole entry list, both with the reject, and 2.7's
the same over gathered 32-entry slices of per-triangle bins with -1 holes
and 0 <= z — held bit for bit against the plain versions and the JAX
package's Pallas kernels in interpret mode, on the adversarial rows of
utils/hazards.py.

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

LIGHT = np.asarray([0.2, 0.8, 0.5, 1.0, 0.1, 0.15, 0.2, 0.0], np.float32)
ONE_TILE = dict(tiles_x=1, tiles_y=1, tile_w=128, tile_h=32)
TWO_TILES = dict(tiles_x=2, tiles_y=1, tile_w=128, tile_h=32)


def _frame(tiles):
    return tiles["tiles_x"] * tiles["tile_w"], tiles["tiles_y"] * tiles["tile_h"]


def _inputs(n_chunks, tiles, seed):
    """Hazard rows and the port's dense bins over them (torch, CPU)."""
    w, h = _frame(tiles)
    rows = hazards.hazard_rows(n_chunks, w, h, seed=seed)
    box, valid = (torch.from_numpy(a) for a in hazards.hazard_boxes(rows))
    caabb, cvalid = raster.chunk_aabbs(box, valid)
    gaabb, gvalid = raster.group_aabbs(box, valid)
    bins, counts = raster.bin_triangles_full(caabb, cvalid, gaabb, gvalid, **tiles)
    return torch.from_numpy(rows), bins, counts


def _no_margin_rows(rows, x0, y0, w=raster.REGION_W, h=raster.REGION_H):
    """region_rows without its rounding margin (what the kernels must not
    do)."""
    c = rows[..., :9].double()
    ys = torch.as_tensor(y0, dtype=torch.float64)[..., None] + 0.5 + torch.arange(
        h, dtype=torch.float64)
    ok = True
    for e in range(3):
        a, b, k = c[..., 3 * e], c[..., 3 * e + 1], c[..., 3 * e + 2]
        top = a * (x0 + 0.5 * w) + a.abs() * (0.5 * (w - 1)) + k
        ok = ok & ~(top[..., None] + b[..., None] * ys < 0.0)
    return ok


def _region_ok(chunk_rows, tx, ty, rows_of):
    """(32, 32, 128): may triangle t be tested at each pixel of tile (tx,
    ty)? The answer for its warp's region and row."""
    x0 = tx * 128 + torch.arange(0, 128, raster.REGION_W)
    y0 = ty * 32 + torch.arange(0, 32, raster.REGION_H)
    ok = rows_of(chunk_rows[:, None, None, :], x0[None, None, :], y0[None, :, None])
    # (t, y region, x region, row) -> (t, tile row, x region) -> pixels
    ok = ok.permute(0, 1, 3, 2).reshape(ok.shape[0], 32, -1)
    return ok.repeat_interleave(raster.REGION_W, 2)


def _entries(rows, bins, tile, e0, e1):
    """The live entries of bins[tile, e0:e1] as the kernels take them:
    (cid, gmask, the chunk's rows)."""
    n_chunks = rows.shape[0] // raster.CHUNK
    for e in range(e0, e1):
        entry = int(bins[tile, e])
        cid, gmask = entry >> 4, entry & 0xF
        if 0 <= cid < n_chunks and gmask:
            yield cid, gmask, rows[cid * raster.CHUNK:(cid + 1) * raster.CHUNK]


def model_fused(rows, bins, counts, tiles, split=raster.FUSED_SPLIT,
                seg_min=raster.FUSED_SEG_MIN, rows_of=raster.region_rows):
    """Kernel 2.1's decomposition in torch: per tile, each segment walked
    alone from (0, -1) with the region reject, then the segments' winners
    folded in order with the walk's rule. Returns (z, tid) frames."""
    X, Y = raster._tile_planes(**tiles, device=rows.device)
    n_tiles = X.shape[0]
    width = bins.shape[1]
    segs_all = raster.fused_segments(counts, width, split, seg_min)
    z_out = torch.zeros(X.shape)
    tid_out = torch.full(X.shape, -1, dtype=torch.int32)
    for tile in range(n_tiles):
        tx, ty = tile % tiles["tiles_x"], tile // tiles["tiles_x"]
        n = int(counts[tile].clamp(0, width))
        segs = int(segs_all[tile])
        Xt, Yt = X[tile:tile + 1], Y[tile:tile + 1]
        zw, tw = z_out[tile], tid_out[tile]
        for q in range(segs):
            e0, e1 = raster.segment_bounds(n, segs, q)
            z = torch.zeros(Xt.shape[1:])
            tid = torch.full(Xt.shape[1:], -1, dtype=torch.int32)
            for cid, gmask, r in _entries(rows, bins, tile, e0, e1):
                ok = _region_ok(r, tx, ty, rows_of)
                for t in range(raster.CHUNK):
                    if not (gmask >> (t // raster.GROUP)) & 1:
                        continue
                    cov, zv = raster._coverage(r[t][None, :, None, None], Xt, Yt)
                    take = cov[0] & (zv[0] >= z) & ok[t]
                    z = torch.where(take, zv[0], z)
                    tid = torch.where(take, cid * raster.CHUNK + t, tid)
            take = (tid >= 0) & (z >= zw)
            zw, tw = torch.where(take, z, zw), torch.where(take, tid, tw)
        z_out[tile], tid_out[tile] = zw, tw
    f = lambda t: raster._tiles_to_frame(t, tiles["tiles_x"], tiles["tiles_y"])  # noqa: E731
    return f(z_out), f(tid_out)


def _units(rows, bins, tile, n, gathered):
    """The rows kernel 2.2 (a unit a live chunk entry, its live groups'
    rows) or 2.7 (gathered: a unit a 32-entry slice of the per-triangle
    bin, in slot order) tests, in order, over bins[tile, :n]. An entry of
    2.7's that is no row of the table (a -1 hole, or outside [0, T)) is a
    dead lane of its slice and moves no other entry."""
    if not gathered:
        for _, gmask, r in _entries(rows, bins, tile, 0, n):
            yield r[[t for t in range(raster.CHUNK) if (gmask >> (t // raster.GROUP)) & 1]]
        return
    for j0 in range(0, n, raster.CHUNK):
        ids = bins[tile, j0:min(n, j0 + raster.CHUNK)]
        yield rows[ids[(ids >= 0) & (ids < rows.shape[0])].long()]


def model_accum(rows, bins, counts, z_base, light, tiles,
                rows_of=raster.region_rows, gathered=False, nonneg=True):
    """Kernel 2.2's decomposition in torch: each tile's whole entry list
    walked in order, every triangle tested only where its warp's region
    may be covered. gathered: kernel 2.7's, the entries per-triangle ids
    walked in slices (_units) and 0 <= z kept (nonneg=False drops it, as
    2.2 may). Returns (acc, cnt) frames."""
    X, Y = raster._tile_planes(**tiles, device=rows.device)
    zb = raster._frame_to_tiles(z_base, tiles["tiles_x"], tiles["tiles_y"],
                                tiles["tile_w"], tiles["tile_h"])
    acc_t, cnt_t = [], []
    for tile in range(X.shape[0]):
        tx, ty = tile % tiles["tiles_x"], tile // tiles["tiles_x"]
        Xt, Yt = X[tile:tile + 1], Y[tile:tile + 1]
        acc = [torch.zeros(Xt.shape) for _ in range(3)]
        cnt = torch.zeros(Xt.shape, dtype=torch.int32)
        n = int(counts[tile].clamp(0, bins.shape[1]))
        for r in _units(rows, bins, tile, n, gathered):
            if not r.shape[0]:   # a slice of holes
                continue
            ok = _region_ok(r, tx, ty, rows_of)
            for t in range(r.shape[0]):
                c = r[t][None, :, None, None]
                cov, zv = raster._coverage(c, Xt, Yt)
                take = cov & (zv >= zb[tile:tile + 1]) & ok[t][None]
                if gathered and nonneg:
                    take &= zv >= 0.0
                cnt = raster._add_fragments(acc, cnt, c, take, Xt, Yt, light)
        acc_t.append(torch.cat(acc))
        cnt_t.append(cnt[0])
    f = lambda t: raster._tiles_to_frame(t, tiles["tiles_x"], tiles["tiles_y"])  # noqa: E731
    return f(torch.stack(acc_t, 1)), f(torch.stack(cnt_t))


def _bits(t):
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _equal(got, want, what):
    for name, g, w in zip(("first", "second"), got, want):
        assert torch.equal(_bits(g), _bits(w)), f"{what}: {name} output differs"


# -- the pieces ---------------------------------------------------------------


@pytest.mark.parametrize("split,seg_min", [(8, 4), (4, 1), (3, 2)])
def test_segments_cut_each_bin_into_contiguous_ordered_pieces(split, seg_min):
    counts = torch.tensor([-3, 0, 1, 3, 4, 5, 17, 31, 32, 33, 154, 1000, 5000],
                          dtype=torch.int32)
    width = 1408
    segs = raster.fused_segments(counts, width, split, seg_min)
    for n_raw, s in zip(counts.tolist(), segs.tolist()):
        n = min(max(n_raw, 0), width)
        assert 1 <= s <= split
        bounds = [raster.segment_bounds(n, s, q) for q in range(s)]
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert s == min(split, max(1, -(-n // seg_min)))   # one a seg_min entries
        assert max(e - b for b, e in bounds) - min(e - b for b, e in bounds) <= 1


def test_region_reject_is_exact_on_random_and_extreme_planes():
    """Wherever region_rows says no, the float edge test the kernels run
    covers no pixel center of that region row (checked at every center)."""
    rng = np.random.default_rng(11)
    n = 3000
    rows = np.zeros((n, 48), np.float32)
    scale = 10.0 ** rng.uniform(-8, 8, size=(n, 9))
    rows[:, :9] = rng.uniform(-1, 1, size=(n, 9)) * scale
    # edges through pixel centers and region borders, tiny slopes
    k = rng.integers(0, 64, size=n)
    rows[::3, 0], rows[::3, 1], rows[::3, 2] = 1.0, -1e-8, -(k[::3] + 0.5)
    rows[1::7, 3:6] = (0.0, 1.0, -8.5)
    rows[2::11, :9] = np.nan
    rows[5::13, 0] = np.inf
    rows[6::17, :9] = (0.0, 0.0, -1.0) * 3   # dead
    t = torch.from_numpy(rows)
    x0 = torch.tensor([0, 32, 64, 96, 224])
    y0 = torch.tensor([0, 8, 24, 56])
    may = raster.region_rows(t[:, None, None, :], x0[None, None, :], y0[None, :, None])
    xs = (torch.arange(32)[None, :] + x0[:, None]).float() + 0.5       # (5, 32)
    ys = (torch.arange(8)[None, :] + y0[:, None]).float() + 0.5        # (4, 8)
    X = xs[None, :, None, :].expand(4, 5, 8, 32)
    Y = ys[:, None, :, None].expand(4, 5, 8, 32)
    c = t[:, :, None, None, None, None]
    cov = (raster._edge_cov(c[:, 0], c[:, 1], c[:, 2], X, Y)
           & raster._edge_cov(c[:, 3], c[:, 4], c[:, 5], X, Y)
           & raster._edge_cov(c[:, 6], c[:, 7], c[:, 8], X, Y)).any(-1)
    assert may.shape == cov.shape == (n, 4, 5, 8)
    assert not (cov & ~may).any(), "a rejected region row has a covered pixel"
    assert (~may).float().mean() > 0.3   # and it does reject
    assert (may.any(-1) & ~may.all(-1)).any()   # whole regions and single rows


# -- the models against the plain versions and JAX ----------------------------


@pytest.fixture(scope="module")
def small():
    """Two tiles, 12 chunks each, and the JAX package's outputs on the same
    rows (interpret mode, its own CHUNK=8 bins over the same boxes)."""
    rows, bins, counts = _inputs(12, TWO_TILES, seed=1)
    w, h = _frame(TWO_TILES)
    z_base = torch.from_numpy(hazards.hazard_z_base(w, h))
    box, valid = hazards.hazard_boxes(rows.numpy())
    caabb, cvalid = jraster.chunk_aabbs(jnp.asarray(box), jnp.asarray(valid))
    gaabb, gvalid = jraster.group_aabbs(jnp.asarray(box), jnp.asarray(valid))
    jbins, jcounts = jraster.bin_triangles_full(caabb, cvalid, gaabb=gaabb, gvalid=gvalid,
                                                **TWO_TILES)
    fused = jraster.rasterize_fused_slabs(jnp.asarray(rows.numpy()), jbins, jcounts,
                                          **TWO_TILES)
    accum = jraster.rasterize_accum_slabs(jnp.asarray(rows.numpy()), jbins, jcounts,
                                          jnp.asarray(z_base.numpy()), jnp.asarray(LIGHT),
                                          **TWO_TILES)
    return dict(rows=rows, bins=bins, counts=counts, z_base=z_base,
                jfused=[np.asarray(a) for a in fused[:2]],
                jaccum=[np.asarray(a) for a in accum])


@pytest.mark.parametrize("split,seg_min", [(raster.FUSED_SPLIT, raster.FUSED_SEG_MIN),
                                           (4, 1), (8, 1)])
def test_fused_model_equals_plain_and_jax(small, split, seg_min):
    rows, bins, counts = small["rows"], small["bins"], small["counts"]
    assert int(raster.fused_segments(counts, bins.shape[1], split, seg_min).min()) > 1
    got = model_fused(rows, bins, counts, TWO_TILES, split, seg_min)
    plain = raster.rasterize_fused_plain(rows, bins, counts, **TWO_TILES)
    _equal(got, plain[:2], "model against rasterize_fused_plain")
    _equal(got, small["jfused"], "model against the JAX package")


def _reversed(bins, counts):
    out = bins.clone()
    for tile in range(bins.shape[0]):
        n = int(counts[tile].clamp(0, bins.shape[1]))
        out[tile, :n] = bins[tile, :n].flip(0)
    return out


def _gathered_inputs(tiles, holes, seed=7):
    """Kernel 2.7's inputs: hazard_accum_rows (rows 5 and 6 of each of 8
    chunks at negative depths) and per-triangle bins of every member of
    each binned chunk (expand_bins), with hazard_holes' -1 holes or none,
    and hazard_accum_z_base (negative over the right half)."""
    _, dense, counts = _inputs(8, tiles, seed)
    w, h = _frame(tiles)
    rows = torch.from_numpy(hazards.hazard_accum_rows(8, w, h, seed=seed))
    live = torch.arange(dense.shape[1])[None, :] < counts[:, None]
    cbins = torch.where(live, dense >> 4, raster.NO_TRI)
    if holes:
        cbins = torch.from_numpy(hazards.hazard_holes(cbins.numpy(), counts.numpy()))
    bins, tcounts = raster.expand_bins(cbins, counts)
    return rows, bins, tcounts, torch.from_numpy(hazards.hazard_accum_z_base(w, h))


@pytest.fixture(scope="module")
def gathered():
    """Kernel 2.7's inputs over two tiles with -1 holes, and over one tile
    without (the JAX wrapper would clip a hole onto row 0) with the JAX
    package's rasterize_accum_fused on it (interpret mode)."""
    rows, bins, counts, z_base = _gathered_inputs(ONE_TILE, holes=False)
    jaccum = jraster.rasterize_accum_fused(
        jnp.asarray(rows.numpy()), jnp.asarray(bins.numpy()), jnp.asarray(counts.numpy()),
        jnp.asarray(z_base.numpy()), jnp.asarray(LIGHT), **ONE_TILE)
    return dict(two=_gathered_inputs(TWO_TILES, holes=True),
                one=(rows, bins, counts, z_base), jaccum=[np.asarray(a) for a in jaccum])


@pytest.mark.parametrize("mode", ["chunks", "gathered"])
def test_accum_model_equals_plain_and_jax(small, gathered, mode):
    """2.2's model on dense bins against the plain version and JAX; 2.7's
    on per-triangle bins with -1 holes, in slot order and each tile's
    reversed, against rasterize_accum_gathered_plain, and on one tile
    against JAX; a 2.7 model without 0 <= z differs (hazard_accum_z_base's
    negative half)."""
    light = torch.from_numpy(LIGHT)
    if mode == "chunks":
        rows, bins, counts, z_base = (small[k] for k in ("rows", "bins", "counts", "z_base"))
        got = model_accum(rows, bins, counts, z_base, light, TWO_TILES)
        plain = raster.rasterize_accum_plain(rows, bins, counts, z_base, light, **TWO_TILES)
        _equal(got, plain, "model against rasterize_accum_plain")
        _equal(got, (small["jaccum"][0], small["jaccum"][1]), "model against the JAX package")
        assert int(got[1].max()) >= 3
        return
    rows, bins, counts, z_base = gathered["two"]
    assert bool((bins[:, :int(counts.min())] < 0).any()), "no hole inside a count"
    for order in ("slot order", "reversed"):
        b = bins if order == "slot order" else _reversed(bins, counts)
        got = model_accum(rows, b, counts, z_base, light, TWO_TILES, gathered=True)
        plain = raster.rasterize_accum_gathered_plain(rows, b, counts, z_base, light,
                                                      **TWO_TILES)
        _equal(got, plain, f"2.7 model against rasterize_accum_gathered_plain, {order}")
        assert int(got[1].max()) >= 3
    rows, bins, counts, z_base = gathered["one"]
    got = model_accum(rows, bins, counts, z_base, light, ONE_TILE, gathered=True)
    _equal(got, (gathered["jaccum"][0], gathered["jaccum"][1]), "2.7 model against JAX")
    loose = model_accum(rows, bins, counts, z_base, light, ONE_TILE, gathered=True,
                        nonneg=False)
    assert int(loose[1].sum()) > int(got[1].sum()), "0 <= z never decides here"


def test_hazards_are_reached(small):
    """The adversarial rows do what they are for: -0.0 and +0.0 winners,
    the tie row won by its latest copy, and a reject without its margin
    changes the frame."""
    rows, bins, counts = small["rows"], small["bins"], small["counts"]
    z, tid = raster.rasterize_fused_plain(rows, bins, counts, **TWO_TILES)[:2]
    zero = (z == 0) & (tid >= 0)
    assert (zero & torch.signbit(z)).any() and (zero & ~torch.signbit(z)).any()
    tie = (tid % raster.CHUNK) == 7
    last_tie = (rows.shape[0] // raster.CHUNK - 1) * raster.CHUNK + 7
    assert tie.any() and (tid[tie] == last_tie).all()
    loose = model_fused(rows, bins, counts, TWO_TILES, rows_of=_no_margin_rows)
    assert not torch.equal(loose[1], tid), "the margin is never needed on these rows"
    w, h = _frame(TWO_TILES)
    light = torch.from_numpy(LIGHT)
    loose = model_accum(rows, bins, counts, small["z_base"], light, TWO_TILES,
                        rows_of=_no_margin_rows)
    plain = raster.rasterize_accum_plain(rows, bins, counts, small["z_base"], light,
                                         **TWO_TILES)
    assert not torch.equal(loose[1], plain[1])


def test_fused_model_splits_a_dense_tile_eight_ways():
    """One tile of 40 entries at the kernel's own constants: 8 segments of
    5, each boundary straddled by an equal-z copy."""
    rows, bins, counts = _inputs(40, ONE_TILE, seed=2)
    assert int(counts[0]) == 40
    assert int(raster.fused_segments(counts, bins.shape[1])[0]) == raster.FUSED_SPLIT
    got = model_fused(rows, bins, counts, ONE_TILE)
    _equal(got, raster.rasterize_fused_plain(rows, bins, counts, **ONE_TILE)[:2],
           "model against rasterize_fused_plain")

"""CPU tests of how the visibility walks 2.4 and 2.6 spread a tile's work
(vis_tile in csrc/raster_common.cuh; csrc/raster_deferred.cu,
raster_gathered.cu): a torch model of the kernels' decomposition — the
tile's per-triangle entries cut into segments (raster.vis_segments), each
walked alone from (0, -1) in entry order with the per-region and per-row
reject (raster.region_rows), the segments' (z, tid) folded in segment
order with the walk's own rule, take if tq >= 0 and zq >= zw — held bit
for bit against the plain versions (rasterize_plain,
rasterize_fused_gathered_plain: z, tid and, for 2.6, every plane) and the
JAX package's Pallas kernels in interpret mode (raster.rasterize,
raster.rasterize_fused), on utils/hazards.py's visibility rows: one dense
tile cut VIS_SPLIT ways (and 16), 2x2 tiles, a bin walked in reverse, and
a bin whose segments hold no winner beside zero-depth winners of either
sign.

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
KINDS = ("deferred", "gathered")   # kernel 2.4, kernel 2.6


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


def _table(kind, rows):
    """The rows as the kernel takes them: (T, 16) packed (2.4) or (T, 48)
    fat rows (2.6)."""
    return torch.from_numpy(hazards.hazard_packed(rows) if kind == "deferred" else rows)


def _inputs(kind, n_chunks, tiles, seed):
    """Visibility hazard rows over the tiles and their per-triangle bins,
    ids ascending: (rows (numpy fat rows), table, bins, counts)."""
    w, h = _frame(tiles)
    rows = hazards.hazard_vis_rows(n_chunks, w, h, seed=seed)
    box, valid = (torch.from_numpy(a) for a in hazards.hazard_boxes(rows))
    bins, counts, _ = raster.bin_triangles(box, valid, bin_cap=rows.shape[0], **tiles)
    return rows, _table(kind, rows), bins, counts


def _region_ok(tri_rows, tx, ty, rows_of=raster.region_rows):
    """(k, 32, 128): may triangle k be tested at each pixel of tile (tx,
    ty)? The answer for its warp's region and row."""
    x0 = tx * 128 + torch.arange(0, 128, raster.REGION_W)
    y0 = ty * 32 + torch.arange(0, 32, raster.REGION_H)
    ok = rows_of(tri_rows[:, None, None, :], x0[None, None, :], y0[None, :, None])
    ok = ok.permute(0, 1, 3, 2).reshape(ok.shape[0], 32, -1)
    return ok.repeat_interleave(raster.REGION_W, 2)


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


def model_vis(table, bins, counts, tiles, split=raster.VIS_SPLIT, seg_min=raster.VIS_SEG_MIN,
              rows_of=raster.region_rows):
    """Kernel 2.4's / 2.6's walk in torch: per tile each segment walked
    alone, in entry order, from (0, -1), every entry tested only where its
    warp's region row may be covered, an entry that is no row of the table
    dropped; then the segments' winners folded in segment order with the
    walk's rule. Returns (z, tid) frames and the most segments of one tile
    that won some pixel."""
    X, Y = raster._tile_planes(**tiles, device=table.device)
    T, width = table.shape[0], bins.shape[1]
    segs_all = raster.fused_segments(counts, width, split, seg_min)
    z_out = torch.zeros(X.shape)
    tid_out = torch.full(X.shape, -1, dtype=torch.int32)
    most_won = 0
    for tile in range(X.shape[0]):
        tx, ty = tile % tiles["tiles_x"], tile // tiles["tiles_x"]
        n, segs = int(counts[tile].clamp(0, width)), int(segs_all[tile])
        Xt, Yt = X[tile:tile + 1], Y[tile:tile + 1]
        zw, tw = z_out[tile], tid_out[tile]
        won = 0
        for q in range(segs):
            e0, e1 = raster.segment_bounds(n, segs, q)
            ids = bins[tile, e0:e1]
            ids = ids[(ids >= 0) & (ids < T)]
            z = torch.zeros(Xt.shape[1:])
            tid = torch.full(Xt.shape[1:], -1, dtype=torch.int32)
            if ids.numel():
                tri = table[ids.long(), :12]
                cov, zv = raster._coverage(tri[:, :, None, None], Xt, Yt)
                cov &= _region_ok(tri, tx, ty, rows_of)
                for k in range(ids.numel()):
                    take = cov[k] & (zv[k] >= z)
                    z = torch.where(take, zv[k], z)
                    tid = torch.where(take, ids[k], tid)
            won += bool((tid >= 0).any())
            take = (tid >= 0) & (z >= zw)
            zw, tw = torch.where(take, z, zw), torch.where(take, tid, tw)
        z_out[tile], tid_out[tile] = zw, tw
        most_won = max(most_won, won)
    f = lambda t: raster._tiles_to_frame(t, tiles["tiles_x"], tiles["tiles_y"])  # noqa: E731
    return (f(z_out), f(tid_out)), most_won


def _bits(t):
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _equal(got, want, what, names=("z", "tid", "nums", "metas", "attrs", "inv")):
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        assert torch.equal(_bits(g), _bits(w)), f"{what}: {name} differs"


def _plain(kind, table, bins, counts, tiles):
    if kind == "deferred":
        return raster.rasterize_plain(table, bins, counts, **tiles)
    return raster.rasterize_fused_gathered_plain(table, bins, counts, **tiles)


def _outputs(kind, table, zt, tiles):
    """The model's (z, tid) with, for 2.6, the planes the kernel's epilogue
    writes (store_winner, as the plain version's _winner_planes)."""
    if kind == "deferred":
        return zt
    X, Y = raster._tile_planes(**tiles, device=table.device)
    tid_t = raster._frame_to_tiles(zt[1], tiles["tiles_x"], tiles["tiles_y"],
                                   tiles["tile_w"], tiles["tile_h"])
    nums, metas = raster._winner_planes(table, tid_t, X, Y)
    f = lambda t: raster._tiles_to_frame(t, tiles["tiles_x"], tiles["tiles_y"])  # noqa: E731
    return (*zt, f(nums), f(metas))


def _jax(kind, table, bins, counts, tiles):
    """The JAX package's kernel on the same rows and bins, in interpret
    mode: rasterize (z, tid) or rasterize_fused (z, tid, attrs, metas,
    inv)."""
    args = (jnp.asarray(table.numpy()), jnp.asarray(bins.numpy()), jnp.asarray(counts.numpy()))
    if kind == "deferred":
        out = jraster.rasterize(*args, **tiles)
    else:
        out = jraster.rasterize_fused(*args, **tiles)
    return [np.asarray(o) for o in out]


def _public(kind, outs, tiles):
    """2.6's carried planes as the public contract (reconstruct_outputs),
    the form the JAX package returns."""
    if kind == "deferred":
        return outs
    h, w = outs[0].shape
    X, Y = raster._frame_planes(h, w, "cpu")
    return (outs[0], outs[1], *raster.reconstruct_outputs(outs[2], outs[3], X, Y))


def _reversed(bins, counts):
    out = bins.clone()
    for tile in range(bins.shape[0]):
        n = int(counts[tile].clamp(0, bins.shape[1]))
        out[tile, :n] = bins[tile, :n].flip(0)
    return out


# -- the cut ------------------------------------------------------------------


def test_vis_segments_are_the_fused_cut_at_the_kernels_constants():
    """vis_segments mirrors VIS_SPLIT / VIS_SEG_MIN of raster_common.cuh:
    one segment for every VIS_SEG_MIN entries, 1 to VIS_SPLIT of them,
    contiguous, covering the clamped count, lengths within 1."""
    counts = torch.tensor([-3, 0, 1, 31, 32, 33, 64, 102, 255, 256, 257, 4453, 9000],
                          dtype=torch.int32)
    width = 8192
    segs = raster.vis_segments(counts, width)
    assert torch.equal(segs, raster.fused_segments(counts, width, raster.VIS_SPLIT,
                                                   raster.VIS_SEG_MIN))
    for n_raw, s in zip(counts.tolist(), segs.tolist()):
        n = min(max(n_raw, 0), width)
        assert s == min(raster.VIS_SPLIT, max(1, -(-n // raster.VIS_SEG_MIN)))
        bounds = [raster.segment_bounds(n, s, q) for q in range(s)]
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert max(e - b for b, e in bounds) - min(e - b for b, e in bounds) <= 1


# -- one dense tile, in order and reversed ------------------------------------


@pytest.fixture(scope="module", params=KINDS)
def dense(request):
    """One tile of ~560 entries, cut VIS_SPLIT ways, its bin in order and
    each tile's reversed, with the JAX package's outputs on both (one JAX
    compile a kind)."""
    kind = request.param
    rows, table, bins, counts = _inputs(kind, 18, ONE_TILE, seed=5)
    assert int(raster.vis_segments(counts, bins.shape[1])[0]) == raster.VIS_SPLIT
    rev = _reversed(bins, counts)
    return dict(kind=kind, rows=rows, table=table, bins=bins, rev=rev, counts=counts,
                jax=_jax(kind, table, bins, counts, ONE_TILE),
                jax_rev=_jax(kind, table, rev, counts, ONE_TILE),
                plain=_plain(kind, table, bins, counts, ONE_TILE))


@pytest.mark.parametrize("split", [raster.VIS_SPLIT, 16])
def test_vis_model_splits_a_dense_tile(dense, split):
    """The dense tile cut `split` ways: the model equals the plain version
    (z, tid, 2.6's planes) and the JAX kernel, bit for bit, and more than
    one segment wins pixels (the fold has work)."""
    kind, table, bins, counts = (dense[k] for k in ("kind", "table", "bins", "counts"))
    assert int(raster.fused_segments(counts, bins.shape[1], split, raster.VIS_SEG_MIN)[0]) \
        == split
    zt, won = model_vis(table, bins, counts, ONE_TILE, split=split)
    got = _outputs(kind, table, zt, ONE_TILE)
    _equal(got, dense["plain"], f"{kind} model against the plain version")
    _equal(_public(kind, got, ONE_TILE), dense["jax"], f"{kind} model against JAX",
           ("z", "tid", "attrs", "metas", "inv"))
    assert won > 1


def test_vis_model_is_exact_on_a_reversed_bin(dense):
    """The dense tile's bin walked in reverse: the ties go the other way
    (the frame differs from the ascending bin's), and the model still
    equals the plain version and the JAX kernel on the reversed bin."""
    kind, table, rev, counts = (dense[k] for k in ("kind", "table", "rev", "counts"))
    zt, _ = model_vis(table, rev, counts, ONE_TILE)
    got = _outputs(kind, table, zt, ONE_TILE)
    _equal(got, _plain(kind, table, rev, counts, ONE_TILE), f"{kind} reversed: model vs plain")
    _equal(_public(kind, got, ONE_TILE), dense["jax_rev"], f"{kind} reversed: model vs JAX",
           ("z", "tid", "attrs", "metas", "inv"))
    assert not torch.equal(got[1], dense["plain"][1]), "no tie changed its winner"


# -- 2x2 tiles -----------------------------------------------------------------


@pytest.fixture(scope="module", params=KINDS)
def quad(request):
    kind = request.param
    rows, table, bins, counts = _inputs(kind, 8, QUAD, seed=3)
    return dict(kind=kind, rows=rows, table=table, bins=bins, counts=counts,
                jax=_jax(kind, table, bins, counts, QUAD),
                plain=_plain(kind, table, bins, counts, QUAD))


def test_vis_model_equals_plain_and_jax_on_quad_tiles(quad):
    kind, table, bins, counts = (quad[k] for k in ("kind", "table", "bins", "counts"))
    assert int(raster.vis_segments(counts, bins.shape[1]).min()) > 1
    zt, _ = model_vis(table, bins, counts, QUAD)
    got = _outputs(kind, table, zt, QUAD)
    _equal(got, quad["plain"], f"{kind} model against the plain version")
    _equal(_public(kind, got, QUAD), quad["jax"], f"{kind} model against JAX",
           ("z", "tid", "attrs", "metas", "inv"))


def test_vis_hazards_are_reached(quad):
    """The visibility hazards do what they are for on the 2x2 tiles:
    -0.0 and +0.0 winners; the tie row (7) won by its latest copy; the
    depth strip (row 2) won left of z = 1 and clipped right of it; the
    infinite-edge strip (row 4) won; no NaN row (3) won; and a reject
    without its rounding margin changes the frame."""
    table, bins, counts = quad["table"], quad["bins"], quad["counts"]
    z, tid = quad["plain"][:2]
    zero = (z == 0) & (tid >= 0)
    assert (zero & torch.signbit(z)).any() and (zero & ~torch.signbit(z)).any()
    t = tid % hazards.CHUNK
    tie = t == 7
    assert tie.any() and (tid[tie] == table.shape[0] - hazards.CHUNK + 7).all()
    w = z.shape[1]
    strip = t == 2
    assert strip[:, : w // 4].any() and not strip[:, 3 * w // 4:].any()
    assert (z[strip] <= 1.0).all()
    assert (t == 4).any() and not (t == 3).any()
    loose, _ = model_vis(table, bins, counts, QUAD, rows_of=_no_margin_rows)
    assert not torch.equal(loose[1], tid), "the margin is never needed on these rows"


# -- segments with no winner beside zero-depth winners -------------------------


@pytest.mark.parametrize("order", ["ascending", "reversed"])
def test_vis_model_folds_empty_segments_and_signed_zeros(dense, order):
    """hazards.hazard_fold_bin over the dense tile's rows: four segments,
    two with no winner, between a -0.0 full-screen winner and a +0.0
    left-half one. The model equals the plain version and the JAX kernel;
    in order the left half holds row 22 at +0.0, the right half row 15 at
    -0.0 (a fold that let an empty segment win would lose those bits);
    reversed, row 15 at -0.0 everywhere."""
    kind, table = dense["kind"], dense["table"]
    fold = torch.full((1, dense["bins"].shape[1]), -1, dtype=torch.int32)
    one = torch.from_numpy(hazards.hazard_fold_bin(18, raster.VIS_SEG_MIN))
    fold[:, : one.shape[1]] = one if order == "ascending" else one.flip(1)
    counts = torch.tensor([one.shape[1]], dtype=torch.int32)
    assert int(raster.vis_segments(counts, fold.shape[1])[0]) == 4
    zt, won = model_vis(table, fold, counts, ONE_TILE)
    got = _outputs(kind, table, zt, ONE_TILE)
    _equal(got, _plain(kind, table, fold, counts, ONE_TILE), f"{kind} fold: model vs plain")
    _equal(_public(kind, got, ONE_TILE), _jax(kind, table, fold, counts, ONE_TILE),
           f"{kind} fold: model vs JAX", ("z", "tid", "attrs", "metas", "inv"))
    z, tid = zt
    assert won == 2
    if order == "ascending":
        assert (tid[:, :64] == 22).all() and (tid[:, 64:] == 15).all()
        assert not torch.signbit(z[:, :64]).any() and torch.signbit(z[:, 64:]).all()
    else:
        assert (tid == 15).all() and torch.signbit(z).all()

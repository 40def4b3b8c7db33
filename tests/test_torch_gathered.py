"""The gathered-row raster oracles of the port (kernels 2.6, 2.7, 2.8: per
triangle bins over the 48-column fat rows) against the JAX package's
rasterize_fused / rasterize_accum_fused / rasterize_peel_fused on identical
inputs, and against the port's own stream passes, as the JAX package's
tests/test_chunk_streaming.py holds its stream kernels to these oracles.
Also the pieces the oracle tests start from: rasterize_fused_chunks,
rasterize_accum_chunks, rasterize_reference and vertex.triangle_setup.

Two scenes, both at 2x2 tiles of 32x128: the multi-quad scene of
tests/test_chunk_streaming.py (JAX setup and bins at the test tier's
CHUNK=8) and the seeded triangles of tests/test_torch_raster.py (an equal-z
pair, a quad split on its diagonal).

Tolerance (PERF.md): integer outputs and the float outputs are exact; the
JAX side runs its Pallas kernels in interpret mode, as its own tests do. On
the CPU the port runs the plain versions of its kernels. Only
rasterize_reference's z is compared within 1e-5: it is a plain numpy loop
with no fused multiply-add, in both packages.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_chunk_streaming import _multi_quad_scene, _setup  # noqa: E402
from tests.test_torch_raster import T, W, H, _screen_tris  # noqa: E402
from tpu_renderer.kernels import raster as jraster  # noqa: E402
from tpu_renderer.kernels import vertex as jvertex  # noqa: E402
from tpu_renderer_torch.kernels import raster, vertex  # noqa: E402
from test_torch_threads import share_cores  # noqa: E402

share_cores()

TILES = dict(tiles_x=2, tiles_y=2, tile_w=128, tile_h=32)
LIGHT = np.asarray([0.2, 0.8, 0.5, 1.0, 0.1, 0.15, 0.2, 0.0], np.float32)
JCHUNK = jraster.CHUNK   # 8 at the test tier (tests/conftest.py)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _same(got, want, names):
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


def _scene_quads():
    s, rows, cbins, ccounts = _setup(_multi_quad_scene())
    return rows, s.aabb, s.valid, cbins, ccounts


def _scene_seeded():
    """tests/test_torch_raster.py's triangles as fat rows in submission
    order, with capped chunk bins over them."""
    rng = np.random.default_rng(3)
    ndc = _screen_tris(rng)
    V = T * 3
    corners = jvertex.expand_corners(
        ndc.reshape(-1, 3), rng.normal(size=(V, 3)).astype(np.float32),
        rng.uniform(size=(V, 4)).astype(np.float32),
        rng.uniform(size=(V, 2)).astype(np.float32),
        np.arange(V, dtype=np.int32).reshape(T, 3), np.zeros(T, np.int32),
        np.ones(T, bool), np.zeros(1, np.int32), np.ones((1, 4), np.float32),
        mat_meta=np.asarray([[0, 0, 64, 64, 7, 3, 0, 0]], np.float32))
    eye = jnp.eye(4, dtype=jnp.float32)
    rows, aabb, valid = jvertex.triangle_setup_rows(
        corners, jnp.zeros(T, jnp.int32), jnp.ones(T, bool), eye[None],
        jnp.ones(1, bool), eye, W, H, sun_dir=jnp.asarray([0.3, 0.8, -0.5]))
    caabb, cvalid = jraster.chunk_aabbs(aabb, valid)
    cbins, ccounts, _ = jraster.bin_triangles(caabb, cvalid, bin_cap=caabb.shape[0],
                                              **TILES)
    return rows, aabb, valid, cbins, ccounts


@pytest.fixture(scope="module", params=["quads", "seeded"])
def scene(request):
    """JAX rows, boxes and bins of one scene, and the opaque depth the
    transparent passes test against: the scene's own on the left tiles (so
    the depth test bites), none on the right."""
    rows, aabb, valid, cbins, ccounts = (_scene_quads if request.param == "quads"
                                         else _scene_seeded)()
    refined = jraster.refine_bins(cbins, aabb, tri_cap=256, **TILES)[:2]
    expanded = jraster.expand_bins(cbins, ccounts)
    fused = jraster.rasterize_fused(rows, *refined, **TILES)
    z_base = np.asarray(fused[0]).copy()
    z_base[:, 128:] = raster.DEPTH_CLEAR
    n = lambda xs: tuple(np.asarray(x) for x in xs)  # noqa: E731
    return dict(name=request.param, rows=np.asarray(rows), aabb=np.asarray(aabb),
                valid=np.asarray(valid), cbins=np.asarray(cbins),
                ccounts=np.asarray(ccounts), refined=n(refined), expanded=n(expanded),
                fused=n(fused), z_base=z_base)


# -- the plain versions against the JAX package's interpret-mode kernels ----


def test_fused_gathered_matches_jax(scene):
    """Kernel 2.6's function on refine_bins output: all five outputs."""
    got = raster.rasterize_fused_gathered(_t(scene["rows"]), *map(_t, scene["refined"]),
                                          **TILES)
    _same(got, scene["fused"], ("z", "tid", "attrs", "metas", "inv"))
    assert int((got[1] >= 0).sum()) > 1000


def test_accum_gathered_matches_jax(scene):
    """Kernel 2.7's function on expand_bins output: the sum in slot order,
    exact, and the count."""
    bins, counts = scene["expanded"]
    want = jraster.rasterize_accum_fused(
        jnp.asarray(scene["rows"]), jnp.asarray(bins), jnp.asarray(counts),
        jnp.asarray(scene["z_base"]), jnp.asarray(LIGHT), **TILES)
    acc, cnt = raster.rasterize_accum_gathered(
        _t(scene["rows"]), _t(bins), _t(counts), _t(scene["z_base"]), _t(LIGHT), **TILES)
    _same((cnt, acc), (want[1], want[0]), ("cnt", "acc"))
    assert int(cnt.max()) >= 2


def test_peel_gathered_matches_jax(scene):
    """Kernel 2.8's function over three peels, `last` fed back."""
    bins, counts = scene["expanded"]
    rows, z = scene["rows"], scene["z_base"]
    last = np.full(z.shape, -1, np.int32)
    layers = 0
    for _ in range(3):
        want = jraster.rasterize_peel_fused(
            jnp.asarray(rows), jnp.asarray(bins), jnp.asarray(counts), jnp.asarray(z),
            jnp.asarray(last), **TILES)
        got = raster.rasterize_peel_gathered(_t(rows), _t(bins), _t(counts), _t(z),
                                             _t(last), **TILES)
        _same(got, want, ("layer", "attrs", "metas", "inv"))
        layer = got[0].numpy()
        layers += int((layer < raster.ID_INF).any())
        last = np.where(layer < raster.ID_INF, layer, raster.ID_INF).astype(np.int32)
    assert layers >= 2


# -- the port's own cross-checks: oracle == stream pass ----------------------


def _port_bins(scene, chunk):
    """The port's capped chunk bins, dense bins and both per-triangle bins
    over the scene's rows at `chunk` (rows padded to whole chunks)."""
    rows, aabb, valid = _t(scene["rows"]), _t(scene["aabb"]), _t(scene["valid"])
    pad = raster.pad_tris(rows.shape[0], chunk) - rows.shape[0]
    if pad:
        # dead rows: the never-covered edge planes, the empty box
        dead = torch.zeros((pad, raster.ROW_COLS))
        dead[:, [2, 5, 8]] = -1.0
        rows = torch.cat([rows, dead])
        aabb = torch.cat([aabb, torch.tensor([raster._EMPTY_AABB] * pad)])
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool)])
    caabb, cvalid = raster.chunk_aabbs(aabb, valid, chunk=chunk)
    gaabb, gvalid = raster.group_aabbs(aabb, valid, group=8)
    cbins, ccounts, overflow = raster.bin_triangles(
        caabb, cvalid, bin_cap=max(caabb.shape[0], 8), **TILES)
    assert int(overflow) == 0
    dense = raster.bin_triangles_full(caabb, cvalid, gaabb, gvalid, **TILES)
    refined = raster.refine_bins(cbins, aabb, tri_cap=256, chunk=chunk, **TILES)
    assert int(refined[2]) == 0
    expanded = raster.expand_bins(cbins, ccounts, chunk=chunk)
    return dict(rows=rows.contiguous(), cbins=cbins, ccounts=ccounts, dense=dense,
                refined=refined[:2], expanded=expanded, cg=dict(chunk=chunk, group=8))


@pytest.mark.parametrize("chunk", [8, 32])
def test_chunk_raster_matches_gathered(scene, chunk):
    """rasterize_fused_chunks (kernel 2.1's walk) == the gathered oracle on
    refined bins == rasterize_fused on dense bins with real group masks."""
    b = _port_bins(scene, chunk)
    names = ("z", "tid", "attrs", "metas", "inv")
    oracle = raster.rasterize_fused_gathered(b["rows"], *b["refined"], **TILES)
    chunks = raster.rasterize_fused_chunks(b["rows"], b["cbins"], b["ccounts"],
                                           **b["cg"], **TILES)
    dense = raster.rasterize_fused(b["rows"], *b["dense"], **b["cg"], **TILES)
    _same(chunks, oracle, names)
    _same(dense, chunks, names)
    if chunk == JCHUNK:   # the very bins the JAX oracle ran on
        _same(oracle, scene["fused"], names)


@pytest.mark.parametrize("chunk", [8, 32])
def test_chunk_accum_matches_gathered(scene, chunk):
    """rasterize_accum_chunks (kernel 2.2's walk) == the gathered oracle on
    expanded bins == rasterize_accum on dense bins. The ids ascend in all
    three, so the sums add in one order: exact."""
    b = _port_bins(scene, chunk)
    z, light = _t(scene["z_base"]), _t(LIGHT)
    oracle = raster.rasterize_accum_gathered(b["rows"], *b["expanded"], z, light, **TILES)
    chunks = raster.rasterize_accum_chunks(b["rows"], b["cbins"], b["ccounts"], z, light,
                                           **b["cg"], **TILES)
    dense = raster.rasterize_accum(b["rows"], *b["dense"], z, light, **b["cg"], **TILES)
    _same(chunks, oracle, ("acc", "cnt"))
    _same(dense, chunks, ("acc", "cnt"))
    assert int(oracle[1].max()) >= 2


@pytest.mark.parametrize("chunk", [8, 32])
def test_peel_matches_gathered(scene, chunk):
    """rasterize_peel_fused (kernel 2.3's walk) == the gathered oracle over
    three peels, each fed its own `last`."""
    b = _port_bins(scene, chunk)
    z = _t(scene["z_base"])
    last1 = last2 = torch.full(z.shape, -1, dtype=torch.int32)
    for _ in range(3):
        oracle = raster.rasterize_peel_gathered(b["rows"], *b["expanded"], z, last1, **TILES)
        stream = raster.rasterize_peel_fused(b["rows"], *b["dense"], z, last2,
                                             **b["cg"], **TILES)
        _same(stream, oracle, ("layer", "attrs", "metas", "inv"))
        last1 = torch.where(oracle[0] < raster.ID_INF, oracle[0], raster.ID_INF)
        last2 = torch.where(stream[0] < raster.ID_INF, stream[0], raster.ID_INF)
    assert int((last1 < raster.ID_INF).sum()) > 0


# -- slot order, dead and bad slots, refusals --------------------------------


def _two_equal_z_rows():
    """Fat rows of two copies of one triangle at one depth."""
    tri = np.asarray([[20, 4], [150, 30], [60, 60]], np.float32)
    ndc = np.empty((2, 3, 3), np.float32)
    ndc[..., 0] = tri[:, 0] / W * 2 - 1
    ndc[..., 1] = tri[:, 1] / H * 2 - 1
    ndc[..., 2] = 0.5
    corners = vertex.expand_corners(
        ndc.reshape(-1, 3), np.zeros((6, 3)), np.ones((6, 4)), np.zeros((6, 2)),
        np.arange(6).reshape(2, 3), np.zeros(2, np.int32), np.ones(2, bool),
        np.zeros(1, np.int32), np.ones((1, 4)), np.zeros((1, 8)), device="cpu")
    rows, _, _ = vertex.triangle_setup_rows(
        corners, torch.zeros(2, dtype=torch.int32), torch.ones(2, dtype=torch.bool),
        torch.eye(4)[None], torch.ones(1, dtype=torch.bool), torch.eye(4), W, H)
    return rows


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_fused_gathered_later_slot_wins_equal_z(order):
    """The tie rule of kernel 2.6 is slot order, not id order: with the
    bins descending, the smaller id sits in the later slot and wins; the
    JAX oracle agrees."""
    rows = _two_equal_z_rows()
    bins = torch.tensor([list(order) + [-1] * 6] * 4, dtype=torch.int32)
    counts = torch.full((4,), 2, dtype=torch.int32)
    out = raster.rasterize_fused_gathered(rows, bins, counts, **TILES)
    covered = out[1][out[1] >= 0]
    assert covered.numel() > 1000 and (covered == order[1]).all()
    want = jraster.rasterize_fused(jnp.asarray(rows.numpy()), jnp.asarray(bins.numpy()),
                                   jnp.asarray(counts.numpy()), **TILES)
    _same(out, want, ("z", "tid", "attrs", "metas", "inv"))


def test_gathered_passes_never_read_past_the_count(scene):
    """Junk past a tile's count changes nothing; an entry inside the count
    that is no row of the table is dropped."""
    rows = _t(scene["rows"])
    bins, counts = map(_t, scene["expanded"])
    z, light = _t(scene["z_base"]), _t(LIGHT)
    last = torch.full(z.shape, -1, dtype=torch.int32)
    junk = bins.clone()
    past = torch.arange(bins.shape[1])[None, :] >= counts[:, None]
    junk[past] = 10 ** 6
    # a bad slot inside the count: the row count itself, and a negative id
    spoiled = torch.cat([torch.full((4, 1), rows.shape[0], dtype=torch.int32),
                         torch.full((4, 1), -7, dtype=torch.int32), junk], dim=1)
    for fn, extra in ((raster.rasterize_fused_gathered, ()),
                      (raster.rasterize_accum_gathered, (z, light)),
                      (raster.rasterize_peel_gathered, (z, last))):
        want = fn(rows, bins, counts, *extra, **TILES)
        _same(fn(rows, junk, counts, *extra, **TILES), want, "abcde")
        _same(fn(rows, spoiled.contiguous(), counts + 2, *extra, **TILES), want, "abcde")
        # counts past the bin width walk the width and no further
        _same(fn(rows, bins, counts + bins.shape[1], *extra, **TILES),
              fn(rows, bins, torch.full_like(counts, bins.shape[1]), *extra, **TILES),
              "abcde")


def test_gathered_wrappers_check_inputs(scene):
    rows = _t(scene["rows"])
    bins, counts = map(_t, scene["expanded"])
    z, light = _t(scene["z_base"]), _t(LIGHT)
    last = torch.full(z.shape, -1, dtype=torch.int32)
    # the id must stay exact where the JAX oracle carries it as a float:
    # 2^24 rows are refused (a zero-stride view: nothing that size exists)
    huge = torch.zeros(1, raster.ROW_COLS).expand(raster.MAX_GATHERED_TRIS,
                                                  raster.ROW_COLS)
    with pytest.raises(ValueError, match="2\\^24"):
        raster.rasterize_fused_gathered(huge, bins, counts, **TILES)
    with pytest.raises(TypeError):
        raster.rasterize_fused_gathered(rows.double(), bins, counts, **TILES)
    with pytest.raises(ValueError):
        raster.rasterize_fused_gathered(rows[:, :16].contiguous(), bins, counts, **TILES)
    with pytest.raises(TypeError):
        raster.rasterize_accum_gathered(rows, bins.long(), counts, z, light, **TILES)
    with pytest.raises(ValueError):
        raster.rasterize_accum_gathered(rows, bins, counts, z[:-1], light, **TILES)
    with pytest.raises(TypeError):
        raster.rasterize_peel_gathered(rows, bins, counts, z, last.float(), **TILES)
    # fat rows of any T: no whole-chunk rule under per-triangle bins
    odd = raster.rasterize_fused_gathered(rows[:-3].contiguous(), bins, counts, **TILES)
    assert odd[0].shape == (H, W)
    # the kernel launchers take CUDA tensors only: no CPU fallback there
    for launch, extra in ((raster.raster_fused_gathered_kernel, ()),
                          (raster.raster_accum_gathered_kernel, (z, light)),
                          (raster.raster_peel_gathered_kernel, (z, last))):
        with pytest.raises(ValueError, match="CUDA"):
            launch(rows, bins, counts, *extra, **TILES)
    assert (raster.fused_gathered_counter.launches, raster.accum_gathered_counter.launches,
            raster.peel_gathered_counter.launches) == (0, 0, 0)


# -- rasterize_reference and vertex.triangle_setup ---------------------------

RW, RH = 128, 64   # tests/test_raster.py's frame: one tile column, two rows
RTILES = dict(tiles_x=1, tiles_y=2, tile_w=128, tile_h=32)


def _setup_args(tris, zs):
    """tests/test_raster.py's setup_from_screen arguments, as numpy."""
    tris, zs = np.asarray(tris, np.float32), np.asarray(zs, np.float32)
    n = tris.shape[0]
    ndc = np.empty((n, 3, 3), np.float32)
    ndc[..., 0] = tris[..., 0] / RW * 2 - 1
    ndc[..., 1] = tris[..., 1] / RH * 2 - 1
    ndc[..., 2] = zs
    V = n * 3
    eye = np.eye(4, dtype=np.float32)
    return (ndc.reshape(-1, 3), np.zeros((V, 3), np.float32), np.ones((V, 4), np.float32),
            np.zeros((V, 2), np.float32), np.arange(V, dtype=np.int32).reshape(n, 3),
            np.zeros(n, np.int32), np.ones(n, bool), eye[None], np.ones(1, bool),
            np.zeros(1, np.int32), np.ones((1, 4), np.float32), eye, RW, RH)


def _both_setups(tris, zs):
    args = _setup_args(tris, zs)
    # jitted, as the frame runs it: the port reproduces XLA's contractions
    want = jax.jit(jvertex.triangle_setup, static_argnums=(12, 13))(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    targs = [a for a in args]
    for i in (7, 8, 11):    # draw_model, draw_visible, viewproj live on the device
        targs[i] = torch.from_numpy(args[i])
    return vertex.triangle_setup(*targs), want


REFERENCE_CASES = {
    "single": ([[[10, 5], [100, 20], [40, 60]]], [[0.5, 0.5, 0.5]]),
    "random": (np.random.default_rng(7).uniform([-20, -20], [RW + 20, RH + 20],
                                                size=(12, 3, 2)),
               np.random.default_rng(8).uniform(0.05, 0.95, size=(12, 3))),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_triangle_setup_matches_jax(case):
    got, want = _both_setups(*REFERENCE_CASES[case])
    _same(got, want, ("packed", "aabb", "attrs", "valid"))


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_raster_matches_jax_copy_and_the_deferred_raster(case):
    """The numpy oracle equals the JAX package's copy, and the deferred
    raster (kernel 2.4's plain version) over full bins agrees with it: ids
    exact, z to rounding (tests/test_raster.py:62-82 mirrored)."""
    got, want = _both_setups(*REFERENCE_CASES[case])
    z_ref, tid_ref = raster.rasterize_reference(got.packed.numpy(), RW, RH)
    z_jax, tid_jax = jraster.rasterize_reference(want.packed, RW, RH)
    np.testing.assert_array_equal(tid_ref, tid_jax)
    np.testing.assert_array_equal(z_ref, z_jax)
    n = got.packed.shape[0]
    bins = torch.arange(n, dtype=torch.int32)[None, :].repeat(2, 1).contiguous()
    z, tid = raster.rasterize(got.packed, bins, torch.full((2,), n, dtype=torch.int32),
                              **RTILES)
    np.testing.assert_array_equal(tid.numpy(), tid_ref)
    np.testing.assert_allclose(z.numpy(), z_ref, atol=1e-5)
    assert int((tid >= 0).sum()) > 100

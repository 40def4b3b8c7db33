"""Parity of the port's sort, binning, raster passes and shading with the
JAX package, on identical inputs (numpy, fixed seed).

Tolerance (PERF.md): integer outputs (sort permutation, bins, counts, tid,
cnt) and the float raster outputs (z, attrs, metas, inv, acc) are exact.
The JAX side runs its Pallas kernels in interpret mode at the test tier's
CHUNK=8 (tests/conftest.py); the port is compared there at chunk=8 with the
very same bins, and at its own CHUNK=32/GROUP=8 with bins it builds itself
(the raster's result does not depend on the chunking).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_renderer.kernels import raster as jraster  # noqa: E402
from tpu_renderer.kernels import shade as jshade  # noqa: E402
from tpu_renderer.kernels import vertex as jvertex  # noqa: E402
from tpu_renderer_torch.kernels import raster, shade  # noqa: E402
from test_torch_threads import share_cores  # noqa: E402

share_cores()

W, H = 256, 64
TILES = dict(tiles_x=2, tiles_y=2, tile_w=128, tile_h=32)
T = 64   # triangles: a multiple of both packages' CHUNK
LIGHT = np.asarray([0.2, 0.8, 0.5, 1.0, 0.1, 0.15, 0.2, 0.0], np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _screen_tris(rng):
    """(T, 3, 3) NDC triangles: random ones, an equal-z duplicate pair (the
    later must win) and a quad split on its diagonal (every pixel on the
    shared edge covered exactly once)."""
    px = np.empty((T, 3, 2), np.float32)
    zs = np.empty((T, 3), np.float32)
    px[:] = rng.uniform([-30, -20], [W + 30, H + 20], size=(T, 3, 2))
    zs[:] = rng.uniform(0.05, 0.95, size=(T, 3))
    px[40] = px[41] = [[20, 4], [150, 30], [60, 60]]
    zs[40] = zs[41] = 0.97
    quad = np.asarray([[130, 6], [250, 6], [250, 58], [130, 58]], np.float32)
    px[50], px[51] = quad[[0, 1, 2]], quad[[0, 2, 3]]
    zs[50] = zs[51] = 0.99
    ndc = np.empty((T, 3, 3), np.float32)
    ndc[..., 0] = px[..., 0] / W * 2 - 1
    ndc[..., 1] = px[..., 1] / H * 2 - 1
    ndc[..., 2] = zs
    return ndc


@pytest.fixture(scope="module")
def ref():
    """JAX fat rows, sorted rows/bins and both raster passes' outputs."""
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
    valid_in = jnp.asarray(rng.uniform(size=T) > 0.1).at[40:52].set(True)
    rows, aabb, valid = jvertex.triangle_setup_rows(
        corners, jnp.zeros(T, jnp.int32), valid_in, eye[None],
        jnp.ones(1, bool), eye, W, H, sun_dir=jnp.asarray([0.3, 0.8, -0.5]))
    order = jraster.sort_order(aabb, valid)
    aabb_s, valid_s, rows_s = jraster.spatial_sort(aabb, valid, rows)
    caabb, cvalid = jraster.chunk_aabbs(aabb_s, valid_s)
    gaabb, gvalid = jraster.group_aabbs(aabb_s, valid_s)
    bins, counts = jraster.bin_triangles_full(caabb, cvalid, gaabb=gaabb,
                                              gvalid=gvalid, **TILES)
    fused = jraster.rasterize_fused_slabs(rows_s, bins, counts, **TILES)
    # opaque depth on the left tiles, none on the right: every layer there
    z_base = np.asarray(fused[0]).copy()
    z_base[:, 128:] = 0.0
    accum = jraster.rasterize_accum_slabs(rows_s, bins, counts,
                                          jnp.asarray(z_base),
                                          jnp.asarray(LIGHT), **TILES)
    n = lambda xs: tuple(np.asarray(x) for x in xs)  # noqa: E731
    return dict(aabb=np.asarray(aabb), valid=np.asarray(valid),
                order=np.asarray(order), aabb_s=np.asarray(aabb_s),
                valid_s=np.asarray(valid_s), rows_s=np.asarray(rows_s),
                caabb=np.asarray(caabb), gaabb=np.asarray(gaabb),
                bins=np.asarray(bins), counts=np.asarray(counts),
                fused=n(fused), z_base=z_base, accum=n(accum))


def test_sort_order_exact(ref):
    order = raster.sort_order(_t(ref["aabb"]), _t(ref["valid"]))
    np.testing.assert_array_equal(order.numpy(), ref["order"])


def test_sort_order_stable_on_ties():
    """Equal keys keep submission order; invalid boxes sort last."""
    aabb = torch.tensor([[9.0, 9, 20, 20]] * 5 + [[0.0, 0, 4, 4]])
    valid = torch.tensor([True, False, True, True, True, True])
    assert raster.sort_order(aabb, valid).tolist() == [5, 0, 2, 3, 4, 1]


def test_bins_and_counts_exact(ref):
    """At the JAX tier's chunk=8/group=8 the port bins exactly alike."""
    a, v = _t(ref["aabb_s"]), _t(ref["valid_s"])
    caabb, cvalid = raster.chunk_aabbs(a, v, chunk=8)
    gaabb, gvalid = raster.group_aabbs(a, v, group=8)
    np.testing.assert_array_equal(caabb.numpy(), ref["caabb"])
    np.testing.assert_array_equal(gaabb.numpy(), ref["gaabb"])
    bins, counts = raster.bin_triangles_full(caabb, cvalid, gaabb, gvalid, **TILES)
    np.testing.assert_array_equal(bins.numpy(), ref["bins"])
    np.testing.assert_array_equal(counts.numpy(), ref["counts"])


def _port_bins(ref, chunk, group):
    if chunk == 8:
        return _t(ref["bins"]), _t(ref["counts"])
    a, v = _t(ref["aabb_s"]), _t(ref["valid_s"])
    caabb, cvalid = raster.chunk_aabbs(a, v, chunk=chunk)
    gaabb, gvalid = raster.group_aabbs(a, v, group=group)
    return raster.bin_triangles_full(caabb, cvalid, gaabb, gvalid, **TILES)


@pytest.mark.parametrize("chunk,group", [(8, 8), (32, 8)])
def test_fused_raster_exact(ref, chunk, group):
    bins, counts = _port_bins(ref, chunk, group)
    if chunk == 32:   # four live groups per entry: the gmask skips matter
        assert (bins[bins >= 0] & 0xF).ne(0xF).any()
    out = raster.rasterize_fused(_t(ref["rows_s"]), bins, counts, chunk=chunk,
                                 group=group, **TILES)
    for name, got, want in zip(("z", "tid", "attrs", "metas", "inv"), out,
                               ref["fused"]):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_fused_raster_semantics(ref):
    """Equal z: the later of the duplicate pair wins; the diagonal of the
    split quad is covered once, with no holes."""
    tid = ref["fused"][1]
    pos = {int(old): new for new, old in enumerate(ref["order"])}
    dup = tid[(tid == pos[40]) | (tid == pos[41])]
    assert dup.size > 100 and (dup == pos[41]).all()
    ys, xs = np.mgrid[0:H, 0:W] + 0.5
    inner = (xs > 131) & (xs < 249) & (ys > 7) & (ys < 57)
    halves = (tid == pos[50]) | (tid == pos[51])
    assert halves[inner].all()


@pytest.mark.parametrize("chunk,group", [(8, 8), (32, 8)])
def test_accum_exact(ref, chunk, group):
    bins, counts = _port_bins(ref, chunk, group)
    acc, cnt = raster.rasterize_accum(
        _t(ref["rows_s"]), bins, counts, _t(ref["z_base"]), _t(LIGHT),
        chunk=chunk, group=group, **TILES)
    np.testing.assert_array_equal(cnt.numpy(), ref["accum"][1])
    np.testing.assert_array_equal(acc.numpy(), ref["accum"][0])
    assert cnt.max() >= 3   # overlapping fragments were summed


def test_wrappers_check_inputs(ref):
    rows = _t(ref["rows_s"])
    bins, counts = _t(ref["bins"]), _t(ref["counts"])
    with pytest.raises(TypeError):
        raster.rasterize_fused(rows.double(), bins, counts, chunk=8, group=8,
                               **TILES)
    with pytest.raises(ValueError):
        raster.rasterize_fused(rows, bins, counts[:-1], chunk=8, group=8,
                               **TILES)
    with pytest.raises(ValueError):
        raster.rasterize_accum(rows, bins, counts, torch.zeros(H, W + 1),
                               _t(LIGHT), chunk=8, group=8, **TILES)
    # the kernel launchers take CUDA tensors only: no CPU fallback there
    with pytest.raises(ValueError, match="CUDA"):
        raster.raster_fused_kernel(rows, bins, counts, **TILES)
    with pytest.raises(ValueError, match="CUDA"):
        raster.raster_accum_kernel(rows, bins, counts, torch.zeros(H, W),
                                   _t(LIGHT), **TILES)


@pytest.mark.parametrize("trilinear,pot", [(False, True), (True, False)])
def test_shade_fused_matches_jax(ref, trilinear, pot):
    """Plain shade on the JAX raster's outputs over a mip-mapped atlas."""
    from tpu_renderer.resources import build_atlas as jbuild_atlas
    from tpu_renderer_torch.resources import build_atlas
    from tpu_renderer_torch.utils.demo import checker_texture, noise_texture

    imgs = [checker_texture(64, 8), noise_texture(64, seed=1)]
    jatlas = jbuild_atlas(imgs)
    atlas = build_atlas(imgs, device="cpu")
    np.testing.assert_array_equal(atlas.quads.numpy().view(np.uint32),
                                  np.asarray(jatlas.quads))
    _, tid, attrs, metas, inv = ref["fused"]
    amb = np.asarray([0.1, 0.12, 0.14], np.float32)
    shade_jit = jax.jit(lambda a, m, i, q: jshade.shade_fused(
        a, m, i, jatlas._replace(quads=q), jnp.asarray(amb), None,
        jnp.float32(1.2), trilinear=trilinear, pot=pot))
    want = np.asarray(shade_jit(jnp.asarray(attrs), jnp.asarray(metas),
                                jnp.asarray(inv), jatlas.quads))
    got = shade.shade_fused(_t(attrs), _t(metas), _t(inv), atlas, _t(amb),
                            torch.tensor(1.2), trilinear=trilinear,
                            pot=pot).numpy()
    won = tid >= 0
    assert won.sum() > 1000
    # log2 (the mip LOD) may differ by an ulp between XLA and torch: it
    # moves the trilinear blend weight, or a pixel whose LOD lands on the
    # other side of a level boundary samples another level. The rest is
    # exact against the jitted JAX shade.
    same = np.all(got == want, axis=0) | ~won
    print(f"shade: {int((~same).sum())} of {int(won.sum())} pixels differ")
    assert same.mean() > 0.999 if trilinear else same.all(), (~same).sum()

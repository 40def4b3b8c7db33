"""Parity of the port's textured-transparency peel with the JAX package:
the plain twin of kernel 2.3 against rasterize_peel_slabs over several
peels (the `last` plane fed back), shading with and without a texture, and
a whole textured transparent stack through render_frame.

Tolerance (PERF.md): best, attrs, metas and inv are exact (integer planes,
and float planes from identical inputs); the shaded planes are exact; a
whole frame may differ in at most 0.1% of its pixels, and each frame test
prints the count. The JAX side runs its Pallas kernels in interpret mode at
the test tier's CHUNK=8 (tests/conftest.py); the port is compared there at
chunk=8 on the JAX bins, and at its own CHUNK=32/GROUP=8 on bins it builds
itself.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_renderer import milestones as jmilestones  # noqa: E402
from tpu_renderer import pipeline as jpipeline  # noqa: E402
from tpu_renderer import scene as jscene  # noqa: E402
from tpu_renderer.kernels import raster as jraster  # noqa: E402
from tpu_renderer.kernels import shade as jshade  # noqa: E402
from tpu_renderer.kernels import vertex as jvertex  # noqa: E402
from tpu_renderer.present import unpack_u8 as junpack  # noqa: E402
from tpu_renderer_torch import milestones, pipeline, scene  # noqa: E402
from tpu_renderer_torch.kernels import raster, shade  # noqa: E402
from tpu_renderer_torch.present import unpack_u8  # noqa: E402
from tpu_renderer_torch.utils.demo import checker_texture  # noqa: E402
from test_torch_threads import share_cores  # noqa: E402

share_cores()

W, H = 256, 64
TILES = dict(tiles_x=2, tiles_y=2, tile_w=128, tile_h=32)
T = 64
TOL = 0.001


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(scope="module")
def ref():
    """Unsorted fat rows of overlapping screen triangles, the JAX dense
    bins over them, an opaque depth plane, and three JAX peels."""
    rng = np.random.default_rng(7)
    px = rng.uniform([-20, -10], [W + 20, H + 10], size=(T, 3, 2)).astype(np.float32)
    # a stack of equal triangles over the middle: one layer each
    px[10:16] = [[30, 2], [200, 20], [90, 62]]
    ndc = np.empty((T, 3, 3), np.float32)
    ndc[..., 0] = px[..., 0] / W * 2 - 1
    ndc[..., 1] = px[..., 1] / H * 2 - 1
    ndc[..., 2] = rng.uniform(0.05, 0.95, size=(T, 3))
    V = T * 3
    corners = jvertex.expand_corners(
        ndc.reshape(-1, 3), rng.normal(size=(V, 3)).astype(np.float32),
        rng.uniform(size=(V, 4)).astype(np.float32),
        rng.uniform(size=(V, 2)).astype(np.float32),
        np.arange(V, dtype=np.int32).reshape(T, 3), np.zeros(T, np.int32),
        np.ones(T, bool), np.zeros(1, np.int32), np.ones((1, 4), np.float32),
        mat_meta=np.asarray([[0, 0, 64, 64, 7, 3, 0, 0]], np.float32))
    eye = jnp.eye(4, dtype=jnp.float32)
    valid_in = jnp.asarray(rng.uniform(size=T) > 0.1).at[10:16].set(True)
    rows, aabb, valid = jvertex.triangle_setup_rows(
        corners, jnp.zeros(T, jnp.int32), valid_in, eye[None],
        jnp.ones(1, bool), eye, W, H, sun_dir=jnp.asarray([0.3, 0.8, -0.5]))
    caabb, cvalid = jraster.chunk_aabbs(aabb, valid)
    gaabb, gvalid = jraster.group_aabbs(aabb, valid)
    bins, counts = jraster.bin_triangles_full(caabb, cvalid, gaabb=gaabb,
                                              gvalid=gvalid, **TILES)
    # opaque depth: nothing on the left half, z = 0.5 on the right
    z_base = np.zeros((H, W), np.float32)
    z_base[:, 128:] = 0.5
    last = jnp.full((H, W), -1, jnp.int32)
    peels = []
    for _ in range(3):
        out = jraster.rasterize_peel_slabs(rows, bins, counts,
                                           jnp.asarray(z_base), last, **TILES)
        peels.append(tuple(np.asarray(x) for x in out))
        last = jnp.where(out[0] < jraster.ID_INF, out[0], jraster.ID_INF)
    return dict(rows=np.asarray(rows), aabb=np.asarray(aabb),
                valid=np.asarray(valid), bins=np.asarray(bins),
                counts=np.asarray(counts), z_base=z_base, peels=peels)


@pytest.mark.parametrize("chunk,group", [(8, 8), (32, 8)])
def test_peel_twin_matches_jax_over_three_peels(ref, chunk, group):
    if chunk == 8:
        bins, counts = _t(ref["bins"]), _t(ref["counts"])
    else:   # the port's own bins, in submission order (no spatial sort)
        bins, counts = pipeline._bins(_t(ref["aabb"]), _t(ref["valid"]), TILES)
    rows, z_base = _t(ref["rows"]), _t(ref["z_base"])
    last = torch.full((H, W), -1, dtype=torch.int32)
    for n, want in enumerate(ref["peels"]):
        got = raster.rasterize_peel_fused(rows, bins, counts, z_base, last,
                                          chunk=chunk, group=group, **TILES)
        for name, g, w in zip(("best", "attrs", "metas", "inv"), got, want):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"peel {n} {name}")
        found = got[0] < raster.ID_INF
        assert found.any()
        last = torch.where(found, got[0], raster.ID_INF)
    # the stack over the middle peels in submission order, one id a layer
    mid = [p[0][32, 100] for p in ref["peels"]]
    assert mid == sorted(mid) and len(set(mid)) == 3


def test_peel_twin_semantics(ref):
    """The first peel is the smallest eligible id: on the left half (no
    opaque depth) the smallest id covering the pixel; ID_INF elsewhere."""
    best = ref["peels"][0][0]
    assert (best == raster.ID_INF).any() and (best < raster.ID_INF).any()
    assert (best[best < raster.ID_INF] < T).all()
    # no layer is found twice
    for a, b in zip(ref["peels"], ref["peels"][1:]):
        both = (a[0] < raster.ID_INF) & (b[0] < raster.ID_INF)
        assert (b[0][both] > a[0][both]).all()


@pytest.mark.parametrize("textured", [True, False])
def test_shade_fused_textured_flag_matches_jax(ref, textured):
    """shade_fused on a peel's outputs, with and without the texture."""
    from tpu_renderer.resources import build_atlas as jbuild_atlas
    from tpu_renderer_torch.resources import build_atlas

    imgs = [checker_texture(64, 8)]
    jatlas, atlas = jbuild_atlas(imgs), build_atlas(imgs, device="cpu")
    best, attrs, metas, inv = ref["peels"][0]
    amb = np.asarray([0.1, 0.12, 0.14], np.float32)
    shade_jit = jax.jit(lambda a, m, i, q: jshade.shade_fused(
        a, m, i, jatlas._replace(quads=q), jnp.asarray(amb), None,
        jnp.float32(1.2), textured=textured, trilinear=False, pot=True))
    want = np.asarray(shade_jit(jnp.asarray(attrs), jnp.asarray(metas),
                                jnp.asarray(inv), jatlas.quads))
    got = shade.shade_fused(_t(attrs), _t(metas), _t(inv), atlas, _t(amb),
                            torch.tensor(1.2), textured=textured,
                            trilinear=False, pot=True).numpy()
    found = best < raster.ID_INF
    assert found.sum() > 1000
    np.testing.assert_array_equal(got[:, found], want[:, found])


def _textured_stack(milestones_mod, scene_mod):
    """Six equal textured glass quads stacked at one depth (the JAX
    package's test_six_transparent_layers_unbounded_sum, with a texture)."""
    s = milestones_mod.textured_quad_scene(checker_texture(32, 4), mipmapped=True)
    s.materials[-1].transparent = True
    s.colors = np.tile(np.array([0.1, 0.05, 0.025, 1], np.float32), (4, 1))
    for k in range(5):
        node = scene_mod.MeshNode(0, f"layer{k}")
        node.refresh_transform(np.eye(4, dtype=np.float32))
        s.nodes.append(node)
        s.top_nodes.append(node)
    return s


def test_textured_transparent_stack_matches_jax():
    """Every layer blends, one peel each, through fp16 after each; the
    background's alpha is below 1, so the blend's dst * dstAlpha counts."""
    fw, fh = 128, 64
    vals = dict(view=np.eye(4, dtype=np.float32), proj=np.eye(4, dtype=np.float32),
                bg_effect=np.int32(0),
                bg_data1=np.asarray([0.1, 0.1, 0.1, 0.7], np.float32),
                bg_data2=np.asarray([0.1, 0.1, 0.1, 1.0], np.float32),
                ambient=np.zeros(4, np.float32),
                sun_dir=np.asarray([0, 0, 1, 1], np.float32),
                sun_color=np.ones(4, np.float32))
    jflat = jscene.flatten_scene(_textured_stack(jmilestones, jscene))
    jimg, jaux = jpipeline.render_frame(
        jflat.buffers, jpipeline.FrameParams(**{k: jnp.asarray(v) for k, v in vals.items()}),
        width=fw, height=fh)
    flat = scene.flatten_scene(_textured_stack(milestones, scene), device="cpu")
    img, aux = pipeline.render_frame(
        flat.buffers, pipeline.FrameParams(**{k: torch.as_tensor(v) for k, v in vals.items()}),
        width=fw, height=fh)
    got, want = unpack_u8(img), junpack(np.asarray(jimg))
    diff = np.any(got != want, axis=-1)
    print(f"textured stack {fw}x{fh}: {int(diff.sum())} of {diff.size} pixels differ")
    assert diff.mean() <= TOL
    assert int(aux["transparent_layers"]) == int(jaux["transparent_layers"]) == 6
    # six textured layers lit the quad's center above the background
    assert (got[fh // 2, fw // 2, :3] > got[2, 2, :3]).all()


def test_peel_wrappers_check_inputs(ref):
    rows, bins, counts = _t(ref["rows"]), _t(ref["bins"]), _t(ref["counts"])
    z_base = _t(ref["z_base"])
    last = torch.full((H, W), -1, dtype=torch.int32)
    with pytest.raises(TypeError):
        raster.rasterize_peel_fused(rows, bins, counts, z_base, last.float(),
                                    chunk=8, group=8, **TILES)
    with pytest.raises(ValueError):
        raster.rasterize_peel_fused(rows, bins, counts, z_base, last[:, 1:],
                                    chunk=8, group=8, **TILES)
    # the kernel launcher takes CUDA tensors only: no CPU fallback there
    with pytest.raises(ValueError, match="CUDA"):
        raster.raster_peel_fused_kernel(rows, bins, counts, z_base, last, **TILES)

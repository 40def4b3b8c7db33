"""Parity of the port's deferred raster path (fused=False) with the JAX
package: the 16-column setup and its fat rows, the capped bins (overflow
counts included), the plain twins of kernels 2.4 and 2.5, the deferred
shade and layer blend, whole frames, and the engine's dense-bin guard and
escalate-and-redraw loop.

Tolerance (PERF.md): everything below is exact (integer outputs, and float
outputs from identical inputs: the port reproduces the fused multiply-adds
XLA-CPU makes of the JAX functions' sums and einsums), except the whole
frames, where at most 0.1% of pixels may differ and each test prints the
count. The JAX side runs at the test tier's CHUNK=8 (tests/conftest.py);
the port's binning is compared there at chunk=8.
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
from tpu_renderer_torch.config import RendererConfig  # noqa: E402
from tpu_renderer_torch.engine import Engine  # noqa: E402
from tpu_renderer_torch.kernels import raster, shade, vertex  # noqa: E402
from tpu_renderer_torch.present import unpack_u8  # noqa: E402
from tpu_renderer_torch.utils.demo import build_demo_glb, checker_texture  # noqa: E402
from test_torch_threads import share_cores  # noqa: E402

share_cores()

W, H = 256, 64
TILES = dict(tiles_x=2, tiles_y=2, tile_w=128, tile_h=32)
T = 64
TOL = 0.001
J8 = 8   # the JAX package's CHUNK in the test tier


def _t(a):
    return torch.from_numpy(np.array(a))


def _geometry(seed, T=T, D=5, V=48):
    """Random indexed geometry: padding rows (draw -1), invalid and
    degenerate triangles, culled draws, behind-the-eye corners."""
    rng = np.random.default_rng(seed)
    model = np.tile(np.eye(4, dtype=np.float32), (D, 1, 1))
    model[:, :3, 3] = rng.normal(scale=2.0, size=(D, 3))
    model[:, :3, :3] += rng.normal(scale=0.2, size=(D, 3, 3))
    vp = np.eye(4, dtype=np.float32)
    vp[3, 2], vp[3, 3] = -1.0, 0.5
    vp[:3] += rng.normal(scale=0.1, size=(3, 4)).astype(np.float32)
    return dict(
        geo=(rng.normal(size=(V, 3)).astype(np.float32),
             rng.normal(size=(V, 3)).astype(np.float32),
             rng.uniform(size=(V, 4)).astype(np.float32),
             rng.uniform(-1, 2, size=(V, 2)).astype(np.float32),
             rng.integers(0, V, size=(T, 3)).astype(np.int32),
             rng.integers(-1, D, size=(T,)).astype(np.int32),
             rng.uniform(size=T) > 0.15,
             rng.integers(0, 3, size=(D,)).astype(np.int32),
             rng.uniform(size=(3, 4)).astype(np.float32)),
        mat_meta=rng.integers(0, 64, size=(3, 8)).astype(np.float32),
        model=model, vis=rng.uniform(size=D) > 0.2, vp=vp)


@pytest.mark.parametrize("seed,sun", [(0, (0.3, 0.8, -0.5)), (1, None)])
def test_triangle_setup_c_and_shade_rows_exact(seed, sun):
    d = _geometry(seed)
    jc = jvertex.expand_corners(*d["geo"], mat_meta=d["mat_meta"])
    tc = vertex.expand_corners(*d["geo"], d["mat_meta"], device="cpu")
    draw, valid = d["geo"][5], d["geo"][6]
    setup = jax.jit(jvertex.triangle_setup_c, static_argnums=(6, 7))
    js = setup(jc, jnp.asarray(draw), jnp.asarray(valid), jnp.asarray(d["model"]),
               jnp.asarray(d["vis"]), jnp.asarray(d["vp"]), W, H,
               sun_dir=None if sun is None else jnp.asarray(sun, jnp.float32))
    ts = vertex.triangle_setup_c(
        tc, _t(draw), _t(valid), _t(d["model"]), _t(d["vis"]), _t(d["vp"]), W, H,
        sun_dir=None if sun is None else torch.tensor(sun))
    for f in vertex.TriangleSetup._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    assert 0 < int(ts.valid.sum()) < T   # live and dead rows both occur
    rows_jit = jax.jit(lambda p, a, b, m: jshade.build_shade_rows(p, a, aabb=b, meta6=m))
    want = rows_jit(js.packed, js.attrs, js.aabb, jc.meta6)
    got = shade.build_shade_rows(ts.packed, ts.attrs, ts.aabb, tc.meta6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _screen_setup(seed):
    """Overlapping screen triangles (identity transforms) through both
    packages' triangle_setup_c; a duplicate pair at equal z."""
    rng = np.random.default_rng(seed)
    px = rng.uniform([-30, -20], [W + 30, H + 20], size=(T, 3, 2)).astype(np.float32)
    px[20:26] = [[20, 3], [230, 25], [70, 60]]   # a six-deep stack
    zs = rng.uniform(0.05, 0.95, size=(T, 3)).astype(np.float32)
    px[40] = px[41] = [[140, 4], [250, 30], [180, 60]]
    zs[40] = zs[41] = 0.97
    ndc = np.empty((T, 3, 3), np.float32)
    ndc[..., 0] = px[..., 0] / W * 2 - 1
    ndc[..., 1] = px[..., 1] / H * 2 - 1
    ndc[..., 2] = zs
    V = T * 3
    geo = (ndc.reshape(-1, 3), rng.normal(size=(V, 3)).astype(np.float32),
           rng.uniform(size=(V, 4)).astype(np.float32),
           rng.uniform(size=(V, 2)).astype(np.float32),
           np.arange(V, dtype=np.int32).reshape(T, 3), np.zeros(T, np.int32),
           rng.uniform(size=T) > 0.1, np.zeros(1, np.int32),
           np.ones((1, 4), np.float32))
    geo[6][20:26] = geo[6][40:42] = True
    meta = np.asarray([[0, 0, 64, 64, 7, 3, 0, 0]], np.float32)
    eye = np.eye(4, dtype=np.float32)
    jc = jvertex.expand_corners(*geo, mat_meta=meta)
    js = jvertex.triangle_setup_c(jc, jnp.asarray(geo[5]), jnp.asarray(geo[6]),
                                  jnp.asarray(eye[None]), jnp.ones(1, bool),
                                  jnp.asarray(eye), W, H,
                                  sun_dir=jnp.asarray([0.3, 0.8, -0.5]))
    return jc, js


@pytest.fixture(scope="module")
def ref():
    """The JAX deferred pipeline's pieces on one screen scene: bins at two
    capacities, the raster, three peels over an opaque depth, the shade
    and a layer blend."""
    jc, js = _screen_setup(5)
    caabb, cvalid = jraster.chunk_aabbs(js.aabb, js.valid)
    out = dict(packed=np.asarray(js.packed), aabb=np.asarray(js.aabb),
               valid=np.asarray(js.valid), caabb=np.asarray(caabb),
               cvalid=np.asarray(cvalid), bins={}, refined={}, expanded={})
    for cap in (64, 2):
        cb = jraster.bin_triangles(caabb, cvalid, bin_cap=cap, **TILES)
        out["bins"][cap] = tuple(np.asarray(x) for x in cb)
        out["expanded"][cap] = tuple(np.asarray(x) for x in
                                     jraster.expand_bins(cb[0], cb[1]))
        for tri_cap in (256, 12):
            out["refined"][cap, tri_cap] = tuple(
                np.asarray(x) for x in jraster.refine_bins(
                    cb[0], js.aabb, tri_cap=tri_cap, **TILES))
    bins, counts, _ = out["refined"][64, 256]
    z, tid = jraster.rasterize(js.packed, jnp.asarray(bins), jnp.asarray(counts), **TILES)
    out["raster"] = (np.asarray(z), np.asarray(tid))
    z_base = np.asarray(z).copy()
    z_base[:, :128] = 0.0        # no opaque depth on the left half
    out["z_base"] = z_base
    last = jnp.full((H, W), -1, jnp.int32)
    out["peels"] = []
    for _ in range(3):
        layer = jraster.rasterize_peel(js.packed, jnp.asarray(bins), jnp.asarray(counts),
                                       jnp.asarray(z_base), last, **TILES)
        out["peels"].append(np.asarray(layer))
        last = jnp.where(layer < jraster.ID_INF, layer, jraster.ID_INF)
    out["rows"] = np.asarray(jshade.build_shade_rows(js.packed, js.attrs, aabb=js.aabb,
                                                     meta6=jc.meta6))
    return out


@pytest.mark.parametrize("cap", [64, 2])
def test_bin_triangles_exact(ref, cap):
    bins, counts, overflow = raster.bin_triangles(
        _t(ref["caabb"]), _t(ref["cvalid"]), bin_cap=cap, **TILES)
    for name, got, want in zip(("bins", "counts", "overflow"),
                               (bins, counts, overflow), ref["bins"][cap]):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert (int(overflow) > 0) == (cap == 2)


@pytest.mark.parametrize("cap,tri_cap", [(64, 256), (64, 12), (2, 256)])
def test_refine_and_expand_bins_exact(ref, cap, tri_cap):
    cbins, ccounts, _ = (_t(a) for a in ref["bins"][cap])
    got = raster.refine_bins(cbins, _t(ref["aabb"]), tri_cap=tri_cap, chunk=J8, **TILES)
    for name, g, w in zip(("bins", "counts", "overflow"), got,
                          ref["refined"][cap, tri_cap]):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert (int(got[2]) > 0) == (tri_cap == 12)
    ex = raster.expand_bins(cbins, ccounts, chunk=J8)
    for g, w in zip(ex, ref["expanded"][cap]):
        np.testing.assert_array_equal(g.numpy(), w)


def test_rasterize_exact(ref):
    bins, counts, _ = (_t(a) for a in ref["refined"][64, 256])
    z, tid = raster.rasterize(_t(ref["packed"]), bins, counts, **TILES)
    np.testing.assert_array_equal(z.numpy(), ref["raster"][0])
    np.testing.assert_array_equal(tid.numpy(), ref["raster"][1])
    # equal z: the later of the duplicate pair wins
    dup = tid.numpy()[(tid.numpy() == 40) | (tid.numpy() == 41)]
    assert dup.size > 100 and (dup == 41).all()


def test_rasterize_peel_exact_over_three_peels(ref):
    bins, counts, _ = (_t(a) for a in ref["refined"][64, 256])
    last = torch.full((H, W), -1, dtype=torch.int32)
    for n, want in enumerate(ref["peels"]):
        layer = raster.rasterize_peel(_t(ref["packed"]), bins, counts,
                                      _t(ref["z_base"]), last, **TILES)
        np.testing.assert_array_equal(layer.numpy(), want, err_msg=f"peel {n}")
        found = layer < raster.ID_INF
        assert found.any()
        last = torch.where(found, layer, raster.ID_INF)
    # layers come in submission order, one id each
    mid = [int(p[32, 60]) for p in ref["peels"]]
    assert mid == sorted(mid) and len(set(mid)) == 3


@pytest.mark.parametrize("textured", [True, False])
def test_shade_and_blend_layer_match_jax(ref, textured):
    from tpu_renderer.resources import build_atlas as jbuild_atlas
    from tpu_renderer_torch.resources import build_atlas

    imgs = [checker_texture(64, 8)]
    jatlas, atlas = jbuild_atlas(imgs), build_atlas(imgs, device="cpu")
    amb = np.asarray([0.1, 0.12, 0.14], np.float32)
    rng = np.random.default_rng(2)
    fb = rng.uniform(0, 1, size=(4, H, W)).astype(np.float32)
    tid = ref["raster"][1]
    layer = np.where(ref["peels"][0] < raster.ID_INF, ref["peels"][0], -1)

    def jax_side(t, lay, q, rows, fb):
        a = jatlas._replace(quads=q)
        opaque = jshade.shade(t, rows, a, jnp.asarray(amb), None, jnp.float32(1.2),
                              fb, trilinear=False, pot=True)
        blend = jshade.blend_layer(fb, lay, rows, a, jnp.asarray(amb), None,
                                   jnp.float32(1.2), textured=textured,
                                   trilinear=False, pot=True)
        return opaque, blend

    want = jax.jit(jax_side)(jnp.asarray(tid), jnp.asarray(layer), jatlas.quads,
                             jnp.asarray(ref["rows"]), jnp.asarray(fb))
    look = dict(atlas=atlas, ambient_rgb=_t(amb), sun_power=torch.tensor(1.2),
                trilinear=False, pot=True)
    opaque = shade.shade(_t(tid), _t(ref["rows"]), background=_t(fb), **look)
    blend = shade.blend_layer(_t(fb), _t(layer), _t(ref["rows"]),
                              textured=textured, **look)
    assert (tid >= 0).sum() > 1000 and (layer >= 0).sum() > 1000
    np.testing.assert_array_equal(opaque.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(blend.numpy(), np.asarray(want[1]))


def _frame_scene(mod, kind):
    """tests/test_pipeline_golden.py:185-225: a textured quad (opaque), a
    transparent colored quad."""
    if kind == "opaque":
        tex = (np.indices((8, 8)).sum(0) % 2 * 200 + 30).astype(np.uint8)
        img = np.stack([tex, tex // 2, 255 - tex, np.full_like(tex, 255)], -1)
        s = mod.textured_quad_scene(img, nearest=False, mipmapped=True)
        s.colors = np.tile(np.array([1, 0.8, 0.6, 1], np.float32), (4, 1))
    else:
        s = mod.colored_quad_scene(z0=0.5, z1=0.5)
        s.materials[-1].transparent = True
        s.colors = np.tile(np.array([0.25, 0.5, 0.125, 1], np.float32), (4, 1))
    return s


@pytest.mark.parametrize("kind", ["opaque", "transparent"])
def test_deferred_frames_match_jax(kind):
    fw, fh = 128, 64
    vals = dict(view=np.eye(4, dtype=np.float32), proj=np.eye(4, dtype=np.float32),
                bg_effect=np.int32(0),
                bg_data1=np.asarray([0.5, 0.25, 0.5, 0.8], np.float32),
                bg_data2=np.asarray([0.3, 0.3, 0.3, 1.0], np.float32),
                ambient=np.asarray([0.1, 0.1, 0.1, 0.1], np.float32),
                sun_dir=np.asarray([0.2, 0.4, 0.9, 1], np.float32),
                sun_color=np.ones(4, np.float32))
    kw = dict(width=fw, height=fh, fused=False)
    jflat = jscene.flatten_scene(_frame_scene(jmilestones, kind))
    jimg, jaux = jpipeline.render_frame(
        jflat.buffers, jpipeline.FrameParams(**{k: jnp.asarray(v) for k, v in vals.items()}),
        bin_cap=128, **kw)
    flat = scene.flatten_scene(_frame_scene(milestones, kind), device="cpu")
    img, aux = pipeline.render_frame(
        flat.buffers, pipeline.FrameParams(**{k: torch.as_tensor(v) for k, v in vals.items()}),
        bin_cap=128, **kw)
    got, want = unpack_u8(img), junpack(np.asarray(jimg))
    diff = np.any(got != want, axis=-1)
    print(f"deferred {kind} {fw}x{fh}: {int(diff.sum())} of {diff.size} pixels differ")
    assert diff.mean() <= TOL
    assert {k: int(v) for k, v in aux.items()} == {k: int(v) for k, v in jaux.items()}
    # the quad is there, over the background
    assert np.any(got[fh // 2, fw // 2] != got[1, 1])


def test_deferred_dense_scene_escalates_and_redraws_same_frame():
    """fused=False keeps the capped deferred path: a dense scene overflows,
    the caps escalate, and the same frame (same camera params) redraws
    before draw() returns (tests/test_engine.py's test of the same name)."""
    s = milestones.colored_quad_scene(z0=0.5, z1=0.5)
    s.colors = np.tile(np.array([0, 1, 0, 1], np.float32), (4, 1))
    rng = np.random.default_rng(3)
    for k in range(700):
        node = scene.MeshNode(0, f"q{k}")
        m = np.eye(4, dtype=np.float32)
        m[0, 3] = rng.uniform(-0.01, 0.01)
        node.refresh_transform(m)
        node.local_transform = m
        s.nodes.append(node)
        s.top_nodes.append(node)
    cfg = RendererConfig(width=128, height=32, fused=False,
                         **milestones.UNLIT_CONFIG_OVERRIDES)
    eng = Engine(cfg, device="cpu")
    eng.init(scene=s)
    assert not eng._fused
    eng._caps = dict(bin_cap=64, tri_cap=128)   # force overflow
    params = eng.frame_params()._replace(view=torch.eye(4), proj=torch.eye(4))
    calls = []
    eng.update_scene = lambda **kw: calls.append(1) or params
    img = eng.draw()
    assert eng._caps["bin_cap"] > 64 or eng._caps["tri_cap"] > 128
    a = {k: int(v) for k, v in eng._last_aux.items()}
    assert a["bin_overflow"] == 0 and a["bin_overflow_tris"] == 0, a
    assert len(calls) == 1     # update_scene ran once: no double integration
    assert img[16, 64][1] > 150   # the green quad rendered


def test_dense_bin_guard_picks_deferred_path(tmp_path):
    """Past config.dense_bin_max_chunks the engine takes the capped
    deferred path (tests/test_engine.py::test_dense_bin_guard_picks_bounded_path),
    and its frame equals the fused path's."""
    assert 2_000_000 // raster.CHUNK > RendererConfig().dense_bin_max_chunks
    path = str(tmp_path / "scene.glb")
    build_demo_glb(path, grid=2)
    frames = {}
    for limit in (RendererConfig().dense_bin_max_chunks, 1):
        eng = Engine(RendererConfig(width=256, height=64, dense_bin_max_chunks=limit,
                                    camera_position=(0.0, 2.0, 12.0)), device="cpu")
        eng.init(scene_path=path)
        assert eng._fused == (limit > 1)
        frames[limit] = eng.draw()
        assert frames[limit].shape == (64, 256, 4) and frames[limit].dtype == np.uint8
    diff = np.any(frames[1] != frames[RendererConfig().dense_bin_max_chunks], axis=-1)
    print(f"deferred vs fused engine frame: {int(diff.sum())} of {diff.size} pixels differ")
    assert diff.mean() <= TOL


def test_deferred_wrappers_check_inputs(ref):
    packed = _t(ref["packed"])
    bins, counts, _ = (_t(a) for a in ref["refined"][64, 256])
    last = torch.full((H, W), -1, dtype=torch.int32)
    with pytest.raises(ValueError):   # fat rows are not packed rows
        raster.rasterize(torch.zeros(T, 48), bins, counts, **TILES)
    with pytest.raises(ValueError):
        raster.rasterize_peel(packed, bins, counts, torch.zeros(H, W + 1), last, **TILES)
    # the kernel launchers take CUDA tensors only: no CPU fallback there
    with pytest.raises(ValueError, match="CUDA"):
        raster.raster_deferred_kernel(packed, bins, counts, **TILES)
    with pytest.raises(ValueError, match="CUDA"):
        raster.raster_peel_kernel(packed, bins, counts, torch.zeros(H, W), last, **TILES)

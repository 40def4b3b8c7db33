"""The port's multi-device frame (tpu_renderer_torch/parallel/multichip.py)
against the JAX package's render_frame_multichip and the port's own
single-device frame, at 128x64 on gloo process groups of CPU ranks: one
spawn of ranks a world size (2, 4, 8), each rank building its meshes from
the same numpy scenes, plus the CLI's own spawn.

Tolerance, each as the JAX twin in tests/test_multichip.py asserts it:
- the band's boxes (_shift_aabb_y) are exact against the JAX function
  jitted with y0 traced, and the band's bins are the frame's bins of the
  band's tiles;
- the deferred frames at (2, 1), (1, 2) and (2, 4), the render-scale blit
  at (2, 1), the stacked textured peel and the trilinear frame at (2, 2)
  are byte for byte the JAX mesh frame and the port's single-device
  frame, with the aux counters equal;
- the deferred textured peel at (2, 2): within 1 u8 step of the
  single-device frame (test_multichip.py:100-123);
- the fused quad at (2, 2), the Engine at (2, 2) on build_demo_glb(grid=2)
  (deferred and fused) and the CLI at 2x1: byte for byte the
  single-device frame (test_multichip.py:30-49, :220-246); the fused
  transparent frames at (2, 2): within 1 u8 step (test_multichip.py:71-97).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_renderer import milestones as jmilestones  # noqa: E402
from tpu_renderer import pipeline as jpipeline  # noqa: E402
from tpu_renderer import resources as jresources  # noqa: E402
from tpu_renderer import scene as jscene  # noqa: E402
from tpu_renderer.kernels import vertex as jvertex  # noqa: E402
from tpu_renderer.parallel import multichip as jmc  # noqa: E402
from tpu_renderer_torch import cli, milestones, pipeline, resources, scene  # noqa: E402
from tpu_renderer_torch.config import RendererConfig  # noqa: E402
from tpu_renderer_torch.engine import Engine  # noqa: E402
from tpu_renderer_torch.kernels import vertex  # noqa: E402
from tpu_renderer_torch.parallel import multichip  # noqa: E402
from tpu_renderer_torch.present import load_png, unpack_u8  # noqa: E402
from tpu_renderer_torch.utils.demo import build_demo_glb  # noqa: E402
from test_torch_threads import share_cores  # noqa: E402

share_cores()

W, H = 128, 64
BG = dict(bg_data1=(0.2, 0.3, 0.4, 1.0), bg_data2=(0.8, 0.7, 0.6, 1.0))


# ---------------------------------------------------------------------------
# Scenes and params, built alike by both packages from the same numbers
# ---------------------------------------------------------------------------


def _quad(ms, sm, res):
    return ms.colored_quad_scene(z0=0.4, z1=0.7)


def _stacked(sm, scene, n=2):
    for k in range(n):
        node = sm.MeshNode(0, f"l{k}")
        node.refresh_transform(np.eye(4, dtype=np.float32))
        scene.nodes.append(node)
        scene.top_nodes.append(node)
    return scene


def _glass(ms, sm, res):
    """The textured transparent quad of test_multichip.py:100-123."""
    tex = np.full((4, 4, 4), 255, np.uint8)
    tex[..., 0] = 128
    scene = ms.textured_quad_scene(tex, nearest=True, mipmapped=False)
    scene.materials[-1].transparent = True
    return scene


def _stacked_glass(ms, sm, res):
    """3 stacked textured transparent layers (test_multichip.py:127-163)."""
    tex = np.full((4, 4, 4), 255, np.uint8)
    tex[..., 0] = 96
    tex[1::2, ::2, 1] = 40
    scene = ms.textured_quad_scene(tex, nearest=True, mipmapped=False)
    scene.materials[-1].transparent = True
    scene.materials[-1].color_factors = np.asarray([0.3, 0.21, 0.17, 1.0], np.float32)
    return _stacked(sm, scene)


def _stacked_tint(ms, sm, res):
    """3 stacked untextured transparent layers (test_multichip.py:71-97)."""
    scene = ms.colored_quad_scene(z0=0.5, z1=0.5)
    scene.materials[-1].transparent = True
    scene.colors = np.tile(np.array([0.1, 0.15, 0.05, 1], np.float32), (4, 1))
    return _stacked(sm, scene)


def _trilinear(ms, sm, res):
    """The two-tap trilinear sampler (test_multichip.py:166-195)."""
    tex = np.zeros((16, 16, 4), np.uint8)
    tex[::2, :, 0] = 255
    tex[:, ::2, 1] = 255
    tex[..., 3] = 255
    scene = ms.textured_quad_scene(tex, nearest=False, mipmapped=True)
    scene.materials[-1].filter_flags = (sm.DEFAULT_SAMPLER_LINEAR_FLAGS
                                        | res.FILTER_MIP_LINEAR)
    return scene


# scene -> (its function, flatten with mip chains?): the JAX tests flatten the
# two glass scenes with mipmapped=False
SCENES = {"quad": (_quad, True), "glass": (_glass, False),
          "stacked_glass": (_stacked_glass, False),
          "stacked_tint": (_stacked_tint, True), "trilinear": (_trilinear, True)}
# background colours by scene, as each JAX test sets them
PARAMS = {"glass": dict(bg_data1=(0.1, 0.1, 0.1, 1.0), bg_data2=(0.1, 0.1, 0.1, 1.0)),
          "stacked_glass": dict(bg_data1=(0.3, 0.3, 0.3, 1.0),
                                bg_data2=(0.3, 0.3, 0.3, 1.0)),
          "stacked_tint": dict(bg_data1=(0.2, 0.2, 0.2, 1.0),
                               bg_data2=(0.2, 0.2, 0.2, 1.0))}


def _param_values(name):
    bg = dict(BG, **PARAMS.get(name, {}))
    return dict(view=np.eye(4, dtype=np.float32), proj=np.eye(4, dtype=np.float32),
                bg_effect=np.int32(0),
                bg_data1=np.asarray(bg["bg_data1"], np.float32),
                bg_data2=np.asarray(bg["bg_data2"], np.float32),
                ambient=np.zeros(4, np.float32),
                sun_dir=np.asarray([0, 0, 1, 1], np.float32),
                sun_color=np.ones(4, np.float32))


def _port_scene(name):
    build, mipmapped = SCENES[name]
    flat = scene.flatten_scene(build(milestones, scene, resources), mipmapped=mipmapped,
                               device="cpu")
    params = pipeline.FrameParams(**{k: torch.as_tensor(v) for k, v in
                                     _param_values(name).items()})
    return flat.buffers, params


def _jax_scene(name):
    build, mipmapped = SCENES[name]
    flat = jscene.flatten_scene(build(jmilestones, jscene, jresources),
                                mipmapped=mipmapped)
    params = jpipeline.FrameParams(**{k: jnp.asarray(v) for k, v in
                                      _param_values(name).items()})
    return flat.buffers, params


def _aux(aux):
    return {k: int(v) for k, v in aux.items()}


# ---------------------------------------------------------------------------
# The rank bodies (run in the spawned ranks; module level, so they pickle)
# ---------------------------------------------------------------------------


def _frames(rank, cases):
    """Each case's mesh frame: (image, aux) by case name, from rank 0;
    an ("engine", ...) case renders build_demo_glb(grid=2) through
    Engine(multichip=...), a ("refuse", ...) case records what Engine.init
    says of a mesh this group cannot hold, a ("launch", ...) case what
    launch returns inside the group."""
    out = {}
    for name, kind, mesh_shape, kw in cases:
        if kind == "launch":
            out[name] = multichip.launch(_rank_and_world, mesh_shape[0] * mesh_shape[1],
                                         device="cpu")
        elif kind == "refuse":
            eng = Engine(RendererConfig(width=W, height=H, multichip=mesh_shape),
                         device="cpu")
            try:
                eng.init()
                out[name] = "no error"
            except RuntimeError as e:
                out[name] = str(e)
        elif kind == "engine":
            eng = Engine(RendererConfig(multichip=mesh_shape, **kw["config"]),
                         device="cpu")
            eng.init(scene_path=kw["scene_path"])
            img = eng.draw()
            out[name] = (img, eng.mesh.shape, eng.stats.triangle_count,
                         eng.stats.drawcall_count)
        else:
            mesh = multichip.make_mesh(*mesh_shape, device="cpu")
            buffers, params = _port_scene(kind)
            img, aux = multichip.render_frame_multichip(
                buffers, params, mesh=mesh, width=W, height=H, bin_cap=128, **kw)
            assert img.shape == (kw.get("out_height", H), kw.get("out_width", W))
            out[name] = (img.numpy(), _aux(aux))
    return out


def _rank_and_world(rank):
    import torch.distributed as dist

    return rank, dist.get_world_size()


# world size -> cases: (name, scene or kind, mesh, statics)
CASES = {
    2: [("deferred_2x1", "quad", (2, 1), dict(fused=False)),
        ("deferred_1x2", "quad", (1, 2), dict(fused=False)),
        ("blit_2x1", "quad", (2, 1), dict(fused=False, out_width=2 * W,
                                          out_height=2 * H)),
        ("refuse_2x2", "refuse", (2, 2), {}),
        ("launch_in_group", "launch", (2, 1), {}),
        *((f"glass_{path}_{r}x{t}", "stacked_glass", (r, t),
           dict(fused=path == "fused", transp_textured=True))
          for path in ("fused", "deferred") for r, t in ((2, 1), (1, 2)))],
    4: [("glass_deferred", "glass", (2, 2), dict(fused=False, transp_textured=True)),
        ("stacked_glass_deferred", "stacked_glass", (2, 2),
         dict(fused=False, transp_textured=True)),
        ("stacked_glass_fused", "stacked_glass", (2, 2), dict(transp_textured=True)),
        ("trilinear_deferred", "trilinear", (2, 2), dict(fused=False)),
        ("quad_fused", "quad", (2, 2), {}),
        ("stacked_tint_fused", "stacked_tint", (2, 2), dict(transp_textured=False))],
    8: [("deferred_2x4", "quad", (2, 4), dict(fused=False))],
}


@pytest.fixture(scope="module")
def demo_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("multichip") / "scene.glb")
    build_demo_glb(path, grid=2)
    return path


ENGINE_BASE = dict(width=W, height=H, camera_position=(0.0, 2.0, 12.0))


@pytest.fixture(scope="module")
def mesh_frames(demo_path):
    """Every case's mesh frame, one spawn a world size."""
    out = {}
    for n, cases in CASES.items():
        cases = list(cases)
        if n == 4:
            cases += [(f"engine_2x2_{'fused' if fused else 'deferred'}", "engine",
                       (2, 2), dict(config=dict(ENGINE_BASE, fused=fused),
                                    scene_path=demo_path))
                      for fused in (False, True)]
        out.update(multichip.launch(_frames, n, device="cpu", args=(cases,)))
    return out


def _single(name, **kw):
    buffers, params = _port_scene(name)
    img, aux = pipeline.render_frame(buffers, params, width=W, height=H,
                                     bin_cap=128, **kw)
    return img.numpy(), _aux(aux)


def _u8_diff(a, b):
    return int(np.abs(unpack_u8(a).astype(int) - unpack_u8(b).astype(int)).max())


# ---------------------------------------------------------------------------
# The band rebase, exact against JAX
# ---------------------------------------------------------------------------


def _setup_inputs(seed, T=512, D=6, V=48):
    rng = np.random.default_rng(seed)
    model = np.tile(np.eye(4, dtype=np.float32), (D, 1, 1))
    model[:, :3, 3] = rng.normal(scale=2.0, size=(D, 3))
    model[:, :3, :3] += rng.normal(scale=0.2, size=(D, 3, 3))
    vp = np.eye(4, dtype=np.float32)
    vp[3, 2], vp[3, 3] = -1.0, 0.5
    vp[:3] += rng.normal(scale=0.1, size=(3, 4)).astype(np.float32)
    geo = (rng.normal(size=(V, 3)).astype(np.float32),
           rng.normal(size=(V, 3)).astype(np.float32),
           rng.uniform(size=(V, 4)).astype(np.float32),
           rng.uniform(-1, 2, size=(V, 2)).astype(np.float32),
           rng.integers(0, V, size=(T, 3)).astype(np.int32),
           rng.integers(-1, D, size=(T,)).astype(np.int32),
           rng.uniform(size=T) > 0.15)
    mats = (rng.integers(0, 3, size=(D,)).astype(np.int32),
            rng.uniform(size=(3, 4)).astype(np.float32))
    meta = rng.integers(0, 64, size=(3, 8)).astype(np.float32)
    return geo, mats, meta, model, rng.uniform(size=D) > 0.2, vp


@pytest.mark.parametrize("y0", [32.0, 544.0])
def test_shift_aabb_y_exact(y0):
    """The band's boxes, moved up by y0, as the JAX package moves them."""
    geo, mats, meta, model, vis, vp = _setup_inputs(2)
    tc = vertex.expand_corners(*geo, *mats, meta, device="cpu")
    t = torch.from_numpy
    _, aabb, _ = vertex.triangle_setup_rows(tc, t(geo[5]), t(geo[6]), t(model),
                                            t(vis), t(vp), 160, 1088)
    want = jax.jit(jmc._shift_aabb_y)(jnp.asarray(aabb.numpy()), jnp.float32(y0))
    np.testing.assert_array_equal(multichip._shift_aabb_y(aabb, torch.tensor(y0)).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("row", [1, 2])
def test_band_bins_are_the_frame_bins_of_the_band(row):
    """A band's bins, from boxes moved up by y0 (whole tiles), equal the
    bins of the frame's tile rows of the band: the kernels, launched over
    the band's tiles from the frame's tile row (tile_y0), see the
    single-device frame's tiles."""
    geo, mats, meta, model, vis, vp = _setup_inputs(3)
    tc = vertex.expand_corners(*geo, *mats, meta, device="cpu")
    t = torch.from_numpy
    W_, H_, band_tiles_y = 256, 96, 1
    _, aabb, valid = vertex.triangle_setup_rows(tc, t(geo[5]), t(geo[6]), t(model),
                                                t(vis), t(vp), W_, H_)
    band = dict(tiles_x=2, tiles_y=band_tiles_y, tile_w=128, tile_h=32)
    frame = dict(band, tiles_y=(row + 1) * band_tiles_y)
    y0 = row * band_tiles_y * 32
    got = pipeline._bins(multichip._shift_aabb_y(aabb, float(y0)), valid, band)
    want_bins, want_counts = pipeline._bins(aabb, valid, frame)
    n_above = row * band_tiles_y * 2
    want_bins, want_counts = want_bins[n_above:], want_counts[n_above:]
    assert int(want_counts.sum()) > 0
    np.testing.assert_array_equal(got[1].numpy(), want_counts.numpy())
    np.testing.assert_array_equal(got[0].numpy(), want_bins.numpy())


# ---------------------------------------------------------------------------
# Mesh frames
# ---------------------------------------------------------------------------


def _jax_mesh_frame(name, mesh_shape, **kw):
    buffers, params = _jax_scene(name)
    img, aux = jmc.render_frame_multichip(buffers, params, mesh=jmc.make_mesh(*mesh_shape),
                                          width=W, height=H, bin_cap=128, **kw)
    return np.asarray(img).view(np.int32), _aux(aux)


@pytest.mark.parametrize("case,mesh_shape", [("deferred_2x1", (2, 1)),
                                              ("deferred_1x2", (1, 2)),
                                              ("deferred_2x4", (2, 4))])
def test_deferred_mesh_matches_jax_and_single_device(mesh_frames, case, mesh_shape):
    if len(jax.devices()) < mesh_shape[0] * mesh_shape[1]:
        pytest.skip("the JAX mesh needs the conftest's 8 virtual devices")
    img, aux = mesh_frames[case]
    jimg, jaux = _jax_mesh_frame("quad", mesh_shape, fused=False)
    single, saux = _single("quad", fused=False)
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(img, single)
    assert aux == jaux
    for k in saux:
        assert aux[k] == saux[k], k
    assert aux["opaque_triangles"] == 2


def test_render_scale_blit_after_the_gather(mesh_frames):
    img, aux = mesh_frames["blit_2x1"]
    jimg, _ = _jax_mesh_frame("quad", (2, 1), fused=False, out_width=2 * W,
                              out_height=2 * H)
    single, _ = _single("quad", fused=False, out_width=2 * W, out_height=2 * H)
    assert img.shape == (2 * H, 2 * W)
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(img, single)


@pytest.mark.parametrize("case,scene_name,kw,exact", [
    ("stacked_glass_deferred", "stacked_glass",
     dict(fused=False, transp_textured=True), True),
    ("trilinear_deferred", "trilinear", dict(fused=False), True),
    ("quad_fused", "quad", {}, True),
    ("stacked_glass_fused", "stacked_glass", dict(transp_textured=True), True),
    ("glass_deferred", "glass", dict(fused=False, transp_textured=True), False),
    ("stacked_tint_fused", "stacked_tint", dict(transp_textured=False), False),
])
def test_2x2_mesh_matches_single_device(mesh_frames, case, scene_name, kw, exact):
    img, aux = mesh_frames[case]
    single, saux = _single(scene_name, **kw)
    diff = _u8_diff(img, single)
    print(f"{case}: {int((img != single).sum())} of {img.size} pixels differ, "
          f"largest difference {diff}")
    if exact:
        np.testing.assert_array_equal(img, single)
    assert diff <= 1
    if "stacked" in scene_name:
        assert saux["transparent_layers"] == 3
    for k in saux:
        assert aux[k] == saux[k], k


@pytest.mark.parametrize("path", ["fused", "deferred"])
@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2), (2, 2)])
def test_mesh_peel_matches_single_device_and_jax(mesh_frames, path, mesh_shape):
    """The textured peel over a mesh (its loop on conditional.run_while,
    each band's launches over its own tiles): three stacked layers, byte
    for byte the single-device frame with the same transparent_layers, at
    every mesh shape; the deferred frames also within the JAX mesh frame's
    tolerance (1 u8 step, test_multichip.py:100-123) with its aux. The JAX
    package's fused peel takes ~70 s to compile in interpret mode, so the
    fused mesh frames stand on the single-device frame, which
    tests/test_torch_peel.py holds to JAX."""
    r, t = mesh_shape
    name = f"stacked_glass_{path}" if mesh_shape == (2, 2) else f"glass_{path}_{r}x{t}"
    kw = dict(fused=path == "fused", transp_textured=True)
    img, aux = mesh_frames[name]
    single, saux = _single("stacked_glass", **kw)
    np.testing.assert_array_equal(img, single)
    assert {k: aux[k] for k in saux} == saux and aux["transparent_layers"] == 3
    if path == "deferred":
        if len(jax.devices()) < r * t:
            pytest.skip("the JAX mesh needs the conftest's 8 virtual devices")
        jimg, jaux = _jax_mesh_frame("stacked_glass", mesh_shape, **kw)
        assert _u8_diff(img, jimg) <= 1
        assert aux == jaux


def _engine_frame(demo_path, fused):
    eng = Engine(RendererConfig(fused=fused, **ENGINE_BASE), device="cpu")
    eng.init(scene_path=demo_path)
    return eng.draw(), eng


def test_engine_mesh_matches_single_device_engine(mesh_frames, demo_path):
    """The deferred engine (the JAX twin's fast-tier case) byte for byte,
    with the composited counters in the stats."""
    img, shape, tris, draws = mesh_frames["engine_2x2_deferred"]
    single, eng = _engine_frame(demo_path, fused=False)
    assert shape == {"rows": 2, "tri": 2}
    np.testing.assert_array_equal(img, single)
    assert tris == eng.stats.triangle_count > 0
    assert draws == eng.stats.drawcall_count > 0


def test_engine_fused_mesh_matches_single_device_engine(mesh_frames, demo_path):
    """The fused engine byte for byte: its JAX twin, whose bands rebase the
    planes to band-local y, is off by a pixel (slow tier)."""
    img, shape, tris, draws = mesh_frames["engine_2x2_fused"]
    single, eng = _engine_frame(demo_path, fused=True)
    np.testing.assert_array_equal(img, single)
    assert (tris, draws) == (eng.stats.triangle_count, eng.stats.drawcall_count)


def test_engine_init_refuses_without_a_fitting_group(mesh_frames):
    eng = Engine(RendererConfig(width=W, height=H, multichip=(2, 1)), device="cpu")
    with pytest.raises(RuntimeError, match="launch or torchrun"):
        eng.init()
    said = mesh_frames["refuse_2x2"]
    assert "needs a process group of 4 ranks, this one has 2" in said


def test_launch_inside_a_group_runs_in_this_rank(mesh_frames):
    """As under torchrun: launch takes the group as it stands."""
    assert mesh_frames["launch_in_group"] == (0, 2)


def test_cli_multichip_writes_the_single_device_png(tmp_path):
    args = ["demo", "--grid", "2", "--width", "256", "--height", "64",
            "--device", "cpu"]
    one, mesh = str(tmp_path / "one.png"), str(tmp_path / "mesh.png")
    assert cli.main([*args, "--out", one]) == 0
    assert cli.main([*args, "--multichip", "2x1", "--out", mesh]) == 0
    np.testing.assert_array_equal(load_png(mesh), load_png(one))

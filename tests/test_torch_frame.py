"""Whole frames through the port against the JAX package: the 4x4 demo grid
(textured cubes, one untextured glass cube, so both raster passes run)
against JAX render_frame on the same buffers, and the port's own renders
against the golden PNGs the JAX package made.

Tolerance (PERF.md): at most 0.1% of pixels may differ; each test prints
the count and the largest difference. The port reproduces the jitted JAX
frame's rounding, so these frames measure 0 differing pixels; the bound
leaves room for an ulp of the mip LOD's log on another platform.
"""

import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_renderer import pipeline as jpipeline  # noqa: E402
from tpu_renderer import scene as jscene  # noqa: E402
from tpu_renderer_torch import convert, milestones, pipeline  # noqa: E402
from tpu_renderer_torch.config import RendererConfig  # noqa: E402
from tpu_renderer_torch.engine import Engine  # noqa: E402
from tpu_renderer_torch.present import load_png, unpack_u8  # noqa: E402
from tpu_renderer_torch.utils.demo import (  # noqa: E402
    build_demo_glb, build_structure_glb, checker_texture)
from test_torch_threads import share_cores  # noqa: E402

share_cores()

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
TOL = 0.001


def _check_frame(name, got, want):
    diff = np.any(got != want, axis=-1)
    worst = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
    print(f"{name}: {int(diff.sum())} of {diff.size} pixels differ, "
          f"largest difference {worst}")
    assert got.shape == want.shape
    assert diff.mean() <= TOL, (name, int(diff.sum()))


@pytest.fixture(scope="module")
def demo_frames(tmp_path_factory):
    """The 4x4 demo grid at 256x64: the JAX frame, the port frame on the
    converted JAX buffers, and the port Engine's own frame."""
    path = str(tmp_path_factory.mktemp("demo") / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0)
    cfg = RendererConfig(width=256, height=64, camera_position=(0.0, 6.0, 8.0))
    eng = Engine(cfg, device="cpu")
    eng.camera.pitch = np.float32(-0.18)
    eng.init(scene_path=path)
    params = eng.frame_params()
    statics = dict(width=256, height=64, transp_textured=False,
                   trilinear=eng._trilinear, pot=eng._pot)

    jflat = jscene.flatten_scene(jscene.load_scene(path))
    jparams = jpipeline.FrameParams(*(jnp.asarray(p.numpy()) for p in params))
    jimg, jaux = jpipeline.render_frame(jflat.buffers, jparams, **statics)

    tree = {k: (v._asdict() if hasattr(v, "_asdict") else v)
            for k, v in jflat.buffers._asdict().items()}
    tree = {k: ({kk: (vv if isinstance(vv, int) else np.asarray(vv))
                 for kk, vv in v.items()} if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}
    buffers = convert.scene_buffers_from_numpy(tree, device="cpu")
    fp = convert.frame_params_from_numpy(
        {k: p.numpy() for k, p in params._asdict().items()}, device="cpu")
    img, aux = pipeline.render_frame(buffers, fp, **statics)
    return dict(jax=unpack_u8(np.asarray(jimg).view(np.int32)), jaux=jaux,
                port=unpack_u8(img), aux=aux, engine=eng.draw(), eng=eng)


def test_demo_frame_matches_jax(demo_frames):
    _check_frame("demo4 256x64 (converted buffers)", demo_frames["port"],
                 demo_frames["jax"])
    # both passes ran: textured opaque cubes and the glass accumulation
    assert int(demo_frames["aux"]["transparent_layers"]) >= 1
    assert int(demo_frames["aux"]["visible_opaque_draws"]) == \
        int(demo_frames["jaux"]["visible_opaque_draws"])


def test_engine_frame_matches_jax(demo_frames):
    _check_frame("demo4 256x64 (Engine)", demo_frames["engine"], demo_frames["jax"])
    stats = demo_frames["eng"].stats
    assert stats.triangle_count > 150 and stats.drawcall_count > 10


def test_render_frames_loop(demo_frames):
    eng = demo_frames["eng"]
    ps = []
    for i in range(3):
        eng.camera.yaw = np.float32(0.002 * i)
        ps.append(eng.update_scene())
    kw = dict(width=256, height=64, transp_textured=False,
              trilinear=eng._trilinear, pot=eng._pot)
    last, sums = pipeline.render_frames(eng.flat.buffers, ps, **kw)
    one, _ = pipeline.render_frame(eng.flat.buffers, ps[-1], **kw)
    assert torch.equal(last, one) and sums.shape == (3,)
    assert int(sums[-1]) == int((one[::191, ::127] & 0xFF).sum())


def _milestone(scene, bg_effect=0, bg1=(1, 1, 1, 1)):
    """tests/test_pipeline_golden.render through the port (128x64, unlit)."""
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    p = pipeline.FrameParams(
        view=torch.eye(4), proj=torch.eye(4),
        bg_effect=torch.tensor(bg_effect, dtype=torch.int32),
        bg_data1=f(bg1), bg_data2=f((1, 1, 1, 1)), ambient=f((0, 0, 0, 0)),
        sun_dir=f((0, 0, 1, 1)), sun_color=f((1, 1, 1, 1)))
    from tpu_renderer_torch.scene import flatten_scene

    img, _ = pipeline.render_frame(flatten_scene(scene, device="cpu").buffers, p,
                                   width=128, height=64)
    return unpack_u8(img)


@pytest.mark.parametrize("name", ["triangle", "quad_sky", "textured"])
def test_milestone_goldens(name):
    scene, kw = {
        "triangle": (milestones.colored_triangle_scene(), {}),
        "quad_sky": (milestones.colored_quad_scene(),
                     dict(bg_effect=1, bg1=(0.1, 0.2, 0.4, 0.97))),
        "textured": (milestones.textured_quad_scene(checker_texture(32, 4)), {}),
    }[name]
    _check_frame(name, _milestone(scene, **kw),
                 load_png(os.path.join(GOLDEN_DIR, f"{name}.png")))


def test_structure_480p_golden(tmp_path):
    path = str(tmp_path / "structure.glb")
    build_structure_glb(path, seed=0)
    cfg = RendererConfig(width=480, height=270, background_effect=1,
                         camera_position=(0.0, 10.0, 42.0))
    eng = Engine(cfg, device="cpu")
    eng.camera.pitch = np.float32(-0.18)
    eng.init(scene_path=path)
    _check_frame("structure_480p", eng.draw(),
                 load_png(os.path.join(GOLDEN_DIR, "structure_480p.png")))


@pytest.mark.parametrize("field,value", [
    ("raster_nbuf", 2), ("raster_group", 4),
    ("tile_w", 48), ("raster_chunk", 8),
    ("raster_sort", "morton")])
def test_unported_config_raises(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Engine(RendererConfig(**{field: value}), device="cpu")


def test_unported_paths_raise():
    """The render scale, the HUD, the pipelined draw, target_fps
    (tests/test_torch_engine.py) and multichip (tests/test_torch_multichip.py)
    no longer raise."""
    eng = Engine(RendererConfig(width=128, height=64, render_scale=0.5), device="cpu")
    eng.init(scene=milestones.colored_triangle_scene())
    assert eng.draw(hud=True).shape == (64, 128, 4)
    assert eng.draw_pipelined() is None and eng.flush_pipelined().shape == (64, 128, 4)


def test_textured_transparent_scene_renders():
    """A textured transparent material takes the depth peel: the quad's
    texture shows through, blended over the background."""
    scene = milestones.textured_quad_scene(checker_texture(32, 4))
    for m in scene.materials:
        m.transparent = True
    eng = Engine(RendererConfig(width=128, height=64, background_effect=0,
                                gradient_data1=(0.1, 0.1, 0.1, 1.0),
                                gradient_data2=(0.1, 0.1, 0.1, 1.0),
                                **milestones.UNLIT_CONFIG_OVERRIDES), device="cpu")
    eng.init(scene=scene)
    assert eng._transp_textured()
    params = eng.frame_params()._replace(view=torch.eye(4), proj=torch.eye(4))
    eng.update_scene = lambda **kw: params
    img = eng.draw()
    assert int(eng._last_aux["transparent_layers"]) == 1
    quad = img[20:44, 40:88, :3].astype(np.int32)
    # the checker's two cells, added to the background, differ inside the quad
    assert quad.max() - quad.min() > 40
    assert (img[2, 2] != img[32, 64]).any()


def test_engine_defaults_to_the_card():
    """Engine, flatten_scene, build_atlas, expand_corners and the convert
    functions default to CUDA; without a card, init refuses to fall back."""
    import inspect

    from tpu_renderer_torch import resources, scene
    from tpu_renderer_torch.kernels import vertex

    assert Engine(RendererConfig()).device.type == "cuda"
    for fn in (Engine.__init__, scene.flatten_scene, resources.build_atlas,
               vertex.expand_corners, convert.scene_buffers_from_numpy,
               convert.frame_params_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=.cpu."):
            Engine(RendererConfig(width=128, height=64)).init(
                scene=milestones.colored_triangle_scene())

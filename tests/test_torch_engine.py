"""The rest of the port's Engine surface against the JAX package's: the
render scale with its linear blit, _extents, resize, cleanup, the
background-effect switch, the stats overlay, the pipelined draw and the
auto quality (target_fps); and the profiling helpers. Everything runs on the CPU (device="cpu").

Tolerance (PERF.md): the blit's weights are the JAX package's bit for bit,
but XLA contracts the resize as one einsum whose summation order and fused
multiply-adds the port does not reproduce, so a resampled value may differ
by an ulp and, where it sits on a rounding boundary, the u8 pixel by one
step. Whole frames through the blit: at most 0.1% of pixels differ, by at
most one u8 step; each test prints the count. Everything else is exact.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax._src.image import scale as jscale
from tpu_renderer import hud as jhud
from tpu_renderer import milestones as jmilestones
from tpu_renderer import present as jpresent
from tpu_renderer.config import RendererConfig as JConfig
from tpu_renderer.engine import Engine as JEngine
from tpu_renderer.utils import profiling as jprofiling
from tpu_renderer_torch import milestones, pipeline
from tpu_renderer_torch.config import RendererConfig
from tpu_renderer_torch.engine import Engine
from tpu_renderer_torch.present import unpack_u8
from tpu_renderer_torch.utils import profiling
from tpu_renderer_torch.utils.demo import build_demo_glb
from test_torch_threads import share_cores

share_cores()

TOL = 0.001
W, H = 256, 128


def _scaled_frames(scale, with_triangle):
    """The same NDC scene at render_scale `scale` through both packages'
    engines (sky background: stars are the blit's hardest input)."""
    kw = dict(width=W, height=H, render_scale=scale, background_effect=1)
    je = JEngine(JConfig(**kw, **jmilestones.UNLIT_CONFIG_OVERRIDES))
    je.init(scene=jmilestones.colored_triangle_scene() if with_triangle else None)
    jparams = je.frame_params()._replace(view=jnp.eye(4, dtype=jnp.float32),
                                         proj=jnp.eye(4, dtype=jnp.float32))
    jimg, _ = je.draw_device(jparams)
    eng = Engine(RendererConfig(**kw, **milestones.UNLIT_CONFIG_OVERRIDES), device="cpu")
    eng.init(scene=milestones.colored_triangle_scene() if with_triangle else None)
    params = eng.frame_params()._replace(view=torch.eye(4), proj=torch.eye(4))
    img, _ = eng.draw_device(params)
    assert eng._extents() == je._extents()
    return unpack_u8(img), jpresent.unpack_u8(np.asarray(jimg))


@pytest.mark.parametrize("scale,with_triangle", [
    (0.5, False), (0.65, False), (0.7, False), (2.0, False), (0.7, True), (2.0, True)])
def test_render_scale_frame_matches_jax(scale, with_triangle):
    got, want = _scaled_frames(scale, with_triangle)
    assert got.shape == want.shape == (H, W, 4)
    diff = np.any(got != want, axis=-1)
    worst = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
    print(f"render_scale {scale} ({'triangle' if with_triangle else 'sky only'}): "
          f"{int(diff.sum())} of {diff.size} pixels differ, largest difference {worst}")
    assert diff.mean() <= TOL and worst <= 1


@pytest.mark.parametrize("n_in,n_out", [(128, 256), (166, 256), (83, 128), (90, 128),
                                        (512, 256), (333, 512), (7, 3), (1, 5)])
def test_blit_weights_equal_jax(n_in, n_out):
    want = np.asarray(jscale.compute_weight_mat(
        n_in, n_out, n_out / n_in, 0.0, jscale._kernels[jscale.ResizeMethod.LINEAR], True))
    got = pipeline._triangle_weights(n_in, n_out)
    np.testing.assert_array_equal(got, want)
    # the taps hold every non-zero weight, in ascending source order
    idx, w = pipeline._blit_taps(n_in, n_out, torch.device("cpu"))
    dense = np.zeros_like(got)
    for k in range(idx.shape[0]):
        np.add.at(dense, (idx[k].numpy(), np.arange(n_out)), w[k].numpy())
    np.testing.assert_array_equal(dense, got)
    assert (np.diff(idx.numpy(), axis=0) >= 0).all()


def test_blit_grows_and_shrinks_like_jax_resize():
    """linear_blit on a random framebuffer, growing (2 taps a sample),
    shrinking (the antialiased, wider kernel) and both at once: against the
    exact contraction of the JAX weights (in float64) within two f32 ulp of
    1, and against jax.image.resize within 1e-5 (XLA-CPU's einsum itself
    sits up to 5e-6 from the exact value on the mixed case: measured)."""
    import jax

    rng = np.random.default_rng(3)
    fb = rng.uniform(0, 1, (4, 96, 256)).astype(np.float16).astype(np.float32)
    linear = jscale._kernels[jscale.ResizeMethod.LINEAR]
    for (w, h, ow, oh) in ((200, 90, 256, 115), (256, 96, 100, 37), (200, 90, 300, 60)):
        got = pipeline.linear_blit(torch.from_numpy(fb), width=w, height=h,
                                   out_width=ow, out_height=oh).numpy()
        wh, ww = (np.asarray(jscale.compute_weight_mat(a, b, b / a, 0.0, linear, True),
                             np.float64) for a, b in ((h, oh), (w, ow)))
        exact = np.einsum("chw,hH,wW->cHW", fb[:, :h, :w].astype(np.float64), wh, ww)
        assert got.shape == exact.shape
        np.testing.assert_allclose(got, exact, rtol=0, atol=2.4e-7)
        want = np.asarray(jax.image.resize(jnp.asarray(fb)[:, :h, :w], (4, oh, ow),
                                           method="linear"))
        print(f"blit {w}x{h} -> {ow}x{oh}: port within "
              f"{np.abs(got - exact).max():.3g} of the exact value, jax.image.resize "
              f"within {np.abs(want - exact).max():.3g}")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_extents_equal_jax_for_a_sweep():
    for (w, h) in ((1920, 1080), (1700, 900), (333, 222), (128, 64), (7, 5)):
        for s in (1.0, 0.5, 0.65, 0.7, 0.33, 0.05, 1.5, 2.0, 0.999):
            cfg = dict(width=w, height=h, render_scale=s)
            got = Engine(RendererConfig(**cfg), device="cpu")._extents()
            assert got == JEngine(JConfig(**cfg))._extents(), (w, h, s)
    assert Engine.FRAME_OVERLAP == JEngine.FRAME_OVERLAP == 3


def test_render_frames_passes_the_output_extent_through():
    eng = Engine(RendererConfig(width=256, height=64, render_scale=0.5,
                                background_effect=1), device="cpu")
    eng.init(scene=milestones.colored_triangle_scene())
    kw = dict(transp_textured=False, trilinear=eng._trilinear, pot=eng._pot,
              **eng._extents())
    ps = [eng.update_scene() for _ in range(2)]
    last, sums = pipeline.render_frames(eng.flat.buffers, ps, **kw)
    one, _ = eng.draw_device(ps[-1])
    assert last.shape == (64, 256) and sums.shape == (2,) and torch.equal(last, one)


def test_render_frame_wants_both_output_extents():
    eng = Engine(RendererConfig(width=128, height=64), device="cpu")
    eng.init()
    with pytest.raises(ValueError, match="together"):
        pipeline.render_frame(eng.flat.buffers, eng.frame_params(), width=128,
                              height=64, out_width=256)


@pytest.fixture(scope="module")
def demo_glb(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("engine") / "demo2.glb")
    build_demo_glb(path, grid=2)
    return path


def _engine(demo_glb, w=256, h=64, **cfg):
    eng = Engine(RendererConfig(width=w, height=h, camera_position=(0.0, 2.0, 12.0),
                                **cfg), device="cpu")
    eng.init(scene_path=demo_glb)
    return eng


def test_resize_renders_the_new_extent_and_drops_the_old(demo_glb):
    eng = _engine(demo_glb)
    first = eng.draw()
    assert eng.draw_pipelined() is None          # one frame in flight
    old_bg = eng._bg_fb
    assert old_bg.shape == (4, 64, 256)
    eng.resize(128, 32)
    assert eng._bg_fb is None and eng._bg_key is None and not eng._inflight
    assert eng._last_aux is None and not eng._slots
    img = eng.draw()
    assert img.shape == (32, 128, 4) and first.shape == (64, 256, 4)
    assert eng._bg_fb.shape == (4, 32, 128)
    # the same frame as an engine that started at the new extent
    np.testing.assert_array_equal(img, _engine(demo_glb, 128, 32).draw())


def test_cleanup_drops_scene_and_caches(demo_glb):
    eng = _engine(demo_glb)
    eng.draw()
    eng.draw_pipelined()
    eng.cleanup()
    assert eng.scene is None and eng.flat is None and eng._caps is None
    assert eng._bg_fb is None and not eng._inflight and eng.flush_pipelined() is None
    eng.init(scene_path=demo_glb)                # and it can start again
    assert eng.draw().shape == (64, 256, 4)


def test_background_effect_switch(demo_glb):
    eng = _engine(demo_glb)
    img_grad = eng.draw()
    key_grad = eng._bg_key
    assert eng.draw() is not None and eng._bg_key == key_grad   # cached
    eng.current_background_effect = 1  # sky (vk_engine.h:137 selector)
    img_sky = eng.draw()
    assert eng._bg_key == (1, 256, 64) != key_grad
    assert not np.array_equal(img_grad, img_sky)
    # sky top rows are dark; gradient default is white
    assert img_sky[0, 0, 2] < 100 and img_grad[0, 0, 2] == 255
    # the same frame as an engine configured with the sky
    np.testing.assert_array_equal(img_sky, _engine(demo_glb, background_effect=1).draw())


def test_background_cache_keys_on_the_render_extent(demo_glb):
    eng = _engine(demo_glb, render_scale=0.5)
    img = eng.draw()
    assert img.shape == (64, 256, 4)
    assert eng._bg_key == (0, 128, 32) and eng._bg_fb.shape == (4, 32, 128)


def test_empty_scene_background_only():
    eng = Engine(RendererConfig(width=128, height=32), device="cpu")
    eng.init()
    assert (eng.draw() == 255).all()  # solid white default gradient


def test_hud_overlay_equals_the_jax_overlay(demo_glb):
    eng = _engine(demo_glb)
    img_hud = eng.draw(hud=True)
    stats = dataclasses.replace(eng.stats)       # what the overlay printed
    img_plain = eng.draw()
    assert not np.array_equal(img_plain[:40, :150], img_hud[:40, :150])
    np.testing.assert_array_equal(img_hud, jhud.draw_stats(img_plain.copy(), stats))


def test_draw_pipelined_lags_draw_by_two(demo_glb):
    eng, twin = _engine(demo_glb), _engine(demo_glb)
    want, got = [], []
    for i in range(6):
        for e in (eng, twin):
            e.camera.yaw = np.float32(0.05 * i)
        want.append(twin.draw())
        got.append(eng.draw_pipelined(stats_interval=2))
    assert got[0] is None and got[1] is None
    for i in range(2, 6):
        np.testing.assert_array_equal(got[i], want[i - 2])
    assert len(eng._inflight) == Engine.FRAME_OVERLAP - 1
    assert eng.stats.triangle_count == twin.stats.triangle_count > 0
    np.testing.assert_array_equal(eng.flush_pipelined(), want[5])
    assert not eng._inflight and eng.flush_pipelined() is None
    assert not np.array_equal(want[0], want[5])


def test_draw_pipelined_present_cells_and_hud(demo_glb):
    eng = _engine(demo_glb)
    full = eng.draw()
    cols, rows = 40, 6
    frames = [eng.draw_pipelined(present_cells=(cols, rows)) for _ in range(3)]
    assert frames[0] is None and frames[1] is None
    assert frames[2].shape == (rows * 2, cols, 4) and frames[2].dtype == np.uint8
    # the index map of viewer.frame_to_halfblocks
    ys = (np.arange(rows * 2) * (64 / (rows * 2))).astype(int).clip(0, 63)
    xs = (np.arange(cols) * (256 / cols)).astype(int).clip(0, 255)
    np.testing.assert_array_equal(frames[2], full[np.ix_(ys, xs)])
    eng.flush_pipelined()
    hud = [eng.draw_pipelined(hud=True) for _ in range(3)][2]
    assert not np.array_equal(hud, full)
    np.testing.assert_array_equal(hud, jhud.draw_stats(full.copy(), eng.stats))


def test_profiling_helpers_equal_jax(tmp_path):
    eng = Engine(RendererConfig(width=128, height=32), device="cpu")
    eng.init()
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        eng.draw()
    assert prof is not None
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert os.path.getsize(tmp_path / "trace" / "key_averages.txt") > 0
    assert os.path.getsize(tmp_path / "trace" / "spans.json") > 0
    assert profiling.stats_text(eng.stats) == jprofiling.stats_text(eng.stats)
    assert "triangles" in profiling.stats_text(eng.stats)


# -- auto quality (config.target_fps) -----------------------------------------

COST = ("_COST_BASE_NS", "_COST_TAP_NS", "_COST_FIXED_MS", "_COST_BLIT_MS", "_COST_MARGIN")
AUTO_EXTENTS = [(1920, 1080), (1280, 720), (1700, 900), (640, 360), (256, 64), (3840, 2160)]


@pytest.mark.parametrize("taps", [0, 1, 2])
def test_auto_scale_matches_jax_under_its_constants(monkeypatch, taps):
    """The model's form is the JAX package's: with its five constants
    patched onto the port's Engine, both pick the same scale and the same
    extents over extents, targets, render scales and this tap count."""
    for name in COST:
        monkeypatch.setattr(Engine, name, getattr(JEngine, name))
    picks = set()
    for (w, h) in AUTO_EXTENTS:
        for target in (30.0, 60.0, 120.0, 10000.0):
            for render_scale in (1.0, 0.8, 0.55):
                kw = dict(width=w, height=h, target_fps=target, render_scale=render_scale)
                je, eng = JEngine(JConfig(**kw)), Engine(RendererConfig(**kw), device="cpu")
                for e in (je, eng):
                    e._scene_taps = lambda: taps
                    e._auto_scale = e._pick_auto_scale()
                assert eng._auto_scale == je._auto_scale, kw
                assert eng._predict_frame_ms(0.7) == je._predict_frame_ms(0.7), kw
                assert eng._extents() == je._extents(), kw
                picks.add(eng._auto_scale)
    # the grid reaches native, the floor and scales between (none between
    # without a per-pixel cost: the untextured model is its fixed term)
    assert {1.0, 0.5} <= picks and (taps == 0 or len(picks) > 2), picks


@pytest.mark.parametrize("trilinear", [False, True])
def test_scene_taps_match_jax(tmp_path, trilinear):
    path = str(tmp_path / "scene.glb")
    build_demo_glb(path, grid=2, trilinear=trilinear)
    kw = dict(width=256, height=64, target_fps=60.0, camera_position=(0.0, 2.0, 12.0))
    je = JEngine(JConfig(**kw))
    je.init(scene_path=path)
    eng = Engine(RendererConfig(**kw), device="cpu")
    eng.init(scene_path=path)
    assert eng._scene_taps() == je._scene_taps() == (2 if trilinear else 1)
    assert eng._trilinear == je._trilinear == trilinear


def _auto_engine(tmp_path, **cfg):
    path = str(tmp_path / "tri_scene.glb")
    if not os.path.exists(path):
        build_demo_glb(path, grid=2, trilinear=True)
    eng = Engine(RendererConfig(camera_position=(0.0, 2.0, 12.0), **cfg), device="cpu")
    eng.init(scene_path=path)
    return eng


@pytest.mark.parametrize("case", ["no target", "within bounds", "impossible target",
                                  "render_scale caps"])
def test_auto_quality_target_fps(tmp_path, case):
    """tests/test_engine.py's test_auto_quality_target_fps, the behaviours
    that hold whatever the constants are."""
    floor = RendererConfig().auto_scale_min
    if case == "no target":
        eng = _auto_engine(tmp_path, width=1920, height=1080)
        assert eng._auto_scale == 1.0
        assert eng._extents() == {"width": 1920, "height": 1080}
    elif case == "within bounds":
        # stock (trilinear-sampler) content at 1080p under a 60 fps target
        eng = _auto_engine(tmp_path, width=1920, height=1080, target_fps=60.0)
        assert eng._trilinear and eng._scene_taps() == 2
        assert floor <= eng._auto_scale <= 1.0
        ext = eng._extents()
        if eng._auto_scale < 1.0:
            assert ext["out_width"] == 1920 and ext["width"] < 1920
        # a target any frame meets keeps the native extent
        slow = _auto_engine(tmp_path, width=1920, height=1080, target_fps=0.01)
        assert slow._auto_scale == 1.0 and "out_width" not in slow._extents()
    elif case == "impossible target":
        eng = _auto_engine(tmp_path, width=256, height=64, target_fps=10000.0)
        assert eng._auto_scale == floor
        assert eng._extents() == dict(width=128, height=32, out_width=256, out_height=64)
        img = eng.draw()
        assert img.shape == (64, 256, 4) and img.dtype == np.uint8
        # a resize picks again, for the new extent
        eng.resize(512, 128)
        assert eng._auto_scale == floor and eng.draw().shape == (128, 512, 4)
    else:
        # never above the configured render_scale, and below it when the
        # model asks for less
        eng = _auto_engine(tmp_path, width=256, height=64, target_fps=0.01,
                           render_scale=0.75)
        assert eng._auto_scale == 1.0 and eng._extents()["width"] == 192
        eng = _auto_engine(tmp_path, width=256, height=64, target_fps=10000.0,
                           render_scale=0.75)
        assert eng._extents()["width"] == 128
        eng = _auto_engine(tmp_path, width=256, height=64, target_fps=10000.0,
                           render_scale=0.25)
        assert eng._extents()["width"] == 64


def test_shipped_cost_model_is_launch_bound():
    """The constants fitted on the card (the graphed frame, which the
    host's launch rate no longer bounds): no negative term, and a fixed term
    below a 60 fps budget, so that target picks, at every extent, the
    largest scale the model predicts under budget: since the fused path's
    shading and setup are one kernel each (2.12, 2.13), the native extent
    for two-tap content at 1080p and at 2160p, both predicted under budget,
    and at 1080p a 120 fps target too (4.06 ms predicted)."""
    assert min(getattr(Engine, name) for name in COST) >= 0.0
    budget = Engine._COST_MARGIN * 1000.0 / 60.0
    assert Engine._COST_FIXED_MS < budget
    eng = Engine(RendererConfig(width=1920, height=1080, target_fps=120.0), device="cpu")
    eng._scene_taps = lambda: 2
    assert eng._pick_auto_scale() == 1.0
    for w, h in AUTO_EXTENTS:
        eng = Engine(RendererConfig(width=w, height=h, target_fps=60.0), device="cpu")
        eng._scene_taps = lambda: 2
        s = eng._pick_auto_scale()
        floor = eng.config.auto_scale_min
        assert s == 1.0 or eng._predict_frame_ms(round(s + 0.05, 2)) > budget, (w, h, s)
        assert eng._predict_frame_ms(s) <= budget or s == floor, (w, h, s)
        if (w, h) == (1920, 1080):
            assert s == 1.0
        if (w, h) == (3840, 2160):
            assert s == 1.0

"""The raster tile (RendererConfig.tile_h, tile_w) on the CPU: the port's
frame at 8x128, 16x128 and 32x64 tiles against the JAX package's
pipeline.render_frame at the same tile, and against the port's own 32x128
frame byte for byte, on the fused path (kernels 2.1, 2.2), the textured
glass (2.1 and the peel, 2.3) and the deferred path (2.4, 2.5); the Engine
at each tile of the set the kernels are built for (raster.TILES) that is
not the default; a (2, 1) mesh of gloo ranks at 8x128 tiles. The tiles
outside the set still raise (tests/test_torch_frame.py). The card's side
(each kernel at each tile, graphed frames) is in tests/test_torch_cuda.py.

The scene is the demo grid 4 at 256x96, the JAX package running as its
own tests run it on the CPU (tests/conftest.py: Pallas interpret mode,
RASTER_CHUNK=8). Tolerance: PERF.md section 2, at most 0.1% of the pixels
against JAX (measured 0); the port's frames at two tiles byte for byte.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_renderer import pipeline as jpipeline  # noqa: E402
from tpu_renderer import scene as jscene  # noqa: E402
from tpu_renderer.present import unpack_u8 as junpack  # noqa: E402
from tpu_renderer_torch import scene  # noqa: E402
from tpu_renderer_torch.bench import frame_statics  # noqa: E402
from tpu_renderer_torch.config import RendererConfig  # noqa: E402
from tpu_renderer_torch.engine import Engine  # noqa: E402
from tpu_renderer_torch.kernels import raster  # noqa: E402
from tpu_renderer_torch.parallel import multichip  # noqa: E402
from tpu_renderer_torch.utils.bench_frame import texture_the_glass  # noqa: E402
from tpu_renderer_torch.utils.demo import build_demo_glb  # noqa: E402
from test_torch_threads import share_cores  # noqa: E402

share_cores()

W, H = 256, 96
TOL = 0.001
DEFAULT = (32, 128)
JAX_TILES = ((8, 128), (16, 128), (32, 64))
PATHS = ("fused", "textured-glass", "deferred")


@pytest.fixture(scope="module")
def demo_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiles") / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0)
    return path


def _config(tile, **kw):
    return RendererConfig(width=W, height=H, tile_h=tile[0], tile_w=tile[1],
                          camera_position=(0.0, 6.0, 8.0), **kw)


def _scene(load, path, kind):
    """The demo scene of a path (load: either package's load_scene): its
    glass textured for the peel."""
    s = load(path)
    return texture_the_glass(s) if kind == "textured-glass" else s


def _engine(path, kind, tile):
    """The port's engine of a path at a tile: the demo, its glass textured
    (the peel), or the deferred path (fused=False)."""
    eng = Engine(_config(tile, fused=kind != "deferred"), device="cpu")
    eng.camera.pitch = np.float32(-0.18)
    eng.init(scene=_scene(scene.load_scene, path, kind))
    return eng


_frames = {}


def _port_frame(path, kind, tile):
    """The port's Engine frame, drawn once a (path, tile)."""
    if (kind, tile) not in _frames:
        eng = _engine(path, kind, tile)
        assert (eng._fused, eng._transp_textured()) == (kind != "deferred",
                                                        kind == "textured-glass")
        _frames[kind, tile] = (eng.draw(), {k: int(v) for k, v in eng._last_aux.items()},
                               eng)
    return _frames[kind, tile]


def _jax_frame(path, kind, eng):
    """The JAX package's render_frame on the same scene, params and statics
    (the engine's tile, caps and path)."""
    jflat = jscene.flatten_scene(_scene(jscene.load_scene, path, kind))
    params = eng.frame_params()
    jparams = jpipeline.FrameParams(*(jnp.asarray(p.numpy()) for p in params))
    img, aux = jpipeline.render_frame(jflat.buffers, jparams, **frame_statics(eng))
    return junpack(np.asarray(img)), {k: int(v) for k, v in aux.items()}


def _differing(got, want):
    assert got.shape == want.shape == (H, W, 4)
    return int(np.any(got != want, axis=-1).sum())


@pytest.mark.parametrize("tile", JAX_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("kind", PATHS)
def test_frame_at_a_tile_matches_jax_and_the_default_tile(demo_path, kind, tile):
    """The port's frame at the tile: within TOL of JAX's at the same tile
    (0 measured), with the same aux counters, and byte for byte the port's
    32x128 frame."""
    img, aux, eng = _port_frame(demo_path, kind, tile)
    want, jaux = _jax_frame(demo_path, kind, eng)
    n = _differing(img, want)
    print(f"{kind} {tile[0]}x{tile[1]}: {n} of {H * W} pixels differ from JAX")
    assert n <= TOL * H * W
    shared = sorted(set(aux) & set(jaux))
    assert "transparent_layers" in shared and {k: aux[k] for k in shared} == \
        {k: jaux[k] for k in shared}
    if kind != "fused":
        assert aux["transparent_layers"] >= 1
    default, default_aux, _ = _port_frame(demo_path, kind, DEFAULT)
    np.testing.assert_array_equal(img, default)
    assert aux == default_aux


@pytest.mark.parametrize("tile", [t for t in raster.TILES if t != DEFAULT],
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_engine_takes_every_tile_of_the_set(demo_path, tile):
    """Engine(RendererConfig(tile_h, tile_w)) at each other tile of the set:
    the textured-glass frame (2.1 and the peel) byte for byte the 32x128
    one, its background and binning at that tile's padded extent."""
    img, aux, eng = _port_frame(demo_path, "textured-glass", tile)
    default, default_aux, _ = _port_frame(demo_path, "textured-glass", DEFAULT)
    np.testing.assert_array_equal(img, default)
    assert aux == default_aux
    hp, wp = eng._bg_fb.shape[1:]
    assert (hp % tile[0], wp % tile[1]) == (0, 0) and hp < H + tile[0] and wp < W + tile[1]


def _mesh_rank(rank, path, tile):
    eng = Engine(_config(tile, multichip=(2, 1)), device="cpu")
    eng.camera.pitch = np.float32(-0.18)
    eng.init(scene_path=path)
    return eng.draw(), eng.mesh.shape


def test_mesh_at_a_small_tile_matches_the_single_device_frame(demo_path):
    """A (2, 1) mesh of gloo ranks at 8x128 tiles: each band is whole 8-row
    tiles (multichip.band_extent), and the frame is byte for byte the
    single-device frame at that tile and at 32x128."""
    tile = (8, 128)
    assert multichip.band_extent(W, H, *tile, 2) == (256, 96, 48)
    img, shape = multichip.launch(_mesh_rank, 2, device="cpu", args=(demo_path, tile))
    assert shape == {"rows": 2, "tri": 1}
    np.testing.assert_array_equal(img, _port_frame(demo_path, "fused", tile)[0])
    np.testing.assert_array_equal(img, _port_frame(demo_path, "fused", DEFAULT)[0])

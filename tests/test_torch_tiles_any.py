"""Tiles past the shipped set (raster.TILES) on the CPU: every tile of whole
32x8 warp regions whose kernels fit an H100 block (raster.tile_rule).

The port's frame at 64x128 (the fused path and the textured glass) and at
8x256 (the fused path) against the JAX package's pipeline.render_frame at
the same tile; the port's frames at 8x32, 16x32, 128x128 and 32x256 byte
for byte its 32x128 frame on the fused, peel and deferred paths; the
Engine at a new tile; a (2, 1) mesh of gloo ranks at 64x128; the rule's
accepted and refused tiles. The card's side (each kernel at each new tile
against its plain version, graphed frames, a refused tile launching
nothing) is in tests/test_torch_cuda.py.

The scene is the demo grid 4 at 256x96, the JAX package running as its
own tests run it on the CPU (tests/conftest.py: Pallas interpret mode,
RASTER_CHUNK=8). Tolerance: PERF.md section 2, at most 0.1% of the pixels
against JAX (0 expected); the port's frames at two tiles byte for byte.
"""

import types

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
# (path, tile) held to the JAX package: three JAX frame compiles
JAX_CASES = (("fused", (64, 128)), ("textured-glass", (64, 128)), ("fused", (8, 256)))
NEW_TILES = ((8, 32), (16, 32), (128, 128), (32, 256))
PATHS = ("fused", "textured-glass", "deferred")


def _label(tile):
    return f"{tile[0]}x{tile[1]}"


@pytest.fixture(scope="module")
def demo_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiles_any") / "demo4.glb")
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


_frames = {}


def _port_frame(path, kind, tile):
    """The port's Engine frame of a path at a tile, drawn once: the demo,
    its glass textured (the peel), or the deferred path (fused=False)."""
    if (kind, tile) not in _frames:
        eng = Engine(_config(tile, fused=kind != "deferred"), device="cpu")
        eng.camera.pitch = np.float32(-0.18)
        eng.init(scene=_scene(scene.load_scene, path, kind))
        assert (eng._fused, eng._transp_textured()) == (kind != "deferred",
                                                        kind == "textured-glass")
        _frames[kind, tile] = (eng.draw(), {k: int(v) for k, v in eng._last_aux.items()},
                               eng)
    return _frames[kind, tile]


def _jax_frame(path, kind, eng):
    """The JAX package's render_frame on the same scene, params and statics
    (the engine's tile, caps and path)."""
    jflat = jscene.flatten_scene(_scene(jscene.load_scene, path, kind))
    jparams = jpipeline.FrameParams(*(jnp.asarray(p.numpy()) for p in eng.frame_params()))
    img, aux = jpipeline.render_frame(jflat.buffers, jparams, **frame_statics(eng))
    return junpack(np.asarray(img)), {k: int(v) for k, v in aux.items()}


@pytest.mark.parametrize("kind,tile", JAX_CASES,
                         ids=[f"{k}-{_label(t)}" for k, t in JAX_CASES])
def test_frame_at_a_new_tile_matches_jax(demo_path, kind, tile):
    """The port's frame at a tile outside the shipped set: within TOL of
    JAX's at the same tile (0 expected), with the same aux counters."""
    assert tile not in raster.TILES and raster.tile_rule(*tile) is None
    img, aux, eng = _port_frame(demo_path, kind, tile)
    want, jaux = _jax_frame(demo_path, kind, eng)
    assert img.shape == want.shape == (H, W, 4)
    n = int(np.any(img != want, axis=-1).sum())
    print(f"{kind} {_label(tile)}: {n} of {H * W} pixels differ from JAX")
    assert n <= TOL * H * W
    shared = sorted(set(aux) & set(jaux))
    assert "transparent_layers" in shared and {k: aux[k] for k in shared} == \
        {k: jaux[k] for k in shared}
    if kind != "fused":
        assert aux["transparent_layers"] >= 1


@pytest.mark.parametrize("tile", NEW_TILES, ids=_label)
@pytest.mark.parametrize("kind", PATHS)
def test_frame_at_a_new_tile_equals_the_default_tile(demo_path, kind, tile):
    """The port's frame at a new tile, a tile of one warp (8x32), of more
    regions than a block has warps (128x128, 32x256: walked in passes) or
    between: byte for byte its 32x128 frame, with the same aux."""
    img, aux, _ = _port_frame(demo_path, kind, tile)
    default, default_aux, _ = _port_frame(demo_path, kind, DEFAULT)
    np.testing.assert_array_equal(img, default)
    assert aux == default_aux


def test_engine_takes_a_new_tile(demo_path):
    """Engine(RendererConfig(tile_h=64, tile_w=128)): the background and the
    binning at that tile's padded extent, and the frame drawn again, and
    through draw_pipelined(), equal to the first."""
    tile = (64, 128)
    img, aux, eng = _port_frame(demo_path, "fused", tile)
    hp, wp = eng._bg_fb.shape[1:]
    assert (hp, wp) == (128, 256)
    assert eng.config.tile_h == 64 and eng.config.tile_w == 128
    np.testing.assert_array_equal(eng.draw(), img)
    assert eng.draw_pipelined() is None
    np.testing.assert_array_equal(eng.flush_pipelined(), img)


def _mesh_rank(rank, path, tile):
    eng = Engine(_config(tile, multichip=(2, 1)), device="cpu")
    eng.camera.pitch = np.float32(-0.18)
    eng.init(scene_path=path)
    return eng.draw(), eng.mesh.shape


def test_mesh_at_a_new_tile_matches_the_single_device_frame(demo_path):
    """A (2, 1) mesh of gloo ranks at 64x128 tiles: each band is one row of
    64-row tiles (multichip.band_extent), and the frame is byte for byte
    the single-device frame at that tile and at 32x128."""
    tile = (64, 128)
    assert multichip.band_extent(W, H, *tile, 2) == (256, 128, 64)
    img, shape = multichip.launch(_mesh_rank, 2, device="cpu", args=(demo_path, tile))
    assert shape == {"rows": 2, "tri": 1}
    np.testing.assert_array_equal(img, _port_frame(demo_path, "fused", tile)[0])
    np.testing.assert_array_equal(img, _port_frame(demo_path, "fused", DEFAULT)[0])


@pytest.mark.parametrize("tile", [(8, 32), (16, 32), (8, 64), (32, 128), (64, 128),
                                  (8, 256), (32, 256), (128, 128), (64, 256), (256, 64),
                                  (72, 128), (8, 544)], ids=_label)
def test_the_rule_takes_whole_regions_within_the_shared_memory(tile):
    """Every tile of whole 32x8 regions up to 16,384 pixels, and odd ones
    past 4,096 (72x128: 36 regions, passes of 12 warps; 8x544: 17, one warp
    a block): accepted, and blocks of at most 512 threads whose passes
    cover the tile's regions."""
    assert raster.tile_rule(*tile) is None
    raster.check_tile(*tile)
    warps, passes = raster.tile_blocks(*tile)
    assert 1 <= warps <= raster.MAX_WARPS
    assert warps * passes * 32 * 8 == tile[0] * tile[1]
    assert max(raster.tile_smem(*tile).values()) <= raster.SMEM_OPT_IN
    assert (passes == 1) == (tile[0] * tile[1] <= 4096)


def test_the_shipped_tiles_keep_their_blocks():
    """The six shipped tiles are one pass, a warp a region, in static shared
    memory within 48 KB: the blocks they always had."""
    for tile in raster.TILES:
        warps, passes = raster.tile_blocks(*tile)
        assert passes == 1 and warps == tile[0] * tile[1] // 256
        assert max(raster.tile_smem(*tile).values()) <= 48 * 1024


@pytest.mark.parametrize("tile,match", [
    ((12, 128), "whole 32x8 warp regions"), ((8, 48), "whole 32x8 warp regions"),
    ((0, 128), "whole 32x8 warp regions"), ((128, 256), "290,816 bytes"),
    ((256, 256), "past the 232,448")], ids=lambda v: _label(v) if isinstance(v, tuple) else "")
def test_the_rule_refuses_other_tiles(tile, match):
    """Off the regions, or past the shared memory a block can opt into:
    refused by the rule, by check_tile (ValueError: what the wrappers run
    on CUDA tensors before any build or launch) and by the Engine
    (NotImplementedError naming the ROADMAP item)."""
    assert match in raster.tile_rule(*tile)
    with pytest.raises(ValueError, match=match):
        raster.check_tile(*tile)
    with pytest.raises(NotImplementedError, match="Queue 1 item 17"):
        Engine(RendererConfig(tile_h=tile[0], tile_w=tile[1]), device="cpu")


def test_sweep_takes_tile_lists(capsys):
    """tools/sweep_tiles.py's --tile_hs / --tile_ws: the tile axes sweep the
    listed values from the shipped point; a refused tile stops the sweep
    before any frame, naming the rule."""
    from tpu_renderer_torch.tools import sweep_tiles

    pts = sweep_tiles.points(["tile_h", "tile_w"], {"tile_h": (8, 64), "tile_w": (32, 256)})
    assert [(p["tile_h"], p["tile_w"]) for p in pts] == [
        (32, 128), (8, 128), (64, 128), (32, 32), (32, 256)]
    assert sweep_tiles.main(["--device", "cpu", "--axes", "tile_h", "--tile_hs", "8,12"]) == 1
    assert "whole 32x8 warp regions" in capsys.readouterr().err


class _FakeTileLibrary:
    """A tile library's C entries as _build binds and sets them up: kernel
    2.k's raster_*_setup writes 1000 + k as its block's bytes and returns
    the error `errors` gives it (0 by default)."""

    def __init__(self, errors=None):
        self._errors = errors or {}
        self._entries = {}

    def __getattr__(self, name):
        from tpu_renderer_torch.kernels import _build

        entries = self.__dict__["_entries"]
        if name not in entries:
            kernel = next((k for k, fn in _build.SETUP.items() if fn == name), None)
            if kernel is not None:
                def entry(tile_h, tile_w, out, k=kernel):
                    out._obj.value = 1000 + int(k.split(".")[1])
                    return self._errors.get(k, 0)
            elif name == "raster_error_string":
                def entry(err):
                    return b"a CUDA error"
            else:
                entry = types.SimpleNamespace()   # a launcher: _bind_raster types it
            entries[name] = entry
        return entries[name]


def test_a_tile_whose_clusters_do_not_fit_is_refused_when_its_library_loads(tmp_path,
                                                                            monkeypatch):
    """Loading a tile's library runs every kernel's setup on the card
    before handing it out (_build.setup_tile): where no cluster of a
    kernel fits (cudaErrorInvalidConfiguration) it raises ValueError naming
    the kernel, another error RuntimeError, and neither library is kept;
    a library whose setups pass is kept, and block_smem reads each
    kernel's bytes from it."""
    from tpu_renderer_torch.kernels import _build

    monkeypatch.setattr(_build, "_tile_libs", {})
    monkeypatch.setattr(_build, "build_tile",
                        lambda tile_h, tile_w, verbose=False: (str(tmp_path / "t.so"), None))
    libs = [_FakeTileLibrary({"2.4": _build.NO_CLUSTER_FITS}), _FakeTileLibrary({"2.1": 2}),
            _FakeTileLibrary()]
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: libs.pop(0))
    with pytest.raises(ValueError, match="no cluster of kernel 2.4's blocks"):
        raster.tile_library(64, 128)
    assert _build._tile_libs == {}
    with pytest.raises(RuntimeError, match="raster_fused_setup failed: CUDA error 2"):
        _build.load_tile_library(64, 128)
    assert _build._tile_libs == {}
    lib = raster.tile_library(64, 128)
    assert _build._tile_libs == {(64, 128): lib} and not libs
    assert raster.block_smem(64, 128) == {f"2.{k}": 1000 + k for k in range(1, 9)}


def test_a_tile_library_is_keyed_by_tile_and_a_failed_build_raises(tmp_path, monkeypatch):
    """A tile outside the set gets a library of its own, named by the tile
    and the hash of the sources and flags (its -DTR_TILE_H/W among them),
    reused without nvcc once built; a failed build raises, and nothing
    stands in for the tile (tile_library raises too)."""
    from tpu_renderer_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_tile_libs", {})
    failing = tmp_path / "nvcc"
    failing.write_text("#!/bin/sh\necho 'nvcc: refused' >&2\nexit 3\n")
    failing.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(failing))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_tile(64, 128)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        raster.tile_library(64, 128)
    assert not list(tmp_path.glob("*.so")) and _build._tile_libs == {}

    def no_nvcc():
        raise AssertionError("nvcc must not run on a cache hit")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    names = set()
    for tile in ((64, 128), (128, 64), (8, 32)):
        flags = (*_build.NVCC_FLAGS, f"-DTR_TILE_H={tile[0]}", f"-DTR_TILE_W={tile[1]}")
        built = tmp_path / f"libraster_tile_{_label(tile)}_{_build._digest(flags=flags)}.so"
        built.write_bytes(b"")
        assert _build.build_tile(*tile) == (str(built), None)
        names.add(built.name)
    assert len(names) == 3 and _build._digest() not in "".join(names)

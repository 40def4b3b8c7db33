"""The mesh frame as one program (tpu_renderer_torch/parallel/multichip.py,
frame_graph.py, engine.py), on the CPU:

- kernels 2.1-2.5 launch over a band's tiles alone: each plain version at
  tile_y0 = k (the band's first tile row) over the band's bins and planes
  equals, bit for bit, its tile_y0 = 0 output over the whole frame sliced
  to the band, at 32x128 and at a tile of two passes (64x128); 2.1 and
  2.3 through their public wrappers too, whose planes are rebuilt at the
  band's pixel centers;
- the route a mesh frame takes is chosen before any capture: a graph over
  nccl, op by op over gloo (a FrameGraph refuses a gloo mesh), and the
  graph's key holds the mesh's shape and rank.

The mesh frames themselves (byte for byte the single-device frames and
within the JAX mesh frame's tolerance at (2, 1), (1, 2) and (2, 2), with
the peel's transparent_layers) are tests/test_torch_multichip.py's, which
renders them in one spawn of ranks a world size.
"""

import functools
import types

import numpy as np
import pytest
import torch

from tpu_renderer_torch import frame_graph, pipeline
from tpu_renderer_torch.config import RendererConfig
from tpu_renderer_torch.engine import Engine
from tpu_renderer_torch.kernels import raster, vertex
from tpu_renderer_torch.parallel import multichip
from test_torch_threads import share_cores

share_cores()

W, H, T = 256, 128, 64
LIGHT = torch.tensor([0.2, 0.8, 0.5, 1.0, 0.1, 0.15, 0.2, 0.0])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _scene():
    """T screen-space triangles over a W x H frame (NDC with identity
    matrices), set up for both paths: fat rows and boxes (fused), packed
    rows (deferred)."""
    rng = np.random.default_rng(15)
    px = rng.uniform([-30, -20], [W + 30, H + 20], size=(T, 3, 2)).astype(np.float32)
    ndc = np.empty((T, 3, 3), np.float32)
    ndc[..., 0] = px[..., 0] / W * 2 - 1
    ndc[..., 1] = px[..., 1] / H * 2 - 1
    ndc[..., 2] = rng.uniform(0.05, 0.95, size=(T, 3))
    V = T * 3
    corners = vertex.expand_corners(
        ndc.reshape(-1, 3), rng.normal(size=(V, 3)).astype(np.float32),
        rng.uniform(size=(V, 4)).astype(np.float32),
        rng.uniform(size=(V, 2)).astype(np.float32),
        np.arange(V, dtype=np.int32).reshape(T, 3), np.zeros(T, np.int32),
        np.ones(T, bool), np.zeros(1, np.int32), np.ones((1, 4), np.float32),
        mat_meta=np.asarray([[0, 0, 64, 64, 7, 3, 0, 0]], np.float32), device="cpu")
    eye = torch.eye(4)
    args = (corners, torch.zeros(T, dtype=torch.int32), _t(rng.uniform(size=T) > 0.1),
            eye[None], torch.ones(1, dtype=torch.bool), eye, W, H)
    sun = torch.tensor([0.3, 0.8, -0.5])
    rows, aabb, valid = vertex.triangle_setup_rows(*args, sun_dir=sun)
    setup = vertex.triangle_setup_c(*args, sun_dir=sun)
    return rows.contiguous(), aabb, valid, setup, rng


@functools.lru_cache(maxsize=None)
def _frame(tile_h, tile_w):
    """Every input of 2.1-2.5 over the whole frame at the tile."""
    rows, aabb, valid, setup, rng = _scene()
    tiles = dict(tiles_x=W // tile_w, tiles_y=H // tile_h, tile_w=tile_w, tile_h=tile_h)
    bins, counts = pipeline._bins(aabb, valid, tiles)
    caabb, cvalid = raster.chunk_aabbs(setup.aabb, setup.valid)
    cbins, _, _ = raster.bin_triangles(caabb, cvalid, bin_cap=64, **tiles)
    tbins, tcounts, _ = raster.refine_bins(cbins, setup.aabb, tri_cap=T, **tiles)
    z, _, _, _ = raster.rasterize_fused_plain(rows, bins, counts, **tiles)
    # opaque depth on the left half, none on the right: layers behind and
    # in front of it
    z_base = torch.where(torch.arange(W) < W // 2, z, torch.zeros(()))
    last = _t(rng.integers(-1, T // 2, size=(H, W)).astype(np.int32))
    return dict(tiles=tiles, rows=rows, bins=bins, counts=counts, packed=setup.packed,
                tbins=tbins, tcounts=tcounts, z_base=z_base.contiguous(), last=last)


def _call(kernel, f, band, public=False):
    """Kernel 2.1-2.5's plain version (or public wrapper) on the frame f,
    over `band` = (tile_y0, tile rows)."""
    k, n = band
    tx, th = f["tiles"]["tiles_x"], f["tiles"]["tile_h"]
    tiles = dict(f["tiles"], tiles_y=n, tile_y0=k)
    rows_of = slice(k * th, (k + n) * th)
    cut = lambda t: t[k * tx:(k + n) * tx].contiguous()  # noqa: E731
    plane = lambda t: t[rows_of].contiguous()  # noqa: E731
    if kernel == "2.1":
        fn = raster.rasterize_fused if public else raster.rasterize_fused_plain
        return fn(f["rows"], cut(f["bins"]), cut(f["counts"]), **tiles)
    if kernel == "2.2":
        return raster.rasterize_accum_plain(f["rows"], cut(f["bins"]), cut(f["counts"]),
                                            plane(f["z_base"]), LIGHT, **tiles)
    if kernel == "2.3":
        fn = raster.rasterize_peel_fused if public else raster.rasterize_peel_fused_plain
        return fn(f["rows"], cut(f["bins"]), cut(f["counts"]), plane(f["z_base"]),
                  plane(f["last"]), **tiles)
    if kernel == "2.4":
        return raster.rasterize_plain(f["packed"], cut(f["tbins"]), cut(f["tcounts"]),
                                      **tiles)
    return raster.rasterize_peel_plain(f["packed"], cut(f["tbins"]), cut(f["tcounts"]),
                                       plane(f["z_base"]), plane(f["last"]), **tiles)


# kernel -> does a public wrapper rebuild planes at the pixel centers?
KERNELS = {"2.1": True, "2.2": False, "2.3": True, "2.4": False, "2.5": False}


@pytest.mark.parametrize("tile", [(32, 128), (64, 128)], ids=["32x128", "64x128"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_band_launch_is_the_frame_sliced(kernel, tile):
    f = _frame(*tile)
    n_rows = f["tiles"]["tiles_y"]
    k = n_rows // 2   # the lower band
    whole = _call(kernel, f, (0, n_rows))
    whole = whole if isinstance(whole, tuple) else (whole,)
    r0 = k * tile[0]
    for public in (False, True) if KERNELS[kernel] else (False,):
        band = _call(kernel, f, (k, n_rows - k), public)
        band = band if isinstance(band, tuple) else (band,)
        if public:
            whole = _call(kernel, f, (0, n_rows), public)
        assert len(band) == len(whole)
        for i, (b, w) in enumerate(zip(band, whole)):
            np.testing.assert_array_equal(b.numpy(), w[..., r0:, :].numpy(),
                                          err_msg=f"{kernel} output {i} public={public}")
    # the band is not empty: some pixel below r0 holds a triangle or a layer
    first = whole[0][..., r0:, :]
    assert bool(((first > 0) & (first < raster.ID_INF)).any())


def test_band_launch_refuses_a_negative_row():
    f = _frame(32, 128)
    with pytest.raises(ValueError, match="tile_y0"):
        raster.rasterize_fused(f["rows"], f["bins"], f["counts"],
                               **dict(f["tiles"], tile_y0=-1))


def test_an_oracle_call_is_a_whole_frame_call():
    """The gathered oracles 2.6-2.8 cover the whole frame: a frame kernel's
    call recorded with tile_y0 = 0 becomes an oracle call without it, and
    a band's call has no oracle twin."""
    from tpu_renderer_torch.tools.time_stream_kernels import frame_tiles

    f = _frame(32, 128)
    assert frame_tiles(dict(f["tiles"], tile_y0=0)) == f["tiles"]
    with pytest.raises(ValueError, match="band"):
        frame_tiles(dict(f["tiles"], tile_y0=2))


def _stub_mesh(backend, shape=(2, 1), rank=1):
    return types.SimpleNamespace(backend=backend, n_rows=shape[0], n_tri=shape[1],
                                 rank=rank, device=torch.device("cpu"), timing=False)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_a_cpu_mesh_draws_op_by_op(backend):
    """On the CPU every mesh draws eagerly: render_frame_multichip on the
    rank's mesh, never a graph."""
    eng = Engine(RendererConfig(width=64, height=32), device="cpu")
    eng.mesh = _stub_mesh(backend)
    fn = eng.render_fn()
    assert fn.func is multichip.render_frame_multichip and fn.keywords["mesh"] is eng.mesh


def test_a_gloo_mesh_is_never_captured():
    """gloo's collectives run on the host: a FrameGraph refuses such a mesh
    before it draws or captures anything."""
    with pytest.raises(ValueError, match="nccl"):
        frame_graph.FrameGraph(None, None, None, {}, mesh=_stub_mesh("gloo"))


def test_graph_key_holds_the_mesh_shape_and_rank():
    buffers = types.SimpleNamespace(
        draw_model=torch.zeros(2, 4, 4),
        _replace=lambda **kw: (torch.zeros(1),))
    bg = torch.zeros(4, 8, 8)
    keys = {frame_graph.graph_key(buffers, bg, {"width": 8}, m)
            for m in (None, _stub_mesh("nccl", (2, 1), 0), _stub_mesh("nccl", (2, 1), 1),
                      _stub_mesh("nccl", (1, 2), 1))}
    assert len(keys) == 4
    assert frame_graph.graph_key(buffers, bg, {"width": 8}, _stub_mesh("nccl")) == \
        frame_graph.graph_key(buffers, bg, {"width": 8}, _stub_mesh("nccl"))


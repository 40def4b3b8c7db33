"""Card-only tests of the port: each CUDA raster kernel against its plain
PyTorch version, and an Engine frame on the card against the same frame
on the CPU. They skip without a CUDA device; run them on a machine with an
sm_90a card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

(--noconftest: tests/conftest.py sets up JAX, which a machine with the
card need not have; nothing here uses it.)
"""

import numpy as np
import pytest
import torch

from tpu_renderer_torch.kernels import raster, vertex

pytestmark = pytest.mark.cuda

W, H = 256, 64
TILES = dict(tiles_x=2, tiles_y=2, tile_w=128, tile_h=32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build for sm_90a)")
    return torch.device("cuda")


def _rows(device, T=96, seed=0):
    """Sorted fat rows + dense bins for random screen triangles."""
    rng = np.random.default_rng(seed)
    ndc = np.empty((T, 3, 3), np.float32)
    ndc[..., :2] = rng.uniform(-1.2, 1.2, size=(T, 3, 2))
    ndc[..., 2] = rng.uniform(0.05, 0.95, size=(T, 3))
    ndc[T - 2:] = ndc[T - 4:T - 2]     # equal-z duplicates: later wins
    V = T * 3
    corners = vertex.expand_corners(
        ndc.reshape(-1, 3), rng.normal(size=(V, 3)), rng.uniform(size=(V, 4)),
        rng.uniform(size=(V, 2)), np.arange(V).reshape(T, 3), np.zeros(T, np.int32),
        np.ones(T, bool), np.zeros(1, np.int32), np.ones((1, 4)),
        np.asarray([[0, 0, 64, 64, 7, 3, 0, 0]]), device=device)
    eye = torch.eye(4, device=device)
    rows, aabb, valid = vertex.triangle_setup_rows(
        corners, torch.zeros(T, dtype=torch.int32, device=device),
        torch.ones(T, dtype=torch.bool, device=device), eye[None],
        torch.ones(1, dtype=torch.bool, device=device), eye, W, H,
        sun_dir=torch.tensor([0.3, 0.8, -0.5], device=device))
    aabb, valid, rows = raster.spatial_sort(aabb, valid, rows)
    caabb, cvalid = raster.chunk_aabbs(aabb, valid)
    gaabb, gvalid = raster.group_aabbs(aabb, valid)
    bins, counts = raster.bin_triangles_full(caabb, cvalid, gaabb, gvalid, **TILES)
    return rows.contiguous(), bins, counts


def _same(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def test_fused_kernel_matches_plain(cuda):
    rows, bins, counts = _rows(cuda)
    before = raster.fused_counter.launches
    got = raster.raster_fused_kernel(rows, bins, counts, **TILES)
    want = raster.rasterize_fused_plain(rows, bins, counts, **TILES)
    torch.cuda.synchronize()
    assert raster.fused_counter.launches == before + 1
    assert all(_same(g, w) for g, w in zip(got, want))
    assert (got[1] >= 0).sum() > 1000


def test_accum_kernel_matches_plain(cuda):
    rows, bins, counts = _rows(cuda, seed=1)
    z = raster.raster_fused_kernel(rows, bins, counts, **TILES)[0]
    z[:, 128:] = 0.0
    light = torch.tensor([0.2, 0.8, 0.5, 1.0, 0.1, 0.15, 0.2, 0.0], device=cuda)
    before = raster.accum_counter.launches
    got = raster.raster_accum_kernel(rows, bins, counts, z, light, **TILES)
    want = raster.rasterize_accum_plain(rows, bins, counts, z, light, **TILES)
    torch.cuda.synchronize()
    assert raster.accum_counter.launches == before + 1
    assert all(_same(g, w) for g, w in zip(got, want))
    assert int(got[1].max()) >= 3


def test_kernels_skip_malformed_bin_entries(cuda):
    """Entries past the bin row, padding (-1) inside the count, and chunk
    ids past the rows are skipped, never read out of bounds."""
    rows, bins, counts = _rows(cuda, seed=2)
    n_chunks = rows.shape[0] // raster.CHUNK
    junk = ((n_chunks + 5) << raster.entry_shift(raster.CHUNK // raster.GROUP)) | 0xF
    bad_bins = torch.cat([bins, torch.full((bins.shape[0], 8), junk, dtype=torch.int32,
                                           device=cuda)], dim=1).contiguous()
    bad_counts = torch.full_like(counts, bad_bins.shape[1] + 100)
    light = torch.tensor([0.2, 0.8, 0.5, 1.0, 0.1, 0.15, 0.2, 0.0], device=cuda)
    z = torch.zeros((H, W), device=cuda)
    for launch, extra in ((raster.raster_fused_kernel, ()),
                          (raster.raster_accum_kernel, (z, light))):
        want = launch(rows, bins, counts, *extra, **TILES)
        got = launch(rows, bad_bins, bad_counts, *extra, **TILES)
        torch.cuda.synchronize()
        assert all(_same(g, w) for g, w in zip(got, want))


def test_wrapper_rejects_bad_tensors_on_card(cuda):
    rows, bins, counts = _rows(cuda)
    with pytest.raises(ValueError):
        raster.rasterize_fused(rows, bins, counts.cpu(), **TILES)
    with pytest.raises(ValueError):
        raster.rasterize_fused(rows, bins, counts, tiles_x=1, tiles_y=4,
                               tile_w=256, tile_h=16)
    # CHUNK and GROUP are compile-time constants of the kernels
    with pytest.raises(ValueError, match="chunk"):
        raster.rasterize_fused(rows, bins, counts, chunk=8, group=8, **TILES)


def test_engine_frame_on_card_equals_cpu(cuda, tmp_path):
    from tpu_renderer_torch.config import RendererConfig
    from tpu_renderer_torch.engine import Engine
    from tpu_renderer_torch.utils.demo import build_demo_glb

    path = str(tmp_path / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0)
    frames = []
    for dev in ("cpu", cuda):
        eng = Engine(RendererConfig(width=W, height=H,
                                    camera_position=(0.0, 6.0, 8.0)), device=dev)
        eng.camera.pitch = np.float32(-0.18)
        eng.init(scene_path=path)
        frames.append(eng.draw())
    np.testing.assert_array_equal(frames[1], frames[0])

"""Card-only tests of the port: each CUDA raster kernel (2.1-2.5) against
its plain PyTorch version, bit for bit, and Engine frames on the card (the
fused path, textured transparency, the deferred path) against the same
frames on the CPU. They skip without a CUDA device; run them on a machine with an
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


def _corners(device, T, seed):
    """Corner data of T random screen triangles (identity transforms), the
    last two an equal-z copy of the two before them (later wins)."""
    rng = np.random.default_rng(seed)
    ndc = np.empty((T, 3, 3), np.float32)
    ndc[..., :2] = rng.uniform(-1.2, 1.2, size=(T, 3, 2))
    ndc[..., 2] = rng.uniform(0.05, 0.95, size=(T, 3))
    ndc[T - 2:] = ndc[T - 4:T - 2]     # equal-z duplicates: later wins
    V = T * 3
    return vertex.expand_corners(
        ndc.reshape(-1, 3), rng.normal(size=(V, 3)), rng.uniform(size=(V, 4)),
        rng.uniform(size=(V, 2)), np.arange(V).reshape(T, 3), np.zeros(T, np.int32),
        np.ones(T, bool), np.zeros(1, np.int32), np.ones((1, 4)),
        np.asarray([[0, 0, 64, 64, 7, 3, 0, 0]]), device=device)


def _setup_args(device, T):
    eye = torch.eye(4, device=device)
    return (torch.zeros(T, dtype=torch.int32, device=device),
            torch.ones(T, dtype=torch.bool, device=device), eye[None],
            torch.ones(1, dtype=torch.bool, device=device), eye, W, H)


SUN = (0.3, 0.8, -0.5)


def _rows(device, T=96, seed=0, sort=True):
    """Fat rows + dense bins for random screen triangles, spatially sorted
    (the opaque pass) or in submission order (the peel)."""
    rows, aabb, valid = vertex.triangle_setup_rows(
        _corners(device, T, seed), *_setup_args(device, T),
        sun_dir=torch.tensor(SUN, device=device))
    if sort:
        aabb, valid, rows = raster.spatial_sort(aabb, valid, rows)
    caabb, cvalid = raster.chunk_aabbs(aabb, valid)
    gaabb, gvalid = raster.group_aabbs(aabb, valid)
    bins, counts = raster.bin_triangles_full(caabb, cvalid, gaabb, gvalid, **TILES)
    return rows.contiguous(), bins, counts


def _packed(device, T=96, seed=0, refine=True):
    """Packed setup rows + capped per-triangle bins (the deferred path)."""
    setup = vertex.triangle_setup_c(_corners(device, T, seed), *_setup_args(device, T),
                                    sun_dir=torch.tensor(SUN, device=device))
    caabb, cvalid = raster.chunk_aabbs(setup.aabb, setup.valid)
    cbins, ccounts, _ = raster.bin_triangles(caabb, cvalid, bin_cap=64, **TILES)
    if refine:
        bins, counts, _ = raster.refine_bins(cbins, setup.aabb, tri_cap=1024, **TILES)
    else:
        bins, counts = raster.expand_bins(cbins, ccounts)
    return setup.packed, bins, counts


def _opaque_depth(device, seed):
    """An opaque depth plane over the left half of the frame."""
    z = raster.raster_fused_kernel(*_rows(device, seed=seed + 10), **TILES)[0]
    z[:, 128:] = 0.0
    return z


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


def test_peel_fused_kernel_matches_plain(cuda):
    """Kernel 2.3 over three peels, `last` fed back."""
    rows, bins, counts = _rows(cuda, seed=3, sort=False)
    z = _opaque_depth(cuda, 3)
    last = torch.full((H, W), -1, dtype=torch.int32, device=cuda)
    before = raster.peel_fused_counter.launches
    for _ in range(3):
        got = raster.raster_peel_fused_kernel(rows, bins, counts, z, last, **TILES)
        want = raster.rasterize_peel_fused_plain(rows, bins, counts, z, last, **TILES)
        torch.cuda.synchronize()
        assert all(_same(g, w) for g, w in zip(got, want))
        found = got[0] < raster.ID_INF
        assert int(found.sum()) > 1000
        last = torch.where(found, got[0], raster.ID_INF)
    assert raster.peel_fused_counter.launches == before + 3


@pytest.mark.parametrize("refine", [True, False])
def test_deferred_kernel_matches_plain(cuda, refine):
    """Kernel 2.4 on refined and on expanded bins."""
    packed, bins, counts = _packed(cuda, seed=4, refine=refine)
    before = raster.deferred_counter.launches
    got = raster.raster_deferred_kernel(packed, bins, counts, **TILES)
    want = raster.rasterize_plain(packed, bins, counts, **TILES)
    torch.cuda.synchronize()
    assert raster.deferred_counter.launches == before + 1
    assert all(_same(g, w) for g, w in zip(got, want))
    assert int((got[1] >= 0).sum()) > 1000


def test_peel_deferred_kernel_matches_plain(cuda):
    """Kernel 2.5 over three peels, `last` fed back."""
    packed, bins, counts = _packed(cuda, seed=5, refine=False)
    z = _opaque_depth(cuda, 5)
    last = torch.full((H, W), -1, dtype=torch.int32, device=cuda)
    before = raster.peel_counter.launches
    for _ in range(3):
        got = raster.raster_peel_kernel(packed, bins, counts, z, last, **TILES)
        want = raster.rasterize_peel_plain(packed, bins, counts, z, last, **TILES)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        found = got < raster.ID_INF
        assert int(found.sum()) > 1000
        last = torch.where(found, got, raster.ID_INF)
    assert raster.peel_counter.launches == before + 3


def test_new_kernels_skip_malformed_bin_entries(cuda):
    """Kernels 2.3-2.5: entries past the bin row, padding inside the count,
    and ids past the table are skipped, never read out of bounds."""
    z = _opaque_depth(cuda, 6)
    last = torch.full((H, W), -1, dtype=torch.int32, device=cuda)
    rows, bins, counts = _rows(cuda, seed=6, sort=False)
    n_chunks = rows.shape[0] // raster.CHUNK
    junk = ((n_chunks + 5) << raster.entry_shift(raster.CHUNK // raster.GROUP)) | 0xF
    packed, tbins, tcounts = _packed(cuda, seed=6)

    def spoil(b, value):
        pad = torch.full((b.shape[0], 8), value, dtype=torch.int32, device=cuda)
        bad = torch.cat([b, pad], dim=1).contiguous()
        return bad, torch.full((b.shape[0],), bad.shape[1] + 100, dtype=torch.int32,
                               device=cuda)

    cases = ((raster.raster_peel_fused_kernel, rows, bins, counts, junk, (z, last)),
             (raster.raster_deferred_kernel, packed, tbins, tcounts,
              packed.shape[0] + 3, ()),
             (raster.raster_peel_kernel, packed, tbins, tcounts, -5, (z, last)))
    for launch, table, b, c, value, extra in cases:
        want = launch(table, b, c, *extra, **TILES)
        got = launch(table, *spoil(b, value), *extra, **TILES)
        torch.cuda.synchronize()
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert all(_same(g, w) for g, w in zip(got, want)), launch.__name__


def test_engine_peel_and_deferred_frames_on_card_equal_cpu(cuda, tmp_path):
    """The demo grid with textured glass: the peel loop (kernel 2.3) on the
    fused path, and the deferred path (kernels 2.4 and 2.5) past a tiny
    dense-bin guard; each frame on the card equals the CPU frame."""
    from tpu_renderer_torch.config import RendererConfig
    from tpu_renderer_torch.engine import Engine
    from tpu_renderer_torch.scene import load_scene
    from tpu_renderer_torch.utils.bench_frame import texture_the_glass
    from tpu_renderer_torch.utils.demo import build_demo_glb

    path = str(tmp_path / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0)
    for limit in (RendererConfig().dense_bin_max_chunks, 1):
        frames = []
        for dev in ("cpu", cuda):
            eng = Engine(RendererConfig(width=W, height=H, dense_bin_max_chunks=limit,
                                        camera_position=(0.0, 6.0, 8.0)), device=dev)
            eng.camera.pitch = np.float32(-0.18)
            eng.init(scene=texture_the_glass(load_scene(path)))
            assert eng._fused == (limit > 1)
            frames.append(eng.draw())
            assert int(eng._last_aux["transparent_layers"]) >= 1
        np.testing.assert_array_equal(frames[1], frames[0])

"""Card-only tests of the port: each CUDA kernel (the raster passes 2.1-2.5,
2.1-2.6 also on adversarial dense tiles that force their split, the peels
and 2.4 / 2.6 also on reversed bins,
the gathered oracles 2.6-2.8, the background passes 2.9-2.11) against its
plain PyTorch version, bit for bit, each stream kernel against its gathered
oracle, and Engine frames on the card (the fused path, textured transparency,
the deferred path, the render scale, the pipelined draw) against the same
frames on the CPU, kernels 2.1-2.5 over a band's tiles (tile_y0 > 0), and
the multi-device frame on the card (a (1, 1) mesh over nccl, graphed and
eager, a (2, 1) mesh over gloo with both ranks on the one card, and
gloo's collectives on CUDA tensors) against the single-device frame. They skip without a CUDA device; run them on a machine with an
sm_90a card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

(--noconftest: tests/conftest.py sets up JAX, which a machine with the
card need not have; nothing here uses it.)
"""

import numpy as np
import pytest
import torch

from tpu_renderer_torch.kernels import _build, background, raster, vertex
from test_torch_threads import share_cores

share_cores()

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
    with pytest.raises(ValueError, match="whole 32x8 warp regions"):
        raster.rasterize_fused(rows, bins, counts, tiles_x=1, tiles_y=4,
                               tile_w=48, tile_h=16)
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


# -- the gathered oracles (kernels 2.6, 2.7, 2.8) -----------------------------

LIGHT = (0.2, 0.8, 0.5, 1.0, 0.1, 0.15, 0.2, 0.0)


def _gathered(device, T=96, seed=0, sort=True):
    """Fat rows with their dense bins (the stream kernels' input) and both
    per-triangle bins over the same rows (the oracles')."""
    rows, aabb, valid = vertex.triangle_setup_rows(
        _corners(device, T, seed), *_setup_args(device, T),
        sun_dir=torch.tensor(SUN, device=device))
    if sort:
        aabb, valid, rows = raster.spatial_sort(aabb, valid, rows)
    rows = rows.contiguous()
    caabb, cvalid = raster.chunk_aabbs(aabb, valid)
    gaabb, gvalid = raster.group_aabbs(aabb, valid)
    dense = raster.bin_triangles_full(caabb, cvalid, gaabb, gvalid, **TILES)
    cbins, ccounts, _ = raster.bin_triangles(caabb, cvalid, bin_cap=64, **TILES)
    refined = raster.refine_bins(cbins, aabb, tri_cap=1024, **TILES)[:2]
    expanded = raster.expand_bins(cbins, ccounts)
    return rows, dense, refined, expanded


def test_fused_gathered_kernel_matches_plain_and_stream(cuda):
    """Kernel 2.6 against its plain version, and kernel 2.1 against 2.6 on
    the same rows; then on the same bins in descending order (the kernel
    walks the slots as given, a later slot winning an equal z)."""
    rows, dense, refined, _ = _gathered(cuda)
    before = raster.fused_gathered_counter.launches
    got = raster.raster_fused_gathered_kernel(rows, *refined, **TILES)
    want = raster.rasterize_fused_gathered_plain(rows, *refined, **TILES)
    stream = raster.raster_fused_kernel(rows, *dense, **TILES)
    torch.cuda.synchronize()
    assert raster.fused_gathered_counter.launches == before + 1
    assert all(_same(g, w) for g, w in zip(got, want))
    assert all(_same(g, s) for g, s in zip(got, stream))
    assert int((got[1] >= 0).sum()) > 1000
    bins, counts = refined
    live = torch.arange(bins.shape[1], device=cuda)[None, :] < counts[:, None]
    key = torch.where(live, -bins, torch.iinfo(torch.int32).max)
    down = torch.where(live, -key.sort(dim=1).values, -1).to(torch.int32).contiguous()
    got = raster.raster_fused_gathered_kernel(rows, down, counts, **TILES)
    want = raster.rasterize_fused_gathered_plain(rows, down, counts, **TILES)
    torch.cuda.synchronize()
    assert all(_same(g, w) for g, w in zip(got, want))


def test_accum_gathered_kernel_matches_plain_and_stream(cuda):
    """Kernel 2.7 against its plain version, and kernel 2.2 against 2.7."""
    rows, dense, _, expanded = _gathered(cuda, seed=1)
    z = raster.raster_fused_kernel(rows, *dense, **TILES)[0]
    z[:, 128:] = 0.0
    light = torch.tensor(LIGHT, device=cuda)
    before = raster.accum_gathered_counter.launches
    got = raster.raster_accum_gathered_kernel(rows, *expanded, z, light, **TILES)
    want = raster.rasterize_accum_gathered_plain(rows, *expanded, z, light, **TILES)
    stream = raster.raster_accum_kernel(rows, *dense, z, light, **TILES)
    torch.cuda.synchronize()
    assert raster.accum_gathered_counter.launches == before + 1
    assert all(_same(g, w) for g, w in zip(got, want))
    assert all(_same(g, s) for g, s in zip(got, stream))
    assert int(got[1].max()) >= 3


def test_peel_gathered_kernel_matches_plain_and_stream(cuda):
    """Kernel 2.8 against its plain version and kernel 2.3 against 2.8 over
    three peels, `last` fed back."""
    rows, dense, _, expanded = _gathered(cuda, seed=3, sort=False)
    z = _opaque_depth(cuda, 3)
    last = torch.full((H, W), -1, dtype=torch.int32, device=cuda)
    before = raster.peel_gathered_counter.launches
    for _ in range(3):
        got = raster.raster_peel_gathered_kernel(rows, *expanded, z, last, **TILES)
        want = raster.rasterize_peel_gathered_plain(rows, *expanded, z, last, **TILES)
        stream = raster.raster_peel_fused_kernel(rows, *dense, z, last, **TILES)
        torch.cuda.synchronize()
        assert all(_same(g, w) for g, w in zip(got, want))
        assert all(_same(g, s) for g, s in zip(got, stream))
        found = got[0] < raster.ID_INF
        assert int(found.sum()) > 1000
        last = torch.where(found, got[0], raster.ID_INF)
    assert raster.peel_gathered_counter.launches == before + 3


def test_gathered_kernels_skip_malformed_bin_entries(cuda):
    """Kernels 2.6-2.8: entries past the bin row, padding inside the count
    and ids past the table are dropped, never read out of bounds."""
    rows, dense, _, expanded = _gathered(cuda, seed=6, sort=False)
    bins, counts = expanded
    z = _opaque_depth(cuda, 6)
    last = torch.full((H, W), -1, dtype=torch.int32, device=cuda)
    light = torch.tensor(LIGHT, device=cuda)
    for launch, extra in ((raster.raster_fused_gathered_kernel, ()),
                          (raster.raster_accum_gathered_kernel, (z, light)),
                          (raster.raster_peel_gathered_kernel, (z, last))):
        # the clean input: live entries first, the row width as the count
        full = torch.full_like(counts, bins.shape[1])
        want = launch(rows, bins, full, *extra, **TILES)
        for value in (rows.shape[0] + 3, -5):
            pad = torch.full((bins.shape[0], 8), value, dtype=torch.int32, device=cuda)
            bad = torch.cat([bins, pad], dim=1).contiguous()
            got = launch(rows, bad, torch.full_like(counts, bad.shape[1] + 100), *extra,
                         **TILES)
            torch.cuda.synchronize()
            assert all(_same(g, w) for g, w in zip(got, want)), (launch.__name__, value)


def test_chunk_bin_wrappers_on_card(cuda):
    """rasterize_fused_chunks / rasterize_accum_chunks launch kernels 2.1 /
    2.2 and equal the dense-bin calls."""
    rows, dense, _, _ = _gathered(cuda, seed=7)
    aabb = rows[:, 44:48].contiguous()
    valid = aabb[:, 2] >= aabb[:, 0]
    caabb, cvalid = raster.chunk_aabbs(aabb, valid)
    cbins, ccounts, _ = raster.bin_triangles(caabb, cvalid, bin_cap=64, **TILES)
    before = (raster.fused_counter.launches, raster.accum_counter.launches)
    a = raster.rasterize_fused_chunks(rows, cbins, ccounts, **TILES)
    b = raster.rasterize_fused(rows, *dense, **TILES)
    light = torch.tensor(LIGHT, device=cuda)
    z = torch.zeros((H, W), device=cuda)
    c = raster.rasterize_accum_chunks(rows, cbins, ccounts, z, light, **TILES)
    d = raster.rasterize_accum(rows, *dense, z, light, **TILES)
    torch.cuda.synchronize()
    assert (raster.fused_counter.launches, raster.accum_counter.launches) == \
        (before[0] + 2, before[1] + 2)
    assert all(_same(x, y) for x, y in zip(a + c, b + d))


# -- kernels 2.1 and 2.2 spread over the card: the dense-tile hazards ---------


def _hazards(device, n_chunks, tiles, seed):
    """utils/hazards.py's adversarial rows over the tiles, their dense
    bins, and the opaque depth for 2.2."""
    from tpu_renderer_torch.utils import hazards

    w, h = tiles["tiles_x"] * tiles["tile_w"], tiles["tiles_y"] * tiles["tile_h"]
    rows = hazards.hazard_rows(n_chunks, w, h, seed=seed)
    box, valid = (torch.from_numpy(a).to(device) for a in hazards.hazard_boxes(rows))
    caabb, cvalid = raster.chunk_aabbs(box, valid)
    gaabb, gvalid = raster.group_aabbs(box, valid)
    bins, counts = raster.bin_triangles_full(caabb, cvalid, gaabb, gvalid, **tiles)
    z_base = torch.from_numpy(hazards.hazard_z_base(w, h)).to(device)
    return torch.from_numpy(rows).to(device), bins, counts, z_base


@pytest.mark.parametrize("n_chunks,tx,ty", [(1000, 1, 1), (40, 2, 2)])
def test_split_kernels_exact_on_dense_hazard_tiles(cuda, n_chunks, tx, ty):
    """One tile of 1,000 entries (2.1 cuts it into 8 segments of 125, each
    boundary straddled by an equal-z copy of the tie triangle), and 2x2
    tiles: 2.1 and 2.2 bit-exact against their plain versions, with the
    hazards reached (-0.0 and +0.0 zero-depth winners, the tie won by its
    latest copy, fragments summed)."""
    tiles = dict(tiles_x=tx, tiles_y=ty, tile_w=128, tile_h=32)
    rows, bins, counts, z_base = _hazards(cuda, n_chunks, tiles, seed=n_chunks)
    if tx * ty == 1:
        assert int(counts[0]) == n_chunks
        assert int(raster.fused_segments(counts, bins.shape[1])[0]) == raster.FUSED_SPLIT
    got = raster.raster_fused_kernel(rows, bins, counts, **tiles)
    want = raster.rasterize_fused_plain(rows, bins, counts, **tiles)
    torch.cuda.synchronize()
    assert all(_same(g, w) for g, w in zip(got, want))
    z, tid = got[:2]
    zero = (z == 0) & (tid >= 0)
    assert (zero & torch.signbit(z)).any() and (zero & ~torch.signbit(z)).any()
    tie = (tid % raster.CHUNK) == 7
    assert tie.any() and int(tid[tie].max()) == (n_chunks - 1) * raster.CHUNK + 7
    light = torch.tensor(LIGHT, device=cuda)
    got = raster.raster_accum_kernel(rows, bins, counts, z_base, light, **tiles)
    want = raster.rasterize_accum_plain(rows, bins, counts, z_base, light, **tiles)
    torch.cuda.synchronize()
    assert all(_same(g, w) for g, w in zip(got, want))
    assert int(got[1].max()) >= 3


def _holed_bins(dense, counts):
    """Per-triangle bins of every member of each binned chunk of dense chunk
    bins (expand_bins), with hazards.hazard_holes' -1 holes inside the
    counts."""
    from tpu_renderer_torch.utils import hazards

    live = torch.arange(dense.shape[1], device=dense.device)[None, :] < counts[:, None]
    cbins = torch.where(live, dense >> 4, raster.NO_TRI).cpu().numpy()
    holed = hazards.hazard_holes(cbins, counts.cpu().numpy())
    return raster.expand_bins(torch.from_numpy(holed).to(dense.device), counts)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n_chunks,tx,ty", [(64, 1, 1), (24, 2, 2)])
def test_accum_gathered_kernel_exact_on_hazard_tiles(cuda, n_chunks, tx, ty, reverse):
    """Kernel 2.7 on every member of each binned chunk of the hazard rows
    (one tile of 2,048 entries, 2x2 tiles), with -1 holes, in slot order or
    each tile's reversed: bit-exact against its plain version under 2.2's
    opaque depth, and on hazard_accum_rows (negative depths) under
    hazard_accum_z_base, whose negative half only 0 <= z decides; one
    launch a call."""
    from tpu_renderer_torch.utils import hazards

    tiles = dict(tiles_x=tx, tiles_y=ty, tile_w=128, tile_h=32)
    w, h = 128 * tx, 32 * ty
    rows, dense, counts, z_base = _hazards(cuda, n_chunks, tiles, seed=n_chunks)
    bins, tcounts = _holed_bins(dense, counts)
    assert bool((bins < 0).any())
    if reverse:
        bins = _reverse_bins(bins, tcounts)
    light = torch.tensor(LIGHT, device=cuda)
    negative = torch.from_numpy(hazards.hazard_accum_rows(n_chunks, w, h, seed=n_chunks))
    for table, zb in ((rows, z_base),
                      (negative.to(cuda), torch.from_numpy(hazards.hazard_accum_z_base(w, h))
                       .to(cuda))):
        before = raster.accum_gathered_counter.launches
        got = raster.raster_accum_gathered_kernel(table, bins, tcounts, zb, light, **tiles)
        want = raster.rasterize_accum_gathered_plain(table, bins, tcounts, zb, light, **tiles)
        torch.cuda.synchronize()
        assert all(_same(g, w_) for g, w_ in zip(got, want))
        assert raster.accum_gathered_counter.launches == before + 1
        assert int(got[1].max()) >= 3


def _peel_hazards(device, kind, n_chunks, tiles, seed):
    """The hazard rows as kernel 2.3 (kind "fused": fat rows, dense chunk
    bins), 2.5 ("deferred": packed rows, per-triangle bins) or 2.8
    ("gathered": fat rows, every member of each binned chunk, with -1
    holes) takes them, and the peels' opaque depth
    (hazards.hazard_peel_z_base)."""
    from tpu_renderer_torch.utils import hazards

    w, h = tiles["tiles_x"] * tiles["tile_w"], tiles["tiles_y"] * tiles["tile_h"]
    rows = hazards.hazard_rows(n_chunks, w, h, seed=seed)
    box, valid = (torch.from_numpy(a).to(device) for a in hazards.hazard_boxes(rows))
    if kind != "deferred":
        caabb, cvalid = raster.chunk_aabbs(box, valid)
        gaabb, gvalid = raster.group_aabbs(box, valid)
        bins, counts = raster.bin_triangles_full(caabb, cvalid, gaabb, gvalid, **tiles)
        if kind == "gathered":
            bins, counts = _holed_bins(bins, counts)
    else:
        bins, counts, _ = raster.bin_triangles(box, valid, bin_cap=rows.shape[0], **tiles)
        rows = hazards.hazard_packed(rows)
    z_base = torch.from_numpy(hazards.hazard_peel_z_base(w, h)).to(device)
    return torch.from_numpy(rows).to(device), bins, counts, z_base


def _reverse_bins(bins, counts):
    """Each tile's entries inside its count in reverse order."""
    n = counts.clamp(0, bins.shape[1])
    k = torch.arange(bins.shape[1], device=bins.device)[None, :]
    src = torch.where(k < n[:, None], n[:, None] - 1 - k, k)
    return bins.gather(1, src).contiguous()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n_chunks,tx,ty", [(64, 1, 1), (24, 2, 2)])
def test_peel_kernels_exact_on_dense_hazard_tiles(cuda, n_chunks, tx, ty, reverse):
    """Kernels 2.3, 2.5 and 2.8 on one tile of 64 chunk entries (cut
    PEEL_SPLIT ways; 2.5's bin holds its ~1,900 triangles, 2.8's every
    member of each chunk with -1 holes) and on 2x2 tiles, over three peels
    with `last` fed back, the bins ascending or each tile's reversed (the
    kernels' early stops must then stand down): bit-exact against their
    plain versions, each peel one launch."""
    tiles = dict(tiles_x=tx, tiles_y=ty, tile_w=128, tile_h=32)
    for kind, seg_min in (("fused", raster.PEEL_SEG_MIN), ("deferred", raster.DEFERRED_SEG_MIN),
                          ("gathered", raster.DEFERRED_SEG_MIN)):
        table, bins, counts, z_base = _peel_hazards(cuda, kind, n_chunks, tiles, seed=n_chunks)
        if tx * ty == 1:
            assert int(raster.peel_segments(counts, bins.shape[1], seg_min)[0]) == raster.PEEL_SPLIT
        if reverse:
            bins = _reverse_bins(bins, counts)
        kernel, plain, counter = {
            "fused": (raster.raster_peel_fused_kernel, raster.rasterize_peel_fused_plain,
                      raster.peel_fused_counter),
            "deferred": (raster.raster_peel_kernel, raster.rasterize_peel_plain,
                         raster.peel_counter),
            "gathered": (raster.raster_peel_gathered_kernel,
                         raster.rasterize_peel_gathered_plain, raster.peel_gathered_counter),
        }[kind]
        last = torch.full(z_base.shape, -1, dtype=torch.int32, device=cuda)
        before = counter.launches
        for peel in range(3):
            got = kernel(table, bins, counts, z_base, last, **tiles)
            want = plain(table, bins, counts, z_base, last, **tiles)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            assert all(_same(g, w) for g, w in zip(got, want)), (kind, peel)
            assert int((got[0] < raster.ID_INF).sum()) > 0, (kind, peel)
            last = torch.where(got[0] < raster.ID_INF, got[0], raster.ID_INF)
        assert counter.launches == before + 3


# -- kernels 2.4 and 2.6: the visibility walk split over a cluster -----------

VIS_KINDS = ("deferred", "gathered")   # kernel 2.4, kernel 2.6


def _vis(kind):
    """(kernel wrapper, plain version, launch counter) of 2.4 or 2.6."""
    if kind == "deferred":
        return raster.raster_deferred_kernel, raster.rasterize_plain, raster.deferred_counter
    return (raster.raster_fused_gathered_kernel, raster.rasterize_fused_gathered_plain,
            raster.fused_gathered_counter)


def _vis_table(device, kind, rows):
    from tpu_renderer_torch.utils import hazards

    return torch.from_numpy(hazards.hazard_packed(rows) if kind == "deferred" else rows).to(device)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n_chunks,tx,ty", [(64, 1, 1), (24, 2, 2)])
def test_vis_kernels_exact_on_dense_hazard_tiles(cuda, n_chunks, tx, ty, reverse):
    """Kernels 2.4 and 2.6 on utils/hazards.py's visibility rows (equal-z
    copies across every segment boundary, -0.0 / +0.0 winners, depths
    past 1, NaN and infinite coefficients): one tile of ~1,900 entries cut
    VIS_SPLIT ways, and 2x2 tiles, the bins ascending or each tile's
    reversed (the ties go the other way): bit-exact against their plain
    versions, one launch a call."""
    from tpu_renderer_torch.utils import hazards

    tiles = dict(tiles_x=tx, tiles_y=ty, tile_w=128, tile_h=32)
    rows = hazards.hazard_vis_rows(n_chunks, 128 * tx, 32 * ty, seed=n_chunks)
    box, valid = (torch.from_numpy(a).to(cuda) for a in hazards.hazard_boxes(rows))
    bins, counts, _ = raster.bin_triangles(box, valid, bin_cap=rows.shape[0], **tiles)
    if tx * ty == 1:
        assert int(raster.vis_segments(counts, bins.shape[1])[0]) == raster.VIS_SPLIT
    if reverse:
        bins = _reverse_bins(bins, counts)
    for kind in VIS_KINDS:
        kernel, plain, counter = _vis(kind)
        table = _vis_table(cuda, kind, rows)
        before = counter.launches
        got = kernel(table, bins, counts, **tiles)
        want = plain(table, bins, counts, **tiles)
        torch.cuda.synchronize()
        assert all(_same(g, w) for g, w in zip(got, want)), kind
        assert counter.launches == before + 1
        assert int((got[1] >= 0).sum()) > 0


def test_vis_kernels_fold_empty_segments_and_signed_zeros(cuda):
    """hazards.hazard_fold_bin: segments with no winner beside zero-depth
    winners of either sign, in order and reversed: 2.4 and 2.6 equal
    their plain versions, and in order the left half holds row 22 at +0.0,
    the right half row 15 at -0.0."""
    from tpu_renderer_torch.utils import hazards

    tiles = dict(tiles_x=1, tiles_y=1, tile_w=128, tile_h=32)
    rows = hazards.hazard_vis_rows(3, 128, 32, seed=0)
    bins = torch.from_numpy(hazards.hazard_fold_bin(3, raster.VIS_SEG_MIN)).to(cuda)
    counts = torch.tensor([bins.shape[1]], dtype=torch.int32, device=cuda)
    assert int(raster.vis_segments(counts, bins.shape[1])[0]) == 4
    for kind in VIS_KINDS:
        kernel, plain, _ = _vis(kind)
        table = _vis_table(cuda, kind, rows)
        for b in (bins, bins.flip(1).contiguous()):
            got = kernel(table, b, counts, **tiles)
            want = plain(table, b, counts, **tiles)
            torch.cuda.synchronize()
            assert all(_same(g, w) for g, w in zip(got, want)), kind
        z, tid = kernel(table, bins, counts, **tiles)[:2]
        assert (tid[:, :64] == 22).all() and (tid[:, 64:] == 15).all()
        assert not torch.signbit(z[:, :64]).any() and torch.signbit(z[:, 64:]).all()


def test_split_wrappers_refuse_misaligned_rows(cuda):
    """2.1, 2.2 and 2.7 copy rows 16 bytes at a time: a view that starts
    off a 16-byte boundary is refused, never read misaligned."""
    rows, bins, counts = _rows(cuda)
    flat = torch.zeros(rows.numel() + 1, device=cuda)
    flat[1:] = rows.flatten()
    off = flat[1:].view(rows.shape)
    with pytest.raises(ValueError, match="16-byte"):
        raster.raster_fused_kernel(off, bins, counts, **TILES)
    with pytest.raises(ValueError, match="16-byte"):
        raster.raster_accum_kernel(off, bins, counts, torch.zeros((H, W), device=cuda),
                                   torch.tensor(LIGHT, device=cuda), **TILES)
    tri = torch.zeros((bins.shape[0], 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        raster.raster_accum_gathered_kernel(off, tri, counts.clamp(max=4),
                                            torch.zeros((H, W), device=cuda),
                                            torch.tensor(LIGHT, device=cuda), **TILES)


# -- the background passes (kernels 2.9, 2.10, 2.11) --------------------------

BG_EXTENTS = [(200, 100), (256, 64), (333, 222), (480, 270), (1700, 900), (1920, 1080)]


def _bg_extent(w, h):
    return dict(height=h, width_pad=-(-w // 128) * 128, height_pad=-(-h // 32) * 32)


@pytest.mark.parametrize("w,h", BG_EXTENTS)
def test_background_kernels_match_plain(cuda, w, h):
    """Kernels 2.9-2.11 on every element of the padded buffer."""
    ext = _bg_extent(w, h)
    rng = np.random.default_rng(w)
    d1, d2 = (torch.tensor(rng.uniform(0, 1, 4), dtype=torch.float32, device=cuda)
              for _ in range(2))
    sky = torch.tensor([0.1, 0.2, 0.4, 0.97], device=cuda)
    before = (background.gradient_counter.launches, background.sky_counter.launches,
              background.grid_counter.launches)
    pairs = ((background.gradient(d1, d2, **ext), background.gradient_plain(d1, d2, **ext)),
             (background.sky(sky, **ext), background.sky_plain(sky, **ext)),
             (background.grid_gradient(width=w, device=cuda, **ext),
              background.grid_gradient_plain(width=w, device=cuda, **ext)))
    torch.cuda.synchronize()
    assert (background.gradient_counter.launches, background.sky_counter.launches,
            background.grid_counter.launches) == tuple(b + 1 for b in before)
    for got, want in pairs:
        assert got.shape == want.shape == (4, ext["height_pad"], ext["width_pad"])
        assert _same(got, want)
    assert float(pairs[1][0][:3].max()) > 0.9          # the sky has stars


def test_background_kernels_equal_the_cpu_plain_versions(cuda):
    """The card's buffers against the CPU's, which the CPU tests hold to
    the JAX package: the host-evaluated cosines make the sky portable."""
    ext = _bg_extent(333, 222)
    sky = torch.tensor([0.1, 0.2, 0.4, 0.97])
    assert _same(background.sky(sky.to(cuda), **ext).cpu(), background.sky(sky, **ext))
    d1, d2 = torch.tensor([0.9, 0.3, 0.2, 1.0]), torch.tensor([0.1, 0.2, 0.7, 0.5])
    assert _same(background.gradient(d1.to(cuda), d2.to(cuda), **ext).cpu(),
                 background.gradient(d1, d2, **ext))
    assert _same(background.grid_gradient(width=333, device=cuda, **ext).cpu(),
                 background.grid_gradient(width=333, device="cpu", **ext))


def test_background_launchers_refuse_malformed_arguments(cuda):
    ext = _bg_extent(256, 64)
    ok = torch.ones(4, device=cuda)
    before = (background.gradient_counter.launches, background.sky_counter.launches,
              background.grid_counter.launches)
    with pytest.raises(TypeError, match="dtype"):
        background.gradient(ok.double(), ok, **ext)
    with pytest.raises(ValueError, match="expected"):          # wrong device
        background.gradient(ok, torch.ones(4), **ext)
    with pytest.raises(ValueError, match="shape"):
        background.sky(torch.ones(5, device=cuda), **ext)
    with pytest.raises(ValueError, match="contiguous"):
        background.sky(torch.ones(8, device=cuda)[::2], **ext)
    for bad in (dict(height=64, width_pad=200, height_pad=64),
                dict(height=64, width_pad=256, height_pad=48)):
        with pytest.raises(ValueError, match="whole"):         # not whole tiles
            background.background_sky_kernel(ok, **bad)
        with pytest.raises(ValueError, match="whole"):
            background.grid_gradient(width=200, device=cuda, **bad)
    with pytest.raises(ValueError, match="whole 32x8 warp regions"):   # the raster's rule
        background.gradient(ok, ok, tile_h=12, tile_w=128, **ext)
    with pytest.raises(ValueError, match="CUDA"):
        background.background_gradient_kernel(torch.ones(4), torch.ones(4), **ext)
    assert before == (background.gradient_counter.launches, background.sky_counter.launches,
                      background.grid_counter.launches)


def _bad_background_arguments(cuda):
    """(what is bad: "data1", "data2" or "extent", data1, data2, extent),
    one bad argument each."""
    ok, ext = torch.ones(4, device=cuda), _bg_extent(256, 64)
    return [("data1", ok.double(), ok, ext),                          # dtype
            ("data1", torch.ones(5, device=cuda), ok, ext),           # shape
            ("data1", torch.ones(8, device=cuda)[::2], ok, ext),      # contiguity
            ("data2", ok, torch.ones(4), ext),                        # device
            ("data2", ok, torch.ones(3, device=cuda), ext),           # shape
            ("extent", ok, ok, dict(height=64, width_pad=200, height_pad=64)),
            ("extent", ok, ok, dict(height=64, width_pad=256, height_pad=48)),
            ("extent", ok, ok, dict(ext, height=0))]


def _raised(fn):
    try:
        fn()
    except Exception as e:   # noqa: BLE001 - the error is what is compared
        return type(e), str(e)
    return None


def test_background_public_functions_and_launchers_raise_alike(cuda):
    """Each argument is checked once, by the launcher: the public function
    raises what its launcher raises for the same bad argument, and neither
    launches."""
    before = (background.gradient_counter.launches, background.sky_counter.launches,
              background.grid_counter.launches)
    for bad, d1, d2, ext in _bad_background_arguments(cuda):
        pairs = [(lambda: background.gradient(d1, d2, **ext),
                  lambda: background.background_gradient_kernel(d1, d2, **ext))]
        if bad != "data2":
            pairs.append((lambda: background.sky(d1, **ext),
                          lambda: background.background_sky_kernel(d1, **ext)))
        if bad == "extent":
            pairs.append((lambda: background.grid_gradient(width=200, device=cuda, **ext),
                          lambda: background.background_grid_kernel(width=200, device=cuda,
                                                                    **ext)))
        for public, launcher in pairs:
            got = _raised(public)
            assert got is not None and got == _raised(launcher), (bad, got)
    assert before == (background.gradient_counter.launches, background.sky_counter.launches,
                      background.grid_counter.launches)


def _demo_engine(path, device, **cfg):
    from tpu_renderer_torch.config import RendererConfig
    from tpu_renderer_torch.engine import Engine

    eng = Engine(RendererConfig(width=W, height=H, camera_position=(0.0, 6.0, 8.0),
                                **cfg), device=device)
    eng.camera.pitch = np.float32(-0.18)
    eng.init(scene_path=path)
    return eng


def test_engine_background_goes_through_the_kernels(cuda, tmp_path):
    """One launch at the first draw, none while the cache holds, one at an
    effect switch and one at a resize; the frames equal the CPU's."""
    from tpu_renderer_torch.utils.demo import build_demo_glb

    path = str(tmp_path / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0)
    eng, cpu = _demo_engine(path, cuda), _demo_engine(path, "cpu")
    g0, s0 = background.gradient_counter.launches, background.sky_counter.launches
    counts = lambda: (background.gradient_counter.launches - g0,  # noqa: E731
                      background.sky_counter.launches - s0)
    np.testing.assert_array_equal(eng.draw(), cpu.draw())
    eng.draw()
    assert counts() == (1, 0)
    eng.current_background_effect = cpu.current_background_effect = 1
    np.testing.assert_array_equal(eng.draw(), cpu.draw())
    eng.draw()
    assert counts() == (1, 1)
    eng.resize(128, 32)
    cpu.resize(128, 32)
    np.testing.assert_array_equal(eng.draw(), cpu.draw())
    assert counts() == (1, 2) and eng._bg_fb.shape == (4, 32, 128)


@pytest.mark.parametrize("scale", [0.65, 2.0])
def test_render_scale_frame_on_card_equals_cpu(cuda, tmp_path, scale):
    """The blit adds its taps in one order on both devices, so the scaled
    frame on the card is the CPU's byte for byte."""
    from tpu_renderer_torch.utils.demo import build_demo_glb

    path = str(tmp_path / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0)
    frames = [_demo_engine(path, dev, render_scale=scale, background_effect=1).draw()
              for dev in ("cpu", cuda)]
    assert frames[0].shape == (H, W, 4)
    np.testing.assert_array_equal(frames[1], frames[0])


def test_draw_pipelined_on_card_lags_draw_by_two(cuda, tmp_path):
    from tpu_renderer_torch.engine import Engine
    from tpu_renderer_torch.utils.demo import build_demo_glb

    path = str(tmp_path / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0)
    eng, twin = _demo_engine(path, cuda), _demo_engine(path, cuda)
    want, got = [], []
    for i in range(7):
        for e in (eng, twin):
            e.camera.yaw = np.float32(0.05 * i)
        want.append(twin.draw())
        got.append(eng.draw_pipelined(stats_interval=2))
    assert got[0] is None and got[1] is None
    for i in range(2, 7):
        np.testing.assert_array_equal(got[i], want[i - 2])
    assert len(eng._slots) == Engine.FRAME_OVERLAP and all(s.is_pinned() for s in eng._slots)
    np.testing.assert_array_equal(eng.flush_pipelined(), want[6])
    cells = [eng.draw_pipelined(present_cells=(40, 6)) for _ in range(3)][2]
    assert cells.shape == (12, 40, 4)


def _card_mesh_rank(rank, path, mesh_shape, fused):
    """A rank of a mesh on the card: the demo frame through
    Engine(multichip=...), the group's backend, the rank's device, and the
    device type of every tensor this rank handed to a collective."""
    import torch.distributed as dist

    seen = []
    reduce, gather = dist.all_reduce, dist.all_gather

    def all_reduce(t, *a, **k):
        seen.append(t.device.type)
        return reduce(t, *a, **k)

    def all_gather(parts, t, *a, **k):
        seen.append(t.device.type)
        return gather(parts, t, *a, **k)

    dist.all_reduce, dist.all_gather = all_reduce, all_gather
    try:
        eng = _demo_engine(path, "cuda", multichip=mesh_shape, fused=fused)
        image = eng.draw()
    finally:
        dist.all_reduce, dist.all_gather = reduce, gather
    return image, dist.get_backend(), str(eng.device), sorted(set(seen))


@pytest.mark.parametrize("mesh_shape,fused,backend", [
    ((1, 1), True, "nccl"), ((2, 1), False, "gloo"), ((2, 1), True, "gloo")])
def test_mesh_on_the_card_equals_the_single_device_frame(cuda, tmp_path, mesh_shape,
                                                         fused, backend):
    """(1, 1) runs nccl; (2, 1) on one card runs gloo with both ranks on
    cuda:0 and hands the collectives CUDA tensors (nothing staged through
    host memory). Each is byte for byte the single-device frame on either
    path: the second band's launches cover its own tiles from the frame's
    tile row (tile_y0), its pixel centers the frame's."""
    from tpu_renderer_torch.parallel import multichip
    from tpu_renderer_torch.utils.demo import build_demo_glb

    if torch.cuda.device_count() != 1:
        pytest.skip("the backend rule is checked on a host with one card")
    path = str(tmp_path / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0)
    single = _demo_engine(path, cuda, fused=fused).draw()
    image, got_backend, device, seen = multichip.launch(
        _card_mesh_rank, mesh_shape[0] * mesh_shape[1], device="cuda",
        args=(path, mesh_shape, fused))
    assert (got_backend, device, seen) == (backend, "cuda:0", ["cuda"])
    diff = np.any(image != single, axis=-1)
    print(f"{mesh_shape} fused={fused}: {int(diff.sum())} of {diff.size} pixels differ")
    np.testing.assert_array_equal(image, single)


def _gloo_ops_rank(rank):
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    out = {}
    for dtype in (torch.float32, torch.int32):
        for op in ("SUM", "MAX", "MIN"):
            t = torch.full((3, 5), rank + 1, dtype=dtype, device=dev)
            dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
            out[(op, str(dtype))] = (t.device.type, t.cpu().unique().tolist())
    parts = [torch.empty(4, device=dev) for _ in range(2)]
    dist.all_gather(parts, torch.full((4,), rank + 1.0, device=dev))
    out["all_gather"] = [p.cpu().tolist() for p in parts]
    return dist.get_backend(), out


def test_gloo_takes_cuda_tensors_in_every_collective_the_mesh_calls(cuda):
    """multichip stages no tensor through host memory: two ranks sharing
    one card run gloo, which reduces (SUM, MAX, MIN on float32 and int32)
    and gathers CUDA tensors as they are."""
    from tpu_renderer_torch.parallel import multichip

    if torch.cuda.device_count() != 1:
        pytest.skip("two ranks share a card only on a host with one card")
    backend, out = multichip.launch(_gloo_ops_rank, 2, device="cuda")
    assert backend == "gloo"
    for dtype in ("torch.float32", "torch.int32"):
        assert out[("SUM", dtype)] == ("cuda", [3])
        assert out[("MAX", dtype)] == ("cuda", [2])
        assert out[("MIN", dtype)] == ("cuda", [1])
    assert out["all_gather"] == [[1.0] * 4, [2.0] * 4]


# -- kernels 2.1-2.5 over a band's tiles (tile_y0) --------------------------


@pytest.mark.parametrize("tile_h,tile_w", [(32, 128), (64, 128)])
def test_band_kernels_match_plain_and_the_frame(cuda, tile_h, tile_w):
    """Kernels 2.1-2.5 launched over the lower band of a 256x256 frame
    (tile_y0 > 0; 64x128 is a tile of two passes): bit for bit their plain
    versions on the band's inputs, and the whole frame's launch sliced to
    the band."""
    hw = 256
    T = 192
    tiles = dict(tiles_x=hw // tile_w, tiles_y=hw // tile_h, tile_w=tile_w, tile_h=tile_h)
    eye = torch.eye(4, device=cuda)
    args = (_corners(cuda, T, 11), torch.zeros(T, dtype=torch.int32, device=cuda),
            torch.ones(T, dtype=torch.bool, device=cuda), eye[None],
            torch.ones(1, dtype=torch.bool, device=cuda), eye, hw, hw)
    sun = torch.tensor(SUN, device=cuda)
    rows, aabb, valid = vertex.triangle_setup_rows(*args, sun_dir=sun)
    rows = rows.contiguous()
    bins, counts = raster.bin_triangles_full(*raster.chunk_aabbs(aabb, valid),
                                             *raster.group_aabbs(aabb, valid), **tiles)
    setup = vertex.triangle_setup_c(*args, sun_dir=sun)
    cb = raster.bin_triangles(*raster.chunk_aabbs(setup.aabb, setup.valid), bin_cap=64,
                              **tiles)
    tbins, tcounts, _ = raster.refine_bins(cb[0], setup.aabb, tri_cap=1024, **tiles)
    light = torch.tensor(LIGHT, device=cuda)
    z = raster.raster_fused_kernel(rows, bins, counts, **tiles)[0].clone()
    z[:, hw // 2:] = 0.0
    last = torch.full((hw, hw), -1, dtype=torch.int32, device=cuda)
    k = tiles["tiles_y"] // 2 + 1
    r0, tx = k * tile_h, tiles["tiles_x"]
    band = dict(tiles, tiles_y=tiles["tiles_y"] - k, tile_y0=k)
    cut = lambda t: t[k * tx:].contiguous()  # noqa: E731
    plane = lambda t: t[r0:].contiguous()  # noqa: E731
    calls = [("raster_fused_kernel", "rasterize_fused_plain", (rows, bins, counts)),
             ("raster_accum_kernel", "rasterize_accum_plain", (rows, bins, counts, z, light)),
             ("raster_peel_fused_kernel", "rasterize_peel_fused_plain",
              (rows, bins, counts, z, last)),
             ("raster_deferred_kernel", "rasterize_plain", (setup.packed, tbins, tcounts)),
             ("raster_peel_kernel", "rasterize_peel_plain",
              (setup.packed, tbins, tcounts, z, last))]
    for name, plain, full in calls:
        # band arguments: bins cut to the band's tiles, planes to its rows
        sub = tuple(cut(a) if i in (1, 2) else plane(a) if a.dim() == 2 and i >= 3 else a
                    for i, a in enumerate(full))
        got = getattr(raster, name)(*sub, **band)
        want = getattr(raster, plain)(*sub, **band)
        whole = getattr(raster, name)(*full, **tiles)
        torch.cuda.synchronize()
        got, want, whole = (x if isinstance(x, tuple) else (x,) for x in (got, want, whole))
        assert all(_same(g, w) for g, w in zip(got, want)), (name, tile_h, tile_w)
        assert all(_same(g, w[..., r0:, :].contiguous()) for g, w in zip(got, whole)), name
        first = got[0]
        assert bool(((first > 0) & (first < raster.ID_INF)).any()), name


# -- a mesh graphed over nccl (frame_graph.FrameGraph with the mesh) -----------


def _nccl_mesh_rank(rank, path):
    """A (1, 1) mesh over nccl, on each path: the first frame (the capture's
    eager warm-up), a replay of its graph, the same frame drawn eagerly,
    and the single-device engine's, as images; the host syncs inside the
    replayed draw_device(); the graphs captured; then what a capture with
    Mesh.timing on raises."""
    import torch.distributed as dist

    from tpu_renderer_torch import pipeline
    from tpu_renderer_torch.present import unpack_u8
    from tpu_renderer_torch.utils.bench_frame import SyncCount

    out = {"backend": dist.get_backend()}
    for kind in ("bench", "textured-glass", "deferred"):
        eng = _path_engine(path, "cuda", kind, multichip=(1, 1))
        first = eng.draw()
        params = eng.update_scene()
        with SyncCount() as syncs:
            image, _ = eng.draw_device(params)
        replay = unpack_u8(image)
        with pipeline.eager():
            eager = eng.draw()
        single = _path_engine(path, "cuda", kind).draw()
        out[kind] = dict(first=first, replay=replay, eager=eager, single=single,
                         syncs=syncs.calls, graphs=len(eng.frame_graphs))
    eng.mesh.timing = True
    eng.frame_graphs.clear()
    try:
        eng.draw()
        out["timing"] = "no error"
    except RuntimeError as e:
        out["timing"] = str(e)
    return out


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    from tpu_renderer_torch.parallel import multichip
    from tpu_renderer_torch.utils.demo import build_demo_glb

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build for sm_90a)")
    if torch.cuda.device_count() != 1:
        pytest.skip("the backend rule is checked on a host with one card")
    path = str(tmp_path_factory.mktemp("nccl") / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0)
    return multichip.launch(_nccl_mesh_rank, 1, device="cuda", args=(path,))


@pytest.mark.parametrize("kind", ["bench", "textured-glass", "deferred"])
def test_nccl_mesh_replays_its_graph_byte_for_byte(nccl_mesh, kind):
    """At (1, 1) on nccl the mesh frame is a replay of its CUDA graph, with
    no host sync inside draw_device(), and equals the eager mesh frame and
    the single-device frame byte for byte."""
    got = nccl_mesh[kind]
    assert nccl_mesh["backend"] == "nccl"
    assert got["graphs"] >= 1 and got["syncs"] == 0
    for k in ("first", "replay", "eager"):
        np.testing.assert_array_equal(got[k], got["single"], err_msg=k)


def test_a_mesh_capture_with_timing_raises(nccl_mesh):
    """Mesh.timing synchronises around each collective: a capture with it
    on raises (nothing falls back to the eager frame)."""
    assert "Mesh.timing" in nccl_mesh["timing"]


# -- the graphed frame (frame_graph.py) ----------------------------------------


def _path_engine(path, device, kind, **cfg):
    """The demo grid 4 engine of a path: "bench", "textured-glass" (its glass
    given the checker texture: the peel, kernel 2.3) or "deferred" (past a
    dense-bin guard of 1: kernels 2.4 and 2.5); cfg: more of its config."""
    from tpu_renderer_torch.config import RendererConfig
    from tpu_renderer_torch.engine import Engine
    from tpu_renderer_torch.scene import load_scene
    from tpu_renderer_torch.utils.bench_frame import texture_the_glass

    eng = Engine(RendererConfig(width=W, height=H, camera_position=(0.0, 6.0, 8.0),
                                dense_bin_max_chunks=1 if kind == "deferred" else 8192,
                                **cfg), device=device)
    eng.camera.pitch = np.float32(-0.18)
    s = load_scene(path)
    eng.init(scene=s if kind == "bench" else texture_the_glass(s))
    return eng


def _counts():
    return {c: c.total() for c in raster._Counter.registry}


def _moved(before):
    return {c: n - before[c] for c, n in _counts().items() if n != before[c]}


@pytest.mark.parametrize("kind", ["bench", "textured-glass", "deferred"])
def test_graphed_frames_equal_eager_frames(cuda, tmp_path, kind):
    """Over an orbit the graphed engine's frames (the first captured, the
    rest replays) equal the eager engine's byte for byte, aux too, and
    launch every kernel as often, the peels counted on the card."""
    from tpu_renderer_torch import pipeline
    from tpu_renderer_torch.utils.demo import build_demo_glb

    path = str(tmp_path / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0)
    eng, ref = _path_engine(path, cuda, kind), _path_engine(path, cuda, kind)
    eng.draw()             # captured (the deferred path: at each cap escalation)
    with pipeline.eager():
        ref.draw()
    for i in range(5):
        for e in (eng, ref):
            e.camera.yaw = np.float32(0.2 * i)
        before = _counts()
        got = eng.draw()
        graphed = _moved(before)
        before = _counts()
        with pipeline.eager():
            want = ref.draw()
        eager = _moved(before)
        np.testing.assert_array_equal(got, want)
        assert {k: int(v) for k, v in eng._last_aux.items()} == \
            {k: int(v) for k, v in ref._last_aux.items()}
        assert graphed == eager and graphed, (graphed, eager)
    assert len(eng.frame_graphs) >= 1 and len(ref.frame_graphs) == 0


def test_graph_peels_as_many_layers_as_the_replayed_frame_has(cuda):
    """The loop runs on the card as long as a layer finds a fragment: a
    graph captured on a view with no transparent layer replays the six-layer
    stack exactly, with 7 peels and 6 layers."""
    from tpu_renderer_torch import milestones, pipeline, scene
    from tpu_renderer_torch.frame_graph import GraphCache
    from tpu_renderer_torch.utils.demo import checker_texture

    s = milestones.textured_quad_scene(checker_texture(32, 4), mipmapped=True)
    s.materials[-1].transparent = True
    for k in range(5):
        node = scene.MeshNode(0, f"layer{k}")
        node.refresh_transform(np.eye(4, dtype=np.float32))
        s.nodes.append(node)
        s.top_nodes.append(node)
    flat = scene.flatten_scene(s, device=cuda)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=cuda)  # noqa: E731
    params = pipeline.FrameParams(
        view=torch.eye(4, device=cuda), proj=torch.eye(4, device=cuda),
        bg_effect=torch.tensor(0, dtype=torch.int32, device=cuda),
        bg_data1=f([0.1, 0.1, 0.1, 0.7]), bg_data2=f([0.1, 0.1, 0.1, 1.0]),
        ambient=torch.zeros(4, device=cuda), sun_dir=f([0, 0, 1, 1]),
        sun_color=torch.ones(4, device=cuda))
    away = params._replace(view=torch.diag(f([1.0, 1.0, 1.0, 1.0])) + f(
        [[0, 0, 0, 50.0], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]))
    kw = dict(width=128, height=64, transp_textured=True)
    bg = pipeline.background_fb(params, width=128, height=64)
    graphs = GraphCache()
    _, first = graphs.frame(flat.buffers, away, bg_fb=bg, **kw)
    assert int(first["transparent_layers"]) == 0
    before = _counts()
    got, aux = graphs.frame(flat.buffers, params, bg_fb=bg, **kw)
    moved = _moved(before)
    with pipeline.eager():
        want, want_aux = pipeline.render_frame(flat.buffers, params, bg_fb=bg, **kw)
    assert torch.equal(got, want)
    assert int(aux["transparent_layers"]) == int(want_aux["transparent_layers"]) == 6
    assert moved[raster.peel_fused_counter] == 7


def test_render_frames_replays_equal_eager_frames(cuda, tmp_path):
    from tpu_renderer_torch import pipeline
    from tpu_renderer_torch.bench import frame_statics, orbit_params
    from tpu_renderer_torch.utils.demo import build_demo_glb

    path = str(tmp_path / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0)
    eng = _path_engine(path, cuda, "textured-glass")
    params, kw = orbit_params(eng, 4), frame_statics(eng)
    img, sums = pipeline.render_frames(eng.flat.buffers, params, frame=eng.render_fn(), **kw)
    assert len(eng.frame_graphs) == 1
    img2, sums2 = pipeline.render_frames(eng.flat.buffers, params, frame=eng.render_fn(), **kw)
    with pipeline.eager():
        want, want_sums = pipeline.render_frames(eng.flat.buffers, params,
                                                 frame=eng.render_fn(), **kw)
    assert torch.equal(img, want) and torch.equal(img2, want)
    assert torch.equal(sums, want_sums) and torch.equal(sums2, want_sums)
    assert len(eng.frame_graphs.captured) == 1


def test_a_scene_loaded_again_is_captured_again(cuda, tmp_path):
    """Engine.init drops the graphs of the scene before: a second scene of
    the same shapes draws itself, not the first one's buffers, through a
    graph captured anew."""
    from tpu_renderer_torch import pipeline
    from tpu_renderer_torch.scene import load_scene
    from tpu_renderer_torch.utils.bench_frame import texture_the_glass
    from tpu_renderer_torch.utils.demo import build_demo_glb

    paths = [str(tmp_path / f"demo4_{seed}.glb") for seed in (0, 1)]
    for seed, path in enumerate(paths):
        build_demo_glb(path, grid=4, seed=seed)
    eng = _path_engine(paths[0], cuda, "textured-glass")
    first = eng.draw()
    eng.init(scene=texture_the_glass(load_scene(paths[1])))
    got = eng.draw()
    with pipeline.eager():
        want = eng.draw()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, first) and len(eng.frame_graphs.captured) == 2


def test_draw_pipelined_keeps_each_frames_aux(cuda, tmp_path):
    """Frames in flight each keep their own image and aux: a replay
    overwrites only the graph's own buffers."""
    from tpu_renderer_torch import pipeline
    from tpu_renderer_torch.utils.demo import build_demo_glb

    path = str(tmp_path / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0)
    eng, ref = _path_engine(path, cuda, "textured-glass"), _path_engine(path, cuda,
                                                                        "textured-glass")
    want, got = [], []
    for i in range(6):
        for e in (eng, ref):
            e.camera.yaw = np.float32(0.4 * i)
        with pipeline.eager():
            want.append((ref.draw(), {k: int(v) for k, v in ref._last_aux.items()}))
        got.append(eng.draw_pipelined(stats_interval=0))
        if i >= 2:
            old = eng._inflight[0]
            assert {k: int(v) for k, v in old.aux.items()} == want[i - 1][1]
    for i in range(2, 6):
        np.testing.assert_array_equal(got[i], want[i - 2][0])
    assert eng._last_aux is not None and len(eng.frame_graphs) == 1


def test_a_failed_capture_raises(cuda, tmp_path, monkeypatch):
    """No fallback: outside pipeline.eager() a frame that cannot be captured
    raises; under it the same engine draws eagerly."""
    from tpu_renderer_torch import pipeline
    from tpu_renderer_torch.utils.demo import build_demo_glb

    path = str(tmp_path / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0)
    eng = _path_engine(path, cuda, "bench")
    shade_fused = pipeline.shade.shade_fused

    def host_read(*args, **kwargs):
        out = shade_fused(*args, **kwargs)
        float(out.max())     # a host read: refused inside a capture
        return out

    monkeypatch.setattr(pipeline.shade, "shade_fused", host_read)
    with pytest.raises(Exception):
        eng.draw()
    with pipeline.eager():
        assert eng.draw().shape == (H, W, 4)


def test_graphed_frame_stamps_every_peel_pass(cuda, tmp_path):
    """A graphed textured-glass frame under profiling.tracing(): each replay
    stamps the frame's spans, the WHILE body's once a pass (layers + 1
    passes, numbered on the card, in increasing time); the graph captured
    with tracing off holds no stamp and replays the same image; the
    calibration's round trip stays under 50 us."""
    from tpu_renderer_torch.utils import profiling
    from tpu_renderer_torch.utils.demo import build_demo_glb

    path = str(tmp_path / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0)
    eng = _path_engine(path, cuda, "textured-glass")
    eng.draw()
    raster.stamp_counter.reset()
    off = eng.draw()                          # a replay of the graph captured untraced
    assert raster.stamp_counter.total() == 0
    with profiling.tracing() as trace:
        first = eng.draw()                    # the traced capture (its first frame eager)
        on = [eng.draw() for _ in range(3)]   # replays
    layers = int(eng._last_aux["transparent_layers"])
    assert layers >= 1 and len(eng.frame_graphs) == 2
    for image in (first, *on):
        np.testing.assert_array_equal(image, off)
    summary = trace.summary()
    assert summary["dropped"] == 0 and summary["calibration_us"] < 50.0
    assert [f["frame"] for f in summary["frames"]] == [1, 2, 3, 4]
    for f in summary["frames"]:
        assert f["peel_passes"] == layers + 1 and len(f["peel_shaded_ms"]) == layers
        assert abs(sum(f["device_self_ms"].values()) - f["device_ms"]["frame"]) < 1e-6
    for frame in (2, 3, 4):
        passes = [s for s in trace.device_spans() if s[0] == "peel_pass" and s[4] == frame]
        assert [s[5] for s in passes] == list(range(layers + 1))
        starts = [s[1] for s in passes]
        assert starts == sorted(starts) and all(s[1] < s[2] for s in passes)
    raster.stamp_counter.reset()
    np.testing.assert_array_equal(eng.draw(), off)
    assert raster.stamp_counter.total() == 0


def test_a_cpu_frame_traced_on_a_card_host_stamps_on_the_cpu(cuda, tmp_path):
    """The trace stamps on the device a frame runs on, not on the current
    card: a CPU engine's traced frame stamps on the CPU beside a card, and a
    card's frame in the same block raises rather than stamp into another
    device's log."""
    from tpu_renderer_torch.utils import profiling
    from tpu_renderer_torch.utils.demo import build_demo_glb

    path = str(tmp_path / "demo2.glb")
    build_demo_glb(path, grid=2, seed=0)
    cpu = _path_engine(path, "cpu", "textured-glass")
    card = _path_engine(path, cuda, "textured-glass")
    card.draw()
    off = cpu.draw()
    raster.stamp_counter.reset()
    with profiling.tracing() as trace:
        on = cpu.draw()
        with pytest.raises(ValueError, match="one device"):
            card.draw()
    assert trace.device == torch.device("cpu")
    assert [s[0] for s in trace.device_spans() if s[3] == -1] == ["frame"]
    assert raster.stamp_counter.total() == len(trace.stamps) > 0
    np.testing.assert_array_equal(on, off)
    summary = trace.summary()
    assert summary["timer_step_ns"] is None and len(summary["frames"]) == 1


# -- every tile of the kernels' set (raster.TILES), and tiles past it --------

# tiles raster.tile_rule takes outside the shipped set, each built into a
# library of its own at its first launch: a warp a block (8x32), two, and
# tiles walked in 2 and 4 passes of 16 warps (64x128, 32x256, 128x128)
NEW_TILES = ((8, 32), (16, 32), (64, 128), (8, 256), (32, 256), (128, 128))


def _tiles(tile_h, tile_w):
    """The grid of whole tiles over W x H padded to the tile."""
    return dict(tiles_x=-(-W // tile_w), tiles_y=-(-H // tile_h), tile_w=tile_w,
                tile_h=tile_h)


def _kernels_match_plain(cuda, tile_h, tile_w):
    """Kernels 2.1-2.8 at the tile against their plain versions, bit for
    bit, on random triangles over W x H binned at that tile (the frame
    padded to whole tiles): 2.1 and 2.2 on sorted rows, 2.3 and 2.5 over two
    peels (`last` fed back), 2.4 on refined bins, 2.6-2.8 over per-triangle
    bins of the same rows."""
    tiles = _tiles(tile_h, tile_w)
    hp, wp = tiles["tiles_y"] * tile_h, tiles["tiles_x"] * tile_w
    rows, aabb, valid = vertex.triangle_setup_rows(
        _corners(cuda, 192, 7), *_setup_args(cuda, 192),
        sun_dir=torch.tensor(SUN, device=cuda))
    aabb, valid, rows = raster.spatial_sort(aabb, valid, rows)
    rows = rows.contiguous()
    caabb, cvalid = raster.chunk_aabbs(aabb, valid)
    dense = raster.bin_triangles_full(caabb, cvalid, *raster.group_aabbs(aabb, valid),
                                      **tiles)
    cbins, ccounts, _ = raster.bin_triangles(caabb, cvalid, bin_cap=64, **tiles)
    tbins, tcounts, _ = raster.refine_bins(cbins, aabb, tri_cap=1024, **tiles)
    setup = vertex.triangle_setup_c(_corners(cuda, 192, 7), *_setup_args(cuda, 192),
                                    sun_dir=torch.tensor(SUN, device=cuda))
    pc = raster.bin_triangles(*raster.chunk_aabbs(setup.aabb, setup.valid), bin_cap=64,
                              **tiles)
    pbins, pcounts, _ = raster.refine_bins(pc[0], setup.aabb, tri_cap=1024, **tiles)
    light = torch.tensor(LIGHT, device=cuda)
    z = raster.raster_fused_kernel(rows, *dense, **tiles)[0].clone()
    z[:, 128:] = 0.0
    last = torch.full((hp, wp), -1, dtype=torch.int32, device=cuda)
    calls = [("raster_fused_kernel", "rasterize_fused_plain", (rows, *dense)),
             ("raster_accum_kernel", "rasterize_accum_plain", (rows, *dense, z, light)),
             ("raster_deferred_kernel", "rasterize_plain", (setup.packed, pbins, pcounts)),
             ("raster_fused_gathered_kernel", "rasterize_fused_gathered_plain",
              (rows, tbins, tcounts)),
             ("raster_accum_gathered_kernel", "rasterize_accum_gathered_plain",
              (rows, tbins, tcounts, z, light))]
    for name, plain, args in calls:
        got, want = getattr(raster, name)(*args, **tiles), getattr(raster, plain)(*args, **tiles)
        torch.cuda.synchronize()
        assert all(_same(g, w) for g, w in zip(got, want)), (name, tile_h, tile_w)
    for name, plain, args in (
            ("raster_peel_fused_kernel", "rasterize_peel_fused_plain", (rows, *dense)),
            ("raster_peel_kernel", "rasterize_peel_plain", (setup.packed, pbins, pcounts)),
            ("raster_peel_gathered_kernel", "rasterize_peel_gathered_plain",
             (rows, tbins, tcounts))):
        lt, found = last, []
        for _ in range(2):
            got = getattr(raster, name)(*args, z, lt, **tiles)
            want = getattr(raster, plain)(*args, z, lt, **tiles)
            got, want = (got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,))
            torch.cuda.synchronize()
            assert all(_same(g, w) for g, w in zip(got, want)), (name, tile_h, tile_w)
            found.append(int((got[0] < raster.ID_INF).sum()))
            lt = torch.where(got[0] < raster.ID_INF, got[0], raster.ID_INF)
        assert found[0] > 500 and found[1] > 0, (name, found)


@pytest.mark.parametrize("tile_h,tile_w", raster.TILES)
def test_raster_kernels_match_plain_at_every_tile(cuda, tile_h, tile_w):
    """Kernels 2.1-2.8 at each tile of the set against their plain
    versions (_kernels_match_plain)."""
    _kernels_match_plain(cuda, tile_h, tile_w)


@pytest.mark.parametrize("tile_h,tile_w", NEW_TILES)
def test_raster_kernels_match_plain_at_every_new_tile(cuda, tile_h, tile_w):
    """Kernels 2.1-2.8 at each new tile, from the library built for it,
    against their plain versions (_kernels_match_plain); the clusters of a
    tile walked in passes were checked to fit before their first launch."""
    _kernels_match_plain(cuda, tile_h, tile_w)
    clusters = raster.max_clusters(tile_h, tile_w)
    if raster.tile_blocks(tile_h, tile_w)[1] > 1:
        assert all(n >= 1 for n in clusters.values()), clusters


# tiles walked in 2 and 4 passes of 16 warps, whose triangle kernels
# (2.4-2.6, 2.8) stage a segment's entries 512 (a block's threads) a batch
PASSES_TILES = ((64, 128), (128, 128))


@pytest.mark.parametrize("tile_h,tile_w", PASSES_TILES)
def test_triangle_kernels_restage_every_segment_at_a_tile_of_passes(cuda, tile_h, tile_w):
    """One tile of more than VIS_SPLIT x 512 per-triangle entries
    (utils/hazards.py's rows, 160 chunks), so that every segment of the
    cluster stages its entries in more than one batch in every pass: 2.4
    and 2.6 (vis_tile_passes) and, over two peels with `last` fed back,
    2.5 and 2.8 (peel_tile_passes) bit-exact against their plain
    versions."""
    from tpu_renderer_torch.utils import hazards

    n_chunks = 160
    tiles = dict(tiles_x=1, tiles_y=1, tile_w=tile_w, tile_h=tile_h)
    warps, passes = raster.tile_blocks(tile_h, tile_w)
    batch = 32 * warps
    assert passes > 1
    rows = hazards.hazard_vis_rows(n_chunks, tile_w, tile_h, seed=n_chunks)
    box, valid = (torch.from_numpy(a).to(cuda) for a in hazards.hazard_boxes(rows))
    bins, counts, _ = raster.bin_triangles(box, valid, bin_cap=rows.shape[0], **tiles)
    assert int(counts[0]) // raster.VIS_SPLIT > batch
    assert int(raster.vis_segments(counts, bins.shape[1])[0]) == raster.VIS_SPLIT
    for kind in VIS_KINDS:
        kernel, plain, _ = _vis(kind)
        table = _vis_table(cuda, kind, rows)
        got, want = kernel(table, bins, counts, **tiles), plain(table, bins, counts, **tiles)
        torch.cuda.synchronize()
        assert all(_same(g, w) for g, w in zip(got, want)), (kind, tile_h, tile_w)
        assert int((got[1] >= 0).sum()) > 0
    for kind, kernel, plain in (
            ("deferred", raster.raster_peel_kernel, raster.rasterize_peel_plain),
            ("gathered", raster.raster_peel_gathered_kernel,
             raster.rasterize_peel_gathered_plain)):
        table, bins, counts, z_base = _peel_hazards(cuda, kind, n_chunks, tiles, seed=n_chunks)
        assert int(counts[0]) // raster.PEEL_SPLIT > batch, (kind, int(counts[0]))
        last = torch.full(z_base.shape, -1, dtype=torch.int32, device=cuda)
        for peel in range(2):
            got = kernel(table, bins, counts, z_base, last, **tiles)
            want = plain(table, bins, counts, z_base, last, **tiles)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            assert all(_same(g, w) for g, w in zip(got, want)), (kind, peel, tile_h, tile_w)
            assert int((got[0] < raster.ID_INF).sum()) > 0, (kind, peel)
            last = torch.where(got[0] < raster.ID_INF, got[0], raster.ID_INF)


@pytest.mark.parametrize("tile_h,tile_w", raster.TILES + NEW_TILES)
def test_block_shared_memory_is_what_the_rule_counts(cuda, tile_h, tile_w):
    """The shared memory a block of each kernel 2.1-2.8 takes at the tile,
    as the compiler laid its instance out (raster.block_smem), equals
    raster.tile_smem, the model tile_rule reads before any build."""
    assert raster.block_smem(tile_h, tile_w) == raster.tile_smem(tile_h, tile_w)


@pytest.mark.parametrize("tile_h,tile_w", raster.TILES + NEW_TILES)
def test_background_kernels_match_plain_at_every_tile(cuda, tile_h, tile_w):
    """Kernels 2.9-2.11 at each tile's padded extent: 1700x900 pads to
    1728 at 64-pixel tiles, an odd multiple of 64 (a half row segment)."""
    d1, d2 = torch.tensor([0.9, 0.3, 0.2, 1.0], device=cuda), torch.tensor(
        [0.1, 0.2, 0.7, 0.5], device=cuda)
    sky = torch.tensor([0.1, 0.2, 0.4, 0.97], device=cuda)
    tile = dict(tile_h=tile_h, tile_w=tile_w)
    for w, h in ((1700, 900), (333, 222)):
        ext = dict(height=h, width_pad=-(-w // tile_w) * tile_w,
                   height_pad=-(-h // tile_h) * tile_h)
        for got, want in (
                (background.gradient(d1, d2, **ext, **tile),
                 background.gradient_plain(d1, d2, **ext)),
                (background.sky(sky, **ext, **tile), background.sky_plain(sky, **ext)),
                (background.grid_gradient(width=w, device=cuda, **ext, **tile),
                 background.grid_gradient_plain(width=w, device=cuda, **ext))):
            torch.cuda.synchronize()
            assert got.shape == (4, ext["height_pad"], ext["width_pad"])
            assert _same(got, want), (w, h, tile_h, tile_w)


def test_a_tile_outside_the_set_raises_on_the_card(cuda):
    """No kernel takes a tile outside raster.tile_rule, and none falls back
    to its plain version or another tile: the wrappers raise, naming the
    rule (off the 32x8 regions) or the bytes (past the shared memory a
    block can opt into), before any build or launch."""
    rows, bins, counts = _rows(cuda)
    before = (raster.fused_counter.launches, background.gradient_counter.launches)
    ok = torch.ones(4, device=cuda)
    for tile_h, tile_w, match in ((12, 128, "whole 32x8 warp regions"),
                                  (128, 256, "290,816 bytes of shared memory")):
        with pytest.raises(ValueError, match=match):
            raster.rasterize_fused(rows, bins[:1], counts[:1], tiles_x=1, tiles_y=1,
                                   tile_w=tile_w, tile_h=tile_h)
        with pytest.raises(ValueError, match=match):
            background.gradient(ok, ok, height=64, width_pad=256, height_pad=tile_h * 2,
                                tile_h=tile_h, tile_w=tile_w)
        assert (tile_h, tile_w) not in _build._tile_libs
    assert (raster.fused_counter.launches, background.gradient_counter.launches) == before


@pytest.mark.parametrize("kind", ["bench", "textured-glass", "deferred"])
def test_graphed_frames_at_every_tile_equal_the_default_tile(cuda, tmp_path, kind):
    """Engine(RendererConfig(tile_h, tile_w)) on the card, graphed, at each
    tile of the set and each new tile (NEW_TILES, built at its first frame,
    before the capture): the frame equals the 32x128 frame byte for byte, and
    the path's kernels launched."""
    from tpu_renderer_torch.config import RendererConfig
    from tpu_renderer_torch.engine import Engine
    from tpu_renderer_torch.scene import load_scene
    from tpu_renderer_torch.utils.bench_frame import texture_the_glass
    from tpu_renderer_torch.utils.demo import build_demo_glb

    path = str(tmp_path / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0)
    counter = {"bench": raster.accum_counter, "textured-glass": raster.peel_fused_counter,
               "deferred": raster.peel_counter}[kind]
    frames = {}
    for tile_h, tile_w in raster.TILES + NEW_TILES:
        eng = Engine(RendererConfig(width=333, height=222, tile_h=tile_h, tile_w=tile_w,
                                    camera_position=(0.0, 6.0, 8.0),
                                    dense_bin_max_chunks=1 if kind == "deferred" else 8192),
                     device=cuda)
        eng.camera.pitch = np.float32(-0.18)
        s = load_scene(path)
        eng.init(scene=s if kind == "bench" else texture_the_glass(s))
        eng.draw()
        counter.reset()
        frames[(tile_h, tile_w)] = eng.draw()     # a replay
        assert counter.total() > 0 and len(eng.frame_graphs) >= 1, (tile_h, tile_w)
    for tile, frame in frames.items():
        np.testing.assert_array_equal(frame, frames[(32, 128)], err_msg=str(tile))


# -- kernel 2.12: the fused path's shading (csrc/shade.cu) ---------------------


def _shade_both(planes, fb, textured, trilinear, pot, blend, fp16):
    """shade_fused_kernel and shade_fused_plain on the same card planes (the
    plain version's torch ops on the card): (kernel, plain), and the
    kernel's launches (1 each)."""
    from tpu_renderer_torch.kernels import shade
    from test_torch_shade import look

    attrs, meta, inv, hit, atlas = planes
    kw = dict(textured=textured, trilinear=trilinear, pot=pot, **look(fb.device))
    if blend is not None:
        kw.update(fb=fb, hit=hit, blend=blend, fp16=fp16)
    before = shade.fused_counter.launches
    got = shade.shade_fused(attrs, meta, inv, atlas, **kw)
    assert shade.fused_counter.launches == before + 1
    want = shade.shade_fused_plain(attrs, meta, inv, atlas, **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("fp16", [True, False])
@pytest.mark.parametrize("blend", [None, "replace", "add"])
@pytest.mark.parametrize("pot", [True, False])
@pytest.mark.parametrize("trilinear", [True, False])
@pytest.mark.parametrize("textured", [True, False])
@pytest.mark.parametrize("source", ["fused", "peel"])
def test_shade_kernel_matches_plain(cuda, source, textured, trilinear, pot, blend, fp16):
    """Kernel 2.12 equals its plain version bit for bit at every static
    combination and blend, on kernel 2.1's opaque planes and kernel 2.3's
    first peel, every filter mode and both wraps shading (shade_planes)."""
    from test_torch_shade import framebuffer, shade_planes

    planes = shade_planes(cuda, source)
    assert int(planes[3].sum()) > 1000
    got, want = _shade_both(planes, framebuffer(cuda), textured, trilinear, pot, blend, fp16)
    assert got.shape == want.shape == (3 if blend is None else 4, H, W)
    assert _same(got, want)


@pytest.mark.parametrize("trilinear", [True, False])
@pytest.mark.parametrize("case", ["inv0", "lod_low", "lod_high", "uv_far", "no_hits"])
def test_shade_kernel_matches_plain_at_the_edges(cuda, case, trilinear):
    """Kernel 2.12 against its plain version on edge_planes: inv 0, the LOD
    clamped at 0 and at n_levels - 1, u and v far outside [0, 1), a layer
    with no hits (the framebuffer comes back as it was, through fp16); both
    wraps, the rgb form and the additive epilogue."""
    from test_torch_shade import edge_planes, framebuffer

    planes = edge_planes(cuda, case)
    fb = framebuffer(cuda)
    for pot in (True, False):
        for blend in (None, "add"):
            got, want = _shade_both(planes, fb, True, trilinear, pot, blend, True)
            assert _same(got, want), (pot, blend)
    if case == "no_hits":
        assert _same(got, fb)


def test_shade_kernel_in_place_and_its_refusals(cuda):
    """out=fb writes the framebuffer in place (the peel's WHILE body), the
    same words as out of place; out overlapping fb without being it, a
    misaligned atlas or a plane off the card is refused before a launch."""
    from tpu_renderer_torch.kernels import shade
    from test_torch_shade import framebuffer, look, shade_planes

    attrs, meta, inv, hit, atlas = shade_planes(cuda, "peel")
    fb = framebuffer(cuda)
    kw = dict(hit=hit, blend="add", **look(cuda))
    want = shade.shade_fused(attrs, meta, inv, atlas, fb=fb, **kw)
    inplace = fb.clone()
    assert shade.shade_fused(attrs, meta, inv, atlas, fb=inplace, out=inplace, **kw) is inplace
    assert _same(inplace, want)
    before = shade.fused_counter.launches
    wide = torch.zeros((5, H, W), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="apart"):
        shade.shade_fused(attrs, meta, inv, atlas, fb=wide[1:], out=wide[:4], **kw)
    odd = torch.zeros(atlas.quads.numel() + 1, dtype=torch.int32, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        shade.shade_fused(attrs, meta, inv, atlas._replace(quads=odd.view(-1, 4)), fb=fb, **kw)
    with pytest.raises(ValueError, match="inv"):
        shade.shade_fused(attrs, meta, inv.cpu(), atlas, fb=fb, **kw)
    assert shade.fused_counter.launches == before


def test_shade_kernel_against_the_cpu_plain_version(cuda):
    """The card's kernel against the plain version on the CPU, on the same
    planes: the untextured shade is equal bit for bit; the textured one
    differs only at pixels where the LOD's log (logf on the card, torch's
    CPU log) differs by an ulp, which can move the mip level or the
    trilinear weight."""
    from tpu_renderer_torch.kernels import shade
    from tpu_renderer_torch.kernels.common import fma
    from test_torch_shade import framebuffer, look, shade_atlas, shade_planes

    attrs, meta, inv, hit, atlas = shade_planes(cuda)
    h_attrs, h_meta, h_inv, h_hit = (t.cpu() for t in (attrs, meta, inv, hit))
    h_atlas = shade_atlas("cpu")
    fb = framebuffer(cuda)
    for textured in (False, True):
        kw = dict(textured=textured, trilinear=True, pot=False, blend="replace")
        got = shade.shade_fused(attrs, meta, inv, atlas, fb=fb, hit=hit, **kw,
                                **look(cuda)).cpu()
        want = shade.shade_fused(h_attrs, h_meta, h_inv, h_atlas, fb=fb.cpu(), hit=h_hit,
                                 **kw, **look("cpu"))
        differ = (got.view(torch.int32) != want.view(torch.int32)).any(dim=0)
        if not textured:
            assert not differ.any()
            continue
        # rho as sample_texture computes it (its operations but the log are exact)
        du_dx, du_dy, dv_dx, dv_dy = shade.uv_gradients(
            h_attrs[4], h_attrs[5], tuple(h_meta[6 + m] for m in range(6)), h_inv)
        ax, bx = du_dx * h_meta[2], dv_dx * h_meta[3]
        ay, by = du_dy * h_meta[2], dv_dy * h_meta[3]
        rho = torch.maximum(torch.sqrt(fma(ax, ax, bx * bx)), torch.sqrt(fma(ay, ay, by * by)))
        rho = torch.clamp(rho, min=1e-12)
        log_differs = torch.log(rho) != torch.log(rho.to(cuda)).cpu()
        assert not (differ & ~log_differs).any()
        assert int(differ.sum()) < 0.01 * int(h_hit.sum())


@pytest.mark.parametrize("kind", ["bench", "textured-glass"])
@pytest.mark.parametrize("trilinear", [False, True], ids=["one_tap", "two_taps"])
def test_graphed_frame_counts_the_two_tap_instance(cuda, tmp_path, kind, trilinear):
    """Replays of a graphed frame count kernel 2.12's two-tap instance
    (shade.trilinear_counter) as often as the kernel where the scene's
    samplers are LINEAR_MIPMAP_LINEAR, and never on a single-tap scene:
    once a frame on the fused path with untextured glass, 1 + layers with
    the textured glass's peel (counted on the card in the WHILE body); a
    traced block's summary lists the same counts, and kernel 2.13's one
    launch a frame."""
    from tpu_renderer_torch.kernels import shade
    from tpu_renderer_torch.utils import profiling
    from tpu_renderer_torch.utils.demo import build_demo_glb

    path = str(tmp_path / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0, trilinear=trilinear)
    eng = _path_engine(path, cuda, kind)
    assert eng._trilinear is trilinear and eng._scene_taps() == (2 if trilinear else 1)
    frames = 3
    eng.draw()                                 # the capture
    with profiling.tracing():
        eng.draw()                             # the traced key's capture
    shade.fused_counter.reset()
    shade.trilinear_counter.reset()
    with profiling.tracing() as trace:
        for _ in range(frames):
            eng.draw()                         # replays
    layers = int(eng._last_aux["transparent_layers"])
    per_frame = 1 + (layers if kind == "textured-glass" else 0)
    assert kind == "bench" or layers >= 1
    want = {"shade.fused": frames * per_frame,
            "shade.trilinear": frames * per_frame if trilinear else 0,
            "vertex.setup": frames}
    assert len(trace.summary()["frames"]) == frames
    assert trace.summary()["launches"] == want
    for _ in range(frames):
        eng.draw()
    assert shade.fused_counter.total() == 2 * want["shade.fused"]
    assert shade.trilinear_counter.total() == 2 * want["shade.trilinear"]


def test_graphed_glass_frame_counts_the_shade_kernel(cuda, tmp_path, monkeypatch):
    """A graphed textured-glass frame (the peel loop, its layers shaded and
    blended in place by kernel 2.12 inside the WHILE body) equals the same
    frame drawn eagerly with the plain version in the kernel's place, and a
    replay counts 1 + transparent_layers launches of the kernel: the opaque
    pass's and one a layer, counted on the card."""
    from tpu_renderer_torch import pipeline
    from tpu_renderer_torch.kernels import shade
    from tpu_renderer_torch.utils.demo import build_demo_glb

    path = str(tmp_path / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0)
    eng = _path_engine(path, cuda, "textured-glass")
    eng.draw()                                 # the capture
    shade.fused_counter.reset()
    got = eng.draw()                           # a replay
    layers = int(eng._last_aux["transparent_layers"])
    assert layers >= 1
    assert shade.fused_counter.total() == 1 + layers
    monkeypatch.setattr(shade, "shade_fused_kernel", shade.shade_fused_plain)
    shade.fused_counter.reset()
    with pipeline.eager():
        want = eng.draw()
    assert shade.fused_counter.total() == 0
    np.testing.assert_array_equal(got, want)

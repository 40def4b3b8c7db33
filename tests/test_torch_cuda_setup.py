"""Card-only tests of kernel 2.13, the fused path's triangle setup
(kernels/csrc/setup.cu): the kernel against its plain PyTorch version
(vertex.triangle_setup_rows_plain) bit for bit, in rows, boxes and flags, on
grid 64's 1080p setup as render_frame calls it (opaque ++ transparent) at
three cameras of the seq sweep, on random and hand-built edge rows with the
sun given and not, and on inputs off 16-byte boundaries over a partial
block; and a graphed grid 64 frame against the same frame drawn with the
plain version in the kernel's place, with the kernel's launches counted.
They skip without a CUDA device; run them on a machine with an sm_90a card:

    python -m pytest --noconftest tests/test_torch_cuda_setup.py -q -m cuda

(--noconftest: tests/conftest.py sets up JAX, which a machine with the card
need not have; nothing here uses it.)
"""

import numpy as np
import pytest
import torch

from tpu_renderer_torch import pipeline
from tpu_renderer_torch.kernels import vertex
from tpu_renderer_torch.utils import profiling
from test_torch_setup import EDGE_ROWS, SUN, same_bits, setup_inputs, sun_dir
from test_torch_threads import share_cores

share_cores()

pytestmark = pytest.mark.cuda

# yaws of the seq traffic's sweep (0.1 rad from the configuration's 0)
YAWS = (0.0, 0.05, 0.1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build for sm_90a)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def grid64(tmp_path_factory):
    """The bench engine: the demo grid 64 at 1920x1080, camera (0, 6, 128),
    pitch -0.18."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build for sm_90a)")
    from tpu_renderer_torch.utils.bench_frame import bench_engine

    return bench_engine(str(tmp_path_factory.mktemp("grid64") / "bench_scene_64.glb"))


def _differ(got, want) -> str:
    """Where two setups differ: output, rows and columns."""
    out = []
    for name, g, w in zip(("rows", "aabb", "valid"), got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        bad = (g != w).reshape(g.shape[0], -1)
        if bad.any():
            rows = bad.any(dim=1).nonzero().flatten()[:8].tolist()
            cols = bad.any(dim=0).nonzero().flatten().tolist()
            out.append(f"{name}: rows {rows} (of {int(bad.any(dim=1).sum())}), columns {cols}")
    return "; ".join(out)


def _both(args, kwargs):
    """Kernel 2.13 and the plain version on the same call; the kernel's
    launches counted."""
    before = vertex.setup_counter.launches
    got = vertex.triangle_setup_rows_kernel(*args, **kwargs)
    assert vertex.setup_counter.launches == before + 1
    return got, vertex.triangle_setup_rows_plain(*args, **kwargs)


@pytest.mark.parametrize("case", ["random", "edges"])
@pytest.mark.parametrize("sun", [SUN, None], ids=["sun", "no_sun"])
def test_setup_kernel_matches_plain_on_random_and_edge_rows(cuda, case, sun):
    """Random rows (padding, invalid triangles, culled draws, corners behind
    the eye) and the hand-built edge rows (setup_inputs: padding, an
    invisible draw, w = 0, w < 0, 0 < w <= 1e-6, det 0 two ways, a NaN and
    an inf corner) set up alike, bit for bit; the public entry takes the
    kernel on the card."""
    args = setup_inputs(cuda, case)
    got, want = _both(args, dict(sun_dir=sun_dir(cuda, sun)))
    assert same_bits(got, want), (_differ(got, want), EDGE_ROWS)
    before = vertex.setup_counter.launches
    public = vertex.triangle_setup_rows(*args, sun_dir=sun_dir(cuda, sun))
    assert vertex.setup_counter.launches == before + 1
    assert same_bits(public, want)


def test_setup_kernel_on_unaligned_inputs_and_a_partial_block(cuda):
    """Every per-triangle input one row in (pos 36 B, uv and meta6 24 B, mat
    4 B off a 16-byte boundary: the staging's 4-byte path) over 255
    triangles (a block and a partial one), bit for bit the plain version."""
    corners, draw, valid, *rest = setup_inputs(cuda, "random", seed=3)
    args = (vertex.CornerData(*(t[1:] for t in corners)), draw[1:], valid[1:], *rest)
    assert args[0].pos.data_ptr() % 16 and args[0].mat.data_ptr() % 16
    got, want = _both(args, dict(sun_dir=sun_dir(cuda, SUN)))
    assert got[0].shape == (255, 48)
    assert same_bits(got, want), _differ(got, want)


def _captured_setup(eng, monkeypatch):
    """The (args, kwargs) of the setup launch in one eager draw of eng."""
    seen = []
    kernel = vertex.triangle_setup_rows_kernel

    def record(*args, **kwargs):
        seen.append((args, kwargs))
        return kernel(*args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(vertex, "triangle_setup_rows_kernel", record)
        with pipeline.eager():
            eng.draw_device()
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("yaw", YAWS)
def test_setup_kernel_matches_plain_on_grid64_at_1080p(grid64, monkeypatch, yaw):
    """Grid 64's setup at 1920x1080 as render_frame calls it, opaque ++
    transparent (49,154 triangles and the opaque pass's 30 padding rows), at
    a camera of the seq sweep, where the cull leaves most of them live: rows,
    boxes and flags bit for bit."""
    grid64.camera.yaw = np.float32(yaw)
    args, kwargs = _captured_setup(grid64, monkeypatch)
    assert args[0].pos.shape[0] == 49184 and int(args[2].sum()) == 49154
    got, want = _both(args, kwargs)
    assert 0 < int(want[2].sum()) < 49154
    assert same_bits(got, want), _differ(got, want)


def test_graphed_grid64_frame_equals_the_plain_setup_frame(grid64, monkeypatch):
    """A graphed grid 64 frame (kernel 2.13 inside the graph) equals the
    same frame drawn eagerly with the plain version in the kernel's place,
    byte for byte, and a replay counts one launch of 2.13 a frame, which a
    traced block's summary lists under vertex.setup."""
    grid64.camera.yaw = np.float32(YAWS[1])
    frames = 3
    grid64.draw()                              # the capture
    with profiling.tracing():
        grid64.draw()                          # the traced key's capture
    vertex.setup_counter.reset()
    with profiling.tracing() as trace:
        traced = [grid64.draw() for _ in range(frames)]   # replays
    assert trace.summary()["launches"]["vertex.setup"] == frames
    got = grid64.draw()
    assert vertex.setup_counter.total() == frames + 1
    monkeypatch.setattr(vertex, "triangle_setup_rows_kernel", vertex.triangle_setup_rows_plain)
    vertex.setup_counter.reset()
    with pipeline.eager():
        want = grid64.draw()
    assert vertex.setup_counter.total() == 0
    np.testing.assert_array_equal(got, want)
    for image in traced:
        np.testing.assert_array_equal(image, want)

"""The fused path's triangle setup (kernels/vertex.py: triangle_setup_rows,
its plain version triangle_setup_rows_plain and kernel 2.13's wrapper
triangle_setup_rows_kernel) on the CPU: CPU tensors take the plain version
without touching the kernel library; the wrapper refuses what the kernel
does not take with ValueError before any build; kernel 2.13's launch counter
is one a trace's summary lists. The plain version against the JAX package is
in tests/test_torch_vertex.py, the kernel against the plain version in
tests/test_torch_cuda_setup.py; setup_inputs makes the inputs both files set
up.
"""

import numpy as np
import pytest
import torch

from tpu_renderer_torch.kernels import _build, raster, vertex
from tpu_renderer_torch.utils import profiling
from test_torch_threads import share_cores

share_cores()

W, H = 160, 96
T, D = 256, 7
# the rows setup_inputs("edges") writes by hand: row -> what it holds
EDGE_ROWS = {0: "padding (draw -1)", 1: "an invisible draw", 2: "a corner at w = 0",
             3: "a corner behind the eye (w < 0)", 4: "a corner at w = 1e-7 (below 1e-6)",
             5: "three equal corners (det 0)", 6: "three collinear corners (det 0)",
             7: "a NaN corner", 8: "an inf corner", 9: "a live triangle of draw 0"}
# w = 1 - z under the edge case's viewproj; draw 0 is the identity
EDGE_VIEWPROJ = ((1.0, 0.0, 0.0, 0.0), (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 1.0, 0.0),
                 (0.0, 0.0, -1.0, 1.0))


def setup_inputs(device, case: str = "random", seed: int = 0):
    """triangle_setup_rows' positional arguments on `device`: T random
    triangles of D draws (as tests/test_torch_vertex.py's: padding rows, invalid
    triangles, culled draws, corners behind the eye), each with corners of
    its own. case "edges": EDGE_VIEWPROJ, whose products are exact on small
    dyadic corners, and the rows of EDGE_ROWS written by hand."""
    rng = np.random.default_rng(seed)
    V = 3 * T
    positions = rng.normal(size=(V, 3)).astype(np.float32)
    tri_draw = rng.integers(-1, D, size=(T,)).astype(np.int32)
    tri_valid = rng.uniform(size=T) > 0.15
    draw_model = np.tile(np.eye(4, dtype=np.float32), (D, 1, 1))
    draw_model[1:, :3, 3] = rng.normal(scale=2.0, size=(D - 1, 3))
    draw_model[1:, :3, :3] += rng.normal(scale=0.2, size=(D - 1, 3, 3))
    draw_visible = rng.uniform(size=D) > 0.2
    draw_visible[0] = True
    viewproj = np.eye(4, dtype=np.float32)
    viewproj[3, 2] = -1.0
    viewproj[3, 3] = 0.5
    viewproj[:3] += rng.normal(scale=0.1, size=(3, 4)).astype(np.float32)
    if case == "edges":
        viewproj = np.asarray(EDGE_VIEWPROJ, np.float32)
        draw_visible[1] = False
        tri_draw[:10] = (-1, 1, 0, 0, 0, 0, 0, 0, 0, 0)
        tri_valid[:10] = True

        def corner(row, i, xyz):
            positions[3 * row + i] = xyz

        live = ((-0.25, -0.25, 0.5), (0.25, -0.25, 0.5), (0.0, 0.25, 0.25))
        for row in range(10):
            for i in range(3):
                corner(row, i, live[i])
        corner(2, 1, (0.25, 0.25, 1.0))             # w = 1 - 1 = 0
        corner(3, 2, (0.25, 0.25, 3.0))             # w = -2
        corner(4, 0, (0.25, 0.25, 1.0 - 1e-7))      # 0 < w <= 1e-6
        for i in range(3):
            corner(5, i, (0.25, 0.5, 0.5))
            corner(6, i, (0.25 * i, 0.25 * i, 0.5))
        corner(7, 0, (np.nan, 0.25, 0.5))
        corner(8, 1, (0.25, 0.25, np.inf))
    elif case != "random":
        raise ValueError(case)
    corners = vertex.expand_corners(
        positions, rng.normal(size=(V, 3)), rng.uniform(size=(V, 4)),
        rng.uniform(-1, 2, size=(V, 2)), np.arange(V).reshape(T, 3), tri_draw, tri_valid,
        rng.integers(0, 3, size=(D,)).astype(np.int32), rng.uniform(size=(3, 4)),
        rng.integers(0, 64, size=(3, 8)).astype(np.float32), device=device)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
    return (corners, t(tri_draw), t(tri_valid), t(draw_model), t(draw_visible), t(viewproj),
            W, H)


SUN = (0.3, 0.8, -0.5)


def sun_dir(device, sun):
    return None if sun is None else torch.tensor(sun, dtype=torch.float32, device=device)


def same_bits(got, want) -> bool:
    """rows, aabb and valid equal word for word."""
    return all(g.dtype == w.dtype and torch.equal(
        g.view(torch.int32) if g.dtype == torch.float32 else g,
        w.view(torch.int32) if w.dtype == torch.float32 else w) for g, w in zip(got, want))


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything builds or loads the kernel library."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel library was built or loaded")

    for name in ("build", "load_library", "build_tile", "load_tile_library"):
        monkeypatch.setattr(_build, name, refuse)


@pytest.mark.parametrize("case", ["random", "edges"])
@pytest.mark.parametrize("sun", [SUN, None], ids=["sun", "no_sun"])
def test_cpu_tensors_take_the_plain_version(no_build, case, sun):
    args = setup_inputs("cpu", case)
    before = vertex.setup_counter.total()
    got = vertex.triangle_setup_rows(*args, sun_dir=sun_dir("cpu", sun))
    want = vertex.triangle_setup_rows_plain(*args, sun_dir=sun_dir("cpu", sun))
    assert vertex.setup_counter.total() == before
    assert [tuple(x.shape) for x in got] == [(T, 48), (T, 4), (T,)]
    assert same_bits(got, want)


def test_the_edge_rows_hold_what_they_say():
    """setup_inputs("edges") reaches each case of EDGE_ROWS in the plain
    version: the dead rows' flags and empty boxes, the full-frame box of a
    live row with a corner at w <= 1e-6, the live row's own box, and the
    NaN or inf that a NaN or inf corner leaves in the depth plane."""
    args = setup_inputs("cpu", "edges")
    rows, aabb, valid = vertex.triangle_setup_rows_plain(*args, sun_dir=sun_dir("cpu", SUN))
    assert valid[:10].tolist() == [False, False, True, True, True, False, False, False, False,
                                   True], EDGE_ROWS
    empty = torch.tensor([-1.0, -1.0, -2.0, -2.0])
    for row in (0, 1, 5, 6, 7, 8):
        assert torch.equal(aabb[row], empty), EDGE_ROWS[row]
        assert torch.equal(rows[row, :9], torch.tensor([0.0, 0.0, -1.0] * 3)), EDGE_ROWS[row]
    for row in (2, 3, 4):
        assert torch.equal(aabb[row], torch.tensor([0.0, 0.0, W, H])), EDGE_ROWS[row]
    assert 0 < float(aabb[9, 0]) < float(aabb[9, 2]) < W
    assert torch.isnan(rows[7, 9:12]).all() and not torch.isfinite(rows[8, 9:12]).any()
    assert torch.equal(rows[:, 44:48], aabb)
    # det 0 is reached exactly, not through a tiny nonzero determinant
    corners, draw, _, model, visible, viewproj, w, h = args
    p, _, _ = vertex._homogeneous(corners, draw, model, visible, viewproj, w, h,
                                  sun_dir("cpu", SUN))
    e0 = vertex._cross(p[1], p[2])
    det = vertex._dot3(e0[0], p[0][0], e0[1], p[0][1], e0[2], p[0][2])
    assert det[5] == 0.0 and det[6] == 0.0 and det[9] != 0.0


def _refused(case):
    """triangle_setup_rows_kernel's (args, kwargs, match) for a case it must
    refuse, on the CPU."""
    corners, draw, valid, model, visible, viewproj, w, h = setup_inputs("cpu")
    kw = dict(sun_dir=sun_dir("cpu", SUN))
    args = [corners, draw, valid, model, visible, viewproj, w, h]
    if case == "cpu":
        return args, kw, "CUDA tensors"
    if case == "corners_tuple":
        args[0] = tuple(corners)
        return args, kw, "CornerData"
    if case == "pos_shape":
        args[0] = corners._replace(pos=corners.pos[:, :2].contiguous())
        return args, kw, "corners.pos"
    if case == "uv_columns":
        args[0] = corners._replace(uv=torch.zeros((T, 3, 3)))
        return args, kw, "corners.uv"
    if case == "mat_dtype":
        args[0] = corners._replace(mat=corners.mat.long())
        return args, kw, "corners.mat"
    if case == "meta6_strided":
        args[0] = corners._replace(meta6=corners.meta6.t().contiguous().t())
        return args, kw, "corners.meta6 must be contiguous"
    if case == "tri_draw_dtype":
        args[1] = draw.long()
        return args, kw, "tri_draw"
    if case == "tri_valid_dtype":
        args[2] = valid.to(torch.uint8)
        return args, kw, "tri_valid"
    if case == "tri_valid_numpy":
        args[2] = valid.numpy()
        return args, kw, "tri_valid must be a tensor"
    if case == "other_device":
        args[3] = torch.empty(model.shape, device="meta")
        return args, kw, "draw_model must be a tensor on cpu"
    if case == "draw_model_shape":
        args[3] = model[:, :3].contiguous()
        return args, kw, "draw_model"
    if case == "draw_visible_length":
        args[4] = torch.ones(D + 1, dtype=torch.bool)
        return args, kw, "draw_visible"
    if case == "viewproj_dtype":
        args[5] = viewproj.double()
        return args, kw, "viewproj"
    if case == "sun_dir_four":
        return args, dict(sun_dir=torch.tensor([*SUN, 0.0])), "sun_dir"
    if case == "width_float":
        args[6] = float(w)
        return args, kw, "width"
    if case == "height_zero":
        args[7] = 0
        return args, kw, "height"
    if case == "no_draws":
        args[3] = torch.zeros((0, 4, 4))
        args[4] = torch.zeros(0, dtype=torch.bool)
        return args, kw, "at least one draw"
    raise ValueError(case)


@pytest.mark.parametrize("case", ["cpu", "corners_tuple", "pos_shape", "uv_columns",
                                  "mat_dtype", "meta6_strided", "tri_draw_dtype",
                                  "tri_valid_dtype", "tri_valid_numpy", "other_device",
                                  "draw_model_shape", "draw_visible_length", "viewproj_dtype",
                                  "sun_dir_four", "width_float", "height_zero", "no_draws"])
def test_the_wrapper_refuses_before_any_build(no_build, case):
    args, kwargs, match = _refused(case)
    before = vertex.setup_counter.total()
    with pytest.raises(ValueError, match=match):
        vertex.triangle_setup_rows_kernel(*args, **kwargs)
    assert vertex.setup_counter.total() == before


def test_the_trace_lists_the_setup_kernels_launches():
    """LAUNCH_COUNTERS names kernel 2.13's counter, one of the counters a
    frame graph's replay adds to."""
    assert profiling.LAUNCH_COUNTERS["vertex.setup"] == ("vertex", "setup_counter")
    assert vertex.setup_counter in raster._Counter.registry

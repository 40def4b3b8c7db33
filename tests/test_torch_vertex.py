"""Parity of the port's vertex stage (frustum cull, corner expansion and the
48-column fat-row setup) with the JAX package, on identical numpy inputs.

Tolerance (PERF.md): exact against the JAX functions jitted, as the JAX
frame runs them: the port sums each product in XLA's order and fuses each
multiply-add that XLA contracts on the CPU.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_renderer.kernels import vertex as jvertex  # noqa: E402
from tpu_renderer_torch.kernels import vertex  # noqa: E402
from test_torch_threads import share_cores  # noqa: E402

share_cores()

W, H = 160, 96


def _random_inputs(T=256, D=7, V=64, seed=0):
    """Random indexed geometry with padding rows (draw -1), invalid and
    degenerate triangles, culled draws and behind-the-eye corners."""
    rng = np.random.default_rng(seed)
    positions = rng.normal(size=(V, 3)).astype(np.float32)
    normals = rng.normal(size=(V, 3)).astype(np.float32)
    colors = rng.uniform(size=(V, 4)).astype(np.float32)
    uvs = rng.uniform(-1, 2, size=(V, 2)).astype(np.float32)
    tri_vidx = rng.integers(0, V, size=(T, 3)).astype(np.int32)
    tri_draw = rng.integers(-1, D, size=(T,)).astype(np.int32)
    tri_valid = rng.uniform(size=T) > 0.15
    draw_model = np.tile(np.eye(4, dtype=np.float32), (D, 1, 1))
    draw_model[:, :3, 3] = rng.normal(scale=2.0, size=(D, 3))
    draw_model[:, :3, :3] += rng.normal(scale=0.2, size=(D, 3, 3))
    draw_visible = rng.uniform(size=D) > 0.2
    draw_mat = rng.integers(0, 3, size=(D,)).astype(np.int32)
    factors = rng.uniform(size=(3, 4)).astype(np.float32)
    mat_meta = rng.integers(0, 64, size=(3, 8)).astype(np.float32)
    viewproj = np.eye(4, dtype=np.float32)
    viewproj[3, 2] = -1.0
    viewproj[3, 3] = 0.5
    viewproj[:3] += rng.normal(scale=0.1, size=(3, 4)).astype(np.float32)
    return dict(positions=positions, normals=normals, colors=colors, uvs=uvs,
                tri_vidx=tri_vidx, tri_draw=tri_draw, tri_valid=tri_valid,
                draw_model=draw_model, draw_visible=draw_visible,
                draw_mat=draw_mat, factors=factors, mat_meta=mat_meta,
                viewproj=viewproj)


def _t(a):
    return torch.from_numpy(np.array(a))


def _corners(d):
    args = (d["positions"], d["normals"], d["colors"], d["uvs"], d["tri_vidx"],
            d["tri_draw"], d["tri_valid"], d["draw_mat"], d["factors"])
    return (jvertex.expand_corners(*args, mat_meta=d["mat_meta"]),
            vertex.expand_corners(*args, d["mat_meta"], device="cpu"))


@pytest.mark.parametrize("seed", [0, 1])
def test_expand_corners_exact(seed):
    jc, tc = _corners(_random_inputs(seed=seed))
    for f in vertex.CornerData._fields:
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)


@pytest.mark.parametrize("seed,sun", [(0, (0.3, 0.8, -0.5)), (1, None)])
def test_triangle_setup_rows_exact(seed, sun):
    d = _random_inputs(seed=seed)
    jc, tc = _corners(d)
    setup = jax.jit(jvertex.triangle_setup_rows, static_argnums=(6, 7))
    jrows, jaabb, jvalid = setup(
        jc, jnp.asarray(d["tri_draw"]), jnp.asarray(d["tri_valid"]),
        jnp.asarray(d["draw_model"]), jnp.asarray(d["draw_visible"]),
        jnp.asarray(d["viewproj"]), W, H,
        sun_dir=None if sun is None else jnp.asarray(sun, jnp.float32))
    rows, aabb, valid = vertex.triangle_setup_rows(
        tc, _t(d["tri_draw"]), _t(d["tri_valid"]), _t(d["draw_model"]),
        _t(d["draw_visible"]), _t(d["viewproj"]), W, H,
        sun_dir=None if sun is None else torch.tensor(sun))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert 0 < valid.sum() < valid.numel()   # live and dead rows both occur
    np.testing.assert_array_equal(aabb.numpy(), np.asarray(jaabb))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draw_visibility_exact(seed):
    rng = np.random.default_rng(seed)
    D = 64
    model = np.tile(np.eye(4, dtype=np.float32), (D, 1, 1))
    model[:, :3, 3] = rng.normal(scale=3.0, size=(D, 3))
    origin = rng.normal(size=(D, 3)).astype(np.float32)
    extents = rng.uniform(0.1, 2.0, size=(D, 3)).astype(np.float32)
    vp = np.eye(4, dtype=np.float32)
    vp[3, 2], vp[3, 3] = -1.0, 0.2
    want = np.asarray(jax.jit(jvertex.draw_visibility)(
        jnp.asarray(vp), jnp.asarray(model), jnp.asarray(origin),
        jnp.asarray(extents)))
    got = vertex.draw_visibility(_t(vp), _t(model), _t(origin), _t(extents))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < D   # some draws culled, some kept


def test_mat4_mul_matches_jax_matmul():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(4, 4)).astype(np.float32)
    b = rng.normal(size=(9, 4, 4)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, y: jnp.einsum("ij,djk->dik", x, y))(
        jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(vertex.mat4_mul(_t(a), _t(b)).numpy(), want)

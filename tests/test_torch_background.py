"""The port's background passes (kernels 2.9-2.11: on the CPU their plain
versions) against the JAX package's: the Pallas kernels in interpret mode,
the jnp forms its frame runs (pipeline._bg_grad / _bg_sky) and the
*_reference oracles, the last two jitted, as its frame is.

Tolerance (PERF.md): exact, on every element of the padded buffer, wherever
XLA evaluates one expression one way: the sky and the grid against all
three, the gradient against the frame's jnp form and the jitted oracle. The
Pallas gradient kernel contracts its mix differently from the frame's jnp
form under XLA-CPU (measured: at most 2 ulp apart), so no function is exact
against both; the port follows the frame, and is held to the Pallas kernel
within 4 ulp with the count printed. The oracles run eagerly (as
tests/test_background.py runs them, op by op, nothing contracted) are held
at that file's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_renderer import pipeline as jpipeline
from tpu_renderer.kernels import background as jbackground
from tpu_renderer_torch import pipeline
from tpu_renderer_torch.kernels import background
from tpu_renderer_torch.kernels.common import pad_extent
from test_torch_threads import share_cores

share_cores()

EXTENTS = [(200, 100), (256, 64), (333, 222)]
SKY = (0.1, 0.2, 0.4, 0.97)


def _extent(w, h):
    wp, hp = pad_extent(w, h, 32, 128)
    return dict(height=h, width_pad=wp, height_pad=hp)


def _t(v):
    return torch.tensor(np.asarray(v, np.float32))


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _differing(got, want):
    assert got.shape == np.asarray(want).shape
    return int((_bits(got.numpy()) != _bits(want)).sum())


def _ulps(got, want):
    return int(np.abs(_bits(got.numpy()).astype(np.int64) - _bits(want)).max())


@pytest.fixture(params=EXTENTS, ids=lambda e: f"{e[0]}x{e[1]}")
def extent(request):
    return request.param


def _colours(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, 4).astype(np.float32),
            rng.uniform(0, 1, 4).astype(np.float32))


def test_gradient_equals_the_frames_form_and_the_oracle(extent):
    w, h = extent
    ext = _extent(w, h)
    d1, d2 = _colours(w)
    got = background.gradient(_t(d1), _t(d2), **ext)
    hot = jax.jit(lambda a, b: jpipeline._bg_grad(
        a, b, ext["height_pad"], ext["width_pad"], h))(d1, d2)
    assert _differing(got, hot) == 0          # padding included
    ref = jax.jit(lambda a, b: jbackground.gradient_reference(a, b, height=h, width=w))(d1, d2)
    assert _differing(got[:, :h, :w], ref) == 0
    eager = jbackground.gradient_reference(d1, d2, height=h, width=w)
    np.testing.assert_allclose(got[:, :h, :w].numpy(), np.asarray(eager), atol=1e-6)


def test_gradient_against_the_pallas_kernel(extent):
    w, h = extent
    ext = _extent(w, h)
    d1, d2 = _colours(w + 1)
    got = background.gradient(_t(d1), _t(d2), **ext)
    want = jbackground.gradient(jnp.asarray(d1), jnp.asarray(d2), **ext)
    print(f"gradient {w}x{h}: {_differing(got, want)} of {got.numel()} elements differ "
          f"from the Pallas kernel, at most {_ulps(got, want)} ulp")
    assert _ulps(got, want) <= 4


def test_sky_equals_pallas_frame_form_and_oracle(extent):
    w, h = extent
    ext = _extent(w, h)
    got = background.sky(_t(SKY), **ext)
    assert _differing(got, jbackground.sky(jnp.asarray(SKY, jnp.float32), **ext)) == 0
    hot = jax.jit(lambda d: jpipeline._bg_sky(d, ext["height_pad"], ext["width_pad"], h))(
        jnp.asarray(SKY, jnp.float32))
    assert _differing(got, hot) == 0
    ref = jax.jit(lambda d: jbackground.sky_reference(d, height=h, width=w))(
        jnp.asarray(SKY, jnp.float32))
    assert _differing(got[:, :h, :w], ref) == 0
    eager = jbackground.sky_reference(jnp.asarray(SKY, jnp.float32), height=h, width=w)
    # eager XLA contracts nothing: the blend differs by rounding only, except
    # where the 415.9x noise sits on the star threshold
    close = np.isclose(got[:, :h, :w].numpy(), np.asarray(eager), atol=1e-5)
    assert close.mean() > 0.999


def test_grid_gradient_equals_pallas_and_oracle(extent):
    w, h = extent
    ext = _extent(w, h)
    got = background.grid_gradient(width=w, device="cpu", **ext)
    assert _differing(got, jbackground.grid_gradient(width=w, **ext)) == 0
    ref = jax.jit(lambda: jbackground.grid_gradient_reference(height=h, width=w))()
    assert _differing(got[:, :h, :w], ref) == 0
    eager = jbackground.grid_gradient_reference(height=h, width=w)
    np.testing.assert_allclose(got[:, :h, :w].numpy(), np.asarray(eager), atol=1e-6)


# the five cases of tests/test_background.py, through the port


def test_gradient_matches_formula():
    w, h = 200, 100
    d1, d2 = [1.0, 0.0, 0.0, 1.0], [0.0, 0.0, 1.0, 1.0]
    out = background.gradient(_t(d1), _t(d2), **_extent(w, h))
    ref = jbackground.gradient_reference(jnp.array(d1), jnp.array(d2), height=h, width=w)
    np.testing.assert_allclose(out[:, :h, :w].numpy(), np.asarray(ref), atol=1e-6)


def test_gradient_default_is_solid_white():
    # reference defaults: data1 = data2 = (1,1,1,1) (vk_engine.cpp:977-978)
    out = background.gradient(torch.ones(4), torch.ones(4), **_extent(128, 32))
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-7)


def test_sky_matches_formula():
    w, h = 256, 64
    out = background.sky(_t(SKY), **_extent(w, h))
    ref = jbackground.sky_reference(jnp.array(SKY), height=h, width=w)
    np.testing.assert_allclose(out[:, :h, :w].numpy(), np.asarray(ref), atol=1e-5)


def test_sky_has_stars_and_gradient():
    w, h = 256, 128
    out = background.sky(_t(SKY), **_extent(w, h)).numpy()[:, :h, :w]
    assert out[2, : h // 4].mean() < out[2, -h // 4:].mean()
    grad_only = 0.4 * np.arange(h, dtype=np.float32)[:, None] / h
    assert ((out[2] - grad_only) > 0.5).sum() > 0
    np.testing.assert_allclose(out[3], 1.0)


def test_grid_gradient_matches_formula():
    w, h = 256, 64
    out = background.grid_gradient(width=w, device="cpu", **_extent(w, h)).numpy()
    ref = jbackground.grid_gradient_reference(height=h, width=w)
    np.testing.assert_allclose(out[:, :h, :w], np.asarray(ref), atol=1e-6)
    assert (out[0, :h, 16] == 0).all() and (out[1, 32, :w] == 0).all()


# the wrappers


def test_wrappers_refuse_malformed_arguments():
    ext = _extent(256, 64)
    with pytest.raises(TypeError, match="dtype"):
        background.gradient(torch.ones(4, dtype=torch.float64), torch.ones(4), **ext)
    with pytest.raises(ValueError, match="shape"):
        background.sky(torch.ones(3), **ext)
    with pytest.raises(ValueError, match="whole"):
        background.sky(torch.ones(4), height=64, width_pad=200, height_pad=64)
    with pytest.raises(ValueError, match="whole"):
        background.grid_gradient(height=60, width=256, width_pad=256, height_pad=60,
                                 device="cpu")
    with pytest.raises(ValueError, match="height"):
        background.gradient(torch.ones(4), torch.ones(4), height=0, width_pad=256,
                            height_pad=64)


def test_kernel_launchers_refuse_cpu_tensors():
    """The CUDA launchers never run a plain version: a CPU tensor raises."""
    ext = _extent(256, 64)
    before = (background.gradient_counter.launches, background.sky_counter.launches,
              background.grid_counter.launches)
    with pytest.raises(ValueError, match="CUDA"):
        background.background_gradient_kernel(torch.ones(4), torch.ones(4), **ext)
    with pytest.raises(ValueError, match="CUDA"):
        background.background_sky_kernel(torch.ones(4), **ext)
    with pytest.raises(ValueError, match="CUDA"):
        background.background_grid_kernel(width=256, device="cpu", **ext)
    assert before == (background.gradient_counter.launches, background.sky_counter.launches,
                      background.grid_counter.launches)


def test_frame_background_dispatches_on_the_effect():
    """pipeline._background: effect 0 is the gradient, anything above the
    sky (clamped as the JAX frame clamps it); the selector is read from the
    params only when the caller does not give it."""
    ext = _extent(256, 64)
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    p = pipeline.FrameParams(
        view=torch.eye(4), proj=torch.eye(4),
        bg_effect=torch.tensor(1, dtype=torch.int32), bg_data1=f(SKY),
        bg_data2=f((0.5, 0.5, 0.5, 1.0)), ambient=f((0, 0, 0, 0)),
        sun_dir=f((0, 0, 1, 1)), sun_color=f((1, 1, 1, 1)))
    sky = background.sky(p.bg_data1, **ext)
    grad = background.gradient(p.bg_data1, p.bg_data2, **ext)
    assert torch.equal(pipeline._background(p, 64, 256, 64), sky)
    assert torch.equal(pipeline._background(p, 64, 256, 64, effect=0), grad)
    assert torch.equal(pipeline._background(p, 64, 256, 64, effect=7), sky)
    assert torch.equal(pipeline._background(p, 64, 256, 64, effect=-1), grad)
    assert torch.equal(pipeline.background_fb(p, width=200, height=64, effect=1), sky)


def test_sky_lattice_tables_are_the_c_librarys_cosines():
    cx0, cx1, cy0, cy1 = background._sky_tables(64, 256, torch.device("cpu"))
    assert cx0.shape == cx1.shape == (256,) and cy0.shape == cy1.shape == (64,)
    # columns 1.. sit in lattice cell floor(i + 0.2) = i; the next cell's
    # first cosine is this cell's second
    assert torch.equal(cx1[:-1], cx0[1:]) and torch.equal(cy1[1:-1], cy0[2:])
    np.testing.assert_allclose(cx0.numpy(), np.cos(np.arange(256) * 37.0), atol=1e-5)
    assert background._sky_tables(64, 256, torch.device("cpu"))[0] is cx0

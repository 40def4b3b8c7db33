"""CPU tests of how kernels 2.9 and 2.10 lay the frame out over the card
(csrc/background.cu): a torch model of each kernel's layout, one warp a
128-pixel row segment (warp g: segment g % segments of row g / segments),
a lane 4 pixels of it. 2.9's model computes the four mix values once a
lane from its row; 2.10's computes a lane's 10 stars once, on its 5
lattice columns x..x+4 and the lattice rows y and y+1 of the shared
(height_pad + 1) x (width_pad + 1) star lattice (background._sky_lattice),
and blends each pixel's 4 of them. Each model writes every pixel of the
padded buffer exactly once and is held bit for bit to the plain versions
(gradient_plain, sky_plain) and to the JAX package's: for the sky its
Pallas kernel in interpret mode, as tests/test_background.py runs it, and
its frame's jitted form; for the gradient the frame's jitted form exactly
and the Pallas kernel within the 1e-6 of tests/test_background.py (the
Pallas kernel contracts the mix otherwise than the frame's form under
XLA-CPU: PERF.md's tolerance policy).

Extents: 480x270, 1700x900 and 1920x1080, chip_smoke.py's, and the card
tests' 200x100, 256x64 and 333x222.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_renderer import pipeline as jpipeline
from tpu_renderer.kernels import background as jbackground
from tpu_renderer_torch.kernels import background
from tpu_renderer_torch.kernels.common import fma
from test_torch_threads import share_cores

share_cores()

SEGMENT, LANES, VEC = 128, 32, 4
SKY = (0.1, 0.2, 0.4, 0.97)
CASES = [(480, 270), (1700, 900), (1920, 1080), (200, 100), (256, 64), (333, 222)]


def _ids(case):
    return f"{case[0]}x{case[1]}"


def _extent(w, h):
    return dict(height=h, width_pad=-(-w // 128) * 128, height_pad=-(-h // 32) * 32)


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _segments(ext):
    """Each warp's (first pixel column of its segment, row), in warp order."""
    wp, hp = ext["width_pad"], ext["height_pad"]
    segs = wp // SEGMENT
    g = torch.arange(segs * hp)
    return (g % segs) * SEGMENT, g // segs


def _writer(ext):
    """An empty buffer, a count of writes a pixel, and put(values (4, warps,
    128), x0, y) writing each warp's segment of its row."""
    out = torch.full((4, ext["height_pad"], ext["width_pad"]), float("nan"))
    writes = torch.zeros(out.shape[1:], dtype=torch.int32)

    def put(values, x0, y):
        cols = x0[:, None] + torch.arange(SEGMENT)[None, :]
        rows = y[:, None].expand_as(cols)
        out[:, rows, cols] = values
        writes.index_put_((rows, cols), torch.ones_like(cols, dtype=torch.int32),
                          accumulate=True)

    return out, writes, put


def model_gradient(d1, d2, ext):
    """Kernel 2.9's layout: each warp's four mix values computed once from
    its row and stored over its segment."""
    x0, y = _segments(ext)
    out, writes, put = _writer(ext)
    blend = y.to(torch.float32) * (_f32(1.0) / _f32(ext["height"]))
    rest = 1.0 - blend
    mix = fma(d2[:, None], blend[None, :], d1[:, None] * rest[None, :]) + 0.0
    put(mix[:, :, None].expand(4, -1, SEGMENT), x0, y)
    return out, writes


def _star(cx, cy, threshold, span):
    """sky.comp:18-33, as the kernel's star() computes it."""
    v = _fract(_f32(415.92653) * (cx + cy))
    s = (v - threshold) / span
    s2 = s * s
    return torch.where(v >= threshold, s2 * (s2 * s2), _f32(0.0))


def _fract(v):
    return v - torch.floor(v)


def model_sky(d1, ext):
    """Kernel 2.10's layout: a lane's 5 lattice cosines (columns x..x+4),
    the 5 stars on them of lattice row y (above) and of row y+1 (below),
    and the 4 stars of each of its pixels blended as the kernel blends
    them."""
    x0, y = _segments(ext)
    lat_x, lat_y = background._sky_lattice(ext["height_pad"], ext["width_pad"],
                                           torch.device("cpu"))
    out, writes, put = _writer(ext)
    threshold = d1[3]
    span = 1.0 - threshold
    # lanes: (warp, lane) -> first pixel
    x = x0[:, None] + torch.arange(LANES)[None, :] * VEC
    cx = lat_x[x[..., None] + torch.arange(VEC + 1)]                    # (warps, 32, 5)
    above = _star(cx, lat_y[y][:, None, None], threshold, span)
    below = _star(cx, lat_y[y + 1][:, None, None], threshold, span)
    fx = _fract((x[..., None] + torch.arange(VEC)).to(torch.float32) + _f32(0.2))
    rx = 1.0 - fx
    yf = y.to(torch.float32)[:, None, None]
    fy = _fract(yf + _f32(-0.06))
    ry = 1.0 - fy
    a0, a1, b0, b1 = above[..., :VEC], above[..., 1:], below[..., :VEC], below[..., 1:]
    s = fma(a0 * rx, ry, b0 * rx * fy)
    s = fma(a1 * fx, ry, s)
    st = fma(b1 * fx, fy, s)                                              # (warps, 32, 4)
    tint = d1[:3] * (_f32(1.0) / _f32(ext["height"]))
    colour = [tint[c] * yf + st for c in range(3)] + [torch.ones_like(st)]
    put(torch.stack(colour).reshape(4, -1, SEGMENT), x0, y)
    return out, writes


def _bits(t):
    return np.ascontiguousarray(np.asarray(t, np.float32)).view(np.int32)


def _exact(got, want):
    return np.array_equal(_bits(got), _bits(want))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module; the other test workers keep their
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _gradient_references(w, h):
    """The colours of extent w x h and, for them, the plain version, the JAX
    frame's jitted form and the Pallas kernel (interpret mode)."""
    ext = _extent(w, h)
    rng = np.random.default_rng(w)
    d1, d2 = (rng.uniform(0, 1, 4).astype(np.float32) for _ in range(2))
    plain = background.gradient_plain(_f32(d1), _f32(d2), **ext)
    frame = jax.jit(lambda a, b: jpipeline._bg_grad(
        a, b, ext["height_pad"], ext["width_pad"], h))(d1, d2)
    pallas = jbackground.gradient(jnp.asarray(d1), jnp.asarray(d2), **ext)
    return d1, d2, plain, np.asarray(frame), np.asarray(pallas)


@functools.lru_cache(maxsize=None)
def _sky_references(w, h):
    """The plain version, the Pallas kernel and the JAX frame's jitted form
    of the sky at extent w x h."""
    ext = _extent(w, h)
    plain = background.sky_plain(_f32(SKY), **ext)
    pallas = jbackground.sky(jnp.asarray(SKY, jnp.float32), **ext)
    frame = jax.jit(lambda d: jpipeline._bg_sky(d, ext["height_pad"], ext["width_pad"], h))(
        jnp.asarray(SKY, jnp.float32))
    return plain, np.asarray(pallas), np.asarray(frame)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_gradient_model_equals_plain_and_jax(case):
    w, h = case
    d1, d2, plain, frame, pallas = _gradient_references(w, h)
    got, writes = model_gradient(_f32(d1), _f32(d2), _extent(w, h))
    assert bool((writes == 1).all()), "a pixel written other than once"
    assert _exact(got, plain)
    assert _exact(got, frame)
    # the Pallas kernel contracts the mix otherwise than the frame's form:
    # held at tests/test_background.py's tolerance (at 1920x1080 the two
    # forms are 40 ulp apart near 0.05, 1.2e-7 absolute)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_sky_model_equals_plain_and_jax(case):
    w, h = case
    got, writes = model_sky(_f32(SKY), _extent(w, h))
    assert bool((writes == 1).all()), "a pixel written other than once"
    for want in _sky_references(w, h):
        assert _exact(got, want)
    assert float(got[:3].max()) > 0.9          # the sky has stars


@pytest.mark.parametrize("w,h", [(480, 270), (1700, 900), (1920, 1080), (2048, 1088)])
def test_sky_lattice_holds_every_table_value(w, h):
    """The shared lattice gives each pixel the cosines the four tables give
    it, bit for bit: cx0 = lat_x[:-1], cx1 = lat_x[1:] (and so cx1[i] =
    cx0[i + 1]), the same for the rows."""
    ext = _extent(w, h)
    hp, wp = ext["height_pad"], ext["width_pad"]
    cx0, cx1, cy0, cy1 = background._sky_tables(hp, wp, torch.device("cpu"))
    lat_x, lat_y = background._sky_lattice(hp, wp, torch.device("cpu"))
    assert lat_x.shape == (wp + 1,) and lat_y.shape == (hp + 1,)
    for table, lattice in ((cx0, lat_x[:-1]), (cx1, lat_x[1:]), (cy0, lat_y[:-1]),
                           (cy1, lat_y[1:])):
        assert torch.equal(table.view(torch.int32), lattice.view(torch.int32))

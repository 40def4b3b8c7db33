"""Background compute passes: the reference's full-screen compute shaders,
each a hand-written CUDA kernel (csrc/background.cu) beside its plain
PyTorch version.

* ``gradient``: vertical mix(data1, data2, y / height)
  (gradient_color.comp:14-27), the engine's background effect 0.
* ``sky``: star-field noise + vertical colour gradient (sky.comp:17-91),
  the engine's background effect 1.
* ``grid_gradient``: x/width, y/height ramp with black 16-pixel grid lines
  (gradient.comp:11-28; compiled by the reference build but never loaded
  by its engine, vk_engine.cpp:935, nor by this one).

Each returns the planar (4, height_pad, width_pad) f32 framebuffer, padding
included (rows run to height_pad and divide by the unpadded height), the
padded extent whole tile_h x tile_w raster tiles. On a CPU tensor (or
device="cpu") the public function checks its arguments and runs the plain
version, at any tile; on CUDA it hands them to the kernel's launcher, which
checks every argument once (the tile one raster.tile_rule takes), launches
through the library's entry point (looked up once), and raises if it
cannot; inside utils.profiling.debug_mode its output is checked for NaN.

The plain versions spell out the operations as XLA evaluates the JAX
package's forms on the CPU (measured bit-identical to its jitted
pipeline._bg_grad / _bg_sky and background.grid_gradient_reference): a
division by a constant is a multiply by its f32 reciprocal, the gradient's
mix contracts into one fused multiply-add, the star blend into three. The
kernels repeat the same operations, so kernel and plain version agree bit
for bit.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

from tpu_renderer_torch.kernels.common import fma
from tpu_renderer_torch.kernels.raster import (TILE_H, TILE_W, _check, _Counter, _launch,
                                               _raw_stream, check_tile)
from tpu_renderer_torch.utils.profiling import checked

GRID_CELL = 16  # gradient.comp's 16x16 workgroup

gradient_counter = _Counter()
sky_counter = _Counter()
grid_counter = _Counter()


def _f32(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def _recip(n: int, device):
    """1 / n in f32: XLA turns a division by a constant into a multiply by
    this reciprocal on the CPU."""
    return _f32(1.0, device) / _f32(n, device)


def _row_blend(hp: int, height: int, device):
    """y / height per row, as a multiply by the f32 reciprocal."""
    return torch.arange(hp, dtype=torch.float32, device=device) * _recip(height, device)


def _fract(x):
    return x - torch.floor(x)


def _pow6(x):
    """x ** 6 as jnp's integer_pow multiplies it: x2 * (x2 * x2)."""
    x2 = x * x
    return x2 * (x2 * x2)


@functools.lru_cache(maxsize=1)
def _libm_cosf():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.cosf.argtypes = [ctypes.c_float]
    lib.cosf.restype = ctypes.c_float
    return lib.cosf


def _lattice_cos(n: int, offset: float, freq: float, device):
    """cos(floor(i + offset) * freq) and cos((floor(i + offset) + 1) * freq)
    for i < n, as f32 vectors of length n. The star lattice only ever takes
    the cosine of these values, so it is evaluated on the host with the C
    library's cosf: the function XLA calls for the JAX reference on the CPU
    (measured bit-identical), where f32 cos implementations otherwise
    differ by an ulp that 415.9x amplifies."""
    cosf = _libm_cosf()
    i0 = np.floor(np.arange(n, dtype=np.float32) + np.float32(offset))
    out = []
    for base in (i0, i0 + np.float32(1.0)):
        arg = base * np.float32(freq)
        out.append(torch.tensor([cosf(float(a)) for a in arg],
                                dtype=torch.float32, device=device))
    return out


@functools.lru_cache(maxsize=8)
def _sky_tables(hp: int, wp: int, device):
    """The star lattice's four cosine vectors: (cx0, cx1) over columns with
    sky.comp's crawl offset 0.2 and frequency 37, (cy0, cy1) over rows with
    offset -0.06 and frequency 57. Made once per extent and device (a few
    KB each); read-only."""
    return (*_lattice_cos(wp, 0.2, 37.0, device), *_lattice_cos(hp, -0.06, 57.0, device))


@functools.lru_cache(maxsize=8)
def _sky_lattice(hp: int, wp: int, device):
    """Kernel 2.10's star lattice: the column cosines of lattice points 0..wp
    and the row cosines of points 0..hp (point i's is the first cosine of
    column or row i, the last point's the last column's or row's second).
    Neighbours share a point: cx1[i] equals cx0[i + 1] and cy1[j] equals
    cy0[j + 1] bit for bit (the same f32 argument), so the lattice holds
    every value of _sky_tables. Made once per extent and device."""
    cx0, cx1, cy0, cy1 = _sky_tables(hp, wp, device)
    return torch.cat([cx0, cx1[-1:]]), torch.cat([cy0, cy1[-1:]])


def _check_extent(height: int, width_pad: int, height_pad: int, tile_h: int,
                  tile_w: int, device):
    if device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no background pass for device type {device.type}")
    if height < 1:
        raise ValueError(f"height must be positive, got {height}")
    if width_pad < 1 or height_pad < 1 or width_pad % tile_w or height_pad % tile_h:
        raise ValueError(f"the padded extent {width_pad}x{height_pad} must be whole "
                         f"{tile_h}x{tile_w} tiles")


def _check_params(name, t, device):
    _check(name, t, torch.float32, (4,), device)


# ---------------------------------------------------------------------------
# gradient_color.comp: mix(data1, data2, y / height)
# ---------------------------------------------------------------------------


def gradient_plain(data1, data2, *, height: int, width_pad: int, height_pad: int):
    """Plain PyTorch version of background_gradient_kernel."""
    yy = _row_blend(height_pad, height, data1.device)[None, :, None]
    mix = fma(data2[:, None, None], yy, data1[:, None, None] * (1.0 - yy))
    return mix + torch.zeros((4, height_pad, width_pad), dtype=torch.float32,
                             device=data1.device)


def _check_launch(height: int, width_pad: int, height_pad: int, tile_h: int, tile_w: int,
                  device):
    """A launcher's checks of the extent: a tile the kernels are built for,
    and whole tiles of it."""
    check_tile(tile_h, tile_w, "background kernels")
    _check_extent(height, width_pad, height_pad, tile_h, tile_w, device)


@checked
def background_gradient_kernel(data1, data2, *, height: int, width_pad: int,
                               height_pad: int, tile_h: int = TILE_H, tile_w: int = TILE_W):
    """Launch the gradient CUDA kernel on CUDA tensors, every argument
    checked here."""
    dev = data1.device
    if dev.type != "cuda":
        raise ValueError(f"background_gradient_kernel takes CUDA tensors, got {dev}")
    _check_launch(height, width_pad, height_pad, tile_h, tile_w, dev)
    _check_params("data1", data1, dev)
    _check_params("data2", data2, dev)
    out = torch.empty((4, height_pad, width_pad), dtype=torch.float32, device=dev)
    _launch("background_gradient_launch", data1.data_ptr(), data2.data_ptr(), height,
            width_pad, height_pad, out.data_ptr(), _raw_stream(dev))
    gradient_counter.launches += 1
    return out


def gradient(data1, data2, *, height: int, width_pad: int, height_pad: int,
             tile_h: int = TILE_H, tile_w: int = TILE_W):
    """The (4, height_pad, width_pad) f32 gradient background: data1 at the
    top row, towards data2 at row `height`. data1, data2: (4,) f32 tensors
    on one device. CPU tensors take the plain version, CUDA tensors the
    kernel (whose launcher checks the arguments)."""
    dev = data1.device
    extent = dict(height=height, width_pad=width_pad, height_pad=height_pad)
    if dev.type == "cuda":
        return background_gradient_kernel(data1, data2, tile_h=tile_h, tile_w=tile_w,
                                          **extent)
    _check_extent(height, width_pad, height_pad, tile_h, tile_w, dev)
    _check_params("data1", data1, dev)
    _check_params("data2", data2, dev)
    return gradient_plain(data1, data2, **extent)


# ---------------------------------------------------------------------------
# sky.comp: star field + vertical gradient
# ---------------------------------------------------------------------------


def sky_plain(data1, *, height: int, width_pad: int, height_pad: int):
    """Plain PyTorch version of background_sky_kernel."""
    dev = data1.device
    hp, wp = height_pad, width_pad
    r, g, b, threshold = data1[0], data1[1], data1[2], data1[3]
    yy = torch.arange(hp, dtype=torch.float32, device=dev)[:, None].expand(hp, wp)
    xx = torch.arange(wp, dtype=torch.float32, device=dev)[None, :].expand(hp, wp)
    # sky.comp:67-69: crawl offset (0.2, -0.06) * frame 1
    fx = _fract(xx + _f32(0.2, dev))
    fy = _fract(yy + _f32(-0.06, dev))
    cx0, cx1, cy0, cy1 = _sky_tables(hp, wp, dev)
    cx0, cx1, cy0, cy1 = cx0[None, :], cx1[None, :], cy0[:, None], cy1[:, None]

    def star(cx, cy):   # sky.comp:18-33: noise, then threshold + pow6
        v = _fract(_f32(415.92653, dev) * (cx + cy))
        shaped = _pow6((v - threshold) / (1.0 - threshold))
        return torch.where(v >= threshold, shaped, _f32(0.0, dev))

    # bilinear blend of the 4 lattice stars (sky.comp:36-54)
    v1, v2 = star(cx0, cy0), star(cx0, cy1)
    v3, v4 = star(cx1, cy0), star(cx1, cy1)
    st = fma(v1 * (1.0 - fx), 1.0 - fy, v2 * (1.0 - fx) * fy)
    st = fma(v3 * fx, 1.0 - fy, st)
    st = fma(v4 * fx, fy, st)
    # sky.comp:60: rgb * y / height, which XLA reassociates to
    # (rgb * (1 / height)) * y
    recip = _recip(height, dev)
    y1 = torch.arange(hp, dtype=torch.float32, device=dev)[:, None]
    return torch.stack([(r * recip) * y1 + st, (g * recip) * y1 + st,
                        (b * recip) * y1 + st,
                        torch.ones((hp, wp), dtype=torch.float32, device=dev)])


@checked
def background_sky_kernel(data1, *, height: int, width_pad: int, height_pad: int,
                          tile_h: int = TILE_H, tile_w: int = TILE_W):
    """Launch the sky CUDA kernel on a CUDA tensor, every argument checked
    here. The per-pixel work runs on the card; the lattice's cosines
    (width_pad + 1 and height_pad + 1 floats, _sky_lattice) come from the
    host's cosf."""
    dev = data1.device
    if dev.type != "cuda":
        raise ValueError(f"background_sky_kernel takes CUDA tensors, got {dev}")
    _check_launch(height, width_pad, height_pad, tile_h, tile_w, dev)
    _check_params("data1", data1, dev)
    lat_x, lat_y = _sky_lattice(height_pad, width_pad, dev)
    out = torch.empty((4, height_pad, width_pad), dtype=torch.float32, device=dev)
    _launch("background_sky_launch", data1.data_ptr(), lat_x.data_ptr(), lat_y.data_ptr(),
            height, width_pad, height_pad, out.data_ptr(), _raw_stream(dev))
    sky_counter.launches += 1
    return out


def sky(data1, *, height: int, width_pad: int, height_pad: int,
        tile_h: int = TILE_H, tile_w: int = TILE_W):
    """The (4, height_pad, width_pad) f32 sky background. data1: (4,) f32
    tensor, rgb of the gradient at row `height` and the star threshold. A
    CPU tensor takes the plain version, a CUDA tensor the kernel (whose
    launcher checks the arguments)."""
    dev = data1.device
    extent = dict(height=height, width_pad=width_pad, height_pad=height_pad)
    if dev.type == "cuda":
        return background_sky_kernel(data1, tile_h=tile_h, tile_w=tile_w, **extent)
    _check_extent(height, width_pad, height_pad, tile_h, tile_w, dev)
    _check_params("data1", data1, dev)
    return sky_plain(data1, **extent)


# ---------------------------------------------------------------------------
# gradient.comp: UV ramp with 16-pixel grid lines
# ---------------------------------------------------------------------------


def grid_gradient_plain(*, height: int, width: int, width_pad: int, height_pad: int,
                        device):
    """Plain PyTorch version of background_grid_kernel."""
    dev = torch.device(device)
    hp, wp = height_pad, width_pad
    y = torch.arange(hp, device=dev)[:, None].expand(hp, wp)
    x = torch.arange(wp, device=dev)[None, :].expand(hp, wp)
    # gradient.comp:20: black where the 16x16 workgroup-local id is 0
    on = (x % GRID_CELL != 0) & (y % GRID_CELL != 0)
    zero = _f32(0.0, dev)
    r = torch.where(on, x.float() * _recip(width, dev), zero)
    g = torch.where(on, y.float() * _recip(height, dev), zero)
    return torch.stack([r, g, torch.zeros_like(r), torch.ones_like(r)])


@checked
def background_grid_kernel(*, height: int, width: int, width_pad: int,
                           height_pad: int, tile_h: int = TILE_H, tile_w: int = TILE_W,
                           device="cuda"):
    """Launch the grid-gradient CUDA kernel on a CUDA device, every argument
    checked here."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"background_grid_kernel takes a CUDA device, got {dev}")
    _check_launch(height, width_pad, height_pad, tile_h, tile_w, dev)
    if width < 1:
        raise ValueError(f"width must be positive, got {width}")
    out = torch.empty((4, height_pad, width_pad), dtype=torch.float32, device=dev)
    _launch("background_grid_launch", height, width, width_pad, height_pad, out.data_ptr(),
            _raw_stream(dev))
    grid_counter.launches += 1
    return out


def grid_gradient(*, height: int, width: int, width_pad: int, height_pad: int,
                  tile_h: int = TILE_H, tile_w: int = TILE_W, device="cuda"):
    """The (4, height_pad, width_pad) f32 grid-gradient background on
    `device`: the plain version on the CPU, the kernel on CUDA (whose
    launcher checks the arguments)."""
    dev = torch.device(device)
    extent = dict(height=height, width=width, width_pad=width_pad, height_pad=height_pad)
    if dev.type == "cuda":
        return background_grid_kernel(device=dev, tile_h=tile_h, tile_w=tile_w, **extent)
    _check_extent(height, width_pad, height_pad, tile_h, tile_w, dev)
    if width < 1:
        raise ValueError(f"width must be positive, got {width}")
    return grid_gradient_plain(device=dev, **extent)

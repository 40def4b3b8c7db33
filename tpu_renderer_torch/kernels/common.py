"""Shared kernel helpers: tiling and padding arithmetic, and the fused
multiply-add the reference's rounding needs."""

from __future__ import annotations

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def pad_extent(width: int, height: int, tile_h: int, tile_w: int) -> tuple[int, int]:
    """Padded framebuffer extent (the visible extent is cropped at present):
    the width pads to a multiple of the tile width, the height to the tile
    height, so every raster tile is whole."""
    return round_up(width, tile_w), round_up(height, tile_h)


_INF = float("inf")


def fma(a, x, y):
    """Correctly rounded f32 a*x + y (one rounding, as __fmaf_rn).

    torch has no fused multiply-add, so it is computed in float64: a*x is
    exact there, the sum is rounded to odd (round to nearest, then one ulp
    toward the exact sum when inexact and even — its error comes from
    TwoSum), and rounding that to f32 is the correctly rounded result."""
    p = a.double() * x.double()
    yd = y.double()
    s = p + yd
    bb = s - p
    err = (p - (s - bb)) + (yd - bb)
    odd = torch.nextafter(s, torch.where(err > 0, _INF, -_INF))
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    return torch.where(fix, odd, s).float()


def dot3_seq(x0, y0, x1, y1, x2, y2):
    """x0*y0 + x1*y1 + x2*y2 as XLA-CPU evaluates a 3-long reduction or
    einsum of the JAX reference: accumulated in order, each step a fused
    multiply-add (measured)."""
    return fma(x2, y2, fma(x1, y1, x0 * y0))

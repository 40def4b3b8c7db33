"""Peaks of the card and the work of the raster stage, counted from the
scene and the camera by the benchmark's reference (reference.Reference's
counts), never from the program's bins: the same work whatever implements
it, so a share of it cannot pass 100%.

The raster stage (kernels 2.1-2.5) has to find, for every pixel, which
fragments cover it and which of them the depth test keeps. Its least work:

* operations: for every covered fragment, opaque or transparent, its three
  edge functions and its depth plane, each a*X + b*Y + c (two fused
  multiply-adds, 4 flops): 16 flops; for every transparent fragment that
  passes the depth test, the additive blend of its colour (3 flops);
* bytes: the setup of every triangle with a covered fragment read once
  (three edge planes and a depth plane, 12 f32: 48 bytes); for every pixel
  its depth (f32) and its winner (i32) written once; for every pixel the
  transparent pass reaches, its RGBA16F sum written once (8 bytes) - only
  where the frame has transparent fragments, counted over the whole frame.
"""

from __future__ import annotations

# NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit)
PEAK_FLOPS_F32 = 67e12        # float32 outside the tensor cores
PEAK_BYTES = 3.35e12          # HBM3

FLOPS_COVERED = 16
FLOPS_BLEND = 3
BYTES_TRIANGLE = 48
BYTES_PIXEL = 8
BYTES_PIXEL_TRANSPARENT = 8


def raster_work(counts: dict, width: int, height: int) -> tuple:
    """(flops, bytes) of the raster stage for one frame's counts."""
    flops = (FLOPS_COVERED * (counts["opaque_fragments"] + counts["transparent_fragments"])
             + FLOPS_BLEND * counts["transparent_passing"])
    pixels = width * height
    nbytes = (BYTES_TRIANGLE * counts["triangles"] + BYTES_PIXEL * pixels
              + (BYTES_PIXEL_TRANSPARENT * pixels if counts["transparent_passing"] else 0))
    return flops, nbytes


def raster_bound_s(counts: dict, width: int, height: int) -> float:
    """The least time the card could take for the raster stage of a frame:
    the larger of its operations at the float32 peak and its bytes at the
    memory peak."""
    flops, nbytes = raster_work(counts, width, height)
    return max(flops / PEAK_FLOPS_F32, nbytes / PEAK_BYTES)

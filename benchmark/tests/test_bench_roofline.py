"""The raster stage's work, as the reference counts it in blocks, against
a count of every (triangle, pixel) pair by brute force at a tiny size."""

import numpy as np
import pytest
import torch

from benchmark import reference, roofline
from benchmark.scene import demo_scene


def brute_counts(ref, position, yaw, pitch):
    look = ref.look
    W, H = look.width, look.height
    vp = torch.as_tensor(reference.projection(look) @ reference.view_matrix(position, yaw, pitch))
    planes, zplane, _, live = ref._setup(vp)
    X = torch.arange(W, dtype=torch.float64)[None, :].expand(H, W) + 0.5
    Y = torch.arange(H, dtype=torch.float64)[:, None].expand(H, W) + 0.5
    zbest = torch.zeros(H, W, dtype=torch.float64)
    covered = {}
    for t in live.nonzero().flatten().tolist():
        cov = torch.ones(H, W, dtype=torch.bool)
        for e in range(3):
            a, b, c = planes[t, e].tolist()
            val = a * X + b * Y + c
            cov &= (val > 0) | ((val == 0) & ((a > 0) | ((a == 0) & (b > 0))))
        z = zplane[t, 0] * X + zplane[t, 1] * Y + zplane[t, 2]
        cov &= (z >= 0) & (z <= 1)
        if cov.any():
            covered[t] = (cov, z)
            if not ref.transparent[t]:
                zbest = torch.where(cov & (z >= zbest), z, zbest)
    opaque = sum(int(c.sum()) for t, (c, _) in covered.items() if not ref.transparent[t])
    transp = sum(int(c.sum()) for t, (c, _) in covered.items() if ref.transparent[t])
    passing = sum(int((c & (z >= zbest)).sum()) for t, (c, z) in covered.items()
                  if ref.transparent[t])
    return dict(opaque_fragments=opaque, transparent_fragments=transp,
                transparent_passing=passing, triangles=len(covered))


@pytest.mark.parametrize("yaw", [0.0, 0.7])
def test_work_count_matches_brute_force(yaw):
    spec = demo_scene(3, 4, transparent_ratio=0.5)
    ref = reference.Reference(spec, reference.Look(48, 32))
    pos, pitch = np.float32([0.0, 4.0, 7.0]), np.float32(-0.3)
    counts = {}
    ref.render(pos, np.float32(yaw), pitch, counts=counts)
    want = brute_counts(ref, pos, np.float32(yaw), pitch)
    assert {k: counts[k] for k in want} == want
    assert want["opaque_fragments"] > 0 and want["transparent_fragments"] > 0
    flops, nbytes = roofline.raster_work(counts, 48, 32)
    assert flops == 16 * (want["opaque_fragments"] + want["transparent_fragments"]) \
        + 3 * want["transparent_passing"]
    per_pixel = 16 if want["transparent_passing"] else 8
    assert nbytes == 48 * want["triangles"] + per_pixel * 48 * 32


def test_bound_is_the_larger_of_operations_and_bytes():
    counts = dict(opaque_fragments=10 ** 9, transparent_fragments=0, transparent_passing=0,
                  triangles=1)
    assert roofline.raster_bound_s(counts, 1, 1) == pytest.approx(16e9 / roofline.PEAK_FLOPS_F32)
    counts = dict(opaque_fragments=1, transparent_fragments=0, transparent_passing=0,
                  triangles=0)
    assert roofline.raster_bound_s(counts, 1920, 1080) == pytest.approx(
        8 * 1920 * 1080 / roofline.PEAK_BYTES)

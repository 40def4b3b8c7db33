"""The port's raster.pad_for_raster and raster.full_bins against the JAX
package's (tpu_renderer/kernels/raster.py:196-210, :509-516) on seeded
numpy inputs: exact (integer and float outputs alike), at the JAX test
tier's CHUNK; and at the port's own CHUNK."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_renderer.kernels import raster as jraster  # noqa: E402
from tpu_renderer_torch.kernels import raster  # noqa: E402
from test_torch_threads import share_cores  # noqa: E402

share_cores()


def _inputs(t, seed):
    rng = np.random.default_rng(seed)
    packed = rng.standard_normal((t, 16)).astype(np.float32)
    aabb = (rng.random((t, 4)) * 200).astype(np.float32)
    valid = rng.random(t) < 0.7
    return packed, aabb, valid


@pytest.mark.parametrize("t", [1, 7, 8, 13, 32, 45])
def test_pad_for_raster_equals_jax(t):
    packed, aabb, valid = _inputs(t, seed=t)
    want = jraster.pad_for_raster(jnp.asarray(packed), jnp.asarray(aabb), jnp.asarray(valid))
    got = raster.pad_for_raster(torch.from_numpy(packed), torch.from_numpy(aabb),
                                torch.from_numpy(valid), chunk=jraster.CHUNK)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[0].shape[0] % jraster.CHUNK == 0


def test_pad_for_raster_at_the_port_chunk():
    packed, aabb, valid = _inputs(45, seed=3)
    p, a, v = raster.pad_for_raster(torch.from_numpy(packed), torch.from_numpy(aabb),
                                    torch.from_numpy(valid))
    assert p.shape == (64, 16) and a.shape == (64, 4) and v.shape == (64,)
    np.testing.assert_array_equal(p[:45].numpy(), packed)
    assert (p[45:] == 0).all() and not v[45:].any()
    assert (a[45:] == torch.tensor([-1.0, -1.0, -2.0, -2.0])).all()


@pytest.mark.parametrize("n_chunks,n_tiles,bin_cap", [(1, 1, 1), (3, 4, 8), (5, 6, 5),
                                                       (0, 2, 4)])
def test_full_bins_equals_jax(n_chunks, n_tiles, bin_cap):
    want = jraster.full_bins(n_chunks, n_tiles, bin_cap)
    got = raster.full_bins(n_chunks, n_tiles, bin_cap, device="cpu")
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.int32 and g.shape == w.shape and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), w)


def test_full_bins_refuses_a_small_cap():
    with pytest.raises(ValueError, match="bin_cap"):
        raster.full_bins(5, 2, 4, device="cpu")

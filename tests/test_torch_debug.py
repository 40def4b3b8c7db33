"""The port's debug_mode (tpu_renderer_torch/utils/profiling.py), the analog
of the JAX package's utils.profiling.debug_mode (jax_debug_nans): inside it
the first torch operation or kernel wrapper that writes a NaN raises
FloatingPointError naming it; infinities pass; the demo frame (grid 2,
256x64) passes and is byte for byte the frame outside it; the mode is off
after the block, after a raise too. On the CPU the kernel wrappers' check
is driven through a stand-in wrapper (no CUDA kernel runs here)."""

import os

import numpy as np
import pytest
import torch

from tpu_renderer_torch.config import RendererConfig
from tpu_renderer_torch.engine import Engine
from tpu_renderer_torch.utils import profiling
from tpu_renderer_torch.utils.demo import build_demo_glb
from test_torch_threads import share_cores

share_cores()


def test_a_nan_raises_and_names_the_op():
    x = torch.tensor([0.0, 1.0])
    with pytest.raises(FloatingPointError, match=r"nan.*aten\.div"):
        with profiling.debug_mode():
            x / x
    assert not profiling._nan_checking()


def test_an_infinity_passes():
    x = torch.tensor([0.0, 1.0])
    with profiling.debug_mode():
        y = 1.0 / x
        z = torch.nextafter(y, torch.tensor(float("inf")))
    assert torch.isinf(y[0]) and torch.isinf(z[0])


def test_the_mode_is_off_after_the_block():
    with profiling.debug_mode():
        assert profiling._nan_checking()
    assert not profiling._nan_checking()
    x = torch.tensor([0.0])
    assert torch.isnan(x / x).all()     # no check outside the block


def test_unwritten_memory_is_not_checked():
    """torch.empty may hand out NaN bit patterns; only what writes counts."""
    with profiling.debug_mode():
        for _ in range(20):
            torch.empty(4096).fill_(1.0)


def test_kernel_wrappers_are_checked():
    """A checked wrapper's outputs are held to the same rule inside the
    mode (the CUDA kernels write them through ctypes, unseen by torch's
    dispatch), and not outside it; every kernel wrapper is checked."""
    from tpu_renderer_torch.kernels import background, raster

    @profiling.checked
    def fake_kernel(n):
        out = torch.zeros(n)
        out.numpy()[0] = np.nan     # written behind torch's back
        return out, torch.zeros(n, dtype=torch.int32)

    assert torch.isnan(fake_kernel(2)[0][0])
    with pytest.raises(FloatingPointError, match="fake_kernel"):
        with profiling.debug_mode():
            fake_kernel(2)
    names = ("raster_fused_kernel", "raster_accum_kernel", "raster_peel_fused_kernel",
             "raster_deferred_kernel", "raster_peel_kernel", "raster_fused_gathered_kernel",
             "raster_accum_gathered_kernel", "raster_peel_gathered_kernel")
    for mod, fns in ((raster, names), (background, ("background_gradient_kernel",
                                                    "background_sky_kernel",
                                                    "background_grid_kernel"))):
        for n in fns:
            assert getattr(mod, n).__wrapped__.__name__ == n


def test_demo_frame_passes_unchanged(tmp_path):
    path = os.path.join(tmp_path, "demo.glb")
    build_demo_glb(path, grid=2, seed=0)

    def engine():
        eng = Engine(RendererConfig(width=256, height=64, camera_position=(0.0, 4.0, 4.4),
                                    background_effect=1), device="cpu")
        eng.camera.pitch = np.float32(-0.15)
        eng.init(scene_path=path)
        return eng

    want = engine().draw()
    with profiling.debug_mode():
        got = engine().draw()
    np.testing.assert_array_equal(got, want)
    assert not profiling._nan_checking()

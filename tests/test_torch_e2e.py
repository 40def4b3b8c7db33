"""End-to-end pin of the port: pipeline.render_frame against the
INDEPENDENT numpy renderer of tests/test_e2e_reference.py (per-draw vertex
transform, per-pixel homogeneous barycentric raster with the top-left rule
and reversed-Z, bilinear REPEAT sampling, lambert-with-floor lighting,
additive transparency), on that test's scene at 64x32, on the CPU.

Tolerance: the JAX package's own bound for this comparison, at most 3
unorm8 steps on any channel (fp16 framebuffer rounding and float32 against
float64 association); the test prints what it measured.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from tests.test_e2e_reference import (  # noqa: E402
    AMBIENT, BG, H, SUN, SUN_POWER, W, _build_scene, _reference_render)
from tpu_renderer_torch import scene as scene_mod  # noqa: E402
from tpu_renderer_torch.pipeline import FrameParams, render_frame  # noqa: E402
from tpu_renderer_torch.present import unpack_u8  # noqa: E402
from test_torch_threads import share_cores  # noqa: E402

share_cores()


def _params():
    f = lambda v: torch.tensor(np.asarray(v, np.float32))  # noqa: E731
    return FrameParams(
        view=torch.eye(4), proj=torch.eye(4), bg_effect=torch.tensor(0, dtype=torch.int32),
        bg_data1=f(BG), bg_data2=f(BG), ambient=f([*AMBIENT, 0.0]),
        sun_dir=f([*SUN, 1.0]), sun_color=f([1, 1, 1, SUN_POWER]))


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    path, tex = _build_scene(tmp_path_factory.mktemp("e2e"))
    scene = scene_mod.load_scene(path)
    flat = scene_mod.flatten_scene(scene, mipmapped=False, device="cpu")
    img, aux = render_frame(flat.buffers, _params(), width=W, height=H, bin_cap=64)
    return dict(got=unpack_u8(img)[..., :3], aux=aux,
                want=_reference_render(scene, tex))


def test_pipeline_matches_independent_numpy_reference(frames):
    got, want = frames["got"], frames["want"]
    # the scene covers a meaningful part of the frame
    bg_u8 = (BG[:3] * 255 + 0.5).astype(int)
    nonbg = (np.abs(want.astype(int) - bg_u8).sum(-1) > 6).sum()
    assert nonbg > W * H * 0.3, f"only {nonbg} non-background pixels"
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"port against the numpy reference: largest difference {diff.max()} of 255, "
          f"{int((diff > 0).any(-1).sum())} of {W * H} pixels differ")
    assert diff.max() <= 3, (
        f"max diff {diff.max()} at {np.unravel_index(diff.argmax(), diff.shape)}")
    assert int(frames["aux"]["transparent_layers"]) >= 1


"""The reference agrees with the program's CPU frame at a small size, on
both configurations, by the comparison that decides `correct`."""

import json
import os

import numpy as np
import pytest

from benchmark import check, harness, reference
from benchmark.scene import demo_scene, write_glb


@pytest.mark.parametrize("config_name", ["grid64-1080p", "glass64-1080p"])
@pytest.mark.parametrize("yaw", [0.0, 0.4])
def test_reference_matches_program_cpu_frame(config_name, yaw, tmp_path):
    with open(os.path.join(harness.HERE, "configs", config_name + ".json")) as f:
        config = json.load(f)
    config["extent"] = {"width": 160, "height": 96}
    config["scene"]["grid"] = 6
    config["camera"]["position"] = [0.0, 6.0, 12.0]
    spec, eng = harness._build_engine(config, "cpu", str(tmp_path))
    eng.camera.yaw = np.float32(yaw)
    got = eng.draw()
    assert eng._transp_textured() == config["path"]["peel"]
    ref = reference.Reference(spec, harness.look_of(config))
    want = ref.render(np.asarray(config["camera"]["position"], np.float32), np.float32(yaw),
                      np.float32(config["camera"]["pitch"])).numpy()
    numbers = check.frame_numbers(got, want)
    print(config_name, yaw, numbers)
    bg = np.all(want[..., :3] == 255, -1).mean()
    assert bg < 0.9, "the frame must show the scene"
    verdict = check.judge([numbers], config["correct_limits"])
    assert verdict["correct"], verdict


def test_frozen_generator_is_the_programs():
    """demo_scene + write_glb write the program's demo GLB byte for byte."""
    from tpu_renderer_torch.utils.demo import build_demo_glb
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for grid, seed in ((4, 0), (6, 9)):
            a = open(build_demo_glb(os.path.join(tmp, "a.glb"), grid=grid, seed=seed), "rb").read()
            b = open(write_glb(demo_scene(grid, seed), os.path.join(tmp, "b.glb")), "rb").read()
            assert a == b

"""The trilinear configuration (benchmark/configs/grid64-trilinear-1080p.json,
the cell grid64-trilinear.seq: stock glTF's LINEAR_MIPMAP_LINEAR sampler)
at a CPU test's size: the port's frames against the benchmark's plain
reference (benchmark/reference.py) through its check (benchmark/check.py),
within the configuration's limits; the same run with the sampler held to
one mip tap fails every limit, so the check sees the second tap; and the
Engine takes the two-tap sampler on the configuration's scene and one tap
on grid64-1080p's, as its set-up record says.

The card's side (the two-tap instance of kernel 2.12 counted in a graphed
frame) is in tests/test_torch_cuda.py."""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import check, harness  # noqa: E402
from tpu_renderer_torch.kernels import shade  # noqa: E402
from tpu_renderer_torch.utils import profiling  # noqa: E402
from test_torch_threads import share_cores  # noqa: E402

share_cores()

CELL = "grid64-trilinear.seq"


def _config(name: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


def _small(config: dict, mix: dict) -> None:
    """The cell at 192x108: grid 8 seen from (0, 6, 24), two-frame batches."""
    config["extent"] = {"width": 192, "height": 108}
    config["scene"]["grid"] = 8
    config["camera"]["position"] = [0.0, 6.0, 24.0]
    mix["batch_frames"] = 2


def test_the_cell_is_declared_as_the_configuration_says():
    bench = harness.load_benchmark()
    cell, config, mix = harness.find_cell(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("grid64-trilinear-1080p", "seq", 1)
    assert config == _config("grid64-trilinear-1080p")
    single = _config("grid64-1080p")
    # grid64-1080p with the sampler changed, and nothing else
    for key in ("extent", "camera", "look", "renderer", "precision", "path",
                "correct_limits", "assumed", "reduced"):
        assert config[key] == single[key], key
    assert config["scene"] == dict(single["scene"], trilinear=True)
    assert mix["loop"] == "sequence"


@pytest.mark.parametrize("taps", [2, 1], ids=["two_taps", "held_to_one_tap"])
def test_the_check_sees_the_second_mip_tap(taps, monkeypatch):
    """A whole run of the cell through the harness (set-up shortened: one
    warm-up frame, no settling), its sampled frames judged against the
    reference at the configuration's own limits."""
    original = shade.shade_fused
    asked = []

    def shade_fused(*args, **kwargs):
        asked.append(kwargs["trilinear"])
        if taps == 1:
            kwargs["trilinear"] = False
        return original(*args, **kwargs)

    monkeypatch.setattr(shade, "shade_fused", shade_fused)
    monkeypatch.setattr(harness, "WARM_FRAMES", 1)
    monkeypatch.setattr(harness, "SETTLE_MIN_S", 0.0)
    result = harness.run_cell(CELL, 3, 0.0, False, device="cpu", adjust=_small)
    assert asked and all(asked)           # the engine asked for two taps every time
    limits = _config("grid64-trilinear-1080p")["correct_limits"]
    numbers = {k: v["value"] for k, v in result["checks"].items()}
    print(taps, numbers)
    assert {k: v["limit"] for k, v in result["checks"].items()} == limits
    assert set(numbers) == set(check.NUMBERS)
    if taps == 2:
        assert result["correct"] is True and result["failed"] == 0
        assert all(numbers[k] <= limits[k] for k in check.NUMBERS), numbers
    else:
        assert result["correct"] is False and result["failed"] >= 1
        assert all(numbers[k] > limits[k] for k in check.NUMBERS), numbers


@pytest.mark.parametrize("config,taps", [("grid64-trilinear-1080p", 2), ("grid64-1080p", 1)])
def test_the_engine_takes_the_configurations_sampler(config, taps, tmp_path):
    """Engine.init on the configuration's full scene (grid 64, 1920x1080),
    built as the harness builds it: the sampler statics that pick kernel
    2.12's instance, and the set-up record that carries them."""
    _, eng = harness._build_engine(_config(config), torch.device("cpu"), str(tmp_path))
    assert eng._trilinear is (taps == 2)
    assert eng._scene_taps() == taps and eng._pot is True
    init = [r for r in profiling.setup_record() if r["name"] == "Engine.init"][-1]
    assert (init["taps"], init["pot"]) == (taps, True)

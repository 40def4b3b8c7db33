"""The lower-precision control (the reference with its shading in
bfloat16, in the program's place) comes out not correct under the
configurations' limits, at a size a test run holds."""

import pytest

from benchmark import control


@pytest.mark.parametrize("cell", ["grid64.seq", "glass64.seq", "grid64.view"])
def test_control_is_not_correct(cell):
    def small(config, mix):
        config["extent"] = {"width": 192, "height": 108}
        config["scene"]["grid"] = 8
        config["camera"]["position"] = [0.0, 6.0, 16.0]

    for line in control.control_readings(cell, [7, 8, 9], frames=40, device="cpu",
                                         adjust=small):
        print(line["seed"], {k: v["value"] for k, v in line["numbers"].items()})
        assert line["correct"] is False
        assert any(v["value"] > v["limit"] for v in line["numbers"].values())

"""The benchmark's own tests: CPU at tiny sizes, plus one test marked
`cuda` that runs a cell on the card and skips without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny(config: dict, mix: dict) -> None:
    """A cell cut to a CPU test's size: 96x64, a 4x4 grid seen from
    (0, 6, 8), two-frame batches, a camera step large enough that
    consecutive frames differ."""
    config["extent"] = {"width": 96, "height": 64}
    config["scene"]["grid"] = 4
    config["camera"]["position"] = [0.0, 6.0, 8.0]
    if mix["loop"] == "sequence":
        mix["batch_frames"] = 2
    mix["yaw_step"] = 0.05


@pytest.fixture
def small():
    return tiny

"""The comparison that decides a run's `correct`.

The frames compared are frames the timed path produced in the window: a
sample of SAMPLE of them in pairs of consecutive frames, drawn from the
run's seed over all the window's frames as they come (a reservoir), kept
as the program returned them.
Once the window has closed and the program is freed, the reference
(reference.py) renders each sampled frame's camera anew from the
generator's arrays, and each frame is judged by two numbers:

* px_off_share: the share of the frame's pixels where a channel differs
  from the reference's by more than OFF_STEPS unorm8 steps;
* mean_abs_u8: the mean absolute difference over the pixels' r, g and b,
  in unorm8 steps;
* block_off_max: the largest share of such pixels in any whole BLOCK x
  BLOCK block of the frame, which a fault confined to a few raster tiles
  moves where the two shares above barely do.

A run is correct when some frame was compared and, in the worst compared
frame, each number is within the limit the configuration file states
(`correct_limits`); PERF.md gives the readings each limit was set from.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

SAMPLE = 6
OFF_STEPS = 2
BLOCK = 32
NUMBERS = ("px_off_share", "mean_abs_u8", "block_off_max")


class Reservoir:
    """A uniform sample of SAMPLE items of a stream, drawn with rng, kept
    in SAMPLE // 2 pairs of consecutive items (2k, 2k + 1): a fault that
    leaves every other frame out delivers a wrong frame in every pair."""

    def __init__(self, rng: np.random.Generator, size: int = SAMPLE):
        self.rng, self.pairs, self.seen, self.last = rng, size // 2, 0, None
        self.kept: Dict[int, Dict[int, object]] = {}

    def offer(self, index: int, make) -> None:
        """Offer stream item `index`; make() gives it, called only when the
        item is kept."""
        key = index // 2
        if key in self.kept:
            self.kept[key][index] = make()
            return
        if key == self.last:          # the pair was drawn at its first item, and not kept
            return
        self.last = key
        if len(self.kept) < self.pairs:
            self.kept[key] = {index: make()}
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.pairs:
                del self.kept[sorted(self.kept)[j]]
                self.kept[key] = {index: make()}
        self.seen += 1

    @property
    def items(self) -> Dict[int, object]:
        return {i: item for pair in self.kept.values() for i, item in pair.items()}


def frame_numbers(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    """The two numbers of one (H, W, 4) uint8 frame against the reference's."""
    if got.shape != want.shape:
        return {"px_off_share": 1.0, "mean_abs_u8": 255.0, "block_off_max": 1.0}
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    off = diff.max(-1) > OFF_STEPS
    h, w = off.shape[0] // BLOCK * BLOCK, off.shape[1] // BLOCK * BLOCK
    blocks = off[:h, :w].reshape(h // BLOCK, BLOCK, w // BLOCK, BLOCK).mean((1, 3))
    return {"px_off_share": float(off.mean()), "mean_abs_u8": float(diff[..., :3].mean()),
            "block_off_max": float(blocks.max()) if blocks.size else float(off.mean())}


def judge(per_frame: List[Dict[str, float]], limits: Dict[str, float]) -> dict:
    """Worst number over the compared frames, beside its limit; how many
    frames were over a limit; and whether the run is correct."""
    worst = {k: max((f[k] for f in per_frame), default=None) for k in NUMBERS}
    over = sum(any(f[k] > limits[k] for k in NUMBERS) for f in per_frame)
    correct = bool(per_frame) and over == 0
    return {"correct": correct, "failed": over,
            "numbers": {k: {"value": worst[k], "limit": limits[k]} for k in NUMBERS}}

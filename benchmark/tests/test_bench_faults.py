"""A run whose timed path is broken underneath comes out not correct: the
program's frame function, replaced below the harness, returns a stale
frame, leaves half of the frames out, or loses a raster tile of each frame
where it is produced. (The cells run on one chip: no exchange between
chips to leave out.)"""

import numpy as np
import pytest
import torch

from benchmark import check, harness


def _stale(render):
    first = {}

    def frame(*args, **kwargs):
        image, aux = render(*args, **kwargs)
        first.setdefault("image", image.clone())
        return first["image"].clone(), aux       # the state never moves on
    return frame


def _half(render):
    last, n = {}, [0]

    def frame(*args, **kwargs):
        n[0] += 1
        if n[0] % 2 == 0 and "image" in last:     # every other frame left out
            return last["image"].clone(), last["aux"]
        image, aux = render(*args, **kwargs)
        last.update(image=image, aux=aux)
        return image, aux
    return frame


def _tile(render):
    def frame(*args, **kwargs):
        image, aux = render(*args, **kwargs)
        image = image.clone()
        image[:32, :32] = torch.tensor(0x12345678, dtype=image.dtype)
        return image, aux
    return frame


@pytest.mark.parametrize("fault", [_stale, _half, _tile], ids=["stale", "half", "tile"])
@pytest.mark.parametrize("cell", ["grid64.seq", "glass64.seq", "grid64.view"])
def test_broken_timed_path_is_not_correct(cell, fault, small, monkeypatch):
    from tpu_renderer_torch import engine

    monkeypatch.setattr(engine, "render_frame", fault(engine.render_frame))

    def adjust(config, mix):
        small(config, mix)
        if mix["loop"] == "sequence":
            mix["batch_frames"] = 4

    seconds = 4.0 if cell.endswith(".view") else 0.0
    result = harness.run_cell(cell, 11, seconds, False, device="cpu", adjust=adjust)
    print(cell, fault.__name__, {k: v["value"] for k, v in result["checks"].items()})
    assert result["correct"] is False
    assert result["failed"] >= 1


@pytest.mark.parametrize("first", [0, 1])
def test_sample_holds_consecutive_pairs(first):
    """Each compared frame comes with its neighbour (2k, 2k + 1), so a
    fault that leaves every other frame out shows in every pair."""
    for seed in range(20):
        sample = check.Reservoir(np.random.default_rng([seed, 1]))
        for i in range(first, 3000):
            sample.offer(i, lambda i=i: i)
        kept = sorted(sample.items)
        assert len(kept) == check.SAMPLE
        assert all(i ^ 1 in kept for i in kept)

"""Time the background kernels 2.9-2.11 and torch.lerp three ways, in turns.

    python3 -m tpu_renderer_torch.tools.time_background [--width 1920]
        [--height 1080] [--rounds 4] [--launches 50] [--label NAME]

The subjects: background.background_gradient_kernel (2.9),
background_sky_kernel (2.10), background_grid_kernel (2.11), and one
torch.lerp over 2.9's broadcast row blend (the PyTorch call that computes
2.9's function). Four readings of each, in ms, by utils/timing.py:

* device ms a launch (device_ms): one pair of CUDA events around the replay
  of a CUDA graph that captured `launches` calls, over the count: the
  card's time alone;
* host ms a call (host_ms): time.perf_counter around `launches` calls
  after warm-up, with no synchronise: what the host spends to enqueue one;
* batched ms a call (batched_ms): one pair of CUDA events around
  `launches` back-to-back calls, over the count, as chip_smoke.py timed
  2.9-2.11 before it had device_ms: the larger of the two above;
* device ms a launch into fresh memory (device_fresh_ms): as device_ms,
  but every captured call keeps its own output, so no launch rewrites a
  buffer the L2 cache still holds.

Each round takes the subjects in order and the next round in reverse
(2.9, lerp, 2.10, 2.11, 2.11, 2.10, lerp, 2.9, ...). Then, in the same
way, the host ms of the pieces of one call of 2.9: the public
background.gradient, the launcher, its checks, its torch.empty, its
stream lookup and its library lookup. Prints one JSON line a reading, then
the card's name and power limit.

It calls only the public wrappers and _check_extent / _check_params of
kernels.background, _build.load_library and utils/timing.py, so the same
file times another checkout of the package placed first on PYTHONPATH
(copy utils/timing.py into one that lacks it):

    PYTHONPATH=path/to/other/checkout python3 tpu_renderer_torch/tools/time_background.py

Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from tpu_renderer_torch.utils.timing import batched_ms, device_ms, host_ms

SUBJECTS = ("background_gradient_kernel", "lerp", "background_sky_kernel",
            "background_grid_kernel")


def readings(fn, launches: int) -> dict:
    """The three readings of fn, in ms."""
    return dict(device_ms=device_ms(fn, launches), host_ms=host_ms(fn, launches),
                batched_ms=batched_ms(fn, launches))


def pad(w: int, h: int):
    """The padded extent (width_pad, height_pad) of whole 32x128 tiles."""
    return -(-w // 128) * 128, -(-h // 32) * 32


def subject_calls(w: int, h: int, device) -> dict:
    """subject -> a no-argument call of it at extent w x h, on the inputs
    chip_smoke.py's phase 8 gives the background kernels."""
    from tpu_renderer_torch.kernels import background

    wp, hp = pad(w, h)
    ext = dict(height=h, width_pad=wp, height_pad=hp)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    d1, d2, sky = f((0.9, 0.3, 0.2, 1.0)), f((0.1, 0.2, 0.7, 0.5)), f((0.1, 0.2, 0.4, 0.97))
    a, b, t = lerp_operands(d1, d2, h, wp, hp)
    return {
        "background_gradient_kernel": lambda: background.background_gradient_kernel(d1, d2, **ext),
        "lerp": lambda: torch.lerp(a, b, t),
        "background_sky_kernel": lambda: background.background_sky_kernel(sky, **ext),
        "background_grid_kernel": lambda: background.background_grid_kernel(
            width=w, device=device, **ext),
    }


def lerp_operands(d1, d2, height: int, wp: int, hp: int):
    """torch.lerp's (start, end, weight) for 2.9's function: the two colours
    and the row blend y / height, broadcast to (4, hp, wp) without copies."""
    blend = torch.arange(hp, dtype=torch.float32, device=d1.device) / height
    return (v.expand(4, hp, wp) for v in (d1[:, None, None], d2[:, None, None],
                                         blend[None, :, None]))


def launch_pieces(w: int, h: int, device) -> dict:
    """piece -> a no-argument call of one piece of a call of 2.9: the public
    function, the launcher, and the launcher's checks, output allocation,
    stream lookup (and torch's own raw one) and library lookup."""
    from tpu_renderer_torch.kernels import _build, background

    wp, hp = pad(w, h)
    ext = dict(height=h, width_pad=wp, height_pad=hp)
    d1 = torch.tensor((0.9, 0.3, 0.2, 1.0), device=device)
    d2 = torch.tensor((0.1, 0.2, 0.7, 0.5), device=device)

    def checks():
        background._check_extent(h, wp, hp, 32, 128, d1.device)
        background._check_params("data1", d1, d1.device)
        background._check_params("data2", d2, d1.device)

    return {
        "gradient (public)": lambda: background.gradient(d1, d2, **ext),
        "background_gradient_kernel (launcher)":
            lambda: background.background_gradient_kernel(d1, d2, **ext),
        "checks": checks,
        "torch.empty": lambda: torch.empty((4, hp, wp), dtype=torch.float32, device=device),
        "current_stream": lambda: torch.cuda.current_stream(device).cuda_stream,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(d1.device.index),
        "load_library": _build.load_library,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--launches", type=int, default=50)
    ap.add_argument("--label", default="", help="a name for this run's lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_background: no CUDA device", file=sys.stderr)
        return 1
    from tpu_renderer_torch.utils.bench_frame import nvidia_smi

    card = nvidia_smi()
    dev = torch.device("cuda")
    calls = subject_calls(args.width, args.height, dev)
    for r in range(args.rounds):
        for name in (SUBJECTS if r % 2 == 0 else SUBJECTS[::-1]):
            print(json.dumps({"label": args.label, "extent": f"{args.width}x{args.height}",
                              "round": r, "subject": name,
                              **readings(calls[name], args.launches),
                              "device_fresh_ms": device_ms(calls[name], args.launches,
                                                           fresh=True)}), flush=True)
    for piece, fn in launch_pieces(args.width, args.height, dev).items():
        print(json.dumps({"label": args.label, "piece": piece,
                          "host_ms": host_ms(fn, args.launches)}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The lower-precision control of the correctness check, and the readings
its limits are set from:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--frames N]

For each seed it draws the frames a run of that seed would compare (the
run's reservoir over the first N frames of the cell's camera path), renders
each with the reference (shading in float64) and with the control (the
reference with its shading in bfloat16, the nearest precision below the
float32 the configuration states), and judges the control's frames as a
run's frames are judged (check.py, the configuration's limits). It prints
one JSON line a seed: the worst numbers and whether the control came out
correct, which it must not. It needs no program and no card, but runs on
the card where there is one. The benchmark's runs do not run it.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control_readings(name: str, seeds, frames: int, device, adjust=None) -> list:
    import numpy as np
    import torch

    from benchmark import check, harness, reference, traffic
    from benchmark.scene import demo_scene

    bench = harness.load_benchmark()
    _, config, mix = harness.find_cell(bench, name)
    if adjust is not None:
        adjust(config, mix)
    spec = demo_scene(**{k: v for k, v in config["scene"].items() if k != "generator"})
    ref = reference.Reference(spec, harness.look_of(config), device=device)
    cam = config["camera"]
    pos, pitch = np.asarray(cam["position"], np.float32), np.float32(cam["pitch"])
    out = []
    for seed in seeds:
        path = traffic.Path(mix, cam, seed)
        sample = check.Reservoir(np.random.default_rng([seed, 1]))
        for i in range(frames):
            sample.offer(i, lambda i=i: i)
        per_frame = []
        for i in sorted(sample.items):
            want = ref.render(pos, path.yaw(i), pitch).cpu().numpy()
            got = ref.render(pos, path.yaw(i), pitch, shade_dtype=torch.bfloat16).cpu().numpy()
            per_frame.append(check.frame_numbers(got, want))
        verdict = check.judge(per_frame, config["correct_limits"])
        out.append({"workload": name, "seed": seed, "frames": sorted(sample.items),
                    "correct": verdict["correct"], "numbers": verdict["numbers"],
                    "per_frame": per_frame})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--frames", type=int, default=600,
                    help="frames of the path a run's sample is drawn from")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, ROOT)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    for line in control_readings(args.workload, [int(s) for s in args.seeds.split(",")],
                                 args.frames, device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

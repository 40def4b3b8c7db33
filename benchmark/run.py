"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA card the cell
asks for. It prints diagnostics on standard error, each compared number
beside its limit as the last lines there, and as the last line of standard
output one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), device (and
with --trace 1 breakdown), then checks (the compared numbers and limits).
It exits 2, printing no result, where there is no CUDA card, where the
program is missing, where the cell cannot take the path it claims, or
where JAX or the JAX package was loaded.
"""

import time

SETUP_T0 = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    # run as a script, the benchmark's own folder heads sys.path: the root
    # of the checkout takes its place, so `benchmark` is a package
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, ROOT)
    if importlib.util.find_spec("tpu_renderer_torch") is None:
        print("benchmark: the program (tpu_renderer_torch) is not in this checkout",
              file=sys.stderr)
        return 2

    import torch

    from benchmark import harness

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("benchmark: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    try:
        cell, _, _ = harness.find_cell(bench, args.workload)
        if torch.cuda.device_count() < cell["chips"]:
            print(f"benchmark: {args.workload} needs {cell['chips']} cards, "
                  f"{torch.cuda.device_count()} here", file=sys.stderr)
            return 2
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  device="cuda", setup_t0=SETUP_T0, bench=bench)
    except harness.CellError as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: the process holds {', '.join(loaded)}, which the port must "
              f"not load", file=sys.stderr)
        return 2
    print(f"card: {harness.nvidia_smi()}", file=sys.stderr)
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

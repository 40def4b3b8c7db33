"""Render the gallery's six images with the port, the twin of the JAX
package's tools/make_gallery.py, into a directory it is given.

    python3 -m tpu_renderer_torch.tools.make_gallery --out DIR
        [--width 960] [--height 540] [--device cuda]

The same six renders at 960x540: the colored triangle, colored quad,
textured quad and sky-background milestones and the demo scene (grid 6,
the sky) through tpu_renderer_torch.cli.main; the structure scene (the
sky, camera (0, 10, 42), pitch -0.18) through Engine. It never writes into
docs/gallery/: the images there are the JAX package's TPU renders, and for
each image it prints how many pixels differ from the one of the same name
there (a report: nothing is asserted; at another extent it says so), and
it refuses an --out under docs/. Renders on the card by default (after
the card's nvidia-smi name and power limit) and exits 1 without one;
--device cpu renders on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from tpu_renderer_torch import cli
from tpu_renderer_torch.config import RendererConfig
from tpu_renderer_torch.engine import Engine
from tpu_renderer_torch.present import load_png, save_png
from tpu_renderer_torch.utils import bench_frame
from tpu_renderer_torch.utils.demo import build_structure_glb

DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "docs")
REFERENCE = os.path.join(DOCS, "gallery")
MILESTONES = (("01_colored_triangle.png", "colored_triangle"),
              ("02_colored_quad.png", "colored_quad"),
              ("03_textured_quad.png", "textured_quad"),
              ("04_sky_background.png", "background_sky"))
DEMO = "05_demo_scene.png"
STRUCTURE = "06_structure_scene.png"
NAMES = tuple(n for n, _ in MILESTONES) + (DEMO, STRUCTURE)


def _cli(argv) -> None:
    rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"tpu_renderer_torch.cli {' '.join(argv)} exited {rc}")


def render(out_dir: str, width: int, height: int, device: str) -> None:
    """The six images into out_dir."""
    ext = ["--width", str(width), "--height", str(height), "--device", device]
    for name, milestone in MILESTONES:
        _cli(["milestone", milestone, *ext, "--out", os.path.join(out_dir, name)])
    _cli(["demo", "--grid", "6", *ext, "--background", "1",
          "--out", os.path.join(out_dir, DEMO)])
    with tempfile.TemporaryDirectory() as tmp:
        path = build_structure_glb(os.path.join(tmp, "structure_gallery.glb"), seed=0)
        eng = Engine(RendererConfig(width=width, height=height, background_effect=1,
                                    camera_position=(0.0, 10.0, 42.0)), device=device)
        eng.camera.pitch = np.float32(-0.18)
        eng.init(scene_path=path)
    save_png(eng.draw(), os.path.join(out_dir, STRUCTURE))
    print(f"wrote {os.path.join(out_dir, STRUCTURE)}")


def compare(out_dir: str) -> dict:
    """name -> pixels that differ from docs/gallery's image (None when the
    extents differ); each printed."""
    out = {}
    for name in NAMES:
        got, want = load_png(os.path.join(out_dir, name)), load_png(os.path.join(REFERENCE, name))
        if got.shape != want.shape:
            out[name] = None
            print(f"[gallery] {name}: {got.shape[1]}x{got.shape[0]}, the reference is "
                  f"{want.shape[1]}x{want.shape[0]}: not compared")
            continue
        differ = int(np.any(got != want, axis=-1).sum())
        out[name] = differ
        print(f"[gallery] {name}: {differ} of {got.shape[0] * got.shape[1]} pixels differ "
              f"from docs/gallery/{name} (the JAX package's TPU render; not asserted)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="directory for the six PNGs (none under docs/)")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    docs = os.path.realpath(DOCS)
    if os.path.commonpath([os.path.realpath(args.out), docs]) == docs:
        print("make_gallery: docs/ holds the reference renders; pass an --out "
              "outside it", file=sys.stderr)
        return 1
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("make_gallery: no CUDA device", file=sys.stderr)
            return 1
        print(f"[device] {bench_frame.nvidia_smi()}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    render(args.out, args.width, args.height, args.device)
    compare(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

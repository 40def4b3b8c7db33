"""Command-line entry point — replaces main.cpp + the GLFW window loop with
headless rendering (PNG output), a terminal viewer and a benchmark mode.

    python -m tpu_renderer_torch.cli render scene.glb --out frame.png
    python -m tpu_renderer_torch.cli demo --grid 12 --out demo.png
    python -m tpu_renderer_torch.cli milestone colored_triangle --out tri.png
    python -m tpu_renderer_torch.cli view --grid 4 --frames 30 --keys "ww"
    python -m tpu_renderer_torch.cli benchmark --frames 120 --width 1920 --height 1080

Every command renders on the CUDA card; --device cpu is the only way to the
CPU. Without a card the command prints the engine's message and exits 2.

--multichip ROWSxTRI runs render, demo, view and benchmark in ROWS * TRI
ranks over a process group (parallel/multichip.launch), each rank the
command's body with Engine(multichip=(ROWS, TRI)); rank 0 alone writes the
PNG and prints. milestone renders on one device, as the JAX CLI's does.
view --multichip: rank 0 reads the launching process's terminal (its path
goes to the ranks; spawned ranks have no stdin of their own) and leads;
before each frame it broadcasts the camera and "go on" to the other ranks,
which follow until it broadcasts "stop". At the end rank 0 prints, for
every rank, the frames it presented and a digest of them.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from tpu_renderer_torch import milestones, resources
from tpu_renderer_torch.config import RendererConfig
from tpu_renderer_torch.engine import Engine, NoDeviceError
from tpu_renderer_torch.pipeline import render_frame
from tpu_renderer_torch.present import save_png, unpack_u8
from tpu_renderer_torch.utils.demo import build_demo_glb
from tpu_renderer_torch.viewer import run_viewer


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--width", type=int, default=1700)    # vk_engine.h:219
    p.add_argument("--height", type=int, default=900)
    p.add_argument("--out", default="frame.png")
    p.add_argument("--camera", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--yaw", type=float, default=0.0)
    p.add_argument("--pitch", type=float, default=0.0)
    p.add_argument("--background", type=int, default=0, choices=(0, 1),
                   help="0=gradient (default white), 1=sky")
    p.add_argument("--render-scale", type=float, default=1.0,
                   help="draw-extent scale; <1 renders fewer pixels and "
                        "linear-blits up (vk_engine.cpp:1220-1222 made live)")
    p.add_argument("--target-fps", type=float, default=None,
                   help="auto quality: draw at the largest render scale the "
                        "engine's cost model predicts reaches this target")
    p.add_argument("--multichip", default=None, metavar="ROWSxTRI",
                   help="shard the frame over a ROWSxTRI mesh of ranks, "
                        "e.g. 2x4: ROWS row bands by TRI triangle shards")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the scene and the frames live (default: the "
                        "CUDA card; nothing falls back to the CPU)")


def _parse_multichip(args):
    s = getattr(args, "multichip", None)
    if not s:
        return None
    try:
        rows, tri = (int(v) for v in s.lower().split("x"))
    except ValueError:
        rows = tri = 0
    if rows < 1 or tri < 1:
        raise SystemExit(f"bad --multichip {s!r}: expected ROWSxTRI, e.g. 2x4")
    return rows, tri


def _make_engine(args, camera, pitch: float = 0.0) -> Engine:
    cfg = RendererConfig(width=args.width, height=args.height,
                         camera_position=tuple(args.camera) if args.camera else camera,
                         background_effect=args.background,
                         render_scale=args.render_scale,
                         target_fps=args.target_fps,
                         multichip=_parse_multichip(args))
    eng = Engine(cfg, device=args.device)
    eng.camera.yaw = np.float32(args.yaw)
    eng.camera.pitch = np.float32(args.pitch + pitch)
    return eng


def _demo_engine(args, tmp: str, camera=None) -> Engine:
    """An engine on args.scene, or on the procedural demo scene (written
    into tmp) at its tilted default camera."""
    scene = getattr(args, "scene", None)
    if scene:
        eng = _make_engine(args, camera, pitch=-0.15)
        eng.init(scene_path=scene)
        return eng
    path = os.path.join(tmp, "demo.glb")
    build_demo_glb(path, grid=args.grid, seed=args.seed)
    eng = _make_engine(args, (0.0, 4.0, args.grid * 2.2), pitch=-0.15)
    eng.init(scene_path=path)
    return eng


def _wrote(args, eng: Engine) -> None:
    print(f"wrote {args.out}  ({eng.stats.triangle_count} tris, "
          f"{eng.stats.drawcall_count} draws, {eng.stats.mesh_draw_time:.2f} ms)")


def _lead() -> bool:
    """Does this process write the command's output? Rank 0 of a mesh, or
    the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _save(image, args, eng: Engine) -> None:
    if _lead():
        save_png(image, args.out)
        _wrote(args, eng)


def cmd_render(args) -> int:
    eng = _make_engine(args, (30.0, 0.0, -85.0))
    eng.init(scene_path=args.scene, variant=args.variant)
    _save(eng.draw(), args, eng)
    return 0


def cmd_demo(args) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        eng = _demo_engine(args, tmp)
    _save(eng.draw(), args, eng)
    return 0


def cmd_milestone(args) -> int:
    # the five BASELINE.json milestone configs; textured_quad uses the
    # checkerboard placeholder so it runs without an asset argument
    scenes = {
        "colored_triangle": milestones.colored_triangle_scene,
        "colored_quad": milestones.colored_quad_scene,
        "textured_quad": lambda: milestones.textured_quad_scene(
            resources.make_error_checkerboard()),
        "background_gradient": None,  # background-only frame, gradient effect
        "background_sky": None,       # background-only frame, sky effect
    }
    if args.name in ("--list", "list"):
        print("\n".join(scenes))
        return 0
    if args.name not in scenes:
        print(f"unknown milestone {args.name}; choices: {list(scenes)}")
        return 1
    cfg = RendererConfig(width=args.width, height=args.height,
                         background_effect=1 if args.name == "background_sky" else 0,
                         **milestones.UNLIT_CONFIG_OVERRIDES)
    eng = Engine(cfg, device=args.device)
    eng.init(scene=scenes[args.name]() if scenes[args.name] else None)
    # milestones are authored in NDC: identity view/proj
    eye = torch.eye(4, dtype=torch.float32, device=eng.device)
    params = eng.frame_params()._replace(view=eye, proj=eye)
    img, _ = render_frame(eng.flat.buffers, params, width=args.width,
                          height=args.height, **eng._caps)
    save_png(unpack_u8(img), args.out)
    print(f"wrote {args.out}")
    return 0


def cmd_benchmark(args) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        eng = _demo_engine(args, tmp, camera=(30.0, 0.0, -85.0))
    eng.draw()   # warm-up: builds the kernels, fills the caches
    # orbit slowly so frames differ (as interactive viewing does)
    t0 = time.perf_counter()
    for i in range(args.frames):
        eng.camera.yaw = np.float32(args.yaw + 0.002 * i)
        eng.draw()
    dt = time.perf_counter() - t0
    fps = args.frames / dt
    print(json.dumps({
        "fps": round(fps, 2),
        "frame_ms": round(1000 * dt / args.frames, 3),
        "triangles": eng.stats.triangle_count,
        "mtris_per_sec": round(eng.stats.triangle_count * fps / 1e6, 2),
        "drawcalls": eng.stats.drawcall_count,
        "width": args.width,
        "height": args.height,
        "backend": eng.device.type,
    }))
    return 0


def cmd_view(args) -> int:
    """Interactive terminal viewer (the GLFW window loop analog)."""
    with tempfile.TemporaryDirectory() as tmp:
        eng = _demo_engine(args, tmp, camera=(0.0, 6.0, 20.0))
    keys = list(args.keys) if args.keys is not None else None
    view = dict(n_frames=args.frames, keys=keys, cols=args.cols, rows=args.rows)
    if eng.mesh is not None:
        return _view_mesh(eng, view)
    n = run_viewer(eng, **view)
    eng.flush_pipelined()
    print(f"\n{n} frames")
    return 0


class _Presented:
    """The frames a rank's draw_pipelined presented: their count and one
    digest over all of them, in order."""

    def __init__(self):
        self.frames = 0
        self._sha = hashlib.sha256()

    def add(self, img):
        if img is not None:
            self.frames += 1
            self._sha.update(np.ascontiguousarray(img).tobytes())

    def digest(self) -> str:
        return self._sha.hexdigest()[:16]


def _camera_message(cam, go: bool, device):
    """The camera state and the "go on" flag as one float64 tensor (exact
    for the camera's float32 and float fields)."""
    vals = [*cam.position, *cam.velocity, cam.yaw, cam.pitch, cam.cursor_x,
            cam.cursor_y, 1.0 if go else 0.0]
    return torch.tensor([float(v) for v in vals], dtype=torch.float64, device=device)


def _set_camera(cam, msg) -> bool:
    """Apply a _camera_message; returns its "go on" flag."""
    v = msg.tolist()
    cam.position = np.asarray(v[0:3], np.float32)
    cam.velocity = np.asarray(v[3:6], np.float32)
    cam.yaw, cam.pitch = np.float32(v[6]), np.float32(v[7])
    cam.cursor_x, cam.cursor_y = v[8], v[9]
    return v[10] != 0.0


class _LeadEngine:
    """Rank 0's engine as run_viewer sees it: each draw_pipelined first
    broadcasts the camera and "go on" to the following ranks, then draws,
    so every rank renders the same frame; every other attribute is the
    engine's."""

    def __init__(self, eng, presented: _Presented):
        self._eng, self._presented = eng, presented

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def send(self, go: bool) -> None:
        dist.broadcast(_camera_message(self._eng.camera, go, self._eng.device), src=0)

    def draw_pipelined(self, *args, **kwargs):
        self.send(True)
        img = self._eng.draw_pipelined(*args, **kwargs)
        self._presented.add(img)
        return img


def _follow(eng, presented: _Presented, cols: int, rows: int) -> None:
    """A following rank of view --multichip: take rank 0's camera, draw as
    it does, until it sends stop."""
    msg = _camera_message(eng.camera, False, eng.device)
    while True:
        dist.broadcast(msg, src=0)
        if not _set_camera(eng.camera, msg):
            return
        presented.add(eng.draw_pipelined(hud=False, present_cells=(cols, rows)))


def _view_mesh(eng, view: dict) -> int:
    """view over a mesh: rank 0 runs the viewer on the terminal and leads,
    the other ranks follow (_follow). Then every rank's presented frames
    and kernel launches (2.1, 2.2, and the background's 2.9 or 2.10) go to
    rank 0, which prints them and fails unless
    every rank presented the same frames."""
    from tpu_renderer_torch.kernels import background, raster

    presented = _Presented()
    if dist.get_rank() == 0:
        lead = _LeadEngine(eng, presented)
        n = run_viewer(lead, **view)
        lead.send(False)
    else:
        _follow(eng, presented, view["cols"], view["rows"])
        n = presented.frames
    eng.flush_pipelined()
    mine = dict(frames=presented.frames, digest=presented.digest(),
                fused=raster.fused_counter.launches, accum=raster.accum_counter.launches,
                gradient=background.gradient_counter.launches,
                sky=background.sky_counter.launches)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    print(f"\n{n} frames")
    for r, m in enumerate(ranks):
        print(f"[multichip] view rank {r}: {m['frames']} frames presented, digest "
              f"{m['digest']}; kernel 2.1 launched {m['fused']}, 2.2 {m['accum']}, "
              f"2.9 {m['gradient']}, 2.10 {m['sky']}")
    if any((m["frames"], m["digest"]) != (ranks[0]["frames"], ranks[0]["digest"])
           for m in ranks):
        print("tpu_renderer_torch: view --multichip: the ranks presented different "
              "frames", file=sys.stderr)
        return 1
    return 0


class _Terminal:
    """The launching process's terminal, opened by path in rank 0 of view
    --multichip as its stdin: the fileno() and read(n) that the viewer's tty
    input uses, unbuffered, so a select() on it sees every pending key."""

    def __init__(self, path: str):
        self._f = open(path, "rb", buffering=0)

    def fileno(self) -> int:
        return self._f.fileno()

    def read(self, n: int = 1) -> str:
        return self._f.read(n).decode("latin-1")

    def close(self) -> None:
        self._f.close()


def _terminal_path():
    """The path of this process's terminal when its stdin is one, else None."""
    try:
        return os.ttyname(sys.stdin.fileno()) if sys.stdin.isatty() else None
    except (AttributeError, OSError, ValueError):   # no stdin, or not a file
        return None


def _rank_command(rank: int, argv, tty=None) -> int:
    """One rank of a --multichip command: the command's body, its output
    from rank 0 alone; rank 0 reads the terminal at path tty, if given, as
    its stdin."""
    if rank != 0:
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            return main(argv)
    if tty is None:
        return main(argv)
    term, stdin = _Terminal(tty), sys.stdin
    sys.stdin = term
    try:
        return main(argv)
    finally:
        sys.stdin = stdin
        term.close()


def _launch_mesh(args, argv, mesh) -> int:
    """Run the command in ROWS * TRI ranks (parallel/multichip.launch)."""
    from tpu_renderer_torch.parallel import multichip

    if args.device == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError("--multichip runs its ranks on the CUDA card by "
                            "default and no CUDA device is available: pass "
                            "--device cpu to run them on the CPU")
    tty = _terminal_path() if args.fn is cmd_view else None
    return multichip.launch(_rank_command, mesh[0] * mesh[1], device=args.device,
                            args=(argv, tty))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(prog="tpu_renderer_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a glTF/GLB scene to PNG")
    p.add_argument("scene")
    p.add_argument("--variant", default=None,
                   help="KHR_materials_variants selection (name or index)")
    _add_common(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("demo", help="render the procedural demo scene")
    p.add_argument("--grid", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    _add_common(p)
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("milestone", help="render a BASELINE milestone config")
    p.add_argument("name")
    _add_common(p)
    p.set_defaults(fn=cmd_milestone)

    p = sub.add_parser("view", help="interactive terminal viewer (wasd + arrows)")
    p.add_argument("--scene", default=None)
    p.add_argument("--grid", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frames", type=int, default=None,
                   help="stop after N frames (default: run until q/ESC)")
    p.add_argument("--keys", default=None,
                   help="scripted per-frame input string (headless/testing)")
    p.add_argument("--cols", type=int, default=96)
    p.add_argument("--rows", type=int, default=24)
    _add_common(p)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("benchmark", help="steady-state FPS benchmark")
    p.add_argument("--scene", default=None)
    p.add_argument("--grid", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frames", type=int, default=60)
    _add_common(p)
    p.set_defaults(fn=cmd_benchmark)

    args = ap.parse_args(argv)
    try:
        mesh = _parse_multichip(args)
        if mesh is not None and args.fn is not cmd_milestone and not dist.is_initialized():
            return _launch_mesh(args, argv, mesh)
        return args.fn(args)
    except (NoDeviceError, NotImplementedError) as e:
        print(f"tpu_renderer_torch: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())

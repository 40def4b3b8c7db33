"""Sweep the raster's shape on the bench frame, the twin of the JAX
package's tools/sweep_tiles.py (which sweeps tile_h at width 128),
extended to the tile's width and to every constant the kernels fix at
compile time that can move.

    python3 -m tpu_renderer_torch.tools.sweep_tiles [--axes tile_h,tile_w,group,ahead]
        [--tile_hs 8,16,32] [--tile_ws 64,128]
        [--grid 64] [--width 1920] [--height 1080] [--device cuda]

One axis at a time from the shipped point (32x128 tiles, GROUP 8, AHEAD 2):

* tile_h in --tile_hs (by default {8, 16, 32}) and tile_w in --tile_ws
  (by default {64, 128}): the raster tile, an argument of the kernels,
  any tile raster.tile_rule takes (a refused one stops the sweep before
  anything runs). A tile of raster.TILES is in the shipped library; any
  other is built into a library of its own (kernels/_build.build_tile),
  with the copies below. A warp walks a 32x8 region at a time: 2.1 runs
  min(16, regions) warps a block, 2.2 min(16, tile_h / 8) a strip, and a
  tile of more regions is walked in passes (csrc/raster_common.cuh Tile);
* group in {8, 16, 32}: triangles a gmask bit (raster.GROUP, GROUP);
* ahead in {1, 2, 3}: chunks copied ahead of the raster into the cp.async
  ring of RING_SLOTS = AHEAD + 2 slots (AHEAD).

CHUNK is not swept: a lane tests one triangle of a chunk for its warp
(static_assert(CHUNK == 32) in raster_common.cuh), so another CHUNK needs
another walk, not another constant.

Nothing shipped changes. A tile point runs the shipped tree at that tile
(--tile). For a GROUP or AHEAD point the tool copies tpu_renderer_torch/
into a temporary directory, rewrites the constants there (rewrite()),
builds the copy's kernel library into the copy's kernels/build (every
copy, the shipped library and the tiles' libraries at once,
kernels/_build.build_from and build_tile). Each
point is measured in a subprocess that imports its tree (--measure).
Each point prints: the tiles, the opaque entries and the most
a tile (bin_triangles_full on the bench frame's sorted opaque set), the
transparent ones, bin_triangles_full's ms a call (CUDA events around one
call, utils/timing.event_ms), kernels 2.1's and 2.2's device ms a call (a
CUDA graph of 20 calls, utils/timing.device_ms) on the frame's inputs, the
nvcc seconds of its tree's build, and its checks: 2.1 and 2.2 equal their
plain versions at that point (every output), and the opaque z / tid and the
transparent sum / count, cropped to the frame, equal the shipped point's
(a digest of each), as none of them depends on the shape. A last JSON line
holds every point. Exits 1 if a check fails or without a card; --device
cpu (small sizes) runs the plain versions in each copy as a check of the
tool: host ms, no device number, no build.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from tpu_renderer_torch import pipeline
from tpu_renderer_torch.kernels import _build, raster
from tpu_renderer_torch.kernels.common import pad_extent
from tpu_renderer_torch.utils import bench_frame, timing

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = {"tile_h": (8, 16, 32), "tile_w": (64, 128), "group": (8, 16, 32),
        "ahead": (1, 2, 3)}
# (file under the package, pattern, point key): the compile-time constants
# rewrite() sets in a copy; each pattern must match exactly once
CONSTANTS = (
    ("kernels/raster.py", r"^GROUP = (\d+)$", ("group",)),
    ("kernels/raster.py", r"^AHEAD = (\d+)$", ("ahead",)),
    ("kernels/csrc/raster_common.cuh", r"^constexpr int GROUP = (\d+);", ("group",)),
    ("kernels/csrc/raster_common.cuh", r"^constexpr int AHEAD = (\d+);", ("ahead",)),
)


def _read(pkg: str, rel: str) -> str:
    with open(os.path.join(pkg, rel)) as f:
        return f.read()


def point_of(pkg: str = PACKAGE) -> dict:
    """The compile-time constants (group, ahead) a package tree is built
    for, read from its sources; raises if a constant is not found exactly
    once or its two files disagree."""
    point = {}
    for rel, pattern, keys in CONSTANTS:
        found = re.findall(pattern, _read(pkg, rel), flags=re.M)
        if len(found) != 1:
            raise ValueError(f"{rel}: {pattern!r} matched {len(found)} times")
        values = found[0] if isinstance(found[0], tuple) else (found[0],)
        for k, v in zip(keys, values):
            if point.setdefault(k, int(v)) != int(v):
                raise ValueError(f"{rel}: {k} = {v}, elsewhere {point[k]}")
    return point


def shipped_point() -> dict:
    """The shipped point: the default tile (RendererConfig's) and the
    shipped sources' constants."""
    return dict(tile_h=raster.TILE_H, tile_w=raster.TILE_W, **point_of())


def points(axes, values=None) -> list:
    """The shipped point, then each named axis's other values (values:
    axis -> its values, AXES by default), one axis at a time from it."""
    values = {**AXES, **(values or {})}
    shipped = shipped_point()
    out = [shipped]
    for axis in axes:
        out += [dict(shipped, **{axis: v}) for v in values[axis] if v != shipped[axis]]
    return out


def in_copy(point: dict) -> bool:
    """Does the point need a rewritten copy (a compile-time constant off the
    shipped sources), or does the shipped tree run it (a tile)?"""
    return any(point[k] != v for k, v in point_of().items())


def rewrite(pkg: str, point: dict) -> None:
    """Set the compile-time constants of the package tree at pkg to point's
    values (its tile is an argument of the kernels, not a constant)."""
    for rel, pattern, keys in CONSTANTS:
        path = os.path.join(pkg, rel)
        text = _read(pkg, rel)
        m = list(re.finditer(pattern, text, flags=re.M))
        if len(m) != 1:
            raise ValueError(f"{rel}: {pattern!r} matched {len(m)} times")
        # the point's values over the groups, right to left so spans hold
        new = m[0].group(0)
        for i in reversed(range(len(keys))):
            a, b = (x - m[0].start() for x in m[0].span(i + 1))
            new = new[:a] + str(point[keys[i]]) + new[b:]
        with open(path, "w") as f:
            f.write(text[:m[0].start()] + new + text[m[0].end():])


def make_variant(point: dict, dest: str) -> str:
    """A copy of tpu_renderer_torch/ under dest with point's compile-time
    constants (no build output, no caches); returns dest, the root to
    import it from."""
    pkg = os.path.join(dest, "tpu_renderer_torch")
    shutil.copytree(PACKAGE, pkg, ignore=shutil.ignore_patterns("build", "__pycache__"))
    rewrite(pkg, point)
    return dest


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# One point, in the subprocess that imports its copy
# ---------------------------------------------------------------------------


def _exact(got, want) -> bool:
    """Bit for bit (a float32 NaN equals itself, -0.0 is not +0.0)."""
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t  # noqa: E731
    return all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))


@torch.no_grad()
def measure(inputs: str, device, tile_h: int, tile_w: int) -> dict:
    """Bin, rasterize (2.1, then 2.2 over its z) and time the bench frame's
    inputs at this tile and this package's constants."""
    dev = torch.device(device)
    d = torch.load(inputs)
    width, height = d["width"], d["height"]
    wp, hp = pad_extent(width, height, tile_h, tile_w)
    tiles = dict(tiles_x=wp // tile_w, tiles_y=hp // tile_h, tile_w=tile_w, tile_h=tile_h)
    sets = {}
    for k in ("opaque", "transparent"):
        aabb, valid, rows = raster.spatial_sort(*(d[k][n].to(dev) for n in ("aabb", "valid", "rows")))
        boxes = (*raster.chunk_aabbs(aabb, valid), *raster.group_aabbs(aabb, valid))
        bins, counts = raster.bin_triangles_full(*boxes, **tiles)
        sets[k] = dict(rows=rows.contiguous(), boxes=boxes, bins=bins, counts=counts)
    o, t = sets["opaque"], sets["transparent"]
    light = d["light"].to(dev)
    cuda = dev.type == "cuda"

    def fused(kernel=cuda):
        fn = raster.raster_fused_kernel if kernel else raster.rasterize_fused_plain
        return fn(o["rows"], o["bins"], o["counts"], **tiles)

    def accum(z, kernel=cuda):
        fn = raster.raster_accum_kernel if kernel else raster.rasterize_accum_plain
        return fn(t["rows"], t["bins"], t["counts"], z, light, **tiles)

    def bins_call():
        return raster.bin_triangles_full(*o["boxes"], **tiles)

    out_f = fused()
    out_a = accum(out_f[0])
    if cuda:
        exact_f = _exact(out_f, fused(kernel=False))
        exact_a = _exact(out_a, accum(out_f[0], kernel=False))
        ms = dict(bins_ms=timing.event_ms(bins_call, runs=10),
                  fused_ms=timing.device_ms(fused, launches=20),
                  accum_ms=timing.device_ms(lambda: accum(out_f[0]), launches=20))
    else:
        exact_f = exact_a = None   # the plain versions alone: nothing to hold
        ms = {}
        for key, fn in (("bins_ms", bins_call), ("fused_ms", fused),
                        ("accum_ms", lambda: accum(out_f[0]))):
            t0 = time.perf_counter()
            fn()
            ms["cpu_" + key] = (time.perf_counter() - t0) * 1000.0
    z, tid = out_f[0][:height, :width], out_f[1][:height, :width]
    acc, cnt = out_a[0][:, :height, :width], out_a[1][:height, :width]
    return dict(point=dict(tile_h=tile_h, tile_w=tile_w, **point_of()), module=raster.__file__, tiles=int(o["counts"].shape[0]),
                entries=int(o["counts"].sum()), max_a_tile=int(o["counts"].max()),
                transparent_entries=int(t["counts"].sum()),
                transparent_max=int(t["counts"].max()), **ms,
                fused_exact=exact_f, accum_exact=exact_a,
                opaque_digest=_digest(z, tid), transparent_digest=_digest(acc, cnt))


# ---------------------------------------------------------------------------
# The sweep, in the launching process
# ---------------------------------------------------------------------------


@torch.no_grad()
def capture_inputs(eng, path: str) -> None:
    """One frame of eng, its opaque and transparent sets (what
    pipeline._binned receives) and 2.2's light vector saved to path."""
    got, light = [], []
    binned, accum = pipeline._binned, raster.rasterize_accum

    def take_binned(aabb, valid, rows, tiles):
        got.append(dict(aabb=aabb.cpu(), valid=valid.cpu(), rows=rows.cpu()))
        return binned(aabb, valid, rows, tiles)

    def take_light(*args, **kwargs):
        light.append(args[4].cpu())
        return accum(*args, **kwargs)

    pipeline._binned, raster.rasterize_accum = take_binned, take_light
    try:
        with pipeline.eager():   # a graph's replay calls neither
            eng.draw()
    finally:
        pipeline._binned, raster.rasterize_accum = binned, accum
    if len(got) != 2 or len(light) != 1:
        raise RuntimeError("the frame took no opaque and transparent binning and accumulation")
    torch.save(dict(opaque=got[0], transparent=got[1], light=light[0],
                    width=eng.config.width, height=eng.config.height), path)


def _run_point(root: str, point: dict, inputs: str, device: str, timeout: float) -> dict:
    """--measure at point's tile in a subprocess importing the tree at root;
    its JSON line."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-m", "tpu_renderer_torch.tools.sweep_tiles",
                          "--measure", inputs, "--device", device,
                          "--tile", f"{point['tile_h']}x{point['tile_w']}"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"sweep point under {root} exited {out.returncode}:\n"
                           f"{out.stderr[-4000:]}")
    result = json.loads(out.stdout.strip().splitlines()[-1])
    if not os.path.realpath(result["module"]).startswith(os.path.realpath(root) + os.sep):
        raise RuntimeError(f"the point under {root} imported {result['module']}")
    return result


def _label(point: dict) -> str:
    return (f"tile {point['tile_h']}x{point['tile_w']} group {point['group']} "
            f"ahead {point['ahead']}")


def sweep(eng, axes, device: str, timeout: float = 900.0, values=None) -> list:
    """Every point of `axes` (points(axes, values)) on eng's frame; one
    dict a point, printed."""
    pts = points(axes, values)
    for p in pts:
        raster.check_tile(p["tile_h"], p["tile_w"])
    repo = os.path.dirname(PACKAGE)
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        capture_inputs(eng, inputs)
        roots = [make_variant(p, os.path.join(tmp, f"point{i}")) if in_copy(p) else repo
                 for i, p in enumerate(pts)]
        build_s = {}
        if device == "cuda":
            # every tree's library and every tile's outside raster.TILES at
            # once, each one nvcc a source
            trees = list(dict.fromkeys(roots))
            tiles = list(dict.fromkeys((p["tile_h"], p["tile_w"]) for p in pts))
            tiles = [t for t in tiles if t not in raster.TILES]
            with concurrent.futures.ThreadPoolExecutor(len(trees) + len(tiles)) as ex:
                futures = [ex.submit(_build.build_from, *(
                    (_build.CSRC_DIR, _build.BUILD_DIR) if r == repo else
                    (os.path.join(r, "tpu_renderer_torch", "kernels", "csrc"),
                     os.path.join(r, "tpu_renderer_torch", "kernels", "build"))))
                    for r in trees] + [ex.submit(_build.build_tile, *t) for t in tiles]
                build_s = {k: f.result()[1] for k, f in zip(trees + tiles, futures)}
        rows = []
        for point, root in zip(pts, roots):
            tile = (point["tile_h"], point["tile_w"])
            key = tile if tile in build_s else root
            secs = build_s.get(key)
            build_s[key] = None   # a library's build is reported at its first point
            r = _run_point(root, point, inputs, device, timeout)
            if r["point"] != point:
                raise RuntimeError(f"the copy for {point} reads {r['point']}")
            shipped = rows[0] if rows else r
            r["build_s"] = secs
            r["opaque_same"] = r["opaque_digest"] == shipped["opaque_digest"]
            r["transparent_same"] = r["transparent_digest"] == shipped["transparent_digest"]
            rows.append(r)
            times = "  ".join(f"{k} {v:.4f}" for k, v in r.items() if k.endswith("_ms"))
            build = ("none" if device != "cuda" else "cached" if secs is None
                     else f"{secs:.2f} s")
            print(f"[sweep] {_label(point)}: {r['tiles']} tiles, {r['entries']} entries "
                  f"(max {r['max_a_tile']} a tile), transparent {r['transparent_entries']} "
                  f"(max {r['transparent_max']}); {times} ms; build {build}; 2.1 == plain "
                  f"{r['fused_exact']}, 2.2 == plain {r['accum_exact']}, planes == shipped "
                  f"point's {r['opaque_same'] and r['transparent_same']}", flush=True)
    return rows


def failed(rows) -> list:
    """The checks a sweep's rows fail."""
    bad = []
    for r in rows:
        for k in ("fused_exact", "accum_exact", "opaque_same", "transparent_same"):
            if r[k] is False:
                bad.append(f"{_label(r['point'])}: {k}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--axes", default=",".join(AXES),
                    help="axes to sweep, comma-separated, of " + ", ".join(AXES))
    ap.add_argument("--tile_hs", default=",".join(map(str, AXES["tile_h"])),
                    help="the tile_h axis's values, comma-separated")
    ap.add_argument("--tile_ws", default=",".join(map(str, AXES["tile_w"])),
                    help="the tile_w axis's values, comma-separated")
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--measure", default=None, metavar="INPUTS",
                    help="(run by the sweep for each point) measure this tree's point "
                         "on the saved inputs and print it as JSON")
    ap.add_argument("--tile", default=f"{raster.TILE_H}x{raster.TILE_W}",
                    help="the tile --measure runs at, HxW")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("sweep_tiles: no CUDA device", file=sys.stderr)
        return 1
    if args.measure:
        tile_h, tile_w = (int(v) for v in args.tile.split("x"))
        print(json.dumps(measure(args.measure, args.device, tile_h, tile_w)))
        return 0
    axes = [a for a in args.axes.split(",") if a]
    unknown = set(axes) - set(AXES)
    if unknown:
        print(f"sweep_tiles: unknown axes {sorted(unknown)}", file=sys.stderr)
        return 1
    values = {k: tuple(int(v) for v in getattr(args, f"{k}s").split(",") if v)
              for k in ("tile_h", "tile_w")}
    refused = [raster.tile_rule(p["tile_h"], p["tile_w"]) for p in points(axes, values)]
    if any(refused):
        print(f"sweep_tiles: {next(r for r in refused if r)}", file=sys.stderr)
        return 1
    if args.device == "cuda":
        print(f"[device] {bench_frame.nvidia_smi()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        eng = bench_frame.bench_engine(
            os.path.join(tmp, "bench_scene.glb"), device=args.device, grid=args.grid,
            width=args.width, height=args.height,
            camera_position=(0.0, 6.0, args.grid * 2.0))
    rows = sweep(eng, axes, args.device, values=values)
    print(json.dumps({"sweep": rows}))
    bad = failed(rows)
    for b in bad:
        print(f"sweep_tiles: check failed: {b}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

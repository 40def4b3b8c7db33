"""One run of one cell: set-up, the measured window, the traced extras,
the correctness check, and the result line.

Everything a cell is made of is found by name: the cell in BENCHMARK.json,
its configuration in configs/<config>.json, its traffic mix in
traffic/<mix>.json (read by traffic.py), and each per-layer metric in
metrics/<metric>.py. Adding a cell, a configuration, a mix or a metric
adds files; it edits none here.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import check, reference, roofline, tracing, traffic
from benchmark.scene import demo_scene, write_glb

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_renderer")   # top-level module names
EAGER_FRAMES = 2        # profiled eager frames of the stage windows
PROFILE_FRAMES = 8      # frames of a sequence cell's profiled window
WARM_FRAMES = 3         # frames of a sequence cell's warm-up batch
SETTLE_FROM = 10 ** 6   # the path index the settling phase starts at (the path is periodic)
PROBE_NODES = 1000      # nodes of the probe graph (Probe)
PROBE_FAST_US = 1.10    # a probe node's device us once the slow start is over (H100 80GB HBM3:
                        # 1.00-1.04 after it, 1.18-1.22 during it; PERF.md)
SETTLE_MIN_S = 2.0      # the settling phase's loop before it reads the probe's verdict
SETTLE_MAX_S = 120.0    # the longest the settling phase waits for the slow start to end
VIEW_PROFILE_CALLS = 16  # draw_pipelined calls of a viewer cell's profiled window


class CellError(RuntimeError):
    """The run cannot measure what the cell claims; it prints no result."""


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(bench: dict, name: str):
    """(cell, configuration, traffic) of the cell named `name`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    return cell, config, mix


def cell_metrics(bench: dict, name: str, kind: str) -> list:
    """The cell's end-to-end (kind "end_to_end") or per-layer metrics."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]}
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"] if m["name"] in e2e]
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def load_metric(name: str):
    """The reader module of per-layer metric `name` (metrics/<name>.py)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _u8(image) -> np.ndarray:
    """A frame as (H, W, 4) uint8 RGBA on the host: a packed (H, W) int32
    frame (render_frames) is unpacked, an RGBA8 image (draw_pipelined)
    taken as it is."""
    a = np.ascontiguousarray(image.cpu().numpy() if torch.is_tensor(image) else image)
    if a.dtype == np.uint8 and a.ndim == 3:
        return a
    return a.view(np.uint8).reshape(*a.shape, 4)


def timed_call(pairs: list, render, *args, **kwargs):
    """render(*args, **kwargs) between two CUDA events recorded on the
    current stream, appended to pairs."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = render(*args, **kwargs)
    e1.record()
    pairs.append((e0, e1))
    return out


class Probe:
    """The benchmark's own CUDA graph of PROBE_NODES one-element adds. Its
    device time a node reads whether the process's slow start of graph
    launches (PERF.md) is over: the program's first frame-graph capture
    starts it, and every graph launch in the process then takes longer,
    until a moment that varies from run to run."""

    def __init__(self, device):
        self.device = device
        self.x = torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(PROBE_NODES):
                self.x.add_(1.0)
        torch.cuda.synchronize(device)

    def us_per_node(self) -> float:
        """The least of three replays' device us a node."""
        best = float("inf")
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            self.graph.replay()
            e1.record()
            e1.synchronize()
            best = min(best, e0.elapsed_time(e1) * 1000.0 / PROBE_NODES)
        return best


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))


def _build_engine(config: dict, device, tmp: str):
    """The scene written to a GLB in tmp, and an Engine initialised on it."""
    from tpu_renderer_torch.config import RendererConfig
    from tpu_renderer_torch.engine import Engine

    spec = demo_scene(**{k: v for k, v in config["scene"].items() if k != "generator"})
    path = write_glb(spec, os.path.join(tmp, "scene.glb"))
    cam, rend, look = config["camera"], config["renderer"], config["look"]
    cfg = RendererConfig(width=config["extent"]["width"], height=config["extent"]["height"],
                         camera_position=tuple(cam["position"]), fov_y_deg=look["fov_y_deg"],
                         z_near=look["z_near"], z_far=look["z_far"],
                         ambient_color=tuple(look["ambient"]),
                         sunlight_direction=tuple(look["sun_dir"]),
                         sunlight_color=tuple(look["sun_color"]),
                         gradient_data1=tuple(look["gradient_top"]),
                         gradient_data2=tuple(look["gradient_bottom"]), **rend)
    eng = Engine(cfg, device=device)
    eng.camera.pitch = np.float32(cam["pitch"])
    eng.camera.yaw = np.float32(cam["yaw"])
    eng.init(scene_path=path)
    return spec, eng


def _check_path(eng, config: dict, layers: int, device) -> str:
    """The path the cell takes against the one its configuration claims."""
    from tpu_renderer_torch.pipeline import graphed

    claim = config["path"]
    took = dict(graphed=graphed(eng.device), fused=eng._fused, peel=eng._transp_textured())
    line = (f"path: graphed={took['graphed']} fused={took['fused']} peel={took['peel']} "
            f"transparent_layers={layers} (claimed graphed={claim['graphed']} "
            f"fused={claim['fused']} peel={claim['peel']})")
    wrong = [k for k in ("fused", "peel") if took[k] != claim[k]]
    if device.type == "cuda" and took["graphed"] != claim["graphed"]:
        wrong.append("graphed")
    if claim["peel"] and layers < 1:
        wrong.append("transparent_layers")
    if wrong:
        raise CellError(line + f": the cell does not take its path ({', '.join(wrong)})")
    return line


class Run:
    """State of one run, filled as it goes."""

    def __init__(self, seed, seconds, trace_on, device, config, mix):
        self.seconds, self.trace_on = seconds, trace_on
        self.device = torch.device(device)
        self.config, self.mix = config, mix
        self.path = traffic.Path(mix, config["camera"], seed)
        self.sample = check.Reservoir(np.random.default_rng([seed, 1]))
        self.t: Dict[str, object] = {"loop": mix["loop"]}   # what the readers read
        self.metrics: Dict[str, float] = {}
        self.probe = Probe(self.device) if self.device.type == "cuda" else None

    def say(self, line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    # -- the sequence loop ------------------------------------------------

    def _frame_hook(self, events: Optional[list], capture: Optional[dict]):
        def frame(i, render, *args, **kwargs):
            if capture is not None and "ms" not in capture:
                _sync(self.device)
                t0 = time.perf_counter()
                image, aux = render(*args, **kwargs)
                _sync(self.device)
                capture["ms"] = (time.perf_counter() - t0) * 1000.0
            elif events is not None:
                image, aux = timed_call(events, render, *args, **kwargs)
            else:
                image, aux = render(*args, **kwargs)
            self._last_aux = aux
            if capture is None:
                self.sample.offer(i, lambda: image)
            return image, aux
        return frame

    def run_sequence(self, eng, setup_t0: float) -> float:
        # set-up: the key's first frame (the capture) and a few replays, in
        # one short batch of the same loop
        capture = {}
        traffic.sequence(eng, self.path, dict(self.mix, batch_frames=WARM_FRAMES), 0.0,
                         self._frame_hook(None, capture), batches=1)
        self.t["capture_ms"] = capture["ms"]
        self.layers = int(self._last_aux.get("transparent_layers", torch.zeros(())))
        self.say(_check_path(eng, self.config, self.layers, self.device))
        setup_s = time.perf_counter() - setup_t0
        self.settle(eng)
        events = [] if (self.trace_on and self.device.type == "cuda") else None
        win = traffic.sequence(eng, self.path, self.mix, self.seconds,
                               self._frame_hook(events, None))
        self.window = win
        self.attempted = win["frames"]
        self.metrics["frames_per_s"] = win["frames"] / win["seconds"]
        self.t["window_s"] = win["seconds"]
        if events is not None:
            _sync(self.device)
            self.t["frame_ms"] = [a.elapsed_time(b) for a, b in events]
        self.say(f"window: {win['frames']} frames in {win['seconds']:.3f} s{self._probe_note()}")
        return setup_s

    def settle(self, eng) -> None:
        """The phase between set-up and the window: the cell's own loop on
        the same frame graph, for SETTLE_MIN_S seconds and then until
        the probe reads the slow start over (at most SETTLE_MAX_S). The
        program's first frame-graph capture starts a slow start in which
        every graph launch of the process takes longer; it ends at a moment
        that varies from run to run, and the window measures the steady
        state after it (PERF.md). setup_s ends before this phase: every
        shape is built and warm by then. Records slow_start_s, the seconds
        from the end of set-up to the probe's first fast reading (the
        phase's length where none came), and reports the frame time and
        the probe's readings on standard error."""
        n = int(self.mix.get("batch_frames", 1))
        t0 = time.perf_counter()
        probes: list = []
        fast_at = None
        pairs: list = []
        chunks: list = []
        i = SETTLE_FROM
        while True:
            elapsed = time.perf_counter() - t0
            if self.probe is not None and fast_at is None:
                probes.append(round(self.probe.us_per_node(), 3))
                if probes[-1] <= PROBE_FAST_US:
                    fast_at = time.perf_counter() - t0
            if elapsed >= SETTLE_MIN_S and (self.probe is None or fast_at is not None
                                            or elapsed >= SETTLE_MAX_S):
                break
            if self.mix["loop"] == "sequence":
                def frame(k, render, *args, **kwargs):
                    if self.device.type == "cuda":
                        return timed_call(pairs, render, *args, **kwargs)
                    return render(*args, **kwargs)

                win = traffic.sequence(eng, self.path, self.mix, 0.0, frame, first=i, batches=1)
                chunks.append(win["frames"])
            else:
                win = traffic.viewer(eng, self.path, self.mix, 0.5, lambda k, img: None, first=i)
                chunks.append(len(win["ends"]))
            i = win["next"]
        _sync(self.device)
        if self.probe is not None:
            self.t["slow_start_s"] = fast_at if fast_at is not None else time.perf_counter() - t0
        if pairs:
            ms = [a.elapsed_time(b) for a, b in pairs]
            per = [round(sum(ms[k:k + n]) / len(ms[k:k + n]), 3) for k in range(0, len(ms), n)]
            loop = f"device ms a frame, each batch: {per}"
        else:
            loop = f"{'frames' if self.mix['loop'] == 'sequence' else 'calls'} each chunk: {chunks}"
        over = (f"over after {fast_at:.3f} s" if fast_at is not None
                else "not over: the window measures it" if self.probe is not None else "no probe")
        self.say(f"settle: {time.perf_counter() - t0:.3f} s, slow start {over}; probe us a node: "
                 f"{probes}; {loop}")

    def _probe_note(self) -> str:
        if self.probe is None:
            return ""
        return f"; probe after it {self.probe.us_per_node():.3f} us a node"

    # -- the viewer loop ----------------------------------------------------

    @contextlib.contextmanager
    def _timed_fetch(self, record: list):
        """Time each _InFlight.image() (the wait on frame N-2's copy and the
        copy-out) from outside."""
        from tpu_renderer_torch import engine as engine_mod

        original = engine_mod._InFlight.image

        def image(inflight):
            t0 = time.perf_counter()
            out = original(inflight)
            record.append((time.perf_counter() - t0) * 1000.0)
            return out

        engine_mod._InFlight.image = image
        try:
            yield
        finally:
            engine_mod._InFlight.image = original

    def run_viewer(self, eng, setup_t0: float) -> float:
        _sync(self.device)
        t0 = time.perf_counter()
        eng.camera.yaw = self.path.yaw(0)
        eng.draw_pipelined(stats_interval=0)
        _sync(self.device)
        self.t["capture_ms"] = (time.perf_counter() - t0) * 1000.0
        for j in range(1, eng.FRAME_OVERLAP + 2):
            eng.camera.yaw = self.path.yaw(j)
            eng.draw_pipelined(stats_interval=0)
        eng.flush_pipelined()
        aux = eng._last_aux
        self.layers = int(aux.get("transparent_layers", torch.zeros(())))
        self.say(_check_path(eng, self.config, self.layers, self.device))
        setup_s = time.perf_counter() - setup_t0
        self.settle(eng)
        fetch: list = []
        timing = self._timed_fetch(fetch) if self.trace_on else contextlib.nullcontext()
        with timing:
            win = traffic.viewer(eng, self.path, self.mix, self.seconds,
                                 lambda i, img: self.sample.offer(i, lambda: img))
        self.window = win
        n = len(win["starts"])
        lag = eng.FRAME_OVERLAP - 1
        got = [win["ends"][k] for k in range(lag, n)]
        intervals = [(b - a) * 1000.0 for a, b in zip(got, got[1:])]
        latency = [(win["ends"][k + lag] - win["starts"][k]) * 1000.0 for k in range(n - lag)]
        self.attempted = n
        if len(intervals) >= 2:
            self.metrics["frame_interval_ms_p95"] = p95(intervals)
        if latency:
            self.metrics["input_latency_ms_p95"] = p95(latency)
        self.t["window_s"] = win["seconds"]
        if self.trace_on:
            calls = [(b - a) * 1000.0 for a, b in zip(win["starts"], win["ends"])]
            # a call waits on one delivered frame once the pipeline is full
            waits = [0.0] * lag + fetch[:n - lag]
            self.t["fetch_ms"] = fetch[:n - lag]
            self.t["host_ms"] = [c - w for c, w in zip(calls, waits)]
        self.say(f"window: {n} calls, {len(got)} frames delivered in {win['seconds']:.3f} s"
                 f"{self._probe_note()}")
        return setup_s

    # -- traced extras ------------------------------------------------------

    def profile_window(self, eng) -> dict:
        """The profiled window: a batch of PROFILE_FRAMES (sequence) or
        VIEW_PROFILE_CALLS calls (viewer) of the same traffic under
        torch.profiler. Returns
        the device block's busy_s and window_s, and the breakdown."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        first = self.window["next"]
        with profile(activities=acts) as prof:
            _sync(self.device)
            with tracing.host_range("profiled window"):
                t0 = time.perf_counter()
                if self.mix["loop"] == "sequence":
                    traffic.sequence(eng, self.path, dict(self.mix, batch_frames=PROFILE_FRAMES),
                                     0.0, lambda i, render, *a, **k: render(*a, **k),
                                     first=first, batches=1)
                else:
                    traffic.viewer(eng, self.path, self.mix, 0.0, lambda i, img: None,
                                   first=first, calls=VIEW_PROFILE_CALLS)
                _sync(self.device)
                wall = time.perf_counter() - t0
        events = prof.events()
        dev = tracing.device_intervals(events)
        hosts = tracing.host_ranges(events)
        span = [h for h in hosts if h[2] == "profiled window"]
        t_lo, t_hi = (span[0][0], span[0][1]) if span else (0.0, wall * 1e6)
        dev_in = [d for d in dev if d[1] > t_lo and d[0] < t_hi]
        busy = tracing.busy_us([(max(s, t_lo), min(e, t_hi), n) for s, e, n in dev_in]) / 1e6
        return dict(busy_s=busy, window_s=(t_hi - t_lo) / 1e6,
                    breakdown={"device_ops": tracing.top_ops(dev_in),
                               "idle_gaps": tracing.idle_gaps(dev_in, hosts, t_lo, t_hi)})

    def profile_stages(self, eng, functions: List[str]) -> None:
        """EAGER_FRAMES eager frames of the window's key at the path's first
        camera, each function of `functions` in a stage window, under
        torch.profiler: device ms a frame of each."""
        from torch.profiler import ProfilerActivity, profile

        eng.camera.yaw = self.path.yaw(0)
        params = eng.update_scene()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with tracing.staged(self.device, []):
            eng.draw_device(params)              # the eager frame's own warm-up
        with profile(activities=acts) as prof:
            with tracing.staged(self.device, functions):
                for _ in range(EAGER_FRAMES):
                    eng.draw_device(params)
                _sync(self.device)
        us = tracing.stage_device_us(prof.events())
        self.t["stage_ms"] = {f: us.get(f, 0.0) / 1000.0 / EAGER_FRAMES for f in functions}
        self.t["profiled_yaw"] = self.path.yaw(0)


def look_of(config: dict) -> reference.Look:
    """The reference's uniforms, from the configuration file."""
    if config["renderer"].get("background_effect", 0) != 0:
        raise CellError("the reference draws the gradient background (effect 0) only")
    look = config["look"]
    return reference.Look(width=config["extent"]["width"], height=config["extent"]["height"],
                          fov_y_deg=look["fov_y_deg"], z_near=look["z_near"],
                          z_far=look["z_far"], ambient=tuple(look["ambient"]),
                          sun_dir=tuple(look["sun_dir"]), sun_color=tuple(look["sun_color"]),
                          bg_top=tuple(look["gradient_top"]),
                          bg_bottom=tuple(look["gradient_bottom"]))


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark's process may
    not hold (JAX and the JAX package), compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"


def run_cell(name: str, seed: int, seconds: float, trace_on: bool, device="cuda",
             setup_t0: Optional[float] = None, adjust: Optional[Callable] = None,
             bench: Optional[dict] = None) -> dict:
    """One run of cell `name`; returns the result line's object. adjust
    (config, mix), if given, edits the configuration and the mix before
    the run (the tests' small sizes)."""
    setup_t0 = time.perf_counter() if setup_t0 is None else setup_t0
    bench = load_benchmark() if bench is None else bench
    cell, config, mix = find_cell(bench, name)
    if adjust is not None:
        adjust(config, mix)
    run = Run(seed, seconds, trace_on, device, config, mix)
    dev = run.device
    per_layer = {m["name"]: load_metric(m["name"]) for m in cell_metrics(bench, name, "per_layer")}
    tmp = tempfile.mkdtemp(prefix="bench_scene_")
    try:
        spec, eng = _build_engine(config, dev, tmp)
        if mix["loop"] == "sequence":
            setup_s = run.run_sequence(eng, setup_t0)
        elif mix["loop"] == "viewer":
            setup_s = run.run_viewer(eng, setup_t0)
        else:
            raise CellError(f"unknown loop {mix['loop']!r} in traffic {cell['traffic']!r}")
        run.metrics["setup_s"] = setup_s
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        device_block = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                        "count": 1 if dev.type == "cuda" else 0, "memory_peak_bytes": peak}
        breakdown = None
        if trace_on:
            prof = run.profile_window(eng)
            device_block.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
            breakdown = prof["breakdown"]
            stages = sorted({f for mod in per_layer.values() for f in getattr(mod, "STAGES", ())})
            if stages:
                run.profile_stages(eng, stages)
        kept = {i: _u8(img) for i, img in sorted(run.sample.items.items())}
        extent = (config["extent"]["width"], config["extent"]["height"])
        del eng
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # the reference, after the window and with the program's state freed
        t_ref = time.perf_counter()
        torch.backends.cuda.matmul.allow_tf32 = False
        ref = reference.Reference(spec, look_of(config), device=dev)
        cam = config["camera"]
        pos, pitch = np.asarray(cam["position"], np.float32), np.float32(cam["pitch"])
        per_frame = []
        for i, got in kept.items():
            want = ref.render(pos, run.path.yaw(i), pitch).cpu().numpy()
            per_frame.append(check.frame_numbers(got, want))
        if "profiled_yaw" in run.t and any(getattr(m, "COUNTS", False)
                                           for m in per_layer.values()):
            counts: dict = {}
            ref.render(pos, run.t["profiled_yaw"], pitch, counts=counts)
            run.t["counts"] = counts
            run.t["raster_bound_ms"] = roofline.raster_bound_s(counts, *extent) * 1000.0
        run.say(f"reference: {len(per_frame)} frames ({sorted(kept)}) in "
                f"{time.perf_counter() - t_ref:.3f} s")
        verdict = check.judge(per_frame, config["correct_limits"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    metrics = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if trace_on:
        for mname, mod in per_layer.items():
            value = mod.read(run.t)
            if value is not None:
                metrics[mname] = {"value": value, "unit": units[mname]}
    else:
        for m in cell_metrics(bench, name, "end_to_end"):
            if m["name"] in run.metrics:
                metrics[m["name"]] = {"value": run.metrics[m["name"]], "unit": m["unit"]}
    result = {"correct": verdict["correct"], "attempted": run.attempted,
              "failed": verdict["failed"], "metrics": metrics, "device": device_block}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = verdict["numbers"]
    return result


def check_lines(result: dict) -> List[str]:
    return [f"check {k}: {v['value']!r} limit {v['limit']!r}"
            for k, v in result["checks"].items()]


"""Engine façade — init/run/draw/cleanup in the shape of the reference's
VulkanEngine (vk_engine.h:79-227, init vk_engine.cpp:171-201, run
:1161-1203, draw :1218-1339, cleanup :1131-1159), headless, on one torch
device.

What stays from the reference: the frame loop, the FPS camera, scene
update, the EngineStats counters, the background-effect selection, the
render scale (draw at a scaled extent, linear-blit to the window extent),
FRAME_OVERLAP frames in flight (draw_pipelined) and the stats overlay. The
scene and every frame live on the engine's device: the CUDA card by
default, the CPU with Engine(config, device="cpu").

Scenes past config.dense_bin_max_chunks (and config.fused=False) take the
capped deferred raster path; a frame whose bins overflow escalates the
caps and redraws the same frame (draw).

config.target_fps engages the auto quality: the largest render scale a
per-pixel cost model, fitted to frames measured on the card, predicts to
reach the target (_pick_auto_scale).

config.multichip = (rows, tri) renders every frame over a ('rows', 'tri')
mesh of ranks (parallel/multichip.py): each rank of an initialised process
group of rows * tri ranks runs its own Engine, and each gets the whole
frame.

On the card, a frame is a replay of a CUDA graph (frame_graph.py): each
key of statics is captured at its first frame and replayed after, the peel
loop inside the graph; frame_graphs keeps a few. A mesh frame is graphed
the same way, collectives and peel loop inside, where the mesh's process
group is nccl (a card a rank). Which route a frame takes is decided from
the device, the backend and pipeline.eager() before any capture
(render_fn), never from a capture's outcome: a failed capture or replay
raises. The CPU, pipeline.eager() (utils.profiling.debug_mode) and a mesh
over gloo draw op by op: gloo's collectives run on the host, which a CUDA
graph cannot hold, and the ranks that share a card run gloo.

What the port does not take raises NotImplementedError naming the
ROADMAP.md item: a tile outside raster.tile_rule (not whole 32x8 warp
regions, or past the shared memory an H100 block can opt into; a tile
the rule takes outside raster.TILES builds its kernels at its first
frame), and the chunk, ring-depth and sort knobs.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import time
from typing import Optional

import numpy as np
import torch

from tpu_renderer_torch import math3d, scene as scene_mod
from tpu_renderer_torch import hud as hud_mod
from tpu_renderer_torch.camera import Camera
from tpu_renderer_torch.config import RendererConfig
from tpu_renderer_torch.frame_graph import GraphCache
from tpu_renderer_torch.kernels import raster
from tpu_renderer_torch.pipeline import FrameParams, background_fb, graphed, render_frame
from tpu_renderer_torch.present import unpack_u8
from tpu_renderer_torch.resources import FILTER_MIP_LINEAR
from tpu_renderer_torch.utils import profiling

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class EngineStats:
    """Mirror of EngineStats (vk_engine.h:16-22)."""

    frame_time: float = 0.0        # ms
    triangle_count: int = 0
    drawcall_count: int = 0
    scene_update_time: float = 0.0  # ms
    mesh_draw_time: float = 0.0     # ms


class NoDeviceError(RuntimeError):
    """The engine was asked for the CUDA card and there is none."""


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to tpu_renderer_torch yet: ROADMAP.md {item}")


def _check_config(cfg: RendererConfig) -> None:
    """Raise on every config value the port does not implement."""
    default = RendererConfig()
    why = raster.tile_rule(cfg.tile_h, cfg.tile_w)
    if why is not None:
        raise _not_ported(f"tile {cfg.tile_h}x{cfg.tile_w} ({why})",
                          "Queue 1 item 17 (the tile rule)")
    if (cfg.raster_chunk, cfg.raster_group) != (raster.CHUNK, raster.GROUP):
        raise _not_ported(f"raster_chunk={cfg.raster_chunk}, raster_group="
                          f"{cfg.raster_group} (the TPU kernels' schedule; the port "
                          f"owns CHUNK={raster.CHUNK}, GROUP={raster.GROUP})",
                          "Queue 1 item 18 (no output depends on them)")
    if cfg.raster_nbuf != default.raster_nbuf:
        raise _not_ported("raster_nbuf (a TPU DMA-ring depth; the CUDA ring's "
                          "depth is AHEAD in csrc/raster_common.cuh)",
                          "Queue 1 item 18 (no output depends on it)")
    if cfg.raster_sort != "hilbert":
        raise _not_ported(f"raster_sort={cfg.raster_sort!r}", "Queue 1 item 12")


class _InFlight:
    """One submitted frame of draw_pipelined: its host image (pinned and
    still being written until `ready` has passed, on CUDA), its counters,
    its frame number and, while tracing, its traced frame's number."""

    def __init__(self, host, ready, aux, frame_number):
        self.host, self.ready, self.aux = host, ready, aux
        self.frame_number = frame_number
        self.traced_frame = profiling.frame_number()

    def image(self) -> np.ndarray:
        """Wait for the copy, then the frame as (H, W, 4) uint8 (host spans
        wait and copy_out, while tracing)."""
        with profiling.span("wait"):
            if self.ready is not None:
                self.ready.synchronize()
        # a copy: the pinned slot is written again FRAME_OVERLAP frames on
        with profiling.span("copy_out"):
            return unpack_u8(self.host.numpy()).copy()


class Engine:
    FRAME_OVERLAP = 3  # frames in flight (vk_engine.h:77)

    def __init__(self, config: Optional[RendererConfig] = None, device="cuda"):
        self.config = config or RendererConfig()
        _check_config(self.config)
        self.device = torch.device(device)
        self.stats = EngineStats()
        self.camera = Camera(position=self.config.camera_position,
                             speed=self.config.camera_speed)
        self.scene: Optional[scene_mod.LoadedScene] = None
        self.flat: Optional[scene_mod.FlattenedDrawList] = None
        self.frame_number = 0
        self.current_background_effect = self.config.background_effect
        self.mesh = None
        self._last_aux = None
        self._params_key = None
        self._bg_key = None
        self._bg_fb = None
        self._caps = None
        self._auto_scale = 1.0
        self._inflight = collections.deque()
        self._slots = []   # draw_pipelined's pinned host images, reused in turn
        self.frame_graphs = GraphCache()

    # -- init (vk_engine.cpp:171-201) ---------------------------------------

    def init(self, scene_path: Optional[str] = None,
             scene: Optional[scene_mod.LoadedScene] = None,
             variant=None) -> None:
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise NoDeviceError(
                "Engine runs on the CUDA card by default and no CUDA device "
                "is available: pass device=\"cpu\" to render on the CPU")
        with profiling.setup_step("Engine.init") as record:
            if self.config.multichip is not None:
                # the mesh first: it decides the rank's card
                from tpu_renderer_torch.parallel import multichip

                self.mesh = multichip.make_mesh(*self.config.multichip,
                                                device=self.device)
                self.device = self.mesh.device
            with profiling.setup_step("load"):
                if scene is not None:
                    self.scene = scene
                elif scene_path is not None:
                    self.scene = scene_mod.load_scene(scene_path, variant=variant)
                else:
                    # empty scene: background only
                    self.scene = scene_mod.LoadedScene()
                    scene_mod.default_materials_and_textures(self.scene)
            # the graphs read the old scene's buffers (a new scene's may take
            # their ids, which key the graphs)
            self.frame_graphs.clear()
            self.flat = scene_mod.flatten_scene(self.scene, device=self.device)
            with profiling.setup_step("caps"):
                self._compute_caps()
            # the sampler statics that pick kernel 2.12's instance
            record.update(taps=self._scene_taps(), pot=self._pot)

    def _compute_caps(self) -> None:
        """Per-scene statics: the deferred path's bin capacities, the
        dense-bin guard, the stats counts, and the trilinear / power-of-two
        sampler fast paths."""
        b = self.flat.buffers
        n_chunks = max(b.opaque_tri_vidx.shape[0] // raster.CHUNK,
                       b.transp_tri_vidx.shape[0] // raster.CHUNK, 1)
        # only the deferred path reads the caps; the fused path is uncapped
        self._caps = dict(bin_cap=int(min(max(64, n_chunks), 512)), tri_cap=1024)
        # the fused path's dense bins are O(n_tiles x n_chunks): past the
        # guard the engine takes the capped deferred path instead
        self._fused = bool(self.config.fused
                           and n_chunks <= self.config.dense_bin_max_chunks)
        if self._fused != self.config.fused:
            logger.info("scene has %d chunks > dense_bin_max_chunks=%d: "
                        "taking the capped deferred raster path", n_chunks,
                        self.config.dense_bin_max_chunks)
        mask = b.draw_opaque_mask.cpu().numpy()
        self._n_transp_draws = int(np.sum(~mask))
        self._n_opaque_draws = int(np.sum(mask))
        self._n_transp_tris = int(b.transp_tri_valid.sum())
        self._n_opaque_tris = int(b.opaque_tri_valid.sum())
        # static: does any material trilinear-blend two mip levels? If not,
        # the shade stage drops its second tap gather
        mm = b.mat_meta.cpu().numpy()
        self._trilinear = bool(np.any(
            (mm[:, 4] > 1)
            & (mm[:, 5].astype(np.int32) & FILTER_MIP_LINEAR).astype(bool)))
        # static: every bound texture has power-of-two dims -> the REPEAT
        # wrap is a bitwise AND (bit-identical to the mod path)
        dims = mm[:, 2:4].astype(np.int64)
        self._pot = bool(np.all((dims > 0) & ((dims & (dims - 1)) == 0)))
        # static: a sampled mip chain anywhere (the cost model's tap count)
        self._textured = bool(np.any(mm[:, 4] >= 1))
        # auto quality (config.target_fps): the render scale the cost model
        # predicts reaches the target on this scene
        self._auto_scale = self._pick_auto_scale()
        if self._auto_scale < 1.0:
            logger.info("auto quality: predicted %.1f ms/frame at the native "
                        "extent > %.1f ms budget: render scale %.2f",
                        self._predict_frame_ms(1.0),
                        1000.0 / self.config.target_fps, self._auto_scale)

    # The per-pixel cost model of the auto quality, in the JAX package's
    # form: frame_ms(s) = fixed + Mpx * s^2 * (base + taps * tap) + blit
    # (blit only when s < 1). The constants are fits to graphed frames
    # (frame_graph.py) of the bench scene measured on an NVIDIA H100 80GB
    # HBM3 at a 700 W power limit by tools/fit_cost_model.py (the points,
    # the fit and its residuals are in PERF.md): trilinear at s = 1.0 and
    # s = 0.7 split the fixed from the per-pixel cost, the single-tap frame
    # at s = 1.0 splits base from tap.
    #   _COST_TAP_NS:   what a second mip tap adds, spread over the pixels
    #   _COST_BASE_NS:  the rest of the per-pixel cost
    #   _COST_FIXED_MS: what does not shrink with the draw extent (setup,
    #                   bins and the raster over the scene's triangles); a
    #                   target whose budget lies below it floors at
    #                   auto_scale_min
    #   _COST_BLIT_MS:  the linear upscale blit, timed alone
    # _COST_MARGIN keeps the pick under budget through frame-to-frame
    # variance.
    _COST_BASE_NS = 0.666
    _COST_TAP_NS = 0.005
    _COST_FIXED_MS = 2.66
    _COST_BLIT_MS = 0.28
    _COST_MARGIN = 0.97

    def _scene_taps(self) -> int:
        """Mip-tap gathers per textured pixel on this scene's hot path."""
        if self._trilinear:
            return 2
        return 1 if self._textured else 0

    def _predict_frame_ms(self, s: float) -> float:
        cfg = self.config
        mpx = cfg.width * cfg.height / 1e6
        t = (self._COST_FIXED_MS
             + mpx * s * s * (self._COST_BASE_NS
                              + self._scene_taps() * self._COST_TAP_NS))
        return t + (self._COST_BLIT_MS if s < 1.0 else 0.0)

    def _pick_auto_scale(self) -> float:
        """Largest render scale in [auto_scale_min, 1], in steps of 0.05,
        that the cost model predicts reaches config.target_fps (1.0 when no
        target is set or the native extent is already under budget; the
        floor when no scale reaches it)."""
        cfg = self.config
        if cfg.target_fps is None:
            return 1.0
        budget_ms = self._COST_MARGIN * 1000.0 / cfg.target_fps
        s = 1.0
        while s > cfg.auto_scale_min and self._predict_frame_ms(s) > budget_ms:
            s = round(s - 0.05, 2)
        return max(s, cfg.auto_scale_min)

    # -- per-frame ------------------------------------------------------------

    def frame_params(self) -> FrameParams:
        """update_scene's uniform block (vk_engine.cpp:1479-1512): the
        static pieces are uploaded once; per frame only the view matrix."""
        cfg = self.config
        key = (cfg, self.current_background_effect)
        if self._params_key != key:
            dev = self.device
            f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
            proj = math3d.vulkan_perspective(
                math3d.radians(cfg.fov_y_deg), cfg.aspect, cfg.z_near, cfg.z_far)
            if self.current_background_effect == 0:
                d1, d2 = cfg.gradient_data1, cfg.gradient_data2
            else:
                d1, d2 = cfg.sky_data1, (0.0, 0.0, 0.0, 0.0)
            self._params_static = FrameParams(
                view=torch.eye(4, dtype=torch.float32, device=dev),
                proj=torch.as_tensor(np.asarray(proj, np.float32), device=dev),
                bg_effect=torch.tensor(self.current_background_effect,
                                       dtype=torch.int32, device=dev),
                bg_data1=f(d1), bg_data2=f(d2),
                ambient=f(cfg.ambient_color),
                sun_dir=f(cfg.sunlight_direction),
                sun_color=f(cfg.sunlight_color),
            )
            self._params_key = key
        view = torch.from_numpy(np.asarray(self.camera.get_view_matrix(), np.float32))
        if self.device.type == "cuda":
            # through pinned memory, so the host does not wait for the card
            view = view.pin_memory().to(self.device, non_blocking=True)
        return self._params_static._replace(view=view.to(self.device))

    def update_scene(self, top_matrix=None,
                     refresh_transforms: bool = False) -> FrameParams:
        """The camera, the transforms when asked, and the frame's uniforms
        (a host span update_scene, while tracing)."""
        with profiling.span("update_scene"):
            t0 = time.perf_counter()
            self.camera.update()
            if refresh_transforms or top_matrix is not None:
                self.flat.refresh_transforms(self.scene, top_matrix)
            params = self.frame_params()
            self.stats.scene_update_time = (time.perf_counter() - t0) * 1000.0
            return params

    def draw_device(self, params: Optional[FrameParams] = None):
        """Render one frame, leaving the image on the device. Returns (image
        (H, W) int32 packed RGBA tensor, aux dict of device scalars). On the
        card outside pipeline.eager(), with no mesh or a mesh over nccl, a
        replay of the frame graph of these statics (captured at their first
        frame; render_fn); the image and aux are the caller's own."""
        if params is None:
            params = self.update_scene()
        with profiling.span("draw_device"):
            cfg = self.config
            statics = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                           fp16=cfg.framebuffer_fp16,
                           transp_textured=self._transp_textured(), fused=self._fused,
                           trilinear=self._trilinear, pot=self._pot,
                           bg_fb=self._bg_fb_cached(params), **self._extents(),
                           **self._caps)
            image, aux = self.render_fn()(self.flat.buffers, params, **statics)
            self.frame_number += 1
            self._last_aux = aux
            return image, aux

    def render_fn(self):
        """What draws this engine's frames, with render_frame's signature:
        on the card outside pipeline.eager() a replay of the frame graph of
        the frame's statics (frame_graphs.frame), over a mesh only where its
        backend is nccl (the graph holds the rank's collectives); else
        op by op, render_frame or over a mesh render_frame_multichip (the
        same statics and caps; the aux counters composite over it, so the
        stats and the cap escalation read them as the single-device
        frame's)."""
        if self.mesh is None:
            return self.frame_graphs.frame if graphed(self.device) else render_frame
        if graphed(self.device) and self.mesh.backend == "nccl":
            return functools.partial(self.frame_graphs.frame, mesh=self.mesh)
        from tpu_renderer_torch.parallel.multichip import render_frame_multichip

        return functools.partial(render_frame_multichip, mesh=self.mesh)

    def _bg_fb_cached(self, params: FrameParams):
        """Background framebuffer (kernel 2.9 or 2.10), cached across
        frames: a pure function of the background effect/params and the
        render extent, so it is launched at the first draw, at an effect
        switch and at a resize. The engine knows the effect on the host, so
        nothing is read back."""
        cfg = self.config
        ext = self._extents()
        key = (self.current_background_effect, ext["width"], ext["height"])
        if self._bg_key != key:
            extent = dict(width=ext["width"], height=ext["height"],
                          tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                          effect=self.current_background_effect)
            if self.mesh is not None:
                # the whole background at the mesh's padded extent; each
                # rank slices its band from it
                from tpu_renderer_torch.parallel import multichip

                self._bg_fb = multichip.background_fb(params, mesh=self.mesh,
                                                      **extent)
            else:
                self._bg_fb = background_fb(params, **extent)
            self._bg_key = key
        return self._bg_fb

    def _extents(self) -> dict:
        """Render and output extents: render_scale scales the draw extent
        and the frame linear-blits to the window extent (the reference's
        _render_scale path made live, vk_engine.cpp:1220-1222). With
        config.target_fps set, the auto-quality scale applies where it is
        below the configured render_scale."""
        cfg = self.config
        s = cfg.render_scale
        if cfg.target_fps is not None:
            s = min(s, self._auto_scale)
        if s == 1.0:
            return dict(width=cfg.width, height=cfg.height)
        # the height follows the effective width scale, so a non-round scale
        # cannot break the aspect ratio
        w = max(1, int(round(cfg.width * s)))
        h = max(1, int(round(cfg.height * w / cfg.width)))
        return dict(width=w, height=h, out_width=cfg.width, out_height=cfg.height)

    def draw(self, with_stats: bool = True, hud: bool = False) -> np.ndarray:
        """Render one frame; returns the (H, W, 4) uint8 image on the host.

        The fused path's dense bins are uncapped, so nothing can overflow.
        On the deferred path a frame that overflows a bin capacity
        escalates the caps and the same frame (same camera params: the
        scene is not updated again) redraws before draw returns, up to 4
        times.

        hud=True burns the stats overlay into the frame (the ImGui window,
        vk_engine.cpp:1175-1191)."""
        t0 = time.perf_counter()
        params = self.update_scene()
        image, aux = self.draw_device(params)
        if with_stats and self._fused:
            self._update_stats(aux)
        elif with_stats:
            for _ in range(4):
                caps = dict(self._caps)
                self._update_stats(aux)   # escalates the caps on overflow
                if self._caps == caps:
                    break
                image, aux = self.draw_device(params)
        out = unpack_u8(image)
        self.stats.mesh_draw_time = (time.perf_counter() - t0) * 1000.0
        if hud:
            out = out.copy()
            hud_mod.draw_stats(out, self.stats)
        return out

    # -- pipelined interactive path (the FRAME_OVERLAP analog) ---------------

    def draw_pipelined(self, hud: bool = False, stats_interval: int = 30,
                       present_cells=None) -> Optional[np.ndarray]:
        """Render one frame with FRAME_OVERLAP frames in flight; returns the
        host image of the frame submitted FRAME_OVERLAP - 1 calls ago (None
        while the pipeline fills).

        The reference never presents the frame it just recorded either: it
        keeps 3 frames in flight and blocks only on the fence 3 frames back
        (vk_engine.cpp:1226-1240). Here frame N is enqueued with a
        non-blocking copy into a pinned host image and an event after it;
        the call then waits on frame N-2's event only, so that frame's copy
        overlaps the device work of the next two. On the CPU the frames are
        rendered synchronously and returned in the same sequence.

        present_cells=(cols, rows): present only a terminal raster's
        samples, a nearest subsample on the device with the index map of
        viewer.frame_to_halfblocks, returned as (rows * 2, cols, 4).
        Stats (one small device fetch) refresh every stats_interval frames;
        on the deferred path that delays the cap escalation by up to an
        interval (the fused path cannot overflow).

        Host spans, while tracing: draw_pipelined, and inside it
        update_scene, draw_device, submit, fetch (the frame it delivers:
        wait and copy_out) and update_stats."""
        with profiling.span("draw_pipelined"):
            t0 = time.perf_counter()
            params = self.update_scene()
            image, aux = self.draw_device(params)
            with profiling.span("submit"):
                if present_cells is not None:
                    cols, rows = present_cells
                    h, w = image.shape
                    ys = (np.arange(rows * 2) * (h / (rows * 2))).astype(np.int64).clip(0, h - 1)
                    xs = (np.arange(cols) * (w / cols)).astype(np.int64).clip(0, w - 1)
                    image = image[torch.as_tensor(ys, device=self.device)][
                        :, torch.as_tensor(xs, device=self.device)]
                self._inflight.append(self._submit(image, aux))
            if len(self._inflight) < self.FRAME_OVERLAP:
                return None
            old = self._inflight.popleft()
            with profiling.span("fetch", frame=old.traced_frame):
                out = old.image()
            if stats_interval and (old.frame_number - 1) % stats_interval == 0:
                with profiling.span("update_stats"):
                    self._update_stats(old.aux)
            self.stats.mesh_draw_time = (time.perf_counter() - t0) * 1000.0
            if hud and present_cells is None:
                hud_mod.draw_stats(out, self.stats)
            return out

    def _submit(self, image, aux) -> _InFlight:
        """Start frame `image`'s copy to the host. On CUDA: into the least
        recently used of FRAME_OVERLAP pinned images (at most FRAME_OVERLAP
        - 1 frames are in flight here, so its frame has been read), with an
        event recorded behind the copy."""
        if self.device.type != "cuda":
            return _InFlight(image, None, aux, self.frame_number)
        full = len(self._slots) == self.FRAME_OVERLAP
        host = self._slots.pop(0) if full else None
        if host is None or host.shape != image.shape:
            host = torch.empty(image.shape, dtype=image.dtype, pin_memory=True)
        self._slots.append(host)
        host.copy_(image, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return _InFlight(host, ready, aux, self.frame_number)

    def flush_pipelined(self) -> Optional[np.ndarray]:
        """Drain the frames in flight (the end of an interactive run);
        returns the last one, or None when there was none."""
        out = None
        while self._inflight:
            out = self._inflight.popleft().image()
        return out

    def _update_stats(self, aux) -> None:
        # one batched device->host transfer for all counters
        keys = sorted(aux.keys())
        vals = torch.stack([aux[k].to(torch.int32) for k in keys]).tolist() \
            if keys else []
        a = dict(zip(keys, vals))
        self.stats.triangle_count = (a.get("opaque_triangles", self._n_opaque_tris)
                                     + self._n_transp_tris)
        self.stats.drawcall_count = (a.get("visible_opaque_draws",
                                           self._n_opaque_draws)
                                     + self._n_transp_draws)
        chunk_of = a.get("bin_overflow", 0) + a.get("bin_overflow_transparent", 0)
        tri_of = (a.get("bin_overflow_tris", 0)
                  + a.get("bin_overflow_transparent_tris", 0))
        if chunk_of or tri_of:
            logger.warning("bin overflow: %d chunk / %d triangle entries "
                           "dropped; escalating the caps", chunk_of, tri_of)
            self._escalate_caps(chunks=chunk_of > 0, tris=tri_of > 0)

    def _escalate_caps(self, chunks: bool = True, tris: bool = True) -> None:
        """Double the capacity that overflowed, and only that one (bounded:
        bin_cap 8192, tri_cap 16384) — the analog of the reference's
        growable descriptor pools (vk_descriptors.cpp:70-170)."""
        c = self._caps
        self._caps = dict(
            bin_cap=min(c["bin_cap"] * 2, 8192) if chunks else c["bin_cap"],
            tri_cap=min(c["tri_cap"] * 2, 16384) if tris else c["tri_cap"])

    def _transp_textured(self) -> bool:
        """Static: does any transparent material bind a real texture?"""
        return any(m.transparent and m.tex != scene_mod.TEX_WHITE
                   for m in self.scene.materials)

    # -- frame loop (vk_engine.cpp:1161-1203) --------------------------------

    def run(self, n_frames: int, on_frame=None) -> np.ndarray:
        """Headless run(): n_frames of update+draw; returns the last frame.
        on_frame(engine, frame_idx, image) may inject camera input."""
        image = None
        for i in range(n_frames):
            t0 = time.perf_counter()
            image = self.draw()
            self.stats.frame_time = (time.perf_counter() - t0) * 1000.0
            if on_frame is not None:
                on_frame(self, i, image)
        return image

    def resize(self, width: int, height: int) -> None:
        """resize_swapchain analog (vk_engine.cpp:1520-1534): the next frame
        renders at the new extent. Frames in flight, the background and the
        pinned host images of the old extent are dropped."""
        self.config = self.config.with_extent(width, height)
        self._drop_frame_state()
        self._compute_caps()

    def cleanup(self) -> None:
        """Drop the scene, its device buffers and every cached frame
        (vk_engine.cpp:1131-1159)."""
        self._drop_frame_state()
        self.scene = None
        self.flat = None
        self._caps = None

    def _drop_frame_state(self) -> None:
        self.frame_graphs.clear()
        self._inflight.clear()
        self._slots.clear()
        self._bg_fb = None
        self._bg_key = None
        self._last_aux = None

"""Engine façade — init/run/draw in the shape of the reference's
VulkanEngine (vk_engine.h:79-227, init vk_engine.cpp:171-201, run
:1161-1203, draw :1218-1339), headless, on one torch device.

What stays from the reference: the frame loop, the FPS camera, scene
update, the EngineStats counters and the background-effect selection. The
scene and every frame live on the engine's device: the CUDA card by
default, the CPU with Engine(config, device="cpu").

Scenes past config.dense_bin_max_chunks (and config.fused=False) take the
capped deferred raster path; a frame whose bins overflow escalates the
caps and redraws the same frame (draw).

What the port does not have yet raises NotImplementedError naming the
ROADMAP.md item: render_scale != 1 and target_fps (the upscale blit and
the auto-quality cost model), multichip, draw_pipelined and the HUD
overlay.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from tpu_renderer_torch import math3d, scene as scene_mod
from tpu_renderer_torch.camera import Camera
from tpu_renderer_torch.config import RendererConfig
from tpu_renderer_torch.kernels import raster
from tpu_renderer_torch.pipeline import FrameParams, background_fb, render_frame
from tpu_renderer_torch.present import unpack_u8
from tpu_renderer_torch.resources import FILTER_MIP_LINEAR

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class EngineStats:
    """Mirror of EngineStats (vk_engine.h:16-22)."""

    frame_time: float = 0.0        # ms
    triangle_count: int = 0
    drawcall_count: int = 0
    scene_update_time: float = 0.0  # ms
    mesh_draw_time: float = 0.0     # ms


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to tpu_renderer_torch yet: ROADMAP.md {item}")


def _check_config(cfg: RendererConfig) -> None:
    """Raise on every config value the port does not implement."""
    default = RendererConfig()
    if cfg.render_scale != 1.0:
        raise _not_ported("render_scale != 1 (the upscale blit)",
                          "Queue 1 item 8")
    if cfg.target_fps is not None:
        raise _not_ported("target_fps (auto quality; its cost model was "
                          "fitted on another device)", "Queue 1 item 8")
    if cfg.multichip is not None:
        raise _not_ported("multichip", "Queue 1 item 11")
    if (cfg.tile_h, cfg.tile_w) != (raster.TILE_H, raster.TILE_W):
        raise _not_ported(f"tile {cfg.tile_h}x{cfg.tile_w} (the kernels take "
                          f"{raster.TILE_H}x{raster.TILE_W})",
                          "Queue 1 item 9 (Hopper tile sweep)")
    if (cfg.raster_chunk, cfg.raster_group) != (raster.CHUNK, raster.GROUP):
        raise _not_ported(f"raster_chunk={cfg.raster_chunk}, raster_group="
                          f"{cfg.raster_group} (the port owns CHUNK="
                          f"{raster.CHUNK}, GROUP={raster.GROUP})",
                          "Queue 1 item 9 (Hopper CHUNK/GROUP sweep)")
    if cfg.raster_nbuf != default.raster_nbuf:
        raise _not_ported("raster_nbuf (a TPU DMA-ring depth)",
                          "Queue 1 item 9")
    if cfg.raster_sort != "hilbert":
        raise _not_ported(f"raster_sort={cfg.raster_sort!r}", "Queue 1 item 12")


class Engine:
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
        self._last_aux = None
        self._params_key = None
        self._bg_key = None
        self._caps = None

    # -- init (vk_engine.cpp:171-201) ---------------------------------------

    def init(self, scene_path: Optional[str] = None,
             scene: Optional[scene_mod.LoadedScene] = None,
             variant=None) -> None:
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Engine runs on the CUDA card by default and no CUDA device "
                "is available: pass device=\"cpu\" to render on the CPU")
        if scene is not None:
            self.scene = scene
        elif scene_path is not None:
            self.scene = scene_mod.load_scene(scene_path, variant=variant)
        else:
            # empty scene: background only
            self.scene = scene_mod.LoadedScene()
            scene_mod.default_materials_and_textures(self.scene)
        self.flat = scene_mod.flatten_scene(self.scene, device=self.device)
        self._compute_caps()

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
        view = np.asarray(self.camera.get_view_matrix(), np.float32)
        return self._params_static._replace(
            view=torch.as_tensor(view, device=self.device))

    def update_scene(self, top_matrix=None,
                     refresh_transforms: bool = False) -> FrameParams:
        t0 = time.perf_counter()
        self.camera.update()
        if refresh_transforms or top_matrix is not None:
            self.flat.refresh_transforms(self.scene, top_matrix)
        params = self.frame_params()
        self.stats.scene_update_time = (time.perf_counter() - t0) * 1000.0
        return params

    def draw_device(self, params: Optional[FrameParams] = None):
        """Render one frame, leaving the image on the device. Returns (image
        (H, W) int32 packed RGBA tensor, aux dict of device scalars)."""
        if params is None:
            params = self.update_scene()
        cfg = self.config
        image, aux = render_frame(
            self.flat.buffers, params,
            width=cfg.width, height=cfg.height,
            tile_h=cfg.tile_h, tile_w=cfg.tile_w,
            fp16=cfg.framebuffer_fp16,
            transp_textured=self._transp_textured(), fused=self._fused,
            trilinear=self._trilinear, pot=self._pot,
            bg_fb=self._bg_fb_cached(params), **self._caps)
        self.frame_number += 1
        self._last_aux = aux
        return image, aux

    def _bg_fb_cached(self, params: FrameParams):
        """Background framebuffer, cached across frames: a pure function of
        the background effect/params and the draw extent."""
        cfg = self.config
        key = (self.current_background_effect, cfg.width, cfg.height)
        if self._bg_key != key:
            self._bg_fb = background_fb(params, width=cfg.width,
                                        height=cfg.height, tile_h=cfg.tile_h,
                                        tile_w=cfg.tile_w)
            self._bg_key = key
        return self._bg_fb

    def draw(self, with_stats: bool = True, hud: bool = False) -> np.ndarray:
        """Render one frame; returns the (H, W, 4) uint8 image on the host.

        The fused path's dense bins are uncapped, so nothing can overflow.
        On the deferred path a frame that overflows a bin capacity
        escalates the caps and the same frame (same camera params: the
        scene is not updated again) redraws before draw returns, up to 4
        times."""
        if hud:
            raise _not_ported("the HUD overlay", "Queue 1 item 9")
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
        return out

    def draw_pipelined(self, *args, **kwargs):
        raise _not_ported("draw_pipelined (FRAME_OVERLAP frames in flight)",
                          "Queue 1 item 8")

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

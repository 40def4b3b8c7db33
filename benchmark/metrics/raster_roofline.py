"""raster_roofline: the raster stage's share of its roofline, %: the least
time the card could take for the frame's raster work (roofline.py, counted
by the benchmark's reference from the scene and the camera) over the device
ms a frame inside the stage windows around the raster passes (kernels
2.1-2.5 and their wrappers, kernels/raster.py), in eager frames of the
window's key at the camera the work was counted at."""

STAGES = ("tpu_renderer_torch.kernels.raster.rasterize_fused",
          "tpu_renderer_torch.kernels.raster.rasterize_accum",
          "tpu_renderer_torch.kernels.raster.rasterize_peel_fused",
          "tpu_renderer_torch.kernels.raster.rasterize",
          "tpu_renderer_torch.kernels.raster.rasterize_peel")
COUNTS = True


def read(t):
    ms = t.get("stage_ms")
    bound = t.get("raster_bound_ms")
    if not ms or bound is None:
        return None
    spent = sum(ms.get(f, 0.0) for f in STAGES)
    if spent <= 0.0:
        return None
    return 100.0 * bound / spent

"""shade_device_ms: the device ms a frame of the shading (kernels/shade.py:
the opaque pass's shade and, on a peel path, every layer's), from the stage
windows around these functions in eager frames of the window's key, under
torch.profiler."""

STAGES = ("tpu_renderer_torch.kernels.shade.shade_fused",
          "tpu_renderer_torch.kernels.shade.shade",
          "tpu_renderer_torch.kernels.shade.blend_layer")


def read(t):
    ms = t.get("stage_ms")
    if not ms or not any(ms.get(f) for f in STAGES):
        return None
    return sum(ms.get(f, 0.0) for f in STAGES)

"""setup_device_ms: the device ms a frame of the cull and the triangle
setup (kernels/vertex.py), from the stage windows around these functions
in eager frames of the window's key, under torch.profiler."""

STAGES = ("tpu_renderer_torch.kernels.vertex.draw_visibility",
          "tpu_renderer_torch.kernels.vertex.triangle_setup_rows",
          "tpu_renderer_torch.kernels.vertex.triangle_setup_c")


def read(t):
    ms = t.get("stage_ms")
    if not ms or not any(ms.get(f) for f in STAGES):
        return None
    return sum(ms.get(f, 0.0) for f in STAGES)

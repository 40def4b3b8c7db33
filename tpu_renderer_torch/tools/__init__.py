"""Profiling tools of the port (python3 -m tpu_renderer_torch.tools.<name>)."""

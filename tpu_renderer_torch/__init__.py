"""tpu_renderer_torch — the PyTorch + CUDA port of tpu_renderer.

The same software rasterizer (glTF scene in, packed RGBA8 frame out) on one
NVIDIA Hopper GPU, the default device (pass device="cpu" for the CPU):
plain PyTorch for the elementwise, sort and gather work, and hand-written
CUDA kernels for the raster passes — the opaque fused raster, the
transparent accumulation, the textured-transparency depth peel, and the
deferred path's visibility raster and peel
(`tpu_renderer_torch.kernels.raster`) — and for the background compute
pass (`tpu_renderer_torch.kernels.background`), sources in `kernels/csrc/`.
Entry points: `Engine`, and `python -m tpu_renderer_torch.cli`. The JAX
package `tpu_renderer` stays the reference; this
package imports neither it nor JAX. Its host modules (config, math3d,
camera, gltf, the scene graph, utils) are copies of the JAX package's.
"""

from tpu_renderer_torch.config import RendererConfig
from tpu_renderer_torch.engine import Engine, EngineStats

__version__ = "0.1.0"

__all__ = ["RendererConfig", "Engine", "EngineStats", "__version__"]

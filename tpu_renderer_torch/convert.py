"""Carry a scene and frame uniforms across from the JAX package.

The JAX package's SceneBuffers / FrameParams leaves, taken to the host as
numpy arrays (np.asarray of each field), become the port's tensors on a
device. The tests use this to feed both packages the same inputs.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tpu_renderer_torch.kernels import raster
from tpu_renderer_torch.kernels.common import round_up
from tpu_renderer_torch.kernels.vertex import CornerData
from tpu_renderer_torch.pipeline import FrameParams, SceneBuffers
from tpu_renderer_torch.resources import TextureAtlas

# per-triangle fields and the value their padding rows take
_TRI_FIELDS = {"tri_vidx": 0, "tri_draw": -1, "tri_valid": False}


def _pad_rows(a: np.ndarray, n: int, value) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], value, a.dtype)
    return np.concatenate([a, pad])


def _corners(d: Mapping, n: int, device) -> CornerData:
    """CornerData from its fields (extra fields of the JAX package's
    CornerData, its T-minor twins, are ignored), padded to n triangles."""
    return CornerData(*(
        torch.as_tensor(_pad_rows(np.asarray(d[f]), n, 0), device=device)
        for f in CornerData._fields))


def scene_buffers_from_numpy(d: Mapping, device="cuda") -> SceneBuffers:
    """The port's SceneBuffers on `device` (the CUDA card by default) from a
    mapping of the JAX package's SceneBuffers fields to numpy arrays;
    `atlas`, `opaque_corners` and `transp_corners` are mappings of their own
    fields. Triangle arrays are
    padded to a multiple of the port's raster.CHUNK with inert rows."""
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
    out = {}
    for name in SceneBuffers._fields:
        if name == "atlas":
            a = d["atlas"]
            quads = np.ascontiguousarray(np.asarray(a["quads"], np.uint32))
            out[name] = TextureAtlas(quads=t(quads.view(np.int32)),
                                     width=int(a["width"]),
                                     tex_meta=np.asarray(a["tex_meta"]))
        elif name.endswith("_corners"):
            prefix = name.split("_")[0]   # opaque / transp
            n = round_up(np.asarray(d[f"{prefix}_tri_draw"]).shape[0], raster.CHUNK)
            out[name] = _corners(d[name], n, device)
        elif any(name.endswith(k) for k in _TRI_FIELDS):
            value = _TRI_FIELDS[name.split("_", 1)[1]]
            a = np.asarray(d[name])
            out[name] = t(_pad_rows(a, round_up(a.shape[0], raster.CHUNK), value))
        else:
            out[name] = t(d[name])
    return SceneBuffers(**out)


def frame_params_from_numpy(d: Mapping, device="cuda") -> FrameParams:
    """The port's FrameParams from a mapping of the JAX package's
    FrameParams fields to numpy arrays."""
    return FrameParams(**{
        k: torch.as_tensor(np.asarray(d[k], np.int32 if k == "bg_effect"
                                      else np.float32), device=device)
        for k in FrameParams._fields})

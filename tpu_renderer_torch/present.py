"""Present path — the swapchain blit + present (vk_images.cpp:33-64,
vk_engine.cpp:1268-1336): crop the padded planar framebuffer, convert float
-> unorm8 (clamp, round half to even as jnp.round does) packed into one
plane, and view the bytes as (H, W, 4) uint8 RGBA on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def to_packed_u32(fb, *, width: int, height: int):
    """(4, Hp, Wp) float framebuffer -> (H, W) int32 tensor whose bits are
    the RGBA8 word r | g<<8 | b<<16 | a<<24 (the JAX package's uint32
    pixel, reinterpreted). Packed in int64, then narrowed."""
    crop = fb[:, :height, :width].to(torch.float32)
    q = torch.clamp(torch.round(crop * 255.0), 0.0, 255.0).to(torch.int64)
    packed = q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24)
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed).to(torch.int32)


def unpack_u8(packed) -> np.ndarray:
    """Host: (H, W) packed plane (int32 tensor or uint32/int32 array) ->
    (H, W, 4) uint8 RGBA (little-endian byte order matches the packing)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    a = np.ascontiguousarray(packed)
    assert a.dtype in (np.uint32, np.int32)
    return a.view(np.uint8).reshape(*a.shape, 4)


def save_png(image_u8: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(np.asarray(image_u8), mode="RGBA").save(path)


def load_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGBA"))

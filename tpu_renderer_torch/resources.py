"""Device resources — the analog of the reference's VMA allocations,
texture uploads and mip generation (vk_engine.cpp:308-338, 1537-1617,
vk_images.cpp:66-133) plus upload_mesh (vk_engine.cpp:340-390).

The atlas layout is the JAX package's (tpu_renderer/resources.py), so the
two packages sample bit-identical texels: one frame needs exactly one
16-byte-row gather per sampled mip level:

* **Analytic atlas layout**: each texture is a packed horizontal pyramid —
  with ``W2 = 2 * max(w0, h0)``, mip level L sits at
  ``x = base_x + W2 - (W2 >> L)`` with size ``(w0 >> L, h0 >> L)``
  (offsets 0, W2/2, 3W2/4, ... — the geometric series packs the whole
  chain into a strip < 2x the base width, ~3.5x tighter than one w0-wide
  slot per level). No per-(texture, level) entry table is ever consulted
  per pixel; level addressing is pure arithmetic from per-texture scalars.
  Using max(w0, h0) keeps every level's slot at least as wide as the
  level itself for non-square textures (slot width W2 >> (L+1) >= the
  clamped level width max(w0 >> L, 1) for every generated level).
* **Prebaked bilinear quads**: the atlas is stored as rows of 4 packed-RGBA8
  texels — texel (x, y) plus its +x/+y/+xy neighbors with REPEAT wrap baked
  inside the level region. A bilinear tap = ONE row gather; nearest-filter
  taps select the right texel from the same quad.

Texture defaults mirror init_default_data (vk_engine.cpp:226-306): 1px
white/grey/black, a 32x32 magenta/black checkerboard used as the error
placeholder (vk_loader.cpp:224-229).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

# Filter flag bits (per material): Vulkan sampler state flattened.
FILTER_MAG_LINEAR = 1
FILTER_MIN_LINEAR = 2
FILTER_MIP_LINEAR = 4


def make_white(size: int = 1) -> np.ndarray:
    return np.full((size, size, 4), 255, np.uint8)


def make_grey() -> np.ndarray:
    # vk_engine.cpp:234 — 0xAAAAAAFF byte-swapped => RGBA (0xAA,0xAA,0xAA,0xFF)
    return np.tile(np.array([0xAA, 0xAA, 0xAA, 0xFF], np.uint8), (1, 1, 1))


def make_black() -> np.ndarray:
    return np.tile(np.array([0, 0, 0, 0xFF], np.uint8), (1, 1, 1))


def make_error_checkerboard() -> np.ndarray:
    """32x32 magenta/black checkerboard (vk_engine.cpp:241-250)."""
    magenta = np.array([0xFF, 0x00, 0xFF, 0xFF], np.uint8)
    black = np.array([0, 0, 0, 0xFF], np.uint8)
    img = np.empty((32, 32, 4), np.uint8)
    for y in range(32):
        for x in range(32):
            img[y, x] = magenta if ((x % 2) ^ (y % 2)) else black
    return img


def downsample_blit(img: np.ndarray) -> np.ndarray:
    """One mip level via the semantics of a linear-filtered vkCmdBlitImage
    half-size blit (vk_images.cpp:66-133): each destination pixel center maps
    to src coords (x+0.5)*scale - 0.5 and samples bilinearly. For even sizes
    this is an exact 2x2 box average.

    Uses the native C++ path (native/assetlib.cpp) when available.
    """
    from tpu_renderer_torch.utils import native

    out = native.downsample_blit_rgba8(img)
    if out is not None:
        return out
    h, w = img.shape[:2]
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    src = img.astype(np.float32)
    ys = (np.arange(nh) + 0.5) * (h / nh) - 0.5
    xs = (np.arange(nw) + 0.5) * (w / nw) - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    out = (
        src[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
        + src[np.ix_(y0, x1)] * (1 - fy) * fx
        + src[np.ix_(y1, x0)] * fy * (1 - fx)
        + src[np.ix_(y1, x1)] * fy * fx
    )
    # UNORM8 round-to-nearest (half up, matching the native path) per blit
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def mip_chain(img: np.ndarray, enabled: bool = True) -> List[np.ndarray]:
    """Full chain down to 1x1 (vk_engine.cpp:1603-1605 mipmap path).

    Level sizes follow (w0 >> L, h0 >> L) so the atlas layout stays
    analytic; identical to iterated floor-halving.
    """
    levels = [img]
    if not enabled:
        return levels
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        levels.append(downsample_blit(levels[-1]))
    return levels


def _pack_rgba8(img: np.ndarray) -> np.ndarray:
    """(h, w, 4) u8 -> (h, w) uint32 little-endian R | G<<8 | B<<16 | A<<24."""
    i = img.astype(np.uint32)
    return i[..., 0] | (i[..., 1] << 8) | (i[..., 2] << 16) | (i[..., 3] << 24)


def _quad_rows(level: np.ndarray) -> np.ndarray:
    """(h, w) u32 -> (h, w, 4) u32 of [T(x,y), T(x+1,y), T(x,y+1), T(x+1,y+1)]
    with REPEAT wrap inside the level."""
    xp = np.roll(level, -1, axis=1)
    yp = np.roll(level, -1, axis=0)
    xyp = np.roll(xp, -1, axis=0)
    return np.stack([level, xp, yp, xyp], axis=-1)


class TextureAtlas(NamedTuple):
    quads: torch.Tensor      # (HA * WA, 4) int32 on the target device —
    #                          prebaked bilinear quads, the RGBA8 words of the
    #                          JAX package's uint32 atlas reinterpreted as
    #                          int32 (torch's uint32 op coverage is thin; the
    #                          channels are read back with & 0xFF)
    width: int               # WA (static)
    tex_meta: np.ndarray     # (n_tex, 6) i32 host array — base_x, base_y,
    #                          w0, h0, n_levels, 0 (spare)


def build_atlas(images: List[np.ndarray], mipmapped=None,
                device="cuda") -> TextureAtlas:
    """Shelf-pack textures as analytic packed-pyramid strips into one quad
    atlas. The atlas width is the power-of-two cover of the widest strip.

    images: list of (h, w, 4) uint8. mipmapped: per-texture bools (or one
    bool / None = all mipmapped). device: where the quads tensor lives (the CUDA card by default).
    """
    assert images, "atlas needs at least one image"
    n = len(images)
    if mipmapped is None or not hasattr(mipmapped, "__len__"):
        mipmapped = [bool(mipmapped) if mipmapped is not None else True] * n
    assert len(mipmapped) == n, "one mipmapped flag per image"

    chains = []
    meta = np.zeros((n, 6), np.int32)
    for i, img in enumerate(images):
        assert img.ndim == 3 and img.shape[2] == 4 and img.dtype == np.uint8
        chain = mip_chain(img, enabled=mipmapped[i])
        h0, w0 = img.shape[:2]
        meta[i, 2] = w0
        meta[i, 3] = h0
        meta[i, 4] = len(chain)
        chains.append(chain)

    def _level_x(i: int, L: int) -> int:
        # packed pyramid: level L at W2 - (W2 >> L), W2 = 2 * max(w0, h0)
        w2 = 2 * max(int(meta[i, 2]), int(meta[i, 3]))
        return w2 - (w2 >> L)

    def _strip_w(i: int) -> int:
        n = len(chains[i])
        return _level_x(i, n - 1) + chains[i][n - 1].shape[1]

    widest = max(_strip_w(i) for i in range(n))
    aw = max(128, 1 << int(np.ceil(np.log2(widest))))

    # shelf packing of the packed-pyramid strips
    shelf_y = 0
    shelf_h = 0
    cursor_x = 0
    places = []
    for i, c in enumerate(chains):
        h, w = c[0].shape[0], _strip_w(i)
        if cursor_x + w > aw:
            shelf_y += shelf_h
            cursor_x = 0
            shelf_h = 0
        places.append((cursor_x, shelf_y))
        cursor_x += w
        shelf_h = max(shelf_h, h)
    ah = ((shelf_y + shelf_h + 7) // 8) * 8

    # the same envelope as the JAX package's atlas (its stream rows bit-pack
    # the texture placement), so both packages accept the same scenes
    assert aw <= 16384 and ah <= 65535, (
        f"texture atlas {aw}x{ah} exceeds the stream-row packing envelope "
        "(width <= 16384, height <= 65535)")
    assert int(meta[:, 2].max()) <= 16383, (
        "texture width > 16383 exceeds the 14-bit stream-row packing field")

    # bake levels straight into the atlas — the native path fuses RGBA8
    # packing + quad prebake + placement in one C++ pass per level
    from tpu_renderer_torch.utils import native

    quads = np.zeros((ah, aw, 4), np.uint32)
    for i, chain in enumerate(chains):
        x, y = places[i]
        for L, lvl in enumerate(chain):
            lx = x + _level_x(i, L)
            if not native.blit_quad_rows_u32(lvl, quads, lx, y):
                q = _quad_rows(_pack_rgba8(lvl))
                quads[y:y + lvl.shape[0], lx:lx + lvl.shape[1]] = q
        meta[i, 0] = x
        meta[i, 1] = y

    return TextureAtlas(
        quads=torch.from_numpy(quads.reshape(-1, 4).view(np.int32)).to(device),
        width=aw,
        tex_meta=meta,
    )

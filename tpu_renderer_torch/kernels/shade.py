"""Deferred shading — mesh.frag (shaders/mesh.frag:12-19) per pixel over the
fused raster's outputs, plus the sampler: analytic per-triangle mip LOD,
trilinear/nearest filtering and REPEAT wrap over the prebaked quad atlas
(resources.build_atlas). Plain PyTorch; the math is the JAX package's
(tpu_renderer/kernels/shade.py) operation for operation, with each
multiply-add fused (kernels.common.fma) where XLA fuses it for the JAX
reference on the CPU (measured), so both round alike. Everything works on
channel-major (Hp, Wp) planes.

On the fused path, shade_fused on CUDA tensors launches kernel 2.12
(csrc/shade.cu: the same operations in one loop, bit for bit the plain
version, shade_fused_plain, which CPU tensors take), and it can do the
composite that follows the shading in the frame as its epilogue. The
deferred path (shade, blend_layer: shade_core's fat-row gather) is plain
PyTorch on every device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from tpu_renderer_torch.kernels.common import dot3_seq, fma
from tpu_renderer_torch.kernels.raster import _Counter, _launch, _ptr, _stream
from tpu_renderer_torch.resources import (
    FILTER_MAG_LINEAR,
    FILTER_MIN_LINEAR,
    FILTER_MIP_LINEAR,
)
from tpu_renderer_torch.utils.profiling import checked

# The fat-row layout (48 f32 per triangle, vertex.triangle_setup_rows):
#   0-8 edge planes, 9-11 depth plane, 12 material id, 13-30 attribute
#   numerator planes [pa x6, pb x6, pc x6] (num_a(X, Y) = pa*X + pb*Y + pc;
#   attributes [light_num, r, g, b, u, v]), 31-36 texture binding (base_x,
#   base_y, w0, h0, n_levels, filter_flags), 37-42 uv-gradient planes
#   (nu_a, nu_b, nv_a, nv_b, den_a, den_b), 43 den_c, 44-47 screen box.

# the fat-row columns shade_core reads (the JAX package's C_* constants)
C_ATTR, C_TEX, C_GRAD, C_DEN = 13, 31, 37, 43

_INV255 = 1.0 / 255.0
_INV_LN2 = float(np.float32(1.0 / np.log(2.0)))

# shade_fused's epilogues (kernel 2.12's blend 1 and 2; 0 is the rgb form)
BLENDS = ("replace", "add")

# kernel 2.12's launches (shade_fused_kernel), and those of its two-tap
# instance (textured and trilinear: a LINEAR_MIPMAP_LINEAR sampler)
fused_counter = _Counter()
trilinear_counter = _Counter()


def build_shade_rows(packed, attrs, aabb, meta6):
    """(T, 16) packed setup rows + (T, 3, 6) per-corner attributes -> (T, 48)
    fat rows (the JAX package's shade.build_shade_rows with aabb and meta6
    given): the attributes fold into numerator planes, pa_a = sum_i
    A_i * attr[i, a] and likewise pb, pc; the uv-gradient and den planes
    are the slopes' and constants' sums."""
    A = [packed[:, 3 * e] for e in range(3)]
    B = [packed[:, 3 * e + 1] for e in range(3)]
    Cc = [packed[:, 3 * e + 2] for e in range(3)]
    pa, pb, pc = ([dot3_seq(K[0], attrs[:, 0, a], K[1], attrs[:, 1, a],
                             K[2], attrs[:, 2, a]) for a in range(6)]
                  for K in (A, B, Cc))
    # jnp.sum over the 3 edges: a sequential reduce
    sumA, sumB, den_c = ((K[0] + K[1]) + K[2] for K in (A, B, Cc))
    planes = ([packed[:, k] for k in range(12)] + [packed[:, 13]]
              + pa + pb + pc + [meta6[:, k] for k in range(6)]
              + [pa[4], pb[4], pa[5], pb[5], sumA, sumB, den_c]
              + [aabb[:, k] for k in range(4)])
    return torch.stack(planes, dim=1).contiguous()


def _chan(texel, shift: int):
    """One RGBA8 channel of a packed texel plane (int32 words) -> f32 [0,1]."""
    return ((texel >> shift) & 0xFF).to(torch.float32) * _INV255


def uv_gradients(u, v, grad_meta, inv):
    """Analytic per-pixel uv screen gradients: uv = num/den with both planes
    linear in X, Y, so d(uv)/dX = (num_X - uv * den_X) * inv.
    grad_meta: 6 planes [nu_a, nu_b, nv_a, nv_b, den_a, den_b].
    Returns (dudx, dudy, dvdx, dvdy)."""
    nu_a, nu_b, nv_a, nv_b, den_a, den_b = grad_meta
    # (nu - u * den) contracted to fma(-u, den, nu), as XLA does
    dudx = fma(-u, den_a, nu_a) * inv
    dudy = fma(-u, den_b, nu_b) * inv
    dvdx = fma(-v, den_a, nv_a) * inv
    dvdy = fma(-v, den_b, nv_b) * inv
    return dudx, dudy, dvdx, dvdy


def _level_coords(w0, h0, li, u, v, pot: bool = False):
    """Texel addressing at mip level li: level size, wrapped quad top-left
    and fractions. pot: every texture has power-of-two dims, so the REPEAT
    wrap is a bitwise AND; otherwise a floor-mod (torch.remainder)."""
    wl = torch.clamp(w0.to(torch.int32) >> li, min=1)
    hl = torch.clamp(h0.to(torch.int32) >> li, min=1)
    half = torch.full_like(u, -0.5)
    su = fma(u, wl.to(torch.float32), half)   # u * wl - 0.5, contracted
    sv = fma(v, hl.to(torch.float32), half)
    x0 = torch.floor(su).to(torch.int32)
    y0 = torch.floor(sv).to(torch.int32)
    fu = su - x0.to(torch.float32)
    fv = sv - y0.to(torch.float32)
    if pot:
        return wl, hl, x0 & (wl - 1), y0 & (hl - 1), fu, fv
    return wl, hl, torch.remainder(x0, wl), torch.remainder(y0, hl), fu, fv


def _sample_level(atlas, base_x, base_y, w0, h0, level, u, v, linear,
                  active=None, pot: bool = False):
    """One mip tap: one quad-row gather + planar filtering -> (r, g, b).

    Level L of a texture sits at x = base_x + W2 - (W2 >> L), with
    W2 = 2 * max(w0, h0). `active` (optional bool plane): pixels whose
    result is unused gather index 0."""
    li = level.to(torch.int32)
    wl, hl, x0w, y0w, fu, fv = _level_coords(w0, h0, li, u, v, pot=pot)
    w2 = torch.maximum(w0.to(torch.int32), h0.to(torch.int32)) << 1
    ex = base_x.to(torch.int32) + w2 - (w2 >> li)
    ey = base_y.to(torch.int32)

    flat = (ey + y0w) * atlas.width + (ex + x0w)
    if active is not None:
        flat = torch.where(active, flat, 0)
    quad = atlas.quads[flat.long()]                # (H, W, 4) — the gather
    t00 = quad[..., 0]
    t10 = quad[..., 1]
    t01 = quad[..., 2]
    t11 = quad[..., 3]

    # nearest texel: floor(u*w) is x0 or x0+1, both in this quad
    nx = fu >= 0.5
    ny = fv >= 0.5
    near = torch.where(nx, torch.where(ny, t11, t10), torch.where(ny, t01, t00))

    w11 = fu * fv
    w10 = fu - w11
    w01 = fv - w11
    w00 = 1.0 - fu - w01
    out = []
    for s in (0, 8, 16):
        # w00*c00 + w10*c10 + w01*c01 + w11*c11, contracted as XLA does
        bilin = fma(w11, _chan(t11, s), fma(w01, _chan(t01, s), fma(
            w10, _chan(t10, s), w00 * _chan(t00, s))))
        out.append(torch.where(linear, bilin, _chan(near, s)))
    return tuple(out)


def sample_texture(atlas, base_x, base_y, w0, h0, n_levels, flags, u, v,
                   grads, trilinear: bool = True, pot: bool = False):
    """Full sampler: analytic mip LOD, trilinear/nearest filtering, REPEAT
    wrap — two taps at most. trilinear=False skips the second tap, for
    scenes where no sampler mixes two mip levels (its weight is then 0)."""
    fl = flags.to(torch.int32)
    dudx, dudy, dvdx, dvdy = grads
    ax, bx = dudx * w0, dvdx * h0
    ay, by = dudy * w0, dvdy * h0
    rho_x = torch.sqrt(fma(ax, ax, bx * bx))
    rho_y = torch.sqrt(fma(ay, ay, by * by))
    rho = torch.maximum(rho_x, rho_y)
    # log2 as XLA evaluates it, log(x) * (1 / ln 2); the log itself may
    # still differ from XLA's by an ulp
    lod = torch.log(torch.clamp(rho, min=1e-12)) * _INV_LN2
    max_level = n_levels - 1.0
    lod = torch.minimum(torch.clamp(lod, min=0.0), max_level)

    mip_linear = (fl & FILTER_MIP_LINEAR) != 0
    # Vulkan: NEAREST mip mode picks ceil(lod + 0.5) - 1; LINEAR blends
    # floor/floor+1 by the fraction
    l_near = torch.minimum(torch.clamp(torch.ceil(lod + 0.5) - 1.0, min=0.0),
                           max_level)
    l_lo = torch.floor(lod)
    l_hi = torch.minimum(l_lo + 1.0, max_level)
    zero = torch.zeros((), device=lod.device)
    frac = torch.where(mip_linear, lod - l_lo, zero)
    lev_a = torch.where(mip_linear, l_lo, l_near)
    lev_b = torch.where(mip_linear, l_hi, l_near)

    mag_lin = (fl & FILTER_MAG_LINEAR) != 0
    min_lin = (fl & FILTER_MIN_LINEAR) != 0
    linear = torch.where(lod > 0.0, min_lin, mag_lin)

    ca = _sample_level(atlas, base_x, base_y, w0, h0, lev_a, u, v, linear,
                       pot=pot)
    if not trilinear:
        return ca
    cb = _sample_level(atlas, base_x, base_y, w0, h0, lev_b, u, v, linear,
                       active=frac > 0.0, pot=pot)
    inv = 1.0 - frac
    return tuple(fma(a, inv, b * frac) for a, b in zip(ca, cb))


def light_and_texture(light_num, color_in, uv, texmeta, grads, atlas,
                      ambient_rgb, sun_power, textured: bool = True,
                      trilinear: bool = True, pot: bool = False):
    """mesh.frag:12-19 given interpolated attribute planes. texmeta: 6
    planes [base_x, base_y, w0, h0, n_levels, filter_flags]; grads are
    ignored when textured is False (no texture is sampled). Returns
    (r, g, b) planes."""
    if textured:
        tex = sample_texture(atlas, texmeta[0], texmeta[1], texmeta[2],
                             texmeta[3], texmeta[4], texmeta[5], uv[0], uv[1],
                             grads, trilinear=trilinear, pot=pot)
    # mesh.frag:13 — light = max(dot(N, sunlight_direction.xyz), 0.1)
    light = torch.maximum(light_num, torch.full((), 0.1, dtype=torch.float32,
                                                device=light_num.device))
    scale = light * sun_power   # mesh.frag:15-18
    out = []
    for c in range(3):
        # color * scale + color * ambient, contracted as XLA does: with the
        # texture the scale product fuses, without it the ambient one
        if textured:
            color = color_in[c] * tex[c]
            out.append(fma(color, scale, color * ambient_rgb[c]))
        else:
            color = color_in[c]
            out.append(fma(color, ambient_rgb[c], color * scale))
    return tuple(out)


def shade_fused_plain(attrs, meta, inv, atlas, ambient_rgb, sun_power,
                      textured: bool = True, trilinear: bool = True,
                      pot: bool = False, *, fb=None, hit=None,
                      blend: Optional[str] = None, fp16: bool = True, out=None):
    """Plain PyTorch version of shade_fused_kernel (shade_fused's
    contract): the JAX package's shade_fused op for op, and the composite
    that follows it in the frame where `blend` is given."""
    grads = uv_gradients(attrs[4], attrs[5],
                         tuple(meta[6 + m] for m in range(6)), inv) \
        if textured else None
    r, g, b = light_and_texture(
        attrs[0], (attrs[1], attrs[2], attrs[3]),
        (attrs[4], attrs[5]), tuple(meta[m] for m in range(6)), grads,
        atlas, ambient_rgb, sun_power, textured=textured,
        trilinear=trilinear, pot=pot)
    rgb = torch.stack([r, g, b])
    if blend is None:
        return rgb
    new = composite(fb, hit, rgb, blend)
    if fp16:   # the R16G16B16A16_SFLOAT attachment's write
        new = new.half().float()
    if out is None:
        return new
    return out.copy_(new)


def composite(fb, hit, src, blend: str):
    """The framebuffer (4, Hp, Wp) after a pass's colour src (3, Hp, Wp)
    lands where hit: blend "replace" (the opaque pass) writes it,
    "add" (vk_pipelines.cpp:157-167) adds src + dst * dstAlpha, contracted as
    XLA does; alpha is 1 where hit, fb stays elsewhere. Before the fp16
    write."""
    if blend == "replace":
        rgb = torch.where(hit[None], src, fb[:3])
    else:
        rgb = torch.where(hit[None], fma(fb[:3], fb[3][None], src), fb[:3])
    alpha = torch.where(hit, torch.ones((), device=hit.device), fb[3])
    return torch.cat([rgb, alpha[None]])


def _check_fused(attrs, meta, inv, fb, hit, blend, out):
    """shade_fused's arguments, on any device: (Hp, Wp), or ValueError."""
    if attrs.dim() != 3 or attrs.shape[0] != 6:
        raise ValueError(f"attrs must be (6, Hp, Wp), got {tuple(attrs.shape)}")
    hw = tuple(attrs.shape[1:])
    for name, t, shape, dtype in (("attrs", attrs, (6, *hw), torch.float32),
                                  ("meta", meta, (13, *hw), torch.float32),
                                  ("inv", inv, hw, torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    if blend is None:
        if fb is not None or hit is not None or out is not None:
            raise ValueError("fb, hit and out go with a blend")
        return hw
    if blend not in BLENDS:
        raise ValueError(f"blend must be one of {BLENDS}, got {blend!r}")
    if fb is None or hit is None:
        raise ValueError(f"blend {blend!r} needs fb and hit")
    for name, t, shape, dtype in (("fb", fb, (4, *hw), torch.float32),
                                  ("hit", hit, hw, torch.bool),
                                  ("out", out, (4, *hw), torch.float32)):
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype):
            raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    return hw


def _overlap(a, b) -> bool:
    """Do the bytes of a and b overlap without being the same tensor's?"""
    a0, b0 = a.data_ptr(), b.data_ptr()
    if a0 == b0:
        return False
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


@checked
def shade_fused_kernel(attrs, meta, inv, atlas, ambient_rgb, sun_power,
                       textured: bool = True, trilinear: bool = True,
                       pot: bool = False, *, fb=None, hit=None,
                       blend: Optional[str] = None, fp16: bool = True, out=None):
    """Launch kernel 2.12 (csrc/shade.cu) on CUDA tensors: what
    shade_fused_plain returns, bit for bit, in one launch on the current
    stream with no wait on the device. Every argument is checked here,
    before the library is built or loaded: CUDA tensors on one device,
    contiguous; the atlas quads (N, 4) int32 on 16-byte boundaries;
    ambient_rgb (3,) and sun_power (one element) f32 tensors; out, where
    given, fb itself or apart from it."""
    hp, wp = _check_fused(attrs, meta, inv, fb, hit, blend, out)
    dev = attrs.device
    if dev.type != "cuda":
        raise ValueError(f"shade_fused_kernel takes CUDA tensors, got {dev}")
    if hp * wp >= 2 ** 31:
        raise ValueError(f"shade_fused_kernel takes fewer than 2^31 pixels, got {hp}x{wp}")
    quads = atlas.quads
    if quads.dim() != 2 or quads.shape[1] != 4 or quads.dtype != torch.int32 \
            or quads.shape[0] < 1:
        raise ValueError(f"atlas.quads must be (N, 4) int32, got {tuple(quads.shape)} "
                         f"{quads.dtype}")
    tensors = [("attrs", attrs), ("meta", meta), ("inv", inv), ("atlas.quads", quads),
               ("ambient_rgb", ambient_rgb), ("sun_power", sun_power),
               ("fb", fb), ("hit", hit), ("out", out)]
    for name, t in tensors:
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{name} must be a tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t, n in (("ambient_rgb", ambient_rgb, 3), ("sun_power", sun_power, 1)):
        if t.dtype != torch.float32 or t.numel() != n:
            raise ValueError(f"{name} must hold {n} float32, got {tuple(t.shape)} {t.dtype}")
    if quads.data_ptr() % 16:
        raise ValueError("atlas.quads must start on a 16-byte boundary")
    if out is not None and _overlap(out, fb):
        raise ValueError("out must be fb itself or apart from it")
    if out is None:
        out = torch.empty((3 if blend is None else 4, hp, wp), dtype=torch.float32, device=dev)
    _launch("shade_fused_launch", _ptr(attrs), _ptr(meta), _ptr(inv), _ptr(quads),
            ctypes.c_int(quads.shape[0]), ctypes.c_int(atlas.width), _ptr(ambient_rgb),
            _ptr(sun_power), _ptr(fb) if fb is not None else None,
            _ptr(hit) if hit is not None else None, _ptr(out), ctypes.c_int(hp * wp),
            ctypes.c_int(int(textured)), ctypes.c_int(int(trilinear)),
            ctypes.c_int(int(pot)), ctypes.c_int(BLENDS.index(blend) + 1 if blend else 0),
            ctypes.c_int(int(fp16)), _stream(dev))
    fused_counter.launches += 1
    if textured and trilinear:
        trilinear_counter.launches += 1
    return out


def shade_fused(attrs, meta, inv, atlas, ambient_rgb, sun_power,
                textured: bool = True, trilinear: bool = True,
                pot: bool = False, *, fb=None, hit=None,
                blend: Optional[str] = None, fp16: bool = True, out=None):
    """Shade from the fused raster's or peel's outputs: attrs (6, Hp, Wp)
    interpolated [light_num, rgb, uv]; meta (13, Hp, Wp) per-winner
    constants; inv (Hp, Wp). Returns (3, Hp, Wp) rgb.

    With blend ("replace": the opaque pass; "add": a peeled layer's
    additive blend), fb (4, Hp, Wp) and hit (Hp, Wp) bool, it returns the
    framebuffer after the composite instead (composite(), then the fp16
    write where fp16), written into out where given (which may be fb
    itself). CPU tensors take the plain version, CUDA tensors kernel 2.12
    (whose wrapper checks the arguments)."""
    if attrs.device.type == "cuda":
        return shade_fused_kernel(attrs, meta, inv, atlas, ambient_rgb, sun_power,
                                  textured, trilinear, pot, fb=fb, hit=hit, blend=blend,
                                  fp16=fp16, out=out)
    _check_fused(attrs, meta, inv, fb, hit, blend, out)
    return shade_fused_plain(attrs, meta, inv, atlas, ambient_rgb, sun_power, textured,
                             trilinear, pot, fb=fb, hit=hit, blend=blend, fp16=fp16, out=out)


def shade_core(t, rows, atlas, ambient_rgb, sun_power, textured: bool = True,
               trilinear: bool = True, pot: bool = False, y0: int = 0):
    """mesh.frag for a per-pixel triangle index plane t (a valid index
    everywhere; the caller masks pixels that have none) over the fat rows
    (the JAX package's shade.shade_core): one row gather per pixel, then
    the perspective-correct interpolation numerator * 1/den. t's first row
    is the frame's row y0 (a multi-device band). Returns (3, Hp, Wp) rgb."""
    hp, wp = t.shape
    dev = t.device
    g = rows[t.long()]                                # (Hp, Wp, 48)
    xx = (torch.arange(wp, dtype=torch.int32, device=dev).to(torch.float32)
          + 0.5)[None, :].expand(hp, wp)
    yy = (torch.arange(y0, y0 + hp, dtype=torch.int32, device=dev).to(torch.float32)
          + 0.5)[:, None].expand(hp, wp)

    def plane(a, b, c):   # a*X + b*Y + c, contracted as XLA does
        return fma(g[..., a], xx, g[..., b] * yy) + g[..., c]

    den = plane(C_GRAD + 4, C_GRAD + 5, C_DEN)
    inv = torch.where(den != 0.0, 1.0 / den, torch.zeros((), device=dev))
    interp = [plane(C_ATTR + a, C_ATTR + 6 + a, C_ATTR + 12 + a) * inv
              for a in range(6)]
    grads = uv_gradients(interp[4], interp[5],
                         tuple(g[..., C_GRAD + m] for m in range(6)), inv) \
        if textured else None
    r, gg, b = light_and_texture(
        interp[0], (interp[1], interp[2], interp[3]), (interp[4], interp[5]),
        tuple(g[..., C_TEX + m] for m in range(6)), grads, atlas, ambient_rgb,
        sun_power, textured=textured, trilinear=trilinear, pot=pot)
    return torch.stack([r, gg, b])


def shade(tid, rows, atlas, ambient_rgb, sun_power, background,
          trilinear: bool = True, pot: bool = False, y0: int = 0):
    """The deferred opaque pass (the JAX package's shade.shade): mesh.frag
    over the visibility buffer tid (-1 = background; its first row the
    frame's row y0); the background (4, Hp, Wp) survives where no triangle
    won (the LOAD-op attachment). Returns (4, Hp, Wp)."""
    valid = tid >= 0
    rgb = shade_core(torch.where(valid, tid, 0), rows, atlas, ambient_rgb,
                     sun_power, trilinear=trilinear, pot=pot, y0=y0)
    rgb = torch.where(valid[None], rgb, background[:3])
    alpha = torch.where(valid, torch.ones((), device=tid.device), background[3])
    return torch.cat([rgb, alpha[None]])


def blend_layer(fb, tid, rows, atlas, ambient_rgb, sun_power,
                textured: bool = True, trilinear: bool = True,
                pot: bool = False):
    """Additive blend of one peeled layer into the framebuffer (the JAX
    package's shade.blend_layer; enable_blending_additive,
    vk_pipelines.cpp:157-167): rgb = src + dst * dstAlpha, alpha = 1 where
    the layer has a fragment (tid >= 0). Returns (4, Hp, Wp)."""
    found = tid >= 0
    src = shade_core(torch.where(found, tid, 0), rows, atlas, ambient_rgb,
                     sun_power, textured=textured, trilinear=trilinear, pot=pot)
    return composite(fb, found, src, "add")

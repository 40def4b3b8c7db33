"""Vertex stage + triangle setup (mesh.vert plus the fixed-function primitive
assembly), in plain PyTorch, and on the card the fused path's setup as
kernel 2.13. The math is the JAX package's
(tpu_renderer/kernels/vertex.py) operation for operation, so the 48-column
fat rows agree with it:

* rasterization is set up in 2D homogeneous coordinates: for each triangle
  the adjugate of M = [[Xh0,Xh1,Xh2],[Yh0,Yh1,Yh2],[w0,w1,w2]] gives edge
  planes whose values at a pixel center are the perspective-correct
  barycentric weights; no near-plane clipping pass is needed;
* frustum culling replicates is_visible (vk_engine.cpp:56-86) per draw,
  including its quirks (plain w-divide, [-1.5, 1.5] min/max seeds).

Every sum of products is written out the way XLA evaluates the JAX
reference's jitted frame on the CPU (measured): the 4x4 products summed
pairwise, and the multiply-adds contracted into fused multiply-adds
(kernels.common.fma), x0*y0 + x1*y1 + x2*y2 as fma(x2, y2, fma(x0, y0,
x1*y1)). So the rounding of every value is fixed, on every device.

triangle_setup_rows on CUDA tensors launches kernel 2.13 (csrc/setup.cu:
the same operations in one loop, bit for bit the plain version,
triangle_setup_rows_plain, which CPU tensors take). The cull
(draw_visibility) and the deferred path's setup (triangle_setup_c) are plain
PyTorch on every device.
"""

from __future__ import annotations

import ctypes
import numbers
from typing import NamedTuple

import numpy as np
import torch

from tpu_renderer_torch.kernels.common import dot3_seq, fma
from tpu_renderer_torch.kernels.raster import _Counter, _launch, _ptr, _stream
from tpu_renderer_torch.utils.profiling import checked

# kernel 2.13's launches (triangle_setup_rows_kernel)
setup_counter = _Counter()


class CornerData(NamedTuple):
    """Corner-expanded static geometry, precomputed once per scene: the
    per-frame setup then needs no per-corner vertex gathers."""

    pos: torch.Tensor    # (T, 3, 3) f32 — corner positions (mesh space)
    nrm: torch.Tensor    # (T, 3, 3) f32 — corner normals (mesh space)
    col: torch.Tensor    # (T, 3, 3) f32 — corner rgb * material color_factors
    uv: torch.Tensor     # (T, 3, 2) f32
    mat: torch.Tensor    # (T,) i32 — material id (padding rows -> 0)
    meta6: torch.Tensor  # (T, 6) f32 — mat_meta[:, :6] texture-binding row


def expand_corners(positions, normals, colors, uvs, tri_vidx, tri_draw,
                   tri_valid, draw_mat, mat_color_factors, mat_meta,
                   device="cuda") -> CornerData:
    """Build CornerData on `device` (the CUDA card by default) from indexed
    host geometry (numpy arrays); runs once per scene (scene.flatten_scene)."""
    vidx = np.asarray(tri_vidx, np.int64)
    draw = np.asarray(tri_draw)
    draw_mat = np.asarray(draw_mat)
    static_ok = np.asarray(tri_valid, bool) & (draw >= 0)
    if draw_mat.shape[0]:
        mat = np.where(static_ok, draw_mat[np.clip(draw, 0, None)], 0)
    else:
        mat = np.zeros(draw.shape, np.int32)
    mat = mat.astype(np.int64)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    vidx_t = torch.as_tensor(vidx, device=device)
    mat_t = torch.as_tensor(mat, device=device)
    factors = t(mat_color_factors)
    col = t(colors)[vidx_t][..., :3] * factors[mat_t][:, None, :3]
    mm = t(mat_meta)
    meta6 = mm[torch.clamp(mat_t, 0, mm.shape[0] - 1), :6]
    return CornerData(pos=t(positions)[vidx_t], nrm=t(normals)[vidx_t],
                      col=col, uv=t(uvs)[vidx_t],
                      mat=mat_t.to(torch.int32), meta6=meta6)


def concat_corners(a: CornerData, b: CornerData) -> CornerData:
    """Concatenate two CornerData blocks along the triangle axis."""
    return CornerData(*(torch.cat([x, y]) for x, y in zip(a, b)))


def _dot3(x0, y0, x1, y1, x2, y2):
    """x0*y0 + x1*y1 + x2*y2, contracted as XLA contracts it."""
    return fma(x2, y2, fma(x0, y0, x1 * y1))


def _cross(u, v):
    """u x v, each component a*b - c*d contracted to fma(a, b, -(c*d))."""
    return (fma(u[1], v[2], -(u[2] * v[1])),
            fma(u[2], v[0], -(u[0] * v[2])),
            fma(u[0], v[1], -(u[1] * v[0])))


def mat4_mul(a, b):
    """(..., 4, 4) @ (..., 4, 4), each entry summed pairwise:
    (a[i,0]*b[0,j] + a[i,1]*b[1,j]) + (a[i,2]*b[2,j] + a[i,3]*b[3,j])."""
    a = a.unsqueeze(-1)              # (..., i, k, 1)
    b = b.unsqueeze(-3)              # (..., 1, k, j)
    p = [a[..., k, :] * b[..., k, :] for k in range(4)]
    return (p[0] + p[1]) + (p[2] + p[3])


def draw_visibility(viewproj, draw_model, bounds_origin, bounds_extents):
    """Per-draw frustum cull — exact semantics of is_visible
    (vk_engine.cpp:56-86). Returns (D,) bool."""
    # the unit cube's corners in vk_engine.cpp:57-60's order, (1, 1, 1),
    # (1, 1, -1), ..., (-1, -1, -1): bit 2, 1, 0 of the index flips x, y, z
    k = torch.arange(8, dtype=torch.int32, device=draw_model.device)
    corners = torch.stack([1 - 2 * ((k >> b) & 1) for b in (2, 1, 0)], 1).to(torch.float32)
    m = mat4_mul(viewproj, draw_model)                  # viewproj * transform
    pts = bounds_origin[:, None, :] + corners[None] * bounds_extents[:, None, :]
    # v[d, c, i] = sum_j m[d, i, j] * pts_h[d, c, j], with pts_h w = 1
    v = ((m[:, None, :, 0] * pts[:, :, None, 0]
          + m[:, None, :, 1] * pts[:, :, None, 1])
         + (m[:, None, :, 2] * pts[:, :, None, 2]
            + m[:, None, :, 3]))                         # (D, 8, 4)
    # vk_engine.cpp:73-75 — unguarded w-divide (quirk kept: no w>0 test)
    ndc = v[..., :3] / v[..., 3:4]
    # vk_engine.cpp:64-65 — min/max seeded at +-1.5
    mn = torch.clamp(ndc.amin(dim=1), max=1.5)
    mx = torch.clamp(ndc.amax(dim=1), min=-1.5)
    # vk_engine.cpp:81-86
    rejected = ((mn[:, 2] > 1.0) | (mx[:, 2] < 0.0)
                | (mn[:, 0] > 1.0) | (mx[:, 0] < -1.0)
                | (mn[:, 1] > 1.0) | (mx[:, 1] < -1.0))
    return ~rejected


def _homogeneous(corners: CornerData, tri_draw, draw_model, draw_visible,
                 viewproj, width: int, height: int, sun_dir):
    """The front half shared by both setups: per corner the viewport-mapped
    homogeneous point p[i] = (Xh, Yh, w) and clip z, and per triangle its
    draw's [mesh-space sun xyz, visibility] row lv."""
    dev = draw_model.device
    f = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
    mvp = mat4_mul(viewproj, draw_model)                              # (D,4,4)
    sd = torch.zeros(3, dtype=torch.float32, device=dev) if sun_dir is None \
        else sun_dir[:3]
    # the sun rotated into each draw's mesh space, once per draw:
    # ls[d, i] = sum_j model[d, j, i] * sd[j]
    md = draw_model[:, :3, :3]
    ls = fma(md[:, 2, :], sd[2], fma(md[:, 1, :], sd[1], md[:, 0, :] * sd[0]))
    lsvis = torch.cat([ls, draw_visible.to(torch.float32)[:, None]], dim=1)

    # padding rows carry draw -1: it wraps to the last draw, as in the JAX
    # package, and good masks it out
    td = tri_draw.long()
    m = [[mvp[td, c, j] for c in range(4)] for j in range(4)]         # m[j][c]
    lvr = lsvis[td]
    lv = [lvr[:, k] for k in range(4)]

    pos = corners.pos
    clip = [[_dot3(pos[:, i, 0], m[0][c], pos[:, i, 1], m[1][c],
                   pos[:, i, 2], m[2][c]) + m[3][c]
             for c in range(4)] for i in range(3)]                   # [i][c]
    w = [clip[i][3] for i in range(3)]
    zc = [clip[i][2] for i in range(3)]
    xh = [(clip[i][0] + w[i]) * (f(0.5) * f(width)) for i in range(3)]
    yh = [(clip[i][1] + w[i]) * (f(0.5) * f(height)) for i in range(3)]
    return [(xh[i], yh[i], w[i]) for i in range(3)], zc, lv


def _screen_aabb(p, good, width: int, height: int):
    """Screen boxes (xmin, ymin, xmax, ymax): trustworthy only when every w
    is comfortably positive; otherwise the triangle crosses the eye plane
    => full frame. Dead triangles get the empty box."""
    dev = good.device
    f = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
    W, H = f(width), f(height)
    w = [p[i][2] for i in range(3)]
    eps = f(1e-6)
    w_ok = (w[0] > eps) & (w[1] > eps) & (w[2] > eps)
    sw = [torch.where(w[i] == 0.0, f(1e-20), w[i]) for i in range(3)]
    sx = [p[i][0] / sw[i] for i in range(3)]
    sy = [p[i][1] / sw[i] for i in range(3)]
    zero = torch.zeros(good.shape, dtype=torch.float32, device=dev)
    xmin = torch.where(w_ok, torch.minimum(torch.minimum(sx[0], sx[1]), sx[2]), zero)
    ymin = torch.where(w_ok, torch.minimum(torch.minimum(sy[0], sy[1]), sy[2]), zero)
    xmax = torch.where(w_ok, torch.maximum(torch.maximum(sx[0], sx[1]), sx[2]), W)
    ymax = torch.where(w_ok, torch.maximum(torch.maximum(sy[0], sy[1]), sy[2]), H)
    empty = (f(-1.0), f(-1.0), f(-2.0), f(-2.0))
    return [torch.where(good, torch.minimum(torch.clamp(v, min=0.0), hi), e)
            for v, hi, e in ((xmin, W, empty[0]), (ymin, H, empty[1]),
                             (xmax, W, empty[2]), (ymax, H, empty[3]))]


def _edge_planes(p, det, tri_valid, tri_draw, vis):
    """Normalised edge planes cp[e][c] (dead rows the never-covered
    (0, 0, -1) row), the sign-applied adjugate rows es, 1/|det| and the
    liveness mask good."""
    dev = det.device
    f = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
    good = tri_valid & (tri_draw >= 0) & (vis > 0) \
        & (det != 0.0) & torch.isfinite(det)
    one = f(1.0)
    s = torch.where(det < 0, f(-1.0), one)
    inv_det = torch.where(det == 0.0, f(0.0), one / torch.abs(det))
    dead = (f(0.0), f(0.0), f(-1.0))
    e = (_cross(p[1], p[2]), _cross(p[2], p[0]), _cross(p[0], p[1]))
    es = [[e[k][c] * s for c in range(3)] for k in range(3)]
    cp = [[torch.where(good, es[k][c] * inv_det, dead[c])
           for c in range(3)] for k in range(3)]
    return cp, es, inv_det, good


class TriangleSetup(NamedTuple):
    """Per-frame setup of the deferred path (the JAX package's
    vertex.TriangleSetup)."""

    packed: torch.Tensor  # (T, 16) f32 [A0,B0,C0, A1,B1,C1, A2,B2,C2,
    #                       zA,zB,zC, valid, mat_id, 0, 0]
    aabb: torch.Tensor    # (T, 4) f32 screen boxes, clamped
    attrs: torch.Tensor   # (T, 3, 6) f32 per-corner [light_num, r, g, b, u, v]
    valid: torch.Tensor   # (T,) bool


SETUP_COLS = 16


def triangle_setup_c(corners: CornerData, tri_draw, tri_valid, draw_model,
                     draw_visible, viewproj, width: int, height: int,
                     sun_dir=None) -> TriangleSetup:
    """Per-frame mesh.vert + primitive setup of the deferred path (the JAX
    package's vertex.triangle_setup_c): 16-column packed rows, screen
    boxes, per-corner attributes and validity. The same math as
    triangle_setup_rows, but its reductions (the determinant, the depth
    plane, the light dot) are the JAX function's sums and einsums, which
    XLA-CPU accumulates in order with fused multiply-adds (dot3_seq)."""
    p, zc, lv = _homogeneous(corners, tri_draw, draw_model, draw_visible,
                             viewproj, width, height, sun_dir)
    e0 = _cross(p[1], p[2])
    det = dot3_seq(e0[0], p[0][0], e0[1], p[0][1], e0[2], p[0][2])
    cp, _, _, good = _edge_planes(p, det, tri_valid, tri_draw, lv[3])
    zplane = [dot3_seq(cp[0][c], zc[0], cp[1][c], zc[1], cp[2][c], zc[2])
              for c in range(3)]
    ab = _screen_aabb(p, good, width, height)
    nrm, col, uv = corners.nrm, corners.col, corners.uv
    light = [dot3_seq(nrm[:, i, 0], lv[0], nrm[:, i, 1], lv[1],
                       nrm[:, i, 2], lv[2]) for i in range(3)]
    attrs = torch.cat([torch.stack(light, 1)[..., None], col, uv], dim=-1)
    zero = torch.zeros_like(det)
    packed = torch.stack(
        [cp[e][c] for e in range(3) for c in range(3)] + zplane
        + [good.to(torch.float32), corners.mat.to(torch.float32), zero, zero],
        dim=1).contiguous()
    return TriangleSetup(packed=packed, aabb=torch.stack(ab, 1).contiguous(),
                         attrs=attrs.contiguous(), valid=good)


def triangle_setup(positions, normals, colors, uvs, tri_vidx, tri_draw,
                   tri_valid, draw_model, draw_visible, draw_mat,
                   mat_color_factors, viewproj, width: int, height: int,
                   sun_dir=None) -> TriangleSetup:
    """mesh.vert + primitive setup over indexed geometry (the JAX package's
    vertex.triangle_setup): expands the corners inline and calls
    triangle_setup_c. For oracle tests, the profile tools and small scenes;
    the frame path expands once per scene. Arrays or tensors; everything is
    built on draw_model's device. No material binds a texture (meta6 = 0)."""
    host = lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)  # noqa: E731
    dev = draw_model.device
    factors = host(mat_color_factors)
    corners = expand_corners(
        host(positions), host(normals), host(colors), host(uvs), host(tri_vidx),
        host(tri_draw), host(tri_valid), host(draw_mat), factors,
        np.zeros((max(factors.shape[0], 1), 8), np.float32), device=dev)
    return triangle_setup_c(
        corners, torch.as_tensor(tri_draw, device=dev).to(torch.int32),
        torch.as_tensor(tri_valid, device=dev).to(torch.bool), draw_model,
        draw_visible, viewproj, width, height, sun_dir=sun_dir)


def triangle_setup_rows_plain(corners: CornerData, tri_draw, tri_valid, draw_model,
                              draw_visible, viewproj, width: int, height: int,
                              sun_dir=None):
    """Plain PyTorch version of triangle_setup_rows_kernel
    (triangle_setup_rows' contract): the JAX package's triangle_setup_rows
    op for op."""
    p, zc, lv = _homogeneous(corners, tri_draw, draw_model, draw_visible,
                             viewproj, width, height, sun_dir)
    e0 = _cross(p[1], p[2])
    det = _dot3(e0[0], p[0][0], e0[1], p[0][1], e0[2], p[0][2])
    cp, es, inv_det, good = _edge_planes(p, det, tri_valid, tri_draw, lv[3])
    zplane = [_dot3(cp[0][c], zc[0], cp[1][c], zc[1], cp[2][c], zc[2])
              for c in range(3)]
    ab = _screen_aabb(p, good, width, height)

    # per-corner attributes [light_num, r, g, b, u, v]; light_num is
    # dot(corner normal, mesh-space sun) (mesh.frag:13 uses the normal
    # only through this dot, which commutes with interpolation)
    nrm, col, uv = corners.nrm, corners.col, corners.uv
    attrs = [[_dot3(nrm[:, i, 0], lv[0], nrm[:, i, 1], lv[1], nrm[:, i, 2], lv[2]),
              col[:, i, 0], col[:, i, 1], col[:, i, 2], uv[:, i, 0], uv[:, i, 1]]
             for i in range(3)]                                      # [i][a]

    # numerator planes num_a(X, Y) = pa*X + pb*Y + pc
    A = [cp[e][0] for e in range(3)]
    B = [cp[e][1] for e in range(3)]
    Cc = [cp[e][2] for e in range(3)]
    pa, pb, pc = ([_dot3(K[0], attrs[0][a], K[1], attrs[1][a], K[2], attrs[2][a])
                   for a in range(6)] for K in (A, B, Cc))
    # the plane sums: XLA sinks the select through the adds and contracts
    # cp0 + cp1 + cp2 into fma(es2, inv_det, fma(es0, inv_det, es1 * inv_det))
    dead = (0.0, 0.0, -1.0)
    sumA, sumB, den_c = (
        torch.where(good, fma(es[2][c], inv_det,
                              fma(es[0][c], inv_det, es[1][c] * inv_det)),
                    torch.full((), dead[c] * 3.0, dtype=torch.float32,
                               device=det.device))
        for c in range(3))
    grad = [pa[4], pb[4], pa[5], pb[5], sumA, sumB]
    meta6 = corners.meta6

    planes = (
        [cp[e][c] for e in range(3) for c in range(3)]       # 0-8 edges
        + zplane                                             # 9-11 depth
        + [corners.mat.to(torch.float32)]                    # 12 material
        + pa + pb + pc                                       # 13-30 attrs
        + [meta6[:, k] for k in range(6)]                    # 31-36 tex meta
        + grad                                               # 37-42 uv grads
        + [den_c]                                            # 43 den const
        + ab                                                 # 44-47 aabb
    )
    rows = torch.stack(planes, dim=1).contiguous()           # (T, 48)
    aabb = torch.stack(ab, dim=1).contiguous()               # (T, 4)
    return rows, aabb, good


_SETUP_SHAPES = (("pos", (3, 3), torch.float32), ("nrm", (3, 3), torch.float32),
                 ("col", (3, 3), torch.float32), ("uv", (3, 2), torch.float32),
                 ("mat", (), torch.int32), ("meta6", (6,), torch.float32))


def _check_setup(corners, tri_draw, tri_valid, draw_model, draw_visible, viewproj, width,
                 height, sun_dir):
    """triangle_setup_rows_kernel's arguments: (T, D), or ValueError. The
    device is checked last, so each other refusal shows on the CPU too."""
    if not isinstance(corners, CornerData) or not isinstance(corners.pos, torch.Tensor):
        raise ValueError(f"corners must be CornerData of tensors, got {type(corners).__name__}")
    dev = corners.pos.device
    T = corners.pos.shape[0] if corners.pos.dim() else -1
    D = draw_model.shape[0] if isinstance(draw_model, torch.Tensor) and draw_model.dim() else -1
    expect = [(f"corners.{name}", getattr(corners, name), (T, *tail), dtype)
              for name, tail, dtype in _SETUP_SHAPES]
    expect += [("tri_draw", tri_draw, (T,), torch.int32),
               ("tri_valid", tri_valid, (T,), torch.bool),
               ("draw_model", draw_model, (D, 4, 4), torch.float32),
               ("draw_visible", draw_visible, (D,), torch.bool),
               ("viewproj", viewproj, (4, 4), torch.float32)]
    if sun_dir is not None:
        expect.append(("sun_dir", sun_dir, (3,), torch.float32))
    for name, t, shape, dtype in expect:
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{name} must be a tensor on {dev}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, v in (("width", width), ("height", height)):
        if not isinstance(v, numbers.Integral) or not 0 < v < 2 ** 24:
            raise ValueError(f"{name} must be an integer in [1, 2^24), got {v!r}")
    if T >= 2 ** 31 // 48:
        raise ValueError(f"triangle_setup_rows_kernel takes fewer than {2 ** 31 // 48} "
                         f"triangles, got {T}")
    if T and D < 1:
        raise ValueError("triangles need at least one draw")
    if dev.type != "cuda":
        raise ValueError(f"triangle_setup_rows_kernel takes CUDA tensors, got {dev}")
    return T, D


@checked
def triangle_setup_rows_kernel(corners: CornerData, tri_draw, tri_valid, draw_model,
                               draw_visible, viewproj, width: int, height: int,
                               sun_dir=None):
    """Launch kernel 2.13 (csrc/setup.cu) on CUDA tensors: what
    triangle_setup_rows_plain returns, bit for bit, in one launch on the
    current stream with no wait on the device. Every argument is checked
    here, before the library is built or loaded: CUDA tensors on one device,
    contiguous, of CornerData's dtypes and shapes; tri_draw (T,) int32,
    tri_valid (T,) bool, draw_model (D, 4, 4) and viewproj (4, 4) float32,
    draw_visible (D,) bool, sun_dir (3,) float32 or None; width and height
    integers."""
    T, D = _check_setup(corners, tri_draw, tri_valid, draw_model, draw_visible, viewproj,
                        width, height, sun_dir)
    dev = corners.pos.device
    rows = torch.empty((T, 48), dtype=torch.float32, device=dev)
    aabb = torch.empty((T, 4), dtype=torch.float32, device=dev)
    valid = torch.empty((T,), dtype=torch.bool, device=dev)
    if T == 0:
        return rows, aabb, valid
    _launch("triangle_setup_launch", _ptr(corners.pos), _ptr(corners.nrm), _ptr(corners.col),
            _ptr(corners.uv), _ptr(corners.mat), _ptr(corners.meta6), _ptr(tri_draw),
            _ptr(tri_valid), _ptr(draw_model), _ptr(draw_visible), ctypes.c_int(D),
            _ptr(viewproj), _ptr(sun_dir) if sun_dir is not None else None, ctypes.c_int(T),
            ctypes.c_int(width), ctypes.c_int(height), _ptr(rows), _ptr(aabb), _ptr(valid),
            _stream(dev))
    setup_counter.launches += 1
    return rows, aabb, valid


def triangle_setup_rows(corners: CornerData, tri_draw, tri_valid, draw_model,
                        draw_visible, viewproj, width: int, height: int,
                        sun_dir=None):
    """Per-frame mesh.vert + primitive setup over corner-expanded geometry.
    Returns (rows (T, 48) f32 in the fat-row layout of shade.py, aabb (T, 4)
    f32 screen boxes, valid (T,) bool). CPU tensors take the plain version,
    CUDA tensors kernel 2.13 (whose wrapper checks the arguments)."""
    if corners.pos.device.type == "cuda":
        return triangle_setup_rows_kernel(corners, tri_draw, tri_valid, draw_model,
                                          draw_visible, viewproj, width, height, sun_dir)
    return triangle_setup_rows_plain(corners, tri_draw, tri_valid, draw_model, draw_visible,
                                     viewproj, width, height, sun_dir)

"""The benchmark's plain reference: a rasterizer in plain PyTorch that
renders a cell's frame from the generator's own arrays (scene.SceneSpec)
and the staged camera, and nothing the program made. It imports no module
of the program, and runs on whatever device it is given (the card after a
run's window has closed; the CPU in the tests).

The frame semantics are the reference Vulkan renderer's, as the program
states them:

* camera: view = inverse(translate(position) @ R), R = yaw about (0, -1, 0)
  then pitch about (1, 0, 0); projection perspectiveRH_ZO(fov_y, aspect,
  near=10000, far=0.1) with proj[1][1] negated (reversed Z);
* draws: each mesh node submits its mesh with model = T @ R @ S; opaque
  draws in (material, mesh, node) order, each culled by is_visible (its
  mesh's box through projection * view * model, a plain divide by w, the
  min / max seeded at +-1.5); transparent draws in node order, unculled;
* raster: homogeneous edge functions with the top-left fill rule at pixel
  centres, no clipping pass; a fragment needs 0 <= z <= 1; opaque: depth
  test GREATER_OR_EQUAL against a depth cleared to 0, a later triangle
  winning a tie; transparent: the same test against the opaque depth,
  no depth write, blended additively (rgb = src + dst * dst_alpha,
  alpha = 1) in submission order;
* shading (mesh.frag): perspective-correct attributes; light =
  max(dot(M3 n, sun.xyz), 0.1); rgb = c * (light * sun.w) + c * ambient.rgb,
  c = base colour * texel;
* sampling: the mip chain of 2x2 linear blits rounded to unorm8, the level
  of detail log2 of the larger screen-space axis of the texel footprint,
  taken from the analytic derivatives of the interpolated uv, nearest or
  linear between levels as the sampler says, bilinear (or nearest) within
  a level with REPEAT wrap;
* framebuffer: RGBA16F over the background (the gradient pass: data1
  towards data2 down the rows), every write rounded to fp16; packed to
  unorm8 with round-half-even.

Geometry, depth and coverage are computed in float64, so that the
reference is not bound to the program's float32 rounding; shading is
computed in `shade_dtype` (float64 for the reference; the lower-precision
control of the correctness check runs it in bfloat16).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.scene import SceneSpec

F64 = torch.float64
TILE = 16                 # the reference's own pixel blocks (an acceleration only)
NEAR_W = 0.099            # below w = 0.1 (the near plane, distance 0.1) no fragment survives z <= 1
ORDER_BITS = 21           # submission order in the opaque depth key
Z_BITS = 41               # depth quantum 2**-41 in the key; the winner's depth is recomputed
PAIR_CHUNK = 1 << 15      # (triangle, block) pairs evaluated at once
NEAREST_FILTERS = (9728, 9984, 9986)          # NEAREST, NEAREST_MIPMAP_*
MIP_NEAREST_FILTERS = (9984, 9985)            # *_MIPMAP_NEAREST


@dataclasses.dataclass(frozen=True)
class Look:
    """The frame's fixed uniforms: extent, projection, lighting, background."""

    width: int
    height: int
    fov_y_deg: float = 70.0
    z_near: float = 10000.0
    z_far: float = 0.1
    ambient: tuple = (0.1, 0.1, 0.1, 0.1)
    sun_dir: tuple = (0.0, 1.0, 0.5, 1.0)
    sun_color: tuple = (1.0, 1.0, 1.0, 1.0)
    bg_top: tuple = (1.0, 1.0, 1.0, 1.0)
    bg_bottom: tuple = (1.0, 1.0, 1.0, 1.0)


def _quat_mat(w, x, y, z) -> np.ndarray:
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y), 0],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x), 0],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y), 0],
        [0, 0, 0, 1]], np.float64)


def view_matrix(position, yaw: float, pitch: float) -> np.ndarray:
    """inverse(translate(position) @ yaw_rotation @ pitch_rotation)."""
    def axis_angle(angle, axis):
        s = math.sin(angle / 2.0)
        return _quat_mat(math.cos(angle / 2.0), axis[0] * s, axis[1] * s, axis[2] * s)

    t = np.eye(4)
    t[:3, 3] = np.asarray(position, np.float64)
    r = axis_angle(float(yaw), (0.0, -1.0, 0.0)) @ axis_angle(float(pitch), (1.0, 0.0, 0.0))
    return np.linalg.inv(t @ r)


def projection(look: Look) -> np.ndarray:
    tan_half = math.tan(math.radians(look.fov_y_deg) / 2.0)
    n, f = look.z_near, look.z_far
    m = np.zeros((4, 4))
    m[0, 0] = 1.0 / (look.width / look.height * tan_half)
    m[1, 1] = -1.0 / tan_half
    m[2, 2] = f / (n - f)
    m[3, 2] = -1.0
    m[2, 3] = -(f * n) / (f - n)
    return m


def model_matrix(node) -> np.ndarray:
    t = np.eye(4)
    t[:3, 3] = node.translation
    x, y, z, w = node.rotation
    s = np.diag([*node.scale, 1.0])
    return t @ _quat_mat(w, x, y, z) @ s


def mip_chain(img: np.ndarray) -> list:
    """The levels of a linear 2x downsampling blit to 1x1, each rounded to
    unorm8 half up (even sizes: the 2x2 average)."""
    levels = [img]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        src = levels[-1].astype(np.float64)
        h, w = src.shape[:2]
        nh, nw = max(h // 2, 1), max(w // 2, 1)
        ys = (np.arange(nh) + 0.5) * (h / nh) - 0.5
        xs = (np.arange(nw) + 0.5) * (w / nw) - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
        y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
        fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
        out = (src[np.ix_(y0, x0)] * (1 - fy) * (1 - fx) + src[np.ix_(y0, x1)] * (1 - fy) * fx
               + src[np.ix_(y1, x0)] * fy * (1 - fx) + src[np.ix_(y1, x1)] * fy * fx)
        levels.append(np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8))
    return levels


class Reference:
    """A scene made ready for the reference: world-space triangles in
    submission order, per-corner attributes, and the textures' mip chains,
    on `device`. render() draws one frame."""

    def __init__(self, spec: SceneSpec, look: Look, device="cpu"):
        self.look = look
        self.dev = torch.device(device)
        sun = np.asarray(look.sun_dir[:3], np.float64)
        draws = []
        for i, node in enumerate(spec.nodes):
            mat = spec.materials[spec.meshes[node.mesh].material]
            draws.append((mat.transparent, i))
        opaque = sorted((i for t, i in draws if not t),
                        key=lambda i: (spec.meshes[spec.nodes[i].mesh].material,
                                       spec.nodes[i].mesh, i))
        transparent = [i for t, i in draws if t]
        self.n_opaque_draws = len(opaque)

        wpos, ln, col, uv, tex, tri_draw, models, boxes = [], [], [], [], [], [], [], []
        for d, i in enumerate(opaque + transparent):
            node = spec.nodes[i]
            mesh = spec.meshes[node.mesh]
            mat = spec.materials[mesh.material]
            m = model_matrix(node)
            models.append(m)
            p = mesh.positions.astype(np.float64)
            boxes.append(((p.max(0) + p.min(0)) / 2, (p.max(0) - p.min(0)) / 2))
            idx = mesh.indices.astype(np.int64).reshape(-1, 3)
            ph = np.concatenate([p, np.ones((len(p), 1))], 1) @ m.T
            nw = mesh.normals.astype(np.float64) @ m[:3, :3].T
            wpos.append(ph[idx])
            ln.append((nw @ sun)[idx])
            col.append(np.broadcast_to(np.asarray(mat.base_color[:3], np.float64),
                                       idx.shape + (3,)))
            uv.append(mesh.uvs.astype(np.float64)[idx])
            tex.append(np.full(len(idx), -1 if mat.texture is None else mat.texture))
            tri_draw.append(np.full(len(idx), d))
        t = lambda a, dt=F64: torch.as_tensor(np.concatenate(a), dtype=dt, device=self.dev)  # noqa: E731
        self.wpos = t(wpos)                    # (T, 3, 4) world-space corners
        self.ln = t(ln)                        # (T, 3) dot(world normal, sun)
        self.col = t(col)                      # (T, 3, 3)
        self.uv = t(uv)                        # (T, 3, 2)
        self.tex = t(tex, torch.int64)         # (T,) -1: untextured
        self.tri_draw = t(tri_draw, torch.int64)
        self.models = torch.as_tensor(np.stack(models), device=self.dev)
        self.box_origin = torch.as_tensor(np.stack([b[0] for b in boxes]), device=self.dev)
        self.box_extent = torch.as_tensor(np.stack([b[1] for b in boxes]), device=self.dev)
        self.transparent = self.tri_draw >= self.n_opaque_draws
        self.order = torch.arange(len(self.tex), device=self.dev)
        if len(self.tex) >= 1 << ORDER_BITS:
            raise ValueError(f"{len(self.tex)} triangles exceed the depth key's "
                             f"{ORDER_BITS}-bit order")

        # sampler: mag, min and mip mode (the loader's flattening of glTF's filters)
        mag, minf = spec.sampler
        self.mag_linear = mag not in NEAREST_FILTERS
        self.min_linear = minf not in NEAREST_FILTERS
        self.mip_linear = minf not in MIP_NEAREST_FILTERS
        texels, offs, sizes = [], [], []
        base = 0
        for img in spec.images:
            chain = mip_chain(img)
            offs.append([])
            sizes.append((img.shape[1], img.shape[0], len(chain)))
            for lvl in chain:
                offs[-1].append(base)
                texels.append(lvl.reshape(-1, 4))
                base += lvl.shape[0] * lvl.shape[1]
        n_lv = max(len(o) for o in offs) if offs else 1
        self.texels = torch.as_tensor(np.concatenate(texels) if texels else
                                      np.zeros((1, 4), np.uint8), device=self.dev)
        self.tex_offs = torch.as_tensor([o + [0] * (n_lv - len(o)) for o in offs] or [[0]],
                                        device=self.dev)
        self.tex_size = torch.as_tensor(sizes or [(1, 1, 1)], device=self.dev)

    # -- per frame ----------------------------------------------------------

    def _visible_draws(self, vp):
        """is_visible of each opaque draw; transparent draws are kept."""
        k = torch.arange(8, device=self.dev)
        corners = torch.stack([1 - 2 * ((k >> b) & 1) for b in (2, 1, 0)], 1).to(F64)
        pts = self.box_origin[:, None] + corners[None] * self.box_extent[:, None]
        ph = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
        v = torch.einsum("dij,dcj->dci", vp[None] @ self.models, ph)
        ndc = v[..., :3] / v[..., 3:4]
        mn = torch.clamp(ndc.amin(1), max=1.5)
        mx = torch.clamp(ndc.amax(1), min=-1.5)
        rejected = ((mn[:, 2] > 1) | (mx[:, 2] < 0) | (mn[:, 0] > 1) | (mx[:, 0] < -1)
                    | (mn[:, 1] > 1) | (mx[:, 1] < -1))
        keep = ~rejected
        keep[self.n_opaque_draws:] = True
        return keep

    def _setup(self, vp):
        """Per triangle: edge planes (T, 3, 3) as (a, b, c) rows, depth plane
        (T, 3), pixel box (T, 4) and liveness."""
        W, H = self.look.width, self.look.height
        clip = self.wpos @ vp.T                                   # (T, 3, 4)
        w = clip[..., 3]
        p = torch.stack([(clip[..., 0] + w) * (W / 2), (clip[..., 1] + w) * (H / 2), w], -1)
        e = torch.stack([torch.linalg.cross(p[:, (k + 1) % 3], p[:, (k + 2) % 3])
                         for k in range(3)], 1)                   # (T, 3 edges, 3)
        det = (e[:, 0] * p[:, 0]).sum(-1)
        live = (det != 0) & torch.isfinite(det) & (w.amax(1) >= NEAR_W)
        live &= self._visible_draws(vp)[self.tri_draw]
        planes = e / torch.where(det == 0, torch.ones_like(det), det)[:, None, None]
        zplane = (planes * clip[..., 2][:, :, None]).sum(1)       # (T, 3)

        # the pixel box of the part with w >= NEAR_W: the corners there and
        # the edges' crossings of that plane
        pts, ok = [p], [w >= NEAR_W]
        for i, j in ((0, 1), (1, 2), (2, 0)):
            wi, wj = w[:, i], w[:, j]
            cross = (wi - NEAR_W) * (wj - NEAR_W) < 0
            s = torch.where(cross, (NEAR_W - wi) / torch.where(cross, wj - wi, 1.0), 0.0)
            pts.append((p[:, i] + (p[:, j] - p[:, i]) * s[:, None])[:, None])
            ok.append(cross[:, None])
        pts, ok = torch.cat(pts, 1), torch.cat(ok, 1)
        sx = pts[..., 0] / pts[..., 2]
        sy = pts[..., 1] / pts[..., 2]
        big = torch.tensor(1e30, dtype=F64, device=self.dev)
        x0 = torch.where(ok, sx, big).amin(1)
        x1 = torch.where(ok, sx, -big).amax(1)
        y0 = torch.where(ok, sy, big).amin(1)
        y1 = torch.where(ok, sy, -big).amax(1)
        box = torch.stack([
            torch.clamp(torch.ceil(x0 - 0.5) - 1, 0, W - 1),
            torch.clamp(torch.ceil(y0 - 0.5) - 1, 0, H - 1),
            torch.clamp(torch.floor(x1 - 0.5) + 1, -1, W - 1),
            torch.clamp(torch.floor(y1 - 0.5) + 1, -1, H - 1)], 1)
        live &= (box[:, 2] >= box[:, 0]) & (box[:, 3] >= box[:, 1])
        return planes, zplane, box.to(torch.int64), live

    def _fragments(self, tris, planes, zplane, box):
        """Covered fragments of triangles `tris`, in blocks: yields (pixel
        index, triangle, z) per block of (triangle, block) pairs."""
        W, H = self.look.width, self.look.height
        bx = box[tris] // TILE
        nx, ny = bx[:, 2] - bx[:, 0] + 1, bx[:, 3] - bx[:, 1] + 1
        counts = nx * ny
        total = int(counts.sum())
        starts = torch.cumsum(counts, 0) - counts
        lane = torch.arange(TILE, device=self.dev)
        for lo in range(0, total, PAIR_CHUNK):
            k = torch.arange(lo, min(lo + PAIR_CHUNK, total), device=self.dev)
            owner = torch.searchsorted(starts, k, right=True) - 1
            r = k - starts[owner]
            tri = tris[owner]
            tx = bx[owner, 0] + r % nx[owner]
            ty = bx[owner, 1] + r // nx[owner]
            px = (tx * TILE)[:, None, None] + lane[None, None, :]
            py = (ty * TILE)[:, None, None] + lane[None, :, None]
            X, Y = px.to(F64) + 0.5, py.to(F64) + 0.5
            pl = planes[tri]
            cov = (px < W) & (py < H)
            for e in range(3):
                a, b, c = (pl[:, e, q][:, None, None] for q in range(3))
                val = a * X + b * Y + c
                top_left = (a > 0) | ((a == 0) & (b > 0))
                cov &= (val > 0) | ((val == 0) & top_left)
            zp = zplane[tri]
            z = zp[:, 0, None, None] * X + zp[:, 1, None, None] * Y + zp[:, 2, None, None]
            cov &= (z >= 0) & (z <= 1)
            sel = cov.nonzero(as_tuple=True)
            yield ((py * W + px)[sel], tri[sel[0]], z[sel])

    def _shade(self, tri, pix, planes, dtype):
        """mesh.frag at pixel centres pix for triangles tri, in dtype.
        Returns (N, 3) float64."""
        W = self.look.width
        X = (pix % W).to(F64) + 0.5
        Y = (pix // W).to(F64) + 0.5
        pl = planes[tri]                                          # (N, 3, 3)
        c = (pl[..., 0] * X[:, None] + pl[..., 1] * Y[:, None] + pl[..., 2]).to(dtype)
        a, b = pl[..., 0].to(dtype), pl[..., 1].to(dtype)
        den = c.sum(1)
        lam = c / den[:, None]
        ln = (lam * self.ln[tri].to(dtype)).sum(1)
        col = (lam[..., None] * self.col[tri].to(dtype)).sum(1)
        uvc = self.uv[tri].to(dtype)
        u = (lam * uvc[..., 0]).sum(1)
        v = (lam * uvc[..., 1]).sum(1)
        tex_id = self.tex[tri]
        texel = torch.ones_like(col)
        has = tex_id >= 0
        if bool(has.any()):
            g = has.nonzero(as_tuple=True)[0]
            sa, sb, sd = a[g], b[g], den[g]
            grads = [((sk * uvc[g, :, q]).sum(1) - (u, v)[q][g] * sk.sum(1)) / sd
                     for sk in (sa, sb) for q in (0, 1)]   # du/dx, dv/dx, du/dy, dv/dy
            texel[g] = self._sample(tex_id[g], u[g], v[g], grads, dtype)
        amb = torch.tensor(self.look.ambient[:3], dtype=dtype, device=self.dev)
        power = torch.tensor(self.look.sun_color[3], dtype=dtype, device=self.dev)
        light = torch.clamp(ln, min=0.1)
        cc = col * texel
        out = cc * (light * power)[:, None] + cc * amb
        return out.to(F64)

    def _sample(self, tex_id, u, v, grads, dtype):
        size = self.tex_size[tex_id]
        w0, h0, n_lv = size[:, 0], size[:, 1], size[:, 2]
        dudx, dvdx, dudy, dvdy = grads
        w0f, h0f = w0.to(dtype), h0.to(dtype)
        rho_x = torch.sqrt((dudx * w0f) ** 2 + (dvdx * h0f) ** 2)
        rho_y = torch.sqrt((dudy * w0f) ** 2 + (dvdy * h0f) ** 2)
        rho = torch.maximum(rho_x, rho_y)
        max_lv = (n_lv - 1).to(dtype)
        lod = torch.minimum(torch.clamp(torch.log2(torch.clamp(rho, min=1e-12)), min=0), max_lv)
        linear = torch.full_like(u, 1.0) if (self.min_linear and self.mag_linear) else (
            torch.where(lod > 0, float(self.min_linear), float(self.mag_linear)))
        if self.mip_linear:
            lo = torch.floor(lod)
            frac = lod - lo
            hi = torch.minimum(lo + 1, max_lv)
            ta = self._tap(tex_id, lo, u, v, linear, dtype)
            tb = self._tap(tex_id, hi, u, v, linear, dtype)
            return ta * (1 - frac)[:, None] + tb * frac[:, None]
        lv = torch.minimum(torch.clamp(torch.ceil(lod + 0.5) - 1, min=0), max_lv)
        return self._tap(tex_id, lv, u, v, linear, dtype)

    def _tap(self, tex_id, level, u, v, linear, dtype):
        """One level's filtered texel with REPEAT wrap, (N, 3)."""
        li = level.to(torch.int64)
        size = self.tex_size[tex_id]
        wl = torch.clamp(size[:, 0] >> li, min=1)
        hl = torch.clamp(size[:, 1] >> li, min=1)
        base = self.tex_offs[tex_id, li]
        su = u * wl.to(dtype) - 0.5
        sv = v * hl.to(dtype) - 0.5
        x0f, y0f = torch.floor(su), torch.floor(sv)
        fu, fv = su - x0f, sv - y0f
        x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)

        def fetch(x, y):
            idx = base + torch.remainder(y, hl) * wl + torch.remainder(x, wl)
            return self.texels[idx, :3].to(dtype) / 255

        t00, t10, t01, t11 = fetch(x0, y0), fetch(x0 + 1, y0), fetch(x0, y0 + 1), fetch(x0 + 1, y0 + 1)
        fu, fv = fu[:, None], fv[:, None]
        bilinear = (t00 * (1 - fu) * (1 - fv) + t10 * fu * (1 - fv)
                    + t01 * (1 - fu) * fv + t11 * fu * fv)
        nearest = torch.where(fv >= 0.5, torch.where(fu >= 0.5, t11, t01),
                              torch.where(fu >= 0.5, t10, t00))
        return torch.where(linear[:, None] > 0, bilinear, nearest)

    @torch.no_grad()
    def render(self, position, yaw: float, pitch: float,
               shade_dtype=F64, counts: Optional[Dict] = None) -> torch.Tensor:
        """The frame at this camera as (H, W, 4) uint8. counts, if given,
        receives the frame's work: covered fragments of the opaque and the
        transparent draws, transparent fragments that pass the depth test,
        triangles with a covered fragment, and the most transparent layers
        at a pixel."""
        look = self.look
        W, H = look.width, look.height
        vp = torch.as_tensor(projection(look) @ view_matrix(position, yaw, pitch),
                             device=self.dev)
        planes, zplane, box, live = self._setup(vp)
        n_pix = W * H
        fp16 = lambda x: x.to(torch.float16).to(F64)  # noqa: E731

        rows = torch.arange(H, device=self.dev, dtype=F64) / H
        top = torch.tensor(look.bg_top, dtype=F64, device=self.dev)
        bottom = torch.tensor(look.bg_bottom, dtype=F64, device=self.dev)
        bg = top[:, None] * (1 - rows[None]) + bottom[:, None] * rows[None]     # (4, H)
        fb = fp16(bg[:, :, None].expand(4, H, W).reshape(4, n_pix).clone())

        touched = torch.zeros(len(self.tex), dtype=torch.bool, device=self.dev)
        keys = torch.full((n_pix,), -1, dtype=torch.int64, device=self.dev)
        n_opaque = 0
        op = (live & ~self.transparent).nonzero(as_tuple=True)[0]
        for pix, tri, z in self._fragments(op, planes, zplane, box):
            q = torch.floor(z * float(1 << Z_BITS)).to(torch.int64)
            keys.scatter_reduce_(0, pix, (q << ORDER_BITS) | self.order[tri], "amax")
            touched[tri] = True
            n_opaque += len(pix)
        won = keys >= 0
        winner = torch.where(won, keys & ((1 << ORDER_BITS) - 1), 0)
        X = (torch.arange(n_pix, device=self.dev) % W).to(F64) + 0.5
        Y = (torch.arange(n_pix, device=self.dev) // W).to(F64) + 0.5
        zw = zplane[winner]
        zopaque = torch.where(won, zw[:, 0] * X + zw[:, 1] * Y + zw[:, 2], 0.0)
        wp = won.nonzero(as_tuple=True)[0]
        if len(wp):
            fb[:3, wp] = fp16(self._shade(winner[wp], wp, planes, shade_dtype).T)
            fb[3, wp] = 1.0

        tp = (live & self.transparent).nonzero(as_tuple=True)[0]
        frag_pix, frag_tri = [], []
        n_transp = 0
        for pix, tri, z in self._fragments(tp, planes, zplane, box):
            n_transp += len(pix)
            touched[tri] = True
            keep = z >= zopaque[pix]
            frag_pix.append(pix[keep])
            frag_tri.append(tri[keep])
        layers = 0
        n_pass = 0
        if frag_pix:
            pix = torch.cat(frag_pix)
            tri = torch.cat(frag_tri)
            n_pass = len(pix)
        if n_pass:
            order = torch.argsort(pix * len(self.tex) + tri)
            pix, tri = pix[order], tri[order]
            first = torch.ones_like(pix, dtype=torch.bool)
            first[1:] = pix[1:] != pix[:-1]
            run_start = torch.cummax(torch.where(first, torch.arange(len(pix), device=self.dev),
                                                 0), 0).values
            rank = torch.arange(len(pix), device=self.dev) - run_start
            src = self._shade(tri, pix, planes, shade_dtype)
            layers = int(rank.max()) + 1
            for r in range(layers):
                sel = (rank == r).nonzero(as_tuple=True)[0]
                p = pix[sel]
                fb[:3, p] = fp16(fb[:3, p] * fb[3, p][None] + src[sel].T)
                fb[3, p] = 1.0
        if counts is not None:
            counts.update(opaque_fragments=n_opaque, transparent_fragments=n_transp,
                          transparent_passing=n_pass, triangles=int(touched.sum()),
                          layers=layers)
        out = torch.clamp(torch.round(fb * 255.0), 0, 255).to(torch.uint8)
        return out.reshape(4, H, W).permute(1, 2, 0).contiguous()

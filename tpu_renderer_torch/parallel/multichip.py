"""Multi-device rendering: SPMD over a ('rows', 'tri') mesh of ranks, one
process a rank (torch.distributed) — the port of the JAX package's
parallel/multichip.py, which runs the same mesh over devices in one
process (shard_map).

* rows (image parallel): the framebuffer is cut into horizontal bands of
  whole tiles; each rank bins, rasterizes and shades only its band: its
  raster launches cover the band's tiles alone (tile_y0), and the planes
  keep the frame's coordinates (render_frame_multichip says why).
* tri (triangle parallel, sort-last): each triangle set is padded to a
  multiple of raster.CHUNK * n_tri and cut into n_tri equal shards; each
  rank rasterizes its shard against its band, then the visibility
  composites over 'tri': the depth MAX, then the MAX of the ids at that
  depth (the GREATER_OR_EQUAL later-wins rule across shards), then a SUM
  of the winner's planes masked to the shard that holds it. The untextured
  transparent sum and count SUM over 'tri'; the textured peel elects each
  layer by a MIN over 'tri' of the shards' next ids.

Every rank calls render_frame_multichip, as every device runs the JAX
shard_map body, and every rank gets the whole frame: the bands all-gather
over 'rows'.

Device and backend, chosen once by one rule (device_and_backend) and
printed by launch: on the card, rank r uses cuda:(r % device_count) and
the ranks share the cards when there are fewer cards than ranks; the
backend is nccl where every rank has a card of its own and gloo otherwise
(the CPU, or more ranks than cards: nccl refuses two ranks on one card).
gloo takes CUDA tensors in every collective this module calls (all_reduce
SUM / MAX / MIN and all_gather; tests/test_torch_cuda.py holds it to
that), so no tensor is staged through host memory here.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist

from tpu_renderer_torch import pipeline
from tpu_renderer_torch.kernels import conditional, raster, shade, vertex
from tpu_renderer_torch.kernels.common import pad_extent, round_up
from tpu_renderer_torch.pipeline import FrameParams, SceneBuffers
from tpu_renderer_torch.present import to_packed_u32

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def device_and_backend(local_rank: int, n_local: int, kind: str = "cuda"):
    """The rank's device and the group's backend: the CPU and gloo; or
    cuda:(local_rank % device_count), over nccl where each of the n_local
    ranks has a card of its own and over gloo where ranks share one."""
    if kind == "cpu":
        return torch.device("cpu"), "gloo"
    if kind != "cuda":
        raise ValueError(f"multichip runs on 'cuda' or 'cpu', not {kind!r}")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("multichip on the card needs a CUDA device: pass "
                           "device=\"cpu\" to run the ranks on the CPU")
    return (torch.device("cuda", local_rank % count),
            "nccl" if n_local <= count else "gloo")


class Mesh:
    """A (n_rows, n_tri) mesh over the ranks of the default process group:
    rank r sits at row r // n_tri and tri r % n_tri, as np.reshape(n_rows,
    n_tri) places the JAX package's devices. It holds the rank's device and
    the groups of its 'rows' column, its 'tri' row and the whole mesh.

    timing=True synchronises the card around every collective and adds its
    host time to collective_ms (and 1 to collectives); off, a collective
    costs one attribute test more. A synchronisation cannot be captured, so
    a collective under a CUDA graph capture (frame_graph.FrameGraph) with
    timing on raises."""

    def __init__(self, n_rows: int, n_tri: int, device: torch.device, groups):
        self.n_rows, self.n_tri = n_rows, n_tri
        self.rank = dist.get_rank()
        self.row, self.tri = divmod(self.rank, n_tri)
        self.device = device
        self.backend = dist.get_backend()
        self._groups = groups
        self.timing = False
        self.collective_ms = 0.0
        self.collectives = 0

    @property
    def shape(self) -> dict:
        return {"rows": self.n_rows, "tri": self.n_tri}

    def _timed(self, fn):
        if not self.timing:
            return fn()
        if self.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("Mesh.timing synchronises the card around each "
                               "collective, which a CUDA graph capture cannot "
                               "hold: turn it off to capture the mesh frame")
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda _dev: None))
        sync(self.device)
        t0 = time.perf_counter()
        out = fn()
        sync(self.device)
        self.collective_ms += (time.perf_counter() - t0) * 1000.0
        self.collectives += 1
        return out

    def all_reduce(self, t, op: str, axis: Optional[str] = None):
        """t reduced by op ('sum', 'max', 'min') over the ranks of `axis`
        ('rows', 'tri', or None for the whole mesh); a new tensor."""
        out = t.clone(memory_format=torch.contiguous_format)
        self._timed(lambda: dist.all_reduce(out, op=_OPS[op],
                                            group=self._groups[axis]))
        return out

    def all_gather(self, t, axis: str, dim: int = 0):
        """The ranks' t along `axis`, concatenated along dim in the axis's
        order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        self._timed(lambda: dist.all_gather(parts, t, group=self._groups[axis]))
        return torch.cat(parts, dim=dim)


def make_mesh(n_rows: int, n_tri: int = 1, device="cuda") -> Mesh:
    """The ('rows', 'tri') mesh over the initialised default process group,
    which must have n_rows * n_tri ranks (launch, or torchrun, starts
    them). Every rank calls it: the groups are made collectively. device:
    'cuda' (the rank's card by device_and_backend) or 'cpu'."""
    n = n_rows * n_tri
    if n_rows < 1 or n_tri < 1:
        raise ValueError(f"a mesh needs rows, tri >= 1, got ({n_rows}, {n_tri})")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"multichip ({n_rows}, {n_tri}) runs one process a rank and needs "
            f"an initialised torch.distributed process group of {n} ranks: "
            f"start them with tpu_renderer_torch.parallel.multichip.launch "
            f"or torchrun")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"multichip ({n_rows}, {n_tri}) needs a process "
                           f"group of {n} ranks, this one has {world}")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev, _ = device_and_backend(local, n_local, torch.device(device).type)
    if dist.get_backend() == "nccl" and dev.type != "cuda":
        raise RuntimeError("an nccl process group takes CUDA tensors only")
    tri_group, _ = dist.new_subgroups_by_enumeration(
        [[r * n_tri + t for t in range(n_tri)] for r in range(n_rows)])
    rows_group, _ = dist.new_subgroups_by_enumeration(
        [[r * n_tri + t for r in range(n_rows)] for t in range(n_tri)])
    return Mesh(n_rows, n_tri, dev,
                {"tri": tri_group, "rows": rows_group, None: dist.group.WORLD})


# ---------------------------------------------------------------------------
# Starting the ranks
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, kind, fn, args, out):
    """One spawned rank: its device, the process group, fn; rank 0 writes
    fn's result to `out` for the parent."""
    dev, backend = device_and_backend(rank, n, kind)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        result = fn(rank, *args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def _describe(n: int, kind: str) -> str:
    dev, backend = device_and_backend(0, n, kind)
    if dev.type == "cpu":
        return f"[multichip] {n} ranks on the CPU over {backend}"
    cards = torch.cuda.device_count()
    share = f"{n} ranks share {cards} card(s)" if n > cards else "one card a rank"
    return (f"[multichip] {n} ranks on cuda:(rank % {cards}) over {backend}: "
            f"{share}")


def launch(fn, n: int, *, device="cuda", args=()):
    """Run fn(rank, *args) in each of n ranks of one process group and
    return rank 0's result (fn's result must pickle).

    n worker processes are spawned on this host (torch.multiprocessing,
    start method spawn, which CUDA needs), each with its device and the
    group of device_and_backend, and joined; a rank that raises fails the
    call. On the card the kernel library is built here first, so that the
    ranks only load it. Under torchrun (WORLD_SIZE set) or an initialised
    group, the group is taken as it stands and fn runs in this process,
    returning this rank's result."""
    import torch.multiprocessing as mp

    kind = torch.device(device).type
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        return _run_in_group(fn, n, kind, args)
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multichip on the card needs a CUDA device: "
                               "pass device=\"cpu\" to run the ranks on the CPU")
        from tpu_renderer_torch.kernels import _build

        _build.build()
    print(_describe(n, kind), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pkl")
        mp.start_processes(_rank_main, args=(n, _free_port(), kind, fn, args, out),
                           nprocs=n, join=True, start_method="spawn")
        with open(out, "rb") as f:
            return pickle.load(f)


def _run_in_group(fn, n: int, kind: str, args):
    """launch under torchrun: the group of its environment, this rank."""
    if not dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", 0))
        dev, backend = device_and_backend(
            local, int(os.environ.get("LOCAL_WORLD_SIZE", n)), kind)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend)
    if dist.get_world_size() != n:
        raise RuntimeError(f"launch of {n} ranks inside a process group of "
                           f"{dist.get_world_size()}")
    if dist.get_rank() == 0:
        print(_describe(n, kind), flush=True)
    return fn(dist.get_rank(), *args)


# ---------------------------------------------------------------------------
# The frame
# ---------------------------------------------------------------------------


def _shift_aabb_y(aabb, y0):
    """Screen boxes moved up by y0 (empty boxes stay empty)."""
    out = aabb.clone()
    out[:, 1] = aabb[:, 1] - y0
    out[:, 3] = aabb[:, 3] - y0
    return out


def band_extent(width: int, height: int, tile_h: int, tile_w: int,
                n_rows: int):
    """(Wp, Hp, band_h): the padded extent with Hp a multiple of tile_h *
    n_rows, so every band is whole tiles."""
    wp, hp = pad_extent(width, height, tile_h, tile_w)
    hp = round_up(hp, tile_h * n_rows)
    return wp, hp, hp // n_rows


@torch.no_grad()
def background_fb(params: FrameParams, *, mesh: Mesh, width: int, height: int,
                  tile_h: int = 32, tile_w: int = 128,
                  effect: Optional[int] = None):
    """The whole background (kernel 2.9 or 2.10) at the mesh's padded
    extent; every rank computes it and slices its band from it."""
    wp, hp, _ = band_extent(width, height, tile_h, tile_w, mesh.n_rows)
    return pipeline._background(params, hp, wp, height, tile_h, tile_w, effect)


def _shard(x, n_pad: int, tri: int, n_tri: int, fill=0):
    """x padded along dim 0 to n_pad rows of `fill`, then the tri-th of
    n_tri equal slices."""
    if x.shape[0] < n_pad:
        pad = torch.full((n_pad - x.shape[0],) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad])
    ts = n_pad // n_tri
    return x[tri * ts:(tri + 1) * ts].contiguous()


def _shard_set(corners: vertex.CornerData, draw, valid, mesh: Mesh):
    """A triangle set's shard on this rank: padded to a multiple of
    raster.CHUNK * n_tri (padding rows: draw -1, invalid, zero corners),
    cut into n_tri equal shards. Returns (corners, draw, valid, t_shard);
    the shard's local id i is global id i + tri * t_shard."""
    n_pad = round_up(max(draw.shape[0], 1), raster.CHUNK * mesh.n_tri)
    cut = lambda x, fill=0: _shard(x, n_pad, mesh.tri, mesh.n_tri, fill)  # noqa: E731
    return (vertex.CornerData(*(cut(f) for f in corners)), cut(draw, -1),
            cut(valid, False), n_pad // mesh.n_tri)


@torch.no_grad()
def render_frame_multichip(buffers: SceneBuffers, params: FrameParams, *,
                           mesh: Mesh, width: int, height: int,
                           tile_h: int = 32, tile_w: int = 128,
                           bin_cap: int = 256, tri_cap: int = 1024,
                           fp16: bool = True, transp_textured: bool = True,
                           fused: bool = True, trilinear: bool = True,
                           pot: bool = False, out_width: Optional[int] = None,
                           out_height: Optional[int] = None, bg_fb=None):
    """The frame sharded over `mesh`: scene replicated on every rank, the
    framebuffer cut into row bands over 'rows', the triangles into shards
    over 'tri'. Called by every rank of the mesh; returns on each ((H, W)
    int32 packed RGBA of the whole frame, aux dict of device scalars like
    render_frame's: counts SUM over 'tri', overflow counters and layers
    MAX over the mesh).

    The statics are render_frame's. As in the JAX package's multi-device
    body, the opaque and transparent sets are set up apart and the
    deferred transparent pass always bins with bin_cap and refines. The
    fused textured peel's bins keep submission order, as the
    single-device peel's do: the id is the peel order.

    Global coordinates: the planes are the single-device frame's, not
    rebased to the band (the JAX body's C += B * y0 rounds the planes
    otherwise and moves 0.17% of the 1080p bench frame's pixels by a u8
    step). A rank's bins are its band's tiles (the boxes binned moved up
    by y0, a whole number of tiles), and its raster launches cover those
    tiles alone, from the frame's tile row y0 / tile_h (the kernels'
    tile_y0), so every plane, depth and layer id is band-sized while each
    pixel center stays the frame's: what the JAX body's grid covers, in
    the frame's coordinates.

    Every rank draws the same operations in the same order, so the frame
    captures as one CUDA graph where the collectives can be captured
    (nccl: frame_graph.FrameGraph with mesh=), the textured peel a WHILE
    node whose test each 'tri' group agrees on (_peel).

    bg_fb: optional (4, Hp, Wp) background at the mesh's padded extent
    (background_fb); out_width/out_height: the upscale blit, after the
    bands gather."""
    if (out_width is None) != (out_height is None):
        raise ValueError("out_width and out_height must be set together")
    wp, hp, band_h = band_extent(width, height, tile_h, tile_w, mesh.n_rows)
    band_tiles = dict(tiles_x=wp // tile_w, tiles_y=band_h // tile_h,
                      tile_w=tile_w, tile_h=tile_h)
    y0 = mesh.row * band_h
    # the raster launches: the band's tiles, from the frame's tile row
    tiles = dict(band_tiles, tile_y0=y0 // tile_h)
    dev = buffers.draw_model.device

    def q(x):
        return x.half().float() if fp16 else x

    if bg_fb is None:
        bg_fb = background_fb(params, mesh=mesh, width=width, height=height,
                              tile_h=tile_h, tile_w=tile_w)
    fb = q(bg_fb[:, y0:y0 + band_h])
    viewproj = vertex.mat4_mul(params.proj, params.view)
    sun = params.sun_dir[:3]
    look = dict(atlas=buffers.atlas, ambient_rgb=params.ambient[:3],
                sun_power=params.sun_color[3], trilinear=trilinear, pot=pot)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    vis = vertex.draw_visibility(viewproj, buffers.draw_model,
                                 buffers.draw_bounds_origin,
                                 buffers.draw_bounds_extents)
    aux = {"visible_opaque_draws": (vis & buffers.draw_opaque_mask).sum(dtype=torch.int32)}
    # overflow counters and layers, MAX over the mesh at the end
    peaks = dict(bin_overflow=zero, bin_overflow_tris=zero,
                 bin_overflow_transparent=zero,
                 bin_overflow_transparent_tris=zero, transparent_layers=zero)

    def band_boxes(aabb):
        return _shift_aabb_y(aabb, float(y0)) if y0 else aabb

    def setup(corners, draw, valid, visible, sort: bool):
        """The shard's setup and its bins over the band's tiles. Fused: fat
        rows, (sort) spatially sorted, dense bins. Deferred: packed rows,
        the fat rows shading gathers, capped chunk bins."""
        if fused:
            rows, aabb, valid_l = vertex.triangle_setup_rows(
                corners, draw, valid, buffers.draw_model, visible, viewproj,
                width, height, sun_dir=sun)
            valid_s = valid_l
            if sort:
                aabb, valid_s, rows = raster.spatial_sort(aabb, valid_l, rows)
            bins, counts = pipeline._bins(band_boxes(aabb), valid_s, band_tiles)
            return dict(rows=rows.contiguous(), bins=bins, counts=counts,
                        valid=valid_l)
        s, rows = pipeline._deferred_setup(corners, draw, valid, buffers, visible,
                                           viewproj, width, height, sun)
        aabb = band_boxes(s.aabb)
        caabb, cvalid = raster.chunk_aabbs(aabb, s.valid)
        cbins, ccounts, overflow_c = raster.bin_triangles(
            caabb, cvalid, bin_cap=bin_cap, **band_tiles)
        return dict(packed=s.packed, aabb=aabb, rows=rows, cbins=cbins,
                    ccounts=ccounts, valid=s.valid, overflow_c=overflow_c)

    def refine(st):
        return raster.refine_bins(st["cbins"], st["aabb"], tri_cap=tri_cap,
                                  **band_tiles)

    # -- opaque: the shard's raster, composited over 'tri' ------------------
    corners, draw, valid, t_shard = _shard_set(
        buffers.opaque_corners, buffers.opaque_tri_draw,
        buffers.opaque_tri_valid, mesh)
    st = setup(corners, draw, valid, vis, sort=True)
    aux["opaque_triangles"] = mesh.all_reduce(
        st["valid"].sum(dtype=torch.int32), "sum", "tri")
    base = mesh.tri * t_shard
    if fused:
        z, tid_l, attrs, meta, inv = raster.rasterize_fused(
            st["rows"], st["bins"], st["counts"], **tiles)
    else:
        peaks["bin_overflow"] = st["overflow_c"]
        bins, counts, peaks["bin_overflow_tris"] = refine(st)
        z, tid_l = raster.rasterize(st["packed"], bins, counts, **tiles)
    # local -> global ids; the deepest z wins, a tie the larger id
    tid = torch.where(tid_l >= 0, tid_l + base, raster.NO_TRI)
    zmax = mesh.all_reduce(z, "max", "tri")
    cand = torch.where(z == zmax, tid, raster.NO_TRI)
    tid = mesh.all_reduce(cand, "max", "tri")
    z = zmax
    if fused:
        # one shard holds the winner's planes: SUM the planes masked to it
        win = (cand == tid) & (tid >= 0)
        planes = torch.cat([attrs, meta, inv[None]])
        planes = mesh.all_reduce(torch.where(win[None], planes, 0.0), "sum", "tri")
        na, nm = attrs.shape[0], meta.shape[0]
        shaded = shade.shade_fused(planes[:na], planes[na:na + nm],
                                   planes[na + nm], **look)
        valid_px = tid >= 0
        rgb = torch.where(valid_px[None], shaded, fb[:3])
        alpha = torch.where(valid_px, torch.ones((), device=dev), fb[3])
        fb = q(torch.cat([rgb, alpha[None]]))
    else:
        # the winner's fat row lives on its shard: gather the shards' rows
        rows_all = mesh.all_gather(st["rows"], "tri")
        fb = q(shade.shade(tid, rows_all, background=fb, y0=y0, **look))

    # -- transparent ----------------------------------------------------------
    if buffers.transp_tri_vidx.shape[0] > 0:
        corners, draw, valid, t_shard = _shard_set(
            buffers.transp_corners, buffers.transp_tri_draw,
            buffers.transp_tri_valid, mesh)
        textured_peel = not (fused and not transp_textured)
        st = setup(corners, draw, valid, torch.ones_like(vis),
                   sort=not textured_peel)
        if not fused:
            peaks["bin_overflow_transparent"] = st["overflow_c"]
        if not textured_peel:
            light = torch.cat([params.sun_dir[:3], params.sun_color[3:4],
                               params.ambient[:3],
                               torch.zeros(1, dtype=torch.float32, device=dev)])
            acc, cnt = raster.rasterize_accum(st["rows"], st["bins"], st["counts"], z,
                                              light.contiguous(), **tiles)
            acc = mesh.all_reduce(acc, "sum", "tri")
            cnt = mesh.all_reduce(cnt, "sum", "tri")
            fb = pipeline._composite(fb, cnt > 0, acc, q)
            peaks["transparent_layers"] = cnt.max()
        else:
            if fused:
                bins, counts = st["bins"], st["counts"]
            else:
                bins, counts, peaks["bin_overflow_transparent_tris"] = refine(st)
            fb, peaks["transparent_layers"] = _peel(
                mesh, st, bins, counts, z, fb, q, mesh.tri * t_shard, y0,
                fused, transp_textured, look, tiles,
                limit=buffers.transp_tri_vidx.shape[0])

    names = list(peaks)
    peak = mesh.all_reduce(torch.stack([peaks[k].to(torch.int32) for k in names]),
                           "max")
    aux.update(zip(names, peak.unbind()))

    # -- gather the bands, blit, present -------------------------------------
    if out_width is not None and (out_width, out_height) != (width, height):
        full = mesh.all_gather(fb, "rows", dim=1)
        up = pipeline.linear_blit(full, width=width, height=height,
                                  out_width=out_width, out_height=out_height)
        return to_packed_u32(up, width=out_width, height=out_height), aux
    image = mesh.all_gather(to_packed_u32(fb, width=wp, height=band_h), "rows")
    return image[:height, :width].contiguous(), aux


def _peel(mesh, st, bins, counts, z, fb, q, base_id, y0, fused, textured,
          look, tiles, limit: int):
    """The textured transparent pass: the global submission-order peel.
    Each layer every 'tri' rank peels its shard's next layer over its
    band's tiles (kernel 2.3 on the fused path, 2.5 on the deferred one), a
    MIN over 'tri' elects the smallest global id, and the winner's planes
    (fused) or shaded colour (deferred) are summed over 'tri' under the win
    mask; the layer blends in and quantises to fp16 as the single-device
    loop does. Returns (fb, layers peeled in this band, a device scalar).

    The loop is pipeline._peel_on_device's: a WHILE node around an IF node
    under a FrameGraph capture (its collectives captured inside the
    nodes' bodies), host tests elsewhere (gloo, the CPU, an eager frame).
    After the MIN `found` is the same on every rank of a 'tri' group, so
    the group's ranks run the same passes, and the same collectives, with
    no collective of their own for the stop. Bands stop apart: their
    collectives are their own groups'. As there, a band of `limit`
    transparent triangles peels at most `limit` layers."""
    last = torch.full(fb.shape[1:], -1, dtype=torch.int32, device=fb.device)
    layers = torch.zeros((), dtype=torch.int32, device=fb.device)
    fb = fb.clone()   # updated in place

    def one_pass():
        # global last -> this shard's eligibility threshold: an earlier
        # shard's winner clamps to -1 (all eligible), a later one stays
        # above every local id (none eligible)
        last_l = torch.clamp(last - base_id, -1, raster.ID_INF)
        if fused:
            layer_l, attrs, meta, inv = raster.rasterize_peel_fused(
                st["rows"], bins, counts, z, last_l, **tiles)
        else:
            layer_l = raster.rasterize_peel(st["packed"], bins, counts, z, last_l,
                                            **tiles)
        found_l = layer_l < raster.ID_INF
        gl = torch.where(found_l, layer_l + base_id, raster.ID_INF)
        layer = mesh.all_reduce(gl, "min", "tri")
        found = layer < raster.ID_INF
        more = found.any()

        def keep():
            win = found_l & (gl == layer)
            if fused:
                planes = torch.cat([attrs, meta, inv[None]])
                planes = mesh.all_reduce(torch.where(win[None], planes, 0.0), "sum", "tri")
                na, nm = attrs.shape[0], meta.shape[0]
                src = shade.shade_fused(planes[:na], planes[na:na + nm],
                                        planes[na + nm], textured=textured, **look)
            else:
                src = shade.shade_core(torch.where(found_l, layer_l, 0), st["rows"],
                                       textured=textured, y0=y0, **look)
                src = mesh.all_reduce(torch.where(win[None], src, 0.0), "sum", "tri")
            fb.copy_(pipeline._composite(fb, found, src, q))
            last.copy_(torch.where(found, layer, raster.ID_INF))
            layers.add_(1)

        conditional.run_if(more, keep)
        return more & (layers <= limit)

    conditional.run_while(torch.ones((), dtype=torch.bool, device=fb.device), one_pass)
    return fb, layers

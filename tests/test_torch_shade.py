"""The fused path's shading (kernels/shade.py: shade_fused, its plain version
shade_fused_plain and kernel 2.12's wrapper shade_fused_kernel) on the CPU:
CPU tensors take the plain version without touching the kernel library; the
wrapper refuses what the kernel does not take with ValueError before any
build; and the epilogue form (blend, fb, hit, fp16, out) equals the shading
followed by the composite the frame ran after it before the two were one
call, for both blends. The kernel against the plain version is in
tests/test_torch_cuda.py; shade_planes and edge_planes make the planes both
files shade.
"""

import numpy as np
import pytest
import torch

from tpu_renderer_torch.kernels import _build, raster, shade, vertex
from tpu_renderer_torch.kernels.common import fma
from tpu_renderer_torch.resources import build_atlas
from tpu_renderer_torch.utils.demo import checker_texture, noise_texture
from test_torch_threads import share_cores

share_cores()

W, H = 256, 64
TILES = dict(tiles_x=2, tiles_y=2, tile_w=128, tile_h=32)
EDGES = ("inv0", "lod_low", "lod_high", "uv_far", "no_hits")


def shade_atlas(device):
    """A power-of-two texture (64x64, 7 levels) and one that is not (48x40,
    6 levels), mip-mapped, in one atlas."""
    imgs = [checker_texture(64, 8), np.ascontiguousarray(noise_texture(64, seed=1)[:40, :48])]
    return build_atlas(imgs, device=device)


def shade_planes(device, source: str = "fused", seed: int = 0):
    """(attrs, meta, inv, hit, atlas) of a real raster over 96 random screen
    triangles at WxH: kernel 2.1's opaque pass ("fused", hit: a winner) or
    kernel 2.3's first peel ("peel", hit: a layer), by the frame's own
    wrappers (the plain versions on the CPU). Each hit pixel is rebound to
    one of shade_atlas's textures (by its triangle's id) with filter flags
    0-7 in a pattern over x and y, so every filter mode, both wraps and
    both mip modes shade."""
    rng = np.random.default_rng(seed)
    T = 96
    ndc = np.empty((T, 3, 3), np.float32)
    ndc[..., :2] = rng.uniform(-1.2, 1.2, size=(T, 3, 2))
    ndc[..., 2] = rng.uniform(0.05, 0.95, size=(T, 3))
    V = T * 3
    corners = vertex.expand_corners(
        ndc.reshape(-1, 3), rng.normal(size=(V, 3)), rng.uniform(size=(V, 4)),
        rng.uniform(-1.5, 2.5, size=(V, 2)), np.arange(V).reshape(T, 3),
        np.zeros(T, np.int32), np.ones(T, bool), np.zeros(1, np.int32), np.ones((1, 4)),
        np.asarray([[0, 0, 64, 64, 7, 3, 0, 0]]), device=device)
    eye = torch.eye(4, device=device)
    rows, aabb, valid = vertex.triangle_setup_rows(
        corners, torch.zeros(T, dtype=torch.int32, device=device),
        torch.ones(T, dtype=torch.bool, device=device), eye[None],
        torch.ones(1, dtype=torch.bool, device=device), eye, W, H,
        sun_dir=torch.tensor((0.3, 0.8, -0.5), device=device))
    if source == "fused":
        aabb, valid, rows = raster.spatial_sort(aabb, valid, rows)
    caabb, cvalid = raster.chunk_aabbs(aabb, valid)
    gaabb, gvalid = raster.group_aabbs(aabb, valid)
    bins, counts = raster.bin_triangles_full(caabb, cvalid, gaabb, gvalid, **TILES)
    rows = rows.contiguous()
    if source == "fused":
        _z, tid, attrs, meta, inv = raster.rasterize_fused(rows, bins, counts, **TILES)
        hit = tid >= 0
    else:
        z_base = torch.zeros((H, W), dtype=torch.float32, device=device)
        last = torch.full((H, W), -1, dtype=torch.int32, device=device)
        tid, attrs, meta, inv = raster.rasterize_peel_fused(rows, bins, counts, z_base, last,
                                                            **TILES)
        hit = tid < raster.ID_INF
    atlas = shade_atlas(device)
    tex = torch.as_tensor(atlas.tex_meta[:, :5], dtype=torch.float32, device=device)
    k = (tid.clamp(min=0) % 2).long()
    yy, xx = torch.meshgrid(torch.arange(H, device=device), torch.arange(W, device=device),
                            indexing="ij")
    flags = ((xx // 3 + yy) % 8).to(torch.float32)
    bound = torch.cat([tex[k].movedim(-1, 0), flags[None]])
    meta = meta.clone()
    meta[:6] = torch.where(hit[None], bound, meta[:6])
    return attrs, meta, inv, hit, atlas


def edge_planes(device, case: str):
    """shade_planes' opaque planes pushed to an edge: inv 0 at every other
    hit column ("inv0": the gradients vanish, the LOD clamps at 0), the
    gradient planes scaled by 1e-9 ("lod_low") or 1e6 ("lod_high": the LOD
    clamps at n_levels - 1), u and v moved hundreds of periods outside
    [0, 1) ("uv_far"), or no pixel hit ("no_hits")."""
    attrs, meta, inv, hit, atlas = shade_planes(device)
    attrs, meta, inv = attrs.clone(), meta.clone(), inv.clone()
    if case == "inv0":
        inv[:, ::2] = 0.0
    elif case in ("lod_low", "lod_high"):
        meta[6:10] *= 1e-9 if case == "lod_low" else 1e6
    elif case == "uv_far":
        attrs[4] = attrs[4] * 37.0 + 1000.5
        attrs[5] = attrs[5] * -29.0 - 777.25
    else:
        hit = torch.zeros_like(hit)
    return attrs, meta, inv, hit, atlas


def framebuffer(device, seed: int = 1):
    """A (4, H, W) framebuffer of fp16 values, alpha in [0, 1]."""
    g = torch.Generator().manual_seed(seed)
    fb = torch.rand((4, H, W), generator=g) * torch.tensor([1.5, 1.2, 0.9, 1.0])[:, None, None]
    return fb.half().float().to(device)


def look(device):
    return dict(ambient_rgb=torch.tensor([0.1, 0.12, 0.14], device=device),
                sun_power=torch.tensor(1.2, device=device))


@pytest.fixture(scope="module")
def planes():
    return shade_planes("cpu")


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything builds or loads the kernel library."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel library was built or loaded")

    for name in ("build", "load_library", "build_tile", "load_tile_library"):
        monkeypatch.setattr(_build, name, refuse)


@pytest.mark.parametrize("blend", [None, "replace", "add"])
def test_cpu_tensors_take_the_plain_version(planes, no_build, blend):
    attrs, meta, inv, hit, atlas = planes
    epilogue = {} if blend is None else dict(fb=framebuffer("cpu"), hit=hit, blend=blend)
    before = shade.fused_counter.total()
    got = shade.shade_fused(attrs, meta, inv, atlas, trilinear=True, **look("cpu"), **epilogue)
    want = shade.shade_fused_plain(attrs, meta, inv, atlas, trilinear=True, **look("cpu"),
                                   **epilogue)
    assert shade.fused_counter.total() == before
    assert got.shape == (3 if blend is None else 4, H, W)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _refused(planes, case):
    """shade_fused_kernel's arguments for a case it must refuse."""
    attrs, meta, inv, hit, atlas = planes
    fb = framebuffer("cpu")
    kw = dict(**look("cpu"))
    if case == "cpu":
        return (attrs, meta, inv, atlas), dict(kw, fb=fb, hit=hit, blend="add")
    if case == "attrs_planes":
        return (attrs[:5], meta, inv, atlas), kw
    if case == "meta_planes":
        return (attrs, meta[:12], inv, atlas), kw
    if case == "inv_dtype":
        return (attrs, meta, inv.double(), atlas), kw
    if case == "blend_name":
        return (attrs, meta, inv, atlas), dict(kw, fb=fb, hit=hit, blend="over")
    if case == "blend_without_fb":
        return (attrs, meta, inv, atlas), dict(kw, hit=hit, blend="replace")
    if case == "fb_without_blend":
        return (attrs, meta, inv, atlas), dict(kw, fb=fb, hit=hit)
    if case == "hit_dtype":
        return (attrs, meta, inv, atlas), dict(kw, fb=fb, hit=hit.int(), blend="add")
    if case == "out_shape":
        return (attrs, meta, inv, atlas), dict(kw, fb=fb, hit=hit, blend="add", out=fb[:3])
    raise ValueError(case)


@pytest.mark.parametrize("case", ["cpu", "attrs_planes", "meta_planes", "inv_dtype",
                                  "blend_name", "blend_without_fb", "fb_without_blend",
                                  "hit_dtype", "out_shape"])
def test_the_wrapper_refuses_before_any_build(planes, no_build, case):
    args, kwargs = _refused(planes, case)
    before = shade.fused_counter.total()
    with pytest.raises(ValueError):
        shade.shade_fused_kernel(*args, **kwargs)
    assert shade.fused_counter.total() == before
    if case != "cpu":   # the public entry refuses the same on the CPU
        with pytest.raises(ValueError):
            shade.shade_fused(*args, **kwargs)


def _two_steps(attrs, meta, inv, atlas, fb, hit, blend, fp16, textured):
    """The shading, then the composite as render_frame ran it after the
    shading before the two were one call: the opaque pass's replace, or
    _composite's additive blend src + dst * dstAlpha; then the fp16 write."""
    src = shade.shade_fused(attrs, meta, inv, atlas, textured=textured, trilinear=True,
                            **look("cpu"))
    if blend == "replace":
        rgb = torch.where(hit[None], src, fb[:3])
    else:
        rgb = torch.where(hit[None], fma(fb[:3], fb[3][None], src), fb[:3])
    alpha = torch.where(hit, torch.ones(()), fb[3])
    out = torch.cat([rgb, alpha[None]])
    return out.half().float() if fp16 else out


@pytest.mark.parametrize("textured", [True, False])
@pytest.mark.parametrize("fp16", [True, False])
@pytest.mark.parametrize("blend", ["replace", "add"])
def test_the_epilogue_equals_shade_then_composite(planes, blend, fp16, textured):
    attrs, meta, inv, hit, atlas = planes
    fb = framebuffer("cpu")
    want = _two_steps(attrs, meta, inv, atlas, fb, hit, blend, fp16, textured)
    got = shade.shade_fused(attrs, meta, inv, atlas, textured=textured, trilinear=True,
                            fb=fb, hit=hit, blend=blend, fp16=fp16, **look("cpu"))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # in place: out=fb, as the peel's WHILE body writes it
    inplace = fb.clone()
    back = shade.shade_fused(attrs, meta, inv, atlas, textured=textured, trilinear=True,
                             fb=inplace, hit=hit, blend=blend, fp16=fp16, out=inplace,
                             **look("cpu"))
    assert back is inplace
    assert torch.equal(inplace.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", EDGES)
def test_edge_planes_shade_finite_where_hit(case):
    """Every edge of edge_planes shades on the CPU, finite and in range
    where hit; the pixels no layer hit keep the framebuffer."""
    attrs, meta, inv, hit, atlas = edge_planes("cpu", case)
    fb = framebuffer("cpu")
    out = shade.shade_fused(attrs, meta, inv, atlas, trilinear=True, fb=fb, hit=hit,
                            blend="add", **look("cpu"))
    assert torch.equal(out[:, ~hit], fb[:, ~hit])
    assert torch.isfinite(out).all()
    if case != "no_hits":
        assert hit.sum() > 1000
        assert (out[3][hit] == 1.0).all()

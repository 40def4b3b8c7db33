"""The port's host side against the JAX package's: the copied loader, scene
graph, flatten, atlas, math and camera give equal arrays on the same GLB;
present packs identical bytes; convert carries JAX buffers across; the
copied hud and viewer are their originals' code; and the port never imports
JAX or the JAX package.

Tolerance (PERF.md): everything here is exact. The JAX package pads
triangle arrays to its test-tier CHUNK=8 and the port to CHUNK=32, so
per-triangle arrays are compared on the JAX package's rows (the port's
extra rows are inert padding).
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_renderer import camera as jcamera  # noqa: E402
from tpu_renderer import gltf as jgltf  # noqa: E402
from tpu_renderer import math3d as jmath3d  # noqa: E402
from tpu_renderer import present as jpresent  # noqa: E402
from tpu_renderer import scene as jscene  # noqa: E402
from tpu_renderer.utils import demo as jdemo  # noqa: E402
from tpu_renderer_torch import camera, convert, gltf, math3d, present, scene  # noqa: E402
from tpu_renderer_torch.config import RendererConfig  # noqa: E402
from tpu_renderer_torch.utils import demo  # noqa: E402
from test_torch_threads import share_cores  # noqa: E402

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "tpu_renderer_torch")


@pytest.fixture(scope="module")
def glb(tmp_path_factory):
    d = tmp_path_factory.mktemp("glb")
    path, jpath = str(d / "port.glb"), str(d / "jax.glb")
    demo.build_demo_glb(path, grid=4, seed=0)
    jdemo.build_demo_glb(jpath, grid=4, seed=0)
    return path, jpath


@pytest.fixture(scope="module")
def flats(glb):
    s = scene.load_scene(glb[0])
    js = jscene.load_scene(glb[0])
    return scene.flatten_scene(s, device="cpu"), jscene.flatten_scene(js), s, js


def _tree(nt):
    """A JAX NamedTuple of arrays -> nested dict of numpy arrays."""
    return {k: (_tree(v) if hasattr(v, "_asdict") else
                v if isinstance(v, int) else np.asarray(v))
            for k, v in nt._asdict().items()}


def test_demo_glb_bytes_identical(glb):
    with open(glb[0], "rb") as a, open(glb[1], "rb") as b:
        assert a.read() == b.read()


def test_loader_arrays_equal(glb):
    p, j = gltf.load_gltf(glb[0]), jgltf.load_gltf(glb[0])
    assert len(p.meshes) == len(j.meshes) and len(p.nodes) == len(j.nodes)
    for pm, jm in zip(p.meshes, j.meshes):
        for f in ("positions", "normals", "colors", "uvs", "indices"):
            np.testing.assert_array_equal(getattr(pm, f), getattr(jm, f))
    for pn, jn in zip(p.nodes, j.nodes):
        np.testing.assert_array_equal(pn.local_transform, jn.local_transform)
    for pi, ji in zip(p.images, j.images):
        np.testing.assert_array_equal(pi, ji)


def test_flatten_and_atlas_equal(flats):
    flat, jflat, s, js = flats
    b, jb = flat.buffers, jflat.buffers
    assert [o.material for o in flat.objects] == [o.material for o in jflat.objects]
    for f in ("positions", "normals", "colors", "uvs", "draw_model",
              "draw_mat", "draw_opaque_mask", "draw_bounds_origin",
              "draw_bounds_extents", "mat_color_factors", "mat_meta"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    for side in ("opaque", "transp"):
        n = np.asarray(getattr(jb, f"{side}_tri_draw")).shape[0]
        assert getattr(b, f"{side}_tri_draw").shape[0] % 32 == 0
        for f in ("tri_vidx", "tri_draw", "tri_valid"):
            got = getattr(b, f"{side}_{f}").numpy()
            np.testing.assert_array_equal(got[:n], np.asarray(getattr(jb, f"{side}_{f}")))
            assert not got[n:].any() or f == "tri_draw"
        pc, jc = getattr(b, f"{side}_corners"), getattr(jb, f"{side}_corners")
        valid = np.asarray(getattr(jb, f"{side}_tri_valid"))
        for f in pc._fields:
            np.testing.assert_array_equal(getattr(pc, f).numpy()[:n][valid],
                                          np.asarray(getattr(jc, f))[valid], err_msg=f)
    np.testing.assert_array_equal(b.atlas.quads.numpy().view(np.uint32),
                                  np.asarray(jb.atlas.quads))
    np.testing.assert_array_equal(b.atlas.tex_meta, np.asarray(jb.atlas.tex_meta))
    assert b.atlas.width == jb.atlas.width


def test_convert_matches_own_flatten(flats):
    flat, jflat, _, _ = flats
    got = convert.scene_buffers_from_numpy(_tree(jflat.buffers), device="cpu")
    for f in got._fields:
        a, b = getattr(got, f), getattr(flat.buffers, f)
        if f == "atlas":
            assert torch.equal(a.quads, b.quads) and a.width == b.width
        elif f.endswith("_corners"):
            valid = flat.buffers.transp_tri_valid if f.startswith("transp") \
                else flat.buffers.opaque_tri_valid
            for x, y in zip(a, b):
                assert torch.equal(x[valid], y[valid]), f
        else:
            assert torch.equal(a, b), f


def test_frame_params_convert():
    d = dict(view=np.eye(4), proj=np.eye(4) * 2, bg_effect=np.int32(1),
             bg_data1=np.arange(4), bg_data2=np.ones(4), ambient=np.zeros(4),
             sun_dir=np.ones(4), sun_color=np.ones(4))
    p = convert.frame_params_from_numpy(d, device="cpu")
    assert p.bg_effect.dtype == torch.int32 and p.proj.dtype == torch.float32
    assert float(p.proj[0, 0]) == 2.0


def test_math3d_and_camera_equal():
    rng = np.random.default_rng(0)
    for fn in ("perspective_zo", "vulkan_perspective"):
        np.testing.assert_array_equal(getattr(math3d, fn)(1.2, 1.7, 0.1, 100.0),
                                      getattr(jmath3d, fn)(1.2, 1.7, 0.1, 100.0))
    q = rng.normal(size=4).astype(np.float32)
    np.testing.assert_array_equal(math3d.quat_to_mat4(q), jmath3d.quat_to_mat4(q))
    m = rng.normal(size=(4, 4)).astype(np.float32)
    np.testing.assert_array_equal(math3d.rotate(m, 0.7, (0, 1, 0)),
                                  jmath3d.rotate(m, 0.7, (0, 1, 0)))
    cams = [camera.Camera(position=(1, 2, 3)), jcamera.Camera(position=(1, 2, 3))]
    for c in cams:
        c.process_key("w", True)
        c.process_cursor(13.0, -4.0)
        c.update()
        c.process_key("w", False)
    np.testing.assert_array_equal(cams[0].get_view_matrix(), cams[1].get_view_matrix())


def test_config_fields_equal():
    from tpu_renderer.config import RendererConfig as JConfig

    assert RendererConfig().__dict__ == JConfig().__dict__


def test_present_packing_equal():
    rng = np.random.default_rng(1)
    fb = rng.uniform(-0.2, 1.2, size=(4, 64, 256)).astype(np.float32)
    # exact halves: round half to even must agree
    fb[0, 0, :8] = (np.arange(8, dtype=np.float32) + 0.5) / 255.0
    want = np.asarray(jpresent.to_packed_u32(jnp.asarray(fb), width=250, height=60))
    got = present.to_packed_u32(torch.from_numpy(fb), width=250, height=60)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(present.unpack_u8(got), jpresent.unpack_u8(want))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _code(path):
    """The module's syntax tree without its docstring."""
    tree = ast.parse(open(path).read())
    if isinstance(tree.body[0], ast.Expr) and isinstance(tree.body[0].value, ast.Constant):
        tree.body = tree.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["hud.py", "viewer.py"])
def test_numpy_only_modules_are_their_originals(module):
    """hud.py and viewer.py import numpy and the standard library only, so
    the port's copies are the originals' code, statement for statement
    (their module docstrings apart)."""
    assert _code(os.path.join(PORT_DIR, module)) == \
        _code(os.path.join(ROOT, "tpu_renderer", module))


def test_hud_overlay_equal():
    from tpu_renderer import hud as jhud
    from tpu_renderer.engine import EngineStats as JStats
    from tpu_renderer_torch import hud
    from tpu_renderer_torch.engine import EngineStats

    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(120, 300, 4), dtype=np.uint8)
    values = dict(frame_time=16.667, triangle_count=46250, drawcall_count=3855,
                  scene_update_time=0.125, mesh_draw_time=12.5)
    got = hud.draw_stats(img.copy(), EngineStats(**values))
    np.testing.assert_array_equal(got, jhud.draw_stats(img.copy(), JStats(**values)))
    assert not np.array_equal(got, img)


NEW_MODULES = ("cli", "hud", "viewer", "utils.profiling", "kernels.background")


def test_port_never_imports_jax_or_reference():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT_DIR)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20
    for mod in NEW_MODULES:
        assert os.path.join(PORT_DIR, *mod.split(".")) + ".py" in files, mod
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tpu_renderer"), (path, mod)


def test_import_leaves_jax_out():
    new = ", ".join(f"tpu_renderer_torch.{m}" for m in NEW_MODULES)
    code = ("import sys, tpu_renderer_torch, tpu_renderer_torch.engine, "
            f"tpu_renderer_torch.convert, tpu_renderer_torch.milestones, {new}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpu_renderer')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

"""The graphed frame's CPU side: the factored peel loop (the form a
FrameGraph captures: a WHILE node around an IF node on the card; its tests
read on the host here, as in every eager frame), against the JAX package
and against the frames the port rendered before the loop was factored; the
capture's rehearsal (no host read or host-built tensor between the
kernels); the graph key and the Engine's graph cache; pipeline.eager(); the
launch counts a capture hands to its replays.

The card's side (a capture and its replays equal to the eager frames, the
pipelined draw's aux) is in tests/test_torch_cuda.py.

Tolerance: the port's frames are compared byte for byte with each other and
with digests of the frames the port rendered before (sha256 of the image
bytes, first 16 hex digits); with the JAX package's frame within 0.1% of
the pixels, as tests/test_torch_peel.py does.
"""

import hashlib
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_renderer import milestones as jmilestones  # noqa: E402
from tpu_renderer import pipeline as jpipeline  # noqa: E402
from tpu_renderer import scene as jscene  # noqa: E402
from tpu_renderer.present import unpack_u8 as junpack  # noqa: E402
from tpu_renderer_torch import frame_graph, milestones, pipeline, scene  # noqa: E402
from tpu_renderer_torch.bench import frame_statics, orbit_params  # noqa: E402
from tpu_renderer_torch.config import RendererConfig  # noqa: E402
from tpu_renderer_torch.engine import Engine  # noqa: E402
from tpu_renderer_torch.kernels import conditional, raster  # noqa: E402
from tpu_renderer_torch.present import unpack_u8  # noqa: E402
from tpu_renderer_torch.utils import profiling  # noqa: E402
from tpu_renderer_torch.utils.bench_frame import texture_the_glass  # noqa: E402
from tpu_renderer_torch.utils.demo import build_demo_glb  # noqa: E402
from test_torch_peel import _textured_stack  # noqa: E402
from test_torch_threads import share_cores  # noqa: E402

share_cores()

FW, FH = 128, 32
TOL = 0.001
STACK_VALUES = dict(view=np.eye(4, dtype=np.float32), proj=np.eye(4, dtype=np.float32),
                    bg_effect=np.int32(0),
                    bg_data1=np.asarray([0.1, 0.1, 0.1, 0.7], np.float32),
                    bg_data2=np.asarray([0.1, 0.1, 0.1, 1.0], np.float32),
                    ambient=np.zeros(4, np.float32),
                    sun_dir=np.asarray([0, 0, 1, 1], np.float32),
                    sun_color=np.ones(4, np.float32))
# the port's frames before the peel loop was factored: the six-layer stack
# at 128x64 (either path), and the demo grid 4 with textured glass at
# 256x64 (fused, then deferred past dense_bin_max_chunks=1), fp16 and fp32
STACK_DIGEST = {True: "92fa08aa7ea68e61", False: "8dd94a317898e244"}
DEMO_DIGEST = {True: "a467faf7df693c1c", False: "8832e912baedc68b"}


def _digest(image) -> str:
    return hashlib.sha256(np.ascontiguousarray(image).tobytes()).hexdigest()[:16]


def _stack():
    flat = scene.flatten_scene(_textured_stack(milestones, scene), device="cpu")
    params = pipeline.FrameParams(**{k: torch.as_tensor(v) for k, v in STACK_VALUES.items()})
    return flat.buffers, params


@pytest.fixture(scope="module")
def jax_stack():
    """The JAX package's frame of the stack at FWxFH (its deferred path: the
    fused one's interpret-mode peel takes ~30 s to compile here, and the
    layer count is the scene's)."""
    flat = jscene.flatten_scene(_textured_stack(jmilestones, jscene))
    img, aux = jpipeline.render_frame(
        flat.buffers,
        jpipeline.FrameParams(**{k: jnp.asarray(v) for k, v in STACK_VALUES.items()}),
        width=FW, height=FH, fused=False)
    return junpack(np.asarray(img)), int(aux["transparent_layers"])


@pytest.mark.parametrize("fused", [True, False])
def test_peel_loop_matches_jax_and_the_frames_before(jax_stack, fused):
    """On both paths: the stack's frame equals the one the port rendered
    before, within 0.1% of JAX's, and counts JAX's layers on the device."""
    buffers, params = _stack()
    img, aux = pipeline.render_frame(buffers, params, width=FW, height=64, fused=fused)
    assert _digest(unpack_u8(img)) == STACK_DIGEST[True]
    want, want_layers = jax_stack
    img, aux = pipeline.render_frame(buffers, params, width=FW, height=FH, fused=fused)
    diff = np.any(unpack_u8(img) != want, axis=-1)
    print(f"stack {FW}x{FH} fused={fused}: "
          f"{int(diff.sum())} of {diff.size} pixels differ from JAX")
    assert diff.mean() <= TOL
    layers = aux["transparent_layers"]
    assert isinstance(layers, torch.Tensor) and layers.dtype == torch.int32
    assert int(layers) == want_layers == 6


@pytest.mark.parametrize("fp16", [True, False])
def test_peel_loops_equal_the_frames_before_on_the_demo(tmp_path, fp16):
    """The demo grid with textured glass, fused and deferred, through the
    Engine's statics: the loop gives the frames the port rendered before,
    byte for byte (fp32: the peel's first composite reads the background
    buffer itself, which the loop, updating fb in place, must not write)."""
    path = str(tmp_path / "demo4.glb")
    build_demo_glb(path, grid=4, seed=0)
    for limit in (RendererConfig().dense_bin_max_chunks, 1):
        eng = Engine(RendererConfig(width=256, height=64, dense_bin_max_chunks=limit,
                                    framebuffer_fp16=fp16, camera_position=(0.0, 6.0, 8.0)),
                     device="cpu")
        eng.camera.pitch = np.float32(-0.18)
        eng.init(scene=texture_the_glass(scene.load_scene(path)))
        params = eng.frame_params()
        statics = frame_statics(eng)
        bg = eng._bg_fb_cached(params)
        before = bg.clone()
        img, aux = pipeline.render_frame(eng.flat.buffers, params, bg_fb=bg, **statics)
        assert _digest(unpack_u8(img)) == DEMO_DIGEST[fp16], (eng._fused, fp16)
        assert int(aux["transparent_layers"]) == 2
        assert torch.equal(bg, before)


@pytest.mark.parametrize("limit,layers,peels", [(2, 3, 3), (None, 6, 7)])
def test_device_loop_stops_past_its_limit(monkeypatch, limit, layers, peels):
    """The limit only keeps a faulty loop off the card forever: at limit 2
    the six-layer stack shades 3 layers (the pass that takes the count past
    the limit is the last); at the frame's own limit (its triangle count)
    the loop shades 6 and its last pass is the empty peel, as the eager
    loop's."""
    buffers, params = _stack()
    calls = []
    peel_layer, on_device = pipeline._peel_layer, pipeline._peel_on_device

    def counted(*args):
        calls.append(1)
        return peel_layer(*args)

    def limited(p, fb, last, n, limit=None, _given=limit):
        return on_device(p, fb, last, n, limit=limit if _given is None else _given)

    monkeypatch.setattr(pipeline, "_peel_layer", counted)
    monkeypatch.setattr(pipeline, "_peel_on_device", limited)
    _, aux = pipeline.render_frame(buffers, params, width=FW, height=FH)
    assert int(aux["transparent_layers"]) == layers and len(calls) == peels


class _NoHostTraffic(TorchDispatchMode):
    """Raises at an operation a CUDA graph capture refuses or that would wait
    for the card: a read of a tensor's value on the host, a tensor made from
    host values, a boolean mask's gather (its size is data)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("_local_scalar_dense", "lift_fresh", "lift_fresh_copy", "nonzero",
                    "masked_select", "unique"):
            raise AssertionError(f"{func}: host traffic inside the frame")
        if name == "index" and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                                   for i in args[1] if i is not None):
            raise AssertionError(f"{func} with a boolean mask inside the frame")
        return func(*args, **(kwargs or {}))


class _Rehearsal:
    """Stands in for a conditional node: the body runs once, as a capture
    records it, and the test is not read."""

    def __init__(self, kind, pred):
        pass

    def __enter__(self):
        return self

    def set(self, pred):
        pass

    def __exit__(self, *exc):
        return False


def _outside_mode(fn):
    def call(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return call


# the plain versions stand in for the kernels on the CPU (they read counts
# on the host; the kernels read them on the card)
PLAIN = ("rasterize_fused_plain", "rasterize_accum_plain", "rasterize_peel_fused_plain",
         "rasterize_plain", "rasterize_peel_plain")


@pytest.mark.parametrize("path", ["bench", "textured-glass", "deferred", "scaled"])
def test_captured_frame_reads_nothing_on_the_host(tmp_path, monkeypatch, path):
    """A rehearsal of the capture on the CPU: render_frame with each
    conditional body run once, does no host read and builds no tensor
    from host values between the kernels (on the card either fails the
    capture, and a host read waits for the card)."""
    glb = str(tmp_path / "demo4.glb")
    build_demo_glb(glb, grid=4, seed=0)
    s = scene.load_scene(glb)
    eng = Engine(RendererConfig(width=256, height=64, camera_position=(0.0, 6.0, 8.0),
                                dense_bin_max_chunks=1 if path == "deferred" else 8192,
                                render_scale=0.65 if path == "scaled" else 1.0),
                 device="cpu")
    eng.init(scene=s if path in ("bench", "scaled") else texture_the_glass(s))
    params = eng.frame_params()
    statics = dict(frame_statics(eng), bg_fb=eng._bg_fb_cached(params))
    want, _ = pipeline.render_frame(eng.flat.buffers, params, **statics)
    for name in PLAIN:
        monkeypatch.setattr(raster, name, _outside_mode(getattr(raster, name)))
    monkeypatch.setattr(conditional, "_capturing", lambda pred: True)
    monkeypatch.setattr(conditional, "_Body", _Rehearsal)
    with _NoHostTraffic():
        got, aux = pipeline.render_frame(eng.flat.buffers, params, **statics)
    if path in ("bench", "scaled"):   # no peel: the frame itself
        assert torch.equal(got, want)
    assert set(aux) >= {"transparent_layers"}


def _statics(**kw):
    base = dict(width=256, height=64, tile_h=32, tile_w=128, fp16=True,
                transp_textured=False, fused=True, trilinear=True, pot=False,
                bin_cap=64, tri_cap=1024)
    base.update(kw)
    return base


def test_graph_key_follows_the_statics_not_the_values(tmp_path):
    glb = str(tmp_path / "demo2.glb")
    build_demo_glb(glb, grid=2, seed=0)
    eng = Engine(RendererConfig(width=256, height=64), device="cpu")
    eng.init(scene_path=glb)
    b = eng.flat.buffers
    bg = pipeline.background_fb(eng.frame_params(), width=256, height=64)
    key = frame_graph.graph_key(b, bg, _statics())
    # the values a replay copies in: the same key
    assert frame_graph.graph_key(b._replace(draw_model=b.draw_model + 1.0), bg + 0.5,
                                 _statics()) == key
    eng.camera.yaw = np.float32(0.3)
    eng.flat.refresh_transforms(eng.scene)
    assert frame_graph.graph_key(eng.flat.buffers, bg, _statics()) == key
    # caps, extent, out extent, path and the other statics: another key
    for change in (dict(bin_cap=128), dict(tri_cap=2048), dict(width=128),
                   dict(out_width=512, out_height=128), dict(fused=False),
                   dict(transp_textured=True), dict(fp16=False), dict(trilinear=False),
                   dict(pot=True)):
        assert frame_graph.graph_key(b, bg, _statics(**change)) != key, change
    # the scene's buffers by identity
    other = b._replace(opaque_tri_vidx=b.opaque_tri_vidx.clone())
    assert frame_graph.graph_key(other, bg, _statics()) != key
    assert frame_graph.graph_key(b, bg[:, :32], _statics()) != key


def test_eager_nests_and_debug_mode_enters_it():
    assert pipeline.graphed("cuda") and not pipeline.graphed("cpu")
    with pipeline.eager():
        assert not pipeline.graphed("cuda")
        with pipeline.eager():
            assert not pipeline.graphed("cuda")
        assert not pipeline.graphed("cuda")
    assert pipeline.graphed("cuda")
    with profiling.debug_mode():
        assert not pipeline.graphed("cuda")
    assert pipeline.graphed("cuda")
    with pytest.raises(RuntimeError):
        with pipeline.eager():
            raise RuntimeError("inside")
    assert pipeline.graphed("cuda")


def test_cpu_engine_and_render_frames_draw_eagerly(tmp_path):
    """On the CPU nothing is captured: the Engine's graph cache stays empty
    and render_frames gives the frames of render_frame."""
    glb = str(tmp_path / "demo2.glb")
    build_demo_glb(glb, grid=2, seed=0)
    eng = Engine(RendererConfig(width=256, height=64), device="cpu")
    eng.init(scene_path=glb)
    frames = [eng.draw() for _ in range(2)]
    assert len(eng.frame_graphs) == 0 and np.array_equal(frames[0], frames[1])
    assert eng.render_fn() is pipeline.render_frame
    params = orbit_params(eng, 2)
    kw = frame_statics(eng)
    img, sums = pipeline.render_frames(eng.flat.buffers, params, **kw)
    bg = pipeline.background_fb(params[0], width=256, height=64)
    want = [pipeline.render_frame(eng.flat.buffers, p, bg_fb=bg, **kw)[0] for p in params]
    assert torch.equal(img, want[-1])
    assert sums.tolist() == [int((w[::191, ::127] & 0xFF).sum()) for w in want]


def test_conditional_nodes_need_a_frame_capture():
    """Outside a FrameGraph capture a conditional body has no pool to take
    its memory from, and the predicate must be one bool."""
    with pytest.raises(RuntimeError, match="FrameGraph"):
        with conditional._Body(conditional.IF, torch.ones((), dtype=torch.bool)):
            pass
    with pytest.raises(ValueError, match="bool"):
        conditional._Body(conditional.WHILE, torch.ones(2, dtype=torch.bool))
    # host tests: the same loop
    n = torch.zeros((), dtype=torch.int32)

    def body():
        n.add_(1)
        conditional.run_if(n == 2, lambda: n.add_(10))
        return n < 20

    conditional.run_while(torch.ones((), dtype=torch.bool), body)
    assert int(n) == 20


def test_engine_init_drops_the_frame_graphs(tmp_path, monkeypatch):
    """A graph reads the scene's buffers it was captured on, and its key
    knows them by id: loading a scene again drops every graph first."""
    glb = str(tmp_path / "demo2.glb")
    build_demo_glb(glb, grid=2, seed=0)
    eng = Engine(RendererConfig(width=256, height=64), device="cpu")
    cleared = []
    monkeypatch.setattr(eng.frame_graphs, "clear", lambda: cleared.append(eng.flat))
    eng.init(scene_path=glb)
    first = eng.flat
    eng.init(scene_path=glb)
    assert cleared == [None, first] and eng.flat is not first


def test_render_fn_follows_the_device_and_eager(tmp_path):
    """The Engine's frame function: render_frame on the CPU; the graph cache
    where frames are graphed, unless pipeline.eager() is entered."""
    glb = str(tmp_path / "demo2.glb")
    build_demo_glb(glb, grid=2, seed=0)
    eng = Engine(RendererConfig(width=256, height=64), device="cpu")
    eng.init(scene_path=glb)
    assert eng.render_fn() is pipeline.render_frame
    eng.device = torch.device("cuda")
    assert eng.render_fn() == eng.frame_graphs.frame
    with pipeline.eager():
        assert eng.render_fn() is pipeline.render_frame


def test_a_capture_hands_its_launch_counts_to_its_replays():
    """What a capture's wrappers counted is taken back (restore) and each
    replay adds it (add), or a conditional body counts it on the card
    (to_device)."""
    a, b = raster._Counter(), raster._Counter()
    try:
        a.launches = 5
        snap = raster._Counter.snapshot()
        a.launches += 2
        b.launches += 1
        moved = raster._Counter.restore(snap)
        assert moved == [(a, 2), (b, 1)] and (a.launches, b.launches) == (5, 0)
        raster._Counter.add(moved)
        raster._Counter.add(moved)
        assert (a.launches, b.launches) == (9, 2)
        raster._Counter.make_tallies("cpu")
        raster._Counter.to_device(moved, "cpu")
        assert (a.total(), b.total()) == (11, 3)
    finally:
        raster._Counter.registry.remove(a)
        raster._Counter.registry.remove(b)


def test_launch_tallies_count_on_the_device():
    c = raster._Counter()
    try:
        assert c.total() == 0
        c.launches += 2
        c.tally("cpu").add_(3)
        assert c.launches == 2 and c.total() == 5
        c.reset()
        assert c.total() == 0
    finally:
        raster._Counter.registry.remove(c)


if __name__ == "__main__":
    raise SystemExit(pytest.main([os.path.abspath(__file__), "-q"]))

"""The cells' scenes: a frozen copy of the program's demo generator
(tpu_renderer_torch/utils/demo.py, build_demo_glb), so that a change to the
program cannot change what the benchmark renders.

demo_scene() draws the scene from its seed as plain arrays (SceneSpec):
the textures, the sampler, the materials, the meshes and the nodes in the
order the renderer submits them. write_glb() serialises a SceneSpec to the
GLB file the program loads; the reference (reference.py) reads the same
SceneSpec directly. Both sides therefore start from the generator's own
arrays, and neither reads what the other made from them.

With the generator's defaults, demo_scene(64, 0) is the scene of the JAX
package's bench.py and of the program's bench twin. glass_texture="checker"
binds the checker texture, with the scene's sampler, to the BLEND glass
material in the GLB itself: the textured-glass scene.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from benchmark.glb_writer import GLBBuilder

# glTF sampler filters (glTF 2.0, sampler.magFilter / minFilter)
LINEAR = 9729
LINEAR_MIPMAP_NEAREST = 9985
LINEAR_MIPMAP_LINEAR = 9987


@dataclasses.dataclass
class Material:
    name: str
    base_color: Tuple[float, float, float, float]
    texture: Optional[int]        # index into SceneSpec.images, None: untextured
    transparent: bool             # alphaMode BLEND


@dataclasses.dataclass
class Mesh:
    positions: np.ndarray         # (V, 3) f32
    normals: np.ndarray           # (V, 3) f32
    uvs: np.ndarray               # (V, 2) f32
    indices: np.ndarray           # (3T,) u32
    material: int
    name: str


@dataclasses.dataclass
class Node:
    mesh: int
    translation: Tuple[float, float, float]
    rotation: Tuple[float, float, float, float]   # x, y, z, w
    scale: Tuple[float, float, float]
    name: str


@dataclasses.dataclass
class SceneSpec:
    images: List[np.ndarray]      # (h, w, 4) u8 each
    sampler: Tuple[int, int]      # (magFilter, minFilter), shared by every texture
    materials: List[Material]
    meshes: List[Mesh]
    nodes: List[Node]             # in submission order: the ground, then the cubes
    root_children: List[int]      # the nodes under the "cubes_root" parent node


def cube_primitive(size: float = 1.0):
    """24-vertex cube (per-face normals/uvs), 12 triangles."""
    s = size / 2.0
    # per face: (normal, 4 corners CCW seen from outside)
    faces = [
        ((0, 0, 1), [(-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)]),
        ((0, 0, -1), [(s, -s, -s), (-s, -s, -s), (-s, s, -s), (s, s, -s)]),
        ((1, 0, 0), [(s, -s, s), (s, -s, -s), (s, s, -s), (s, s, s)]),
        ((-1, 0, 0), [(-s, -s, -s), (-s, -s, s), (-s, s, s), (-s, s, -s)]),
        ((0, 1, 0), [(-s, s, s), (s, s, s), (s, s, -s), (-s, s, -s)]),
        ((0, -1, 0), [(-s, -s, -s), (s, -s, -s), (s, -s, s), (-s, -s, s)]),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for f, (n, corners) in enumerate(faces):
        base = 4 * f
        pos.extend(corners)
        nrm.extend([n] * 4)
        uv.extend([(0, 1), (1, 1), (1, 0), (0, 0)])
        idx.extend([base, base + 1, base + 2, base, base + 2, base + 3])
    return (np.asarray(pos, np.float32), np.asarray(nrm, np.float32),
            np.asarray(uv, np.float32), np.asarray(idx, np.uint32))


def checker_texture(size: int = 256, cells: int = 8,
                    c0=(200, 200, 200, 255), c1=(40, 40, 60, 255)) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size]
    mask = ((xx * cells // size) ^ (yy * cells // size)) & 1
    img = np.where(mask[..., None] == 1, np.array(c1, np.uint8), np.array(c0, np.uint8))
    return img.astype(np.uint8)


def gradient_texture(size: int = 256, c0=(255, 120, 40, 255), c1=(30, 60, 200, 255)) -> np.ndarray:
    t = np.linspace(0, 1, size, dtype=np.float32)[:, None, None]
    img = np.asarray(c0, np.float32) * (1 - t) + np.asarray(c1, np.float32) * t
    return np.broadcast_to(np.round(img).astype(np.uint8), (size, size, 4)).copy()


def noise_texture(size: int = 256, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = rng.uniform(80, 255, (size // 8, size // 8, 3))
    img = np.kron(base, np.ones((8, 8, 1)))
    out = np.empty((size, size, 4), np.uint8)
    out[..., :3] = img.astype(np.uint8)
    out[..., 3] = 255
    return out


def demo_scene(grid: int = 8, seed: int = 0, transparent_ratio: float = 0.08,
               spacing: float = 3.0, trilinear: bool = False,
               glass_texture: Optional[str] = None) -> SceneSpec:
    """Cube-grid scene: grid*grid textured cubes (12 tris each) over a ground
    plane, a few transparent, under a parent node. The draws of the random
    generator are build_demo_glb's, in its order, so the same seed gives
    the same scene.

    trilinear=True declares LINEAR_MIPMAP_LINEAR samplers (the reference
    loader's default mipmap mode); otherwise LINEAR_MIPMAP_NEAREST (one mip
    tap). glass_texture="checker": the glass material samples the checker
    texture."""
    if glass_texture not in (None, "checker"):
        raise ValueError(f"glass_texture must be None or 'checker', not {glass_texture!r}")
    rng = np.random.default_rng(seed)
    images = [checker_texture(), gradient_texture(), noise_texture()]
    sampler = (LINEAR, LINEAR_MIPMAP_LINEAR if trilinear else LINEAR_MIPMAP_NEAREST)
    materials = [
        Material("checker", (1, 1, 1, 1), 0, False),
        Material("grad", (1, 1, 1, 1), 1, False),
        Material("noise", (1, 1, 1, 1), 2, False),
        Material("plain_orange", (0.9, 0.6, 0.3, 1), None, False),
        Material("plain_cyan", (0.4, 0.8, 0.9, 1), None, False),
        Material("glass", (0.2, 0.4, 0.9, 0.4), 0 if glass_texture else None, True),
    ]
    glass = len(materials) - 1

    pos, nrm, uv, idx = cube_primitive(1.0)
    # one mesh per material: each cube instance is a node referencing a
    # shared mesh; then the glass cube, then the ground plane
    meshes = [Mesh(pos, nrm, uv, idx, m, f"cube{m}") for m in range(5)]
    meshes.append(Mesh(pos, nrm, uv, idx, glass, "glass_cube"))
    ext = grid * spacing * 0.6
    gp = np.array([[-ext, -1, -ext], [ext, -1, -ext], [ext, -1, ext], [-ext, -1, ext]],
                  np.float32)
    gn = np.tile(np.array([0, 1, 0], np.float32), (4, 1))
    guv = np.array([[0, 0], [8, 0], [8, 8], [0, 8]], np.float32)
    gidx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    meshes.append(Mesh(gp, gn, guv, gidx, 0, "ground"))
    ground_mesh = len(meshes) - 1

    nodes = [Node(ground_mesh, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0), (1.0, 1.0, 1.0),
                  "ground")]
    half = (grid - 1) / 2.0
    for gx in range(grid):
        for gz in range(grid):
            x = (gx - half) * spacing
            zpos = (gz - half) * spacing
            y = float(rng.uniform(-0.5, 2.0))
            s = float(rng.uniform(0.6, 1.6))
            ang = float(rng.uniform(0, np.pi))
            q = (0.0, float(np.sin(ang / 2)), 0.0, float(np.cos(ang / 2)))  # x,y,z,w
            if rng.uniform() < transparent_ratio:
                mesh = glass
            else:
                mesh = int(rng.integers(0, 5))
            nodes.append(Node(mesh, (x, y, zpos), q, (s, s, s), f"cube_{gx}_{gz}"))
    return SceneSpec(images=images, sampler=sampler, materials=materials, meshes=meshes,
                     nodes=nodes, root_children=list(range(1, len(nodes))))


def write_glb(spec: SceneSpec, path: str) -> str:
    """Serialise the scene as build_demo_glb writes it: the same images,
    sampler, textures, materials, meshes and node hierarchy, in the same
    order (the ground a top-level node, the cubes children of one root)."""
    b = GLBBuilder()
    img_ids = [b.add_image(img) for img in spec.images]
    smp = b.add_sampler(mag=spec.sampler[0], min_=spec.sampler[1])
    tex_ids = [b.add_texture(i, smp) for i in img_ids]
    for m in spec.materials:
        b.add_material(m.base_color, texture=None if m.texture is None else tex_ids[m.texture],
                       alpha_mode="BLEND" if m.transparent else "OPAQUE", name=m.name)
    for m in spec.meshes:
        b.add_mesh([dict(positions=m.positions, normals=m.normals, uvs=m.uvs,
                         indices=m.indices, material=m.material)], name=m.name)
    children = set(spec.root_children)
    ids = {}
    for i, n in enumerate(spec.nodes):
        if i in children:
            continue
        ids[i] = b.add_node(mesh=n.mesh, name=n.name)
    kids = [b.add_node(mesh=spec.nodes[i].mesh, translation=spec.nodes[i].translation,
                       rotation=spec.nodes[i].rotation, scale=spec.nodes[i].scale,
                       name=spec.nodes[i].name, top_level=False)
            for i in spec.root_children]
    b.add_node(children=kids, name="cubes_root")
    b.save(path)
    return path

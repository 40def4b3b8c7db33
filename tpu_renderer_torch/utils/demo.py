"""Procedural demo / benchmark scenes.

The reference renders assets/structure.glb (vk_engine.cpp:196-200), which is
not redistributable here; these generators build comparable glTF scenes
(textured multi-material meshes in a node hierarchy, opaque + additive
transparent passes) through the same GLB writer + loader path.
"""

from __future__ import annotations

import numpy as np

from tpu_renderer_torch.utils.glb_writer import GLBBuilder


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


def build_demo_glb(path: str, grid: int = 8, seed: int = 0,
                   transparent_ratio: float = 0.08, spacing: float = 3.0,
                   trilinear: bool = False) -> str:
    """Cube-grid scene: grid*grid textured cubes (12 tris each) over a ground
    plane, a few transparent, arranged under a parent node hierarchy.

    trilinear=True declares LINEAR_MIPMAP_LINEAR samplers — the reference
    loader's DEFAULT mipmap mode (extract_mipmap_mode's default branch,
    vk_loader.cpp:43-54) — so the renderer pays both mip taps per pixel
    (the bench's trilinear variant).
    """
    rng = np.random.default_rng(seed)
    b = GLBBuilder()

    img_checker = b.add_image(checker_texture())
    img_grad = b.add_image(gradient_texture())
    img_noise = b.add_image(noise_texture())
    # default: linear, mip-nearest (one tap); trilinear: the reference default
    smp = b.add_sampler(mag=9729, min_=9987 if trilinear else 9985)
    tex_checker = b.add_texture(img_checker, smp)
    tex_grad = b.add_texture(img_grad, smp)
    tex_noise = b.add_texture(img_noise, smp)

    mats = [
        b.add_material((1, 1, 1, 1), texture=tex_checker, name="checker"),
        b.add_material((1, 1, 1, 1), texture=tex_grad, name="grad"),
        b.add_material((1, 1, 1, 1), texture=tex_noise, name="noise"),
        b.add_material((0.9, 0.6, 0.3, 1), name="plain_orange"),
        b.add_material((0.4, 0.8, 0.9, 1), name="plain_cyan"),
    ]
    mat_glass = b.add_material((0.2, 0.4, 0.9, 0.4), alpha_mode="BLEND", name="glass")

    pos, nrm, uv, idx = cube_primitive(1.0)

    # one mesh per material (mirrors multi-surface meshes: each cube instance
    # is a node referencing a shared mesh)
    cube_meshes = [
        b.add_mesh([dict(positions=pos, normals=nrm, uvs=uv, indices=idx, material=m)],
                   name=f"cube{mi}")
        for mi, m in enumerate(mats)
    ]
    glass_mesh = b.add_mesh(
        [dict(positions=pos, normals=nrm, uvs=uv, indices=idx, material=mat_glass)],
        name="glass_cube")

    # ground plane (two triangles, checker)
    ext = grid * spacing * 0.6
    gp = np.array([[-ext, -1, -ext], [ext, -1, -ext], [ext, -1, ext], [-ext, -1, ext]], np.float32)
    gn = np.tile(np.array([0, 1, 0], np.float32), (4, 1))
    guv = np.array([[0, 0], [8, 0], [8, 8], [0, 8]], np.float32)
    gidx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    ground = b.add_mesh([dict(positions=gp, normals=gn, uvs=guv, indices=gidx,
                              material=mats[0])], name="ground")
    b.add_node(mesh=ground, name="ground")

    children = []
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
                mesh = glass_mesh
            else:
                mesh = cube_meshes[int(rng.integers(0, len(cube_meshes)))]
            children.append(
                b.add_node(mesh=mesh, translation=(x, y, zpos), rotation=q,
                           scale=(s, s, s), name=f"cube_{gx}_{gz}", top_level=False))
    b.add_node(children=children, name="cubes_root")

    b.save(path)
    return path


def build_structure_glb(path: str, seed: int = 0) -> str:
    """An architectural scene in the spirit of the reference's structure.glb
    (vk_engine.cpp:196-200): floor slabs, colonnades, walls, stairs and a
    tower, with shared meshes instanced by nodes.
    """
    rng = np.random.default_rng(seed)
    b = GLBBuilder()
    img_stone = b.add_image(noise_texture(128, seed=9))
    img_tile = b.add_image(checker_texture(128, 16, (180, 170, 150, 255), (90, 80, 70, 255)))
    img_roof = b.add_image(gradient_texture(128, (160, 60, 40, 255), (90, 30, 20, 255)))
    smp = b.add_sampler(mag=9729, min_=9985)
    m_stone = b.add_material((1, 1, 1, 1), texture=b.add_texture(img_stone, smp), name="stone")
    m_tile = b.add_material((1, 1, 1, 1), texture=b.add_texture(img_tile, smp), name="tile")
    m_roof = b.add_material((1, 1, 1, 1), texture=b.add_texture(img_roof, smp), name="roof")
    m_glass = b.add_material((0.3, 0.5, 0.9, 0.4), alpha_mode="BLEND", name="glass")

    pos, nrm, uv, idx = cube_primitive(1.0)

    def mesh(mat, name):
        return b.add_mesh([dict(positions=pos, normals=nrm, uvs=uv,
                                indices=idx, material=mat)], name=name)

    cube_stone = mesh(m_stone, "stone_cube")
    cube_tile = mesh(m_tile, "tile_cube")
    cube_roof = mesh(m_roof, "roof_cube")
    cube_glass = mesh(m_glass, "glass_cube")

    def block(mesh_id, pos3, scale3, name):
        return b.add_node(mesh=mesh_id, translation=pos3, scale=scale3,
                          name=name, top_level=True)

    # plaza floor
    block(cube_tile, (0, -0.5, 0), (60, 1, 60), "plaza")
    # colonnade: two rows of pillars with beams
    for i in range(8):
        x = -14 + 4 * i
        for zrow in (-6, 6):
            block(cube_stone, (x, 3, zrow), (1, 6, 1), f"pillar_{i}_{zrow}")
        block(cube_stone, (x, 6.5, 0), (1.2, 1, 13), f"beam_{i}")
    # walls with window gaps (glass)
    for i in range(10):
        x = -18 + 4 * i
        block(cube_stone, (x, 2, -14), (4, 4, 1), f"wall_{i}")
        block(cube_glass, (x, 5.5, -14), (3, 2.6, 0.4), f"win_{i}")
    # stairs
    for i in range(6):
        block(cube_tile, (20 + i, 0.25 + 0.5 * i, 0), (1, 0.5 + i, 8), f"stair_{i}")
    # tower
    block(cube_stone, (26, 6, 0), (4, 12, 4), "tower")
    block(cube_roof, (26, 13.5, 0), (5, 3, 5), "tower_roof")
    # scattered crates
    for k in range(24):
        x, z = rng.uniform(-16, 16, 2)
        s_ = float(rng.uniform(0.5, 1.4))
        block(cube_stone if k % 3 else cube_roof, (float(x), s_ / 2, float(z)),
              (s_, s_, s_), f"crate_{k}")
    b.save(path)
    return path

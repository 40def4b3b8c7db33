"""The five BASELINE.json milestone configs, expressed as scenes for the
general pipeline.

1. colored_triangle — hardcoded NDC triangle, per-vertex RGB
   (shaders/colored_triangle.vert:6-25)
2. gradient/sky backgrounds (kernels/background; engine background_effect)
3. colored_triangle_mesh — indexed quad, per-vertex color, depth test
   (shaders/colored_triangle_mesh.vert, init_mesh_pipeline rectangle
   vk_engine.h:144)
4. textured mesh (tex_image.frag pure texture sample)
5. full glTF scene graph (utils/demo.build_demo_glb or any .glb)

The unlit shaders (1, 3, 4) are reproduced through the lit mesh pipeline
with a neutral configuration: normals (0,0,1), sun direction (0,0,1) with
power 1 and ambient 0 makes mesh.frag's output equal inColor * texture —
exactly colored_triangle.frag / tex_image.frag.
"""

from __future__ import annotations

import numpy as np

from tpu_renderer_torch import scene as scene_mod
from tpu_renderer_torch.scene import (
    Bounds,
    GeoSurface,
    LoadedScene,
    MeshAsset,
    MeshNode,
    SceneMaterial,
)

UNLIT_CONFIG_OVERRIDES = dict(
    ambient_color=(0.0, 0.0, 0.0, 0.0),
    sunlight_direction=(0.0, 0.0, 1.0, 1.0),
    sunlight_color=(1.0, 1.0, 1.0, 1.0),
)


def _simple_scene(positions, normals, colors, uvs, indices,
                  material: SceneMaterial) -> LoadedScene:
    scene = LoadedScene()
    scene_mod.default_materials_and_textures(scene)
    scene.materials.append(material)
    mat_idx = len(scene.materials) - 1
    scene.positions = np.asarray(positions, np.float32)
    scene.normals = np.asarray(normals, np.float32)
    scene.colors = np.asarray(colors, np.float32)
    scene.uvs = np.asarray(uvs, np.float32)
    scene.indices = np.asarray(indices, np.uint32)
    n_idx = len(indices)
    mesh = MeshAsset(
        name="milestone",
        surfaces=[GeoSurface(start_index=0, count=n_idx, material=mat_idx,
                             bounds=Bounds(origin=np.zeros(3, np.float32),
                                           extents=np.full(3, 10.0, np.float32)))],
        vertex_offset=0,
        index_offset=0,
    )
    scene.meshes.append(mesh)
    node = MeshNode(0, name="milestone")
    scene.nodes.append(node)
    scene.top_nodes.append(node)
    node.refresh_transform(np.eye(4, dtype=np.float32))
    return scene


def _unlit_material(tex: int = scene_mod.TEX_WHITE,
                    flags: int = scene_mod.DEFAULT_SAMPLER_LINEAR_FLAGS) -> SceneMaterial:
    return SceneMaterial(
        name="unlit",
        color_factors=np.ones(4, np.float32),
        metal_rough_factors=np.array([1, 0.5, 0, 0], np.float32),
        transparent=False,
        tex=tex,
        filter_flags=flags,
    )


def colored_triangle_scene() -> LoadedScene:
    """Milestone 1: the hardcoded NDC triangle
    (shaders/colored_triangle.vert:6-25). Drawn with an identity view/proj
    (the dormant triangle pipeline has no matrices)."""
    positions = [(1, 1, 0), (-1, 1, 0), (0, -1, 0)]
    colors = [(1, 0, 0, 1), (0, 1, 0, 1), (0, 0, 1, 1)]
    normals = [(0, 0, 1)] * 3
    uvs = [(0, 0)] * 3
    return _simple_scene(positions, normals, colors, uvs, [0, 1, 2],
                         _unlit_material())


def colored_quad_scene(z0: float = 0.5, z1: float = 0.5) -> LoadedScene:
    """Milestone 3: indexed rectangle with per-vertex color + depth test —
    the rectangle fed to the dormant mesh pipeline (vk_engine.cpp:285-296
    commented test-mesh path / init_mesh_pipeline)."""
    positions = [(-0.5, -0.5, z0), (0.5, -0.5, z0), (0.5, 0.5, z1), (-0.5, 0.5, z1)]
    colors = [(1, 0, 0, 1), (0, 1, 0, 1), (0, 0, 1, 1), (1, 1, 0, 1)]
    normals = [(0, 0, 1)] * 4
    uvs = [(0, 0), (1, 0), (1, 1), (0, 1)]
    return _simple_scene(positions, normals, colors, uvs, [0, 1, 2, 0, 2, 3],
                         _unlit_material())


def textured_quad_scene(image: np.ndarray, nearest: bool = False,
                        mipmapped: bool = False) -> LoadedScene:
    """Milestone 4: tex_image.frag — pure texture sample over a quad."""
    scene = colored_quad_scene()
    scene.textures.append(image)
    scene.texture_mipmapped.append(mipmapped)
    tex_idx = len(scene.textures) - 1
    flags = 0 if nearest else scene_mod.DEFAULT_SAMPLER_LINEAR_FLAGS
    scene.materials[-1] = _unlit_material(tex=tex_idx, flags=flags)
    # white vertex colors so output == texture exactly
    scene.colors = np.ones_like(scene.colors)
    return scene

"""Scene graph + draw-list flattening — the host-side layer the reference
implements as Node/MeshNode/LoadedGLTF + DrawContext
(vk_types.h:144-170, vk_engine.h:24-43, vk_engine.cpp:1716-1736).

Semantics preserved exactly, including the two transform quirks:

* ``refresh_transform`` passes **parent_matrix** (not its own world
  transform) to children (vk_types.h:157-163);
* ``MeshNode.draw`` uses ``world_transform @ top_matrix`` in that order
  (vk_engine.cpp:1717).

The scene graph is a copy of the JAX package's (tpu_renderer/scene.py).
Instead of recording one vkCmdDrawIndexed per RenderObject, the flattened
draw list becomes packed triangle tensors (SceneBuffers) on the device
that flatten_scene is given. Frustum culling runs on the device
(kernels/vertex.draw_visibility), so the flatten is static per scene and
the per-frame host work is only matrix collection.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from tpu_renderer_torch import gltf as gltf_mod
from tpu_renderer_torch import resources
from tpu_renderer_torch.kernels import raster, vertex
from tpu_renderer_torch.pipeline import SceneBuffers
from tpu_renderer_torch.utils.profiling import setup_step

# Default texture slots (init_default_data, vk_engine.cpp:226-306)
TEX_WHITE = 0
TEX_GREY = 1
TEX_BLACK = 2
TEX_ERROR_CHECKERBOARD = 3
NUM_DEFAULT_TEXTURES = 4

DEFAULT_SAMPLER_LINEAR_FLAGS = (
    resources.FILTER_MAG_LINEAR | resources.FILTER_MIN_LINEAR
)  # _default_sampler_linear: LINEAR mag/min, mipmap mode defaults to NEAREST
#    with maxLod=0 (vk_engine.cpp:253-262) => no mip bit.


@dataclasses.dataclass
class SceneMaterial:
    """MaterialInstance analog (vk_types.h:127-142)."""

    name: str
    color_factors: np.ndarray
    metal_rough_factors: np.ndarray
    transparent: bool
    tex: int           # atlas texture id for the colorTex binding
    filter_flags: int


@dataclasses.dataclass
class Bounds:
    origin: np.ndarray
    extents: np.ndarray

    @property
    def sphere_radius(self) -> float:
        return float(np.linalg.norm(self.extents))


@dataclasses.dataclass
class GeoSurface:
    start_index: int
    count: int
    material: int  # index into LoadedScene.materials
    bounds: Bounds
    # KHR_materials_variants: variant index -> LoadedScene material index
    # (None = no mappings). select_variant() consults this.
    variant_materials: Optional[Dict[int, int]] = None


@dataclasses.dataclass
class MeshAsset:
    name: str
    surfaces: List[GeoSurface]
    vertex_offset: int  # base into the scene-global vertex pool
    index_offset: int   # base into the scene-global index pool


class Node:
    """vk_types.h:144-170."""

    def __init__(self, name: str = ""):
        self.name = name
        self.parent: Optional["Node"] = None
        self.children: List["Node"] = []
        self.local_transform = np.eye(4, dtype=np.float32)
        self.world_transform = np.eye(4, dtype=np.float32)

    def refresh_transform(self, parent_matrix: np.ndarray) -> None:
        self.world_transform = (parent_matrix @ self.local_transform).astype(np.float32)
        for c in self.children:
            # reference quirk: children receive parent_matrix, NOT
            # world_transform (vk_types.h:161)
            c.refresh_transform(parent_matrix)

    def draw(self, top_matrix: np.ndarray, ctx: "DrawContext") -> None:
        for c in self.children:
            c.draw(top_matrix, ctx)


class MeshNode(Node):
    def __init__(self, mesh_index: int, name: str = ""):
        super().__init__(name)
        self.mesh_index = mesh_index

    def draw(self, top_matrix: np.ndarray, ctx: "DrawContext") -> None:
        # vk_engine.cpp:1717 — node_matrix = world_transform * top_matrix
        node_matrix = (self.world_transform @ top_matrix).astype(np.float32)
        ctx.emit(self.mesh_index, node_matrix, node=self)
        super().draw(top_matrix, ctx)


@dataclasses.dataclass
class RenderObject:
    """vk_engine.h:29-38 analog, with indices instead of pointers."""

    mesh_index: int
    surface_index: int
    material: int
    transform: np.ndarray
    transparent: bool
    node: Optional["Node"] = None


class DrawContext:
    """vk_engine.h:40-43 — flat opaque/transparent surface lists."""

    def __init__(self, scene: "LoadedScene"):
        self.scene = scene
        self.opaque_surfaces: List[RenderObject] = []
        self.transparent_surfaces: List[RenderObject] = []

    def emit(self, mesh_index: int, node_matrix: np.ndarray,
             node: Optional["Node"] = None) -> None:
        mesh = self.scene.meshes[mesh_index]
        for si, s in enumerate(mesh.surfaces):
            obj = RenderObject(
                mesh_index=mesh_index,
                surface_index=si,
                material=s.material,
                transform=node_matrix,
                transparent=self.scene.materials[s.material].transparent,
                node=node,
            )
            if obj.transparent:
                self.transparent_surfaces.append(obj)
            else:
                self.opaque_surfaces.append(obj)


class LoadedScene:
    """LoadedGLTF analog (vk_loader.h:33-57): owns meshes, nodes, materials,
    textures, and the scene-global vertex/index pools."""

    def __init__(self) -> None:
        self.meshes: List[MeshAsset] = []
        self.nodes: List[Node] = []
        self.top_nodes: List[Node] = []
        self.materials: List[SceneMaterial] = []
        self.textures: List[np.ndarray] = []      # RGBA8 images, atlas order
        self.texture_mipmapped: List[bool] = []
        self.positions = np.zeros((0, 3), np.float32)
        self.normals = np.zeros((0, 3), np.float32)
        self.colors = np.zeros((0, 4), np.float32)
        self.uvs = np.zeros((0, 2), np.float32)
        self.indices = np.zeros((0,), np.uint32)
        self.mesh_by_name: Dict[str, int] = {}
        self.node_by_name: Dict[str, Node] = {}
        self.variants: List[str] = []  # KHR_materials_variants names

    def draw(self, top_matrix: np.ndarray) -> DrawContext:
        """LoadedGLTF::Draw (vk_loader.cpp:56-60)."""
        ctx = DrawContext(self)
        for n in self.top_nodes:
            n.draw(top_matrix, ctx)
        return ctx


def default_materials_and_textures(scene: LoadedScene) -> None:
    """init_default_data equivalents (vk_engine.cpp:226-306)."""
    scene.textures = [
        resources.make_white(),
        resources.make_grey(),
        resources.make_black(),
        resources.make_error_checkerboard(),
    ]
    scene.texture_mipmapped = [False, False, False, False]
    scene.materials = [
        SceneMaterial(
            name="default",
            color_factors=np.ones(4, np.float32),
            metal_rough_factors=np.array([1, 0.5, 0, 0], np.float32),
            transparent=False,
            tex=TEX_WHITE,
            filter_flags=DEFAULT_SAMPLER_LINEAR_FLAGS,
        )
    ]


def scene_from_parsed(parsed: gltf_mod.ParsedGLTF) -> LoadedScene:
    """load_gltf_meshes (vk_loader.cpp:162-437): build the runtime scene."""
    scene = LoadedScene()
    default_materials_and_textures(scene)
    scene.variants = list(parsed.variants)

    # images -> texture slots (failures -> error checkerboard,
    # vk_loader.cpp:224-229)
    image_tex: List[int] = []
    for img in parsed.images:
        if img is None:
            image_tex.append(TEX_ERROR_CHECKERBOARD)
        else:
            image_tex.append(len(scene.textures))
            scene.textures.append(img)
            scene.texture_mipmapped.append(True)  # MIPMAP_ENABLED, vk_loader.cpp:24

    # materials (vk_loader.cpp:241-284); scene materials start at index 1
    # (index 0 is the engine default material)
    mat_base = len(scene.materials)
    for m in parsed.materials:
        tex = TEX_WHITE
        flags = DEFAULT_SAMPLER_LINEAR_FLAGS
        if m.base_color_image is not None and m.base_color_image < len(image_tex):
            tex = image_tex[m.base_color_image]
            if m.base_color_sampler is not None and m.base_color_sampler < len(parsed.samplers):
                flags = parsed.samplers[m.base_color_sampler].filter_flags
            else:
                flags = gltf_mod.DEFAULT_SAMPLER_FLAGS
        scene.materials.append(
            SceneMaterial(
                name=m.name,
                color_factors=m.color_factors,
                metal_rough_factors=m.metal_rough_factors,
                transparent=m.transparent,
                tex=tex,
                filter_flags=flags,
            )
        )

    # meshes -> global vertex/index pools (upload_mesh batching)
    pos_all, nrm_all, col_all, uv_all, idx_all = [], [], [], [], []
    v_off = 0
    i_off = 0
    for pm in parsed.meshes:
        surfaces = []
        for s in pm.surfaces:
            if s.material is not None:
                mat = mat_base + s.material
            elif len(parsed.materials) > 0:
                mat = mat_base  # vk_loader.cpp:362 — falls back to materials[0]
            else:
                mat = 0  # no scene materials at all: engine default
            vmap = None
            if s.variant_materials:
                vmap = {v: mat_base + m
                        for v, m in s.variant_materials.items()}
            surfaces.append(
                GeoSurface(
                    start_index=s.start_index,
                    count=s.count,
                    material=mat,
                    bounds=Bounds(origin=s.bounds_origin, extents=s.bounds_extents),
                    variant_materials=vmap,
                )
            )
        mesh = MeshAsset(
            name=pm.name,
            surfaces=surfaces,
            vertex_offset=v_off,
            index_offset=i_off,
        )
        scene.mesh_by_name[pm.name] = len(scene.meshes)
        scene.meshes.append(mesh)
        pos_all.append(pm.positions)
        nrm_all.append(pm.normals)
        col_all.append(pm.colors)
        uv_all.append(pm.uvs)
        idx_all.append(pm.indices)
        v_off += pm.positions.shape[0]
        i_off += pm.indices.shape[0]

    if pos_all:
        scene.positions = np.concatenate(pos_all).astype(np.float32)
        scene.normals = np.concatenate(nrm_all).astype(np.float32)
        scene.colors = np.concatenate(col_all).astype(np.float32)
        scene.uvs = np.concatenate(uv_all).astype(np.float32)
        scene.indices = np.concatenate(idx_all).astype(np.uint32)

    # nodes (vk_loader.cpp:383-435)
    for pn in parsed.nodes:
        node: Node
        if pn.mesh is not None:
            node = MeshNode(pn.mesh, name=pn.name)
        else:
            node = Node(name=pn.name)
        node.local_transform = pn.local_transform
        scene.nodes.append(node)
        scene.node_by_name[pn.name] = node
    for i, pn in enumerate(parsed.nodes):
        for c in pn.children:
            scene.nodes[i].children.append(scene.nodes[c])
            scene.nodes[c].parent = scene.nodes[i]
    for i in parsed.top_nodes:
        scene.top_nodes.append(scene.nodes[i])
        scene.nodes[i].refresh_transform(np.eye(4, dtype=np.float32))

    return scene


def load_scene(path: str, variant=None) -> LoadedScene:
    scene = scene_from_parsed(gltf_mod.load_gltf(path))
    if variant is not None:
        select_variant(scene, variant)
    return scene


def select_variant(scene: LoadedScene, variant) -> int:
    """Apply a KHR_materials_variants selection (by name or index).

    Switches each surface with a mapping for the variant to its mapped
    material; surfaces without a mapping keep their base material (per the
    extension spec). Returns the number of surfaces switched. Re-flatten
    (flatten_scene) afterwards to rebuild the draw list. The reference
    parses the extension but never selects (vk_loader.cpp:169-191) — its
    render equals our default (no-selection) render.
    """
    if isinstance(variant, str):
        if variant not in scene.variants:
            raise KeyError(
                f"unknown variant {variant!r}; available: {scene.variants}")
        vidx = scene.variants.index(variant)
    else:
        vidx = int(variant)
    switched = 0
    for mesh in scene.meshes:
        for surf in mesh.surfaces:
            if surf.variant_materials and vidx in surf.variant_materials:
                new_mat = surf.variant_materials[vidx]
                if new_mat != surf.material:
                    surf.material = new_mat
                    switched += 1
    return switched


@dataclasses.dataclass
class FlattenedDrawList:
    """Static draw-list structure + per-frame matrix sources."""

    objects: List[RenderObject]          # opaque (sorted) then transparent
    n_opaque: int
    buffers: SceneBuffers
    # (node, surface) behind each draw slot, for per-frame matrix refresh
    draw_sources: Optional[List] = None

    def refresh_transforms(self, scene: "LoadedScene",
                           top_matrix: Optional[np.ndarray] = None) -> None:
        """Per-frame transform update — the cheap analog of the reference's
        every-frame scene re-flatten (update_scene vk_engine.cpp:1479-1512).
        Node local_transform edits (+ refresh_transform on roots) are picked
        up here; the draw-list STRUCTURE (which surfaces exist, sort order)
        stays fixed, exactly like a scene whose graph topology is static.
        """
        if top_matrix is None:
            top_matrix = np.eye(4, dtype=np.float32)
        mats = np.stack([
            (node.world_transform @ top_matrix).astype(np.float32)
            for node, _si in self.draw_sources
        ]) if self.draw_sources else np.zeros((0, 4, 4), np.float32)
        self.buffers = self.buffers._replace(draw_model=torch.as_tensor(
            mats, device=self.buffers.draw_model.device))


def _pad_tris(vidx, draw, n):
    pad = raster.pad_tris(n) - n
    valid = np.ones(n, bool)
    if pad:
        vidx = np.concatenate([vidx, np.zeros((pad, 3), np.int32)])
        draw = np.concatenate([draw, np.full(pad, -1, np.int32)])
        valid = np.concatenate([valid, np.zeros(pad, bool)])
    return vidx, draw, valid


def flatten_scene(scene: LoadedScene, top_matrix: Optional[np.ndarray] = None,
                  mipmapped: bool = True, device="cuda") -> FlattenedDrawList:
    """update_scene + draw_geometry's host half (vk_engine.cpp:1357-1378):
    emit RenderObjects, sort opaque by (material, mesh) — the analog of the
    reference's (material ptr, index buffer) sort — and pack triangle
    tensors on `device` (the CUDA card unless the caller names another).
    """
    # the set-up record (utils/profiling.setup_step): the host half, then
    # the uploads
    with setup_step("flatten"):
        if top_matrix is None:
            top_matrix = np.eye(4, dtype=np.float32)
        ctx = scene.draw(top_matrix)

        opaque = sorted(
            range(len(ctx.opaque_surfaces)),
            key=lambda i: (
                ctx.opaque_surfaces[i].material,
                ctx.opaque_surfaces[i].mesh_index,
                i,
            ),
        )
        objects = [ctx.opaque_surfaces[i] for i in opaque] + ctx.transparent_surfaces
        n_opaque = len(opaque)

        draw_model = (np.stack([o.transform for o in objects]) if objects
                      else np.zeros((0, 4, 4), np.float32))
        draw_mat = (np.array([o.material for o in objects], np.int32) if objects
                    else np.zeros(0, np.int32))
        draw_bo = np.zeros((len(objects), 3), np.float32)
        draw_be = np.zeros((len(objects), 3), np.float32)

        op_vidx, op_draw = [], []
        tr_vidx, tr_draw = [], []
        for d, o in enumerate(objects):
            mesh = scene.meshes[o.mesh_index]
            s = mesh.surfaces[o.surface_index]
            draw_bo[d] = s.bounds.origin
            draw_be[d] = s.bounds.extents
            idx = scene.indices[mesh.index_offset + s.start_index:
                                mesh.index_offset + s.start_index + s.count]
            tris = (idx.astype(np.int64) + mesh.vertex_offset).reshape(-1, 3).astype(np.int32)
            dids = np.full(tris.shape[0], d, np.int32)
            if o.transparent:
                tr_vidx.append(tris)
                tr_draw.append(dids)
            else:
                op_vidx.append(tris)
                op_draw.append(dids)

        def cat(parts, shape):
            return np.concatenate(parts) if parts else np.zeros(shape, np.int32)

        ov = cat(op_vidx, (0, 3))
        od = cat(op_draw, (0,))
        tv = cat(tr_vidx, (0, 3))
        td = cat(tr_draw, (0,))
        ov, od, oval = _pad_tris(ov, od, ov.shape[0])
        tv, td, tval = _pad_tris(tv, td, tv.shape[0])

    with setup_step("upload"):
        atlas = resources.build_atlas(
            scene.textures,
            mipmapped=[m and mipmapped for m in scene.texture_mipmapped],
            device=device,
        )

        # per-material texture binding state (atlas placement + sampler), packed
        # as small f32 rows so the shade stage needs no per-pixel table lookups
        tex_meta_np = np.asarray(atlas.tex_meta)
        mat_meta = np.zeros((max(len(scene.materials), 1), 8), np.float32)
        for i, m in enumerate(scene.materials):
            bx, by, w0, h0, nlev, _ = tex_meta_np[m.tex]
            mat_meta[i, :6] = (bx, by, w0, h0, nlev, m.filter_flags)

        n_mat = len(scene.materials)
        mat_cf = (np.stack([m.color_factors for m in scene.materials])
                  .astype(np.float32) if n_mat else np.ones((1, 4), np.float32))
        # corner-expand the static geometry once (the one-time analog of the
        # loader's vertex interleave, vk_loader.cpp:286-358): the frame function
        # then needs no per-corner vertex/material gathers (see vertex.CornerData)
        opc = vertex.expand_corners(
            scene.positions, scene.normals, scene.colors, scene.uvs,
            ov, od, oval, draw_mat, mat_cf, mat_meta, device=device)
        trc = vertex.expand_corners(
            scene.positions, scene.normals, scene.colors, scene.uvs,
            tv, td, tval, draw_mat, mat_cf, mat_meta, device=device)
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        buffers = SceneBuffers(
            positions=t(scene.positions),
            normals=t(scene.normals),
            colors=t(scene.colors),
            uvs=t(scene.uvs),
            opaque_tri_vidx=t(ov),
            opaque_tri_draw=t(od),
            opaque_tri_valid=t(oval),
            transp_tri_vidx=t(tv),
            transp_tri_draw=t(td),
            transp_tri_valid=t(tval),
            draw_model=t(draw_model.astype(np.float32)),
            draw_mat=t(draw_mat),
            draw_opaque_mask=t(
                np.array([not o.transparent for o in objects], bool)),
            draw_bounds_origin=t(draw_bo),
            draw_bounds_extents=t(draw_be),
            mat_color_factors=t(mat_cf),
            mat_meta=t(mat_meta),
            atlas=atlas,
            opaque_corners=opc,
            transp_corners=trc,
        )
    return FlattenedDrawList(
        objects=objects, n_opaque=n_opaque, buffers=buffers,
        draw_sources=[(o.node, o.surface_index) for o in objects])

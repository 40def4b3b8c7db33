"""Pure-Python glTF 2.0 / GLB parser — replaces fastgltf + stb_image
(vk_loader.cpp:162-437, load_image vk_loader.cpp:81-160).

Produces plain numpy arrays; no third-party glTF dependency. Image decode
uses PIL (PNG/JPEG), with failures mapping to the error-checkerboard
placeholder exactly like the reference (vk_loader.cpp:224-229).

Parsing semantics mirror the reference loader:

* indices offset by the running vertex count per mesh (vk_loader.cpp:306-315)
* vertex defaults: normal (1,0,0), color (1,1,1,1), uv (0,0)
  (vk_loader.cpp:320-328)
* per-surface bounds computed over ALL vertices accumulated so far in the
  mesh — a reference quirk kept for parity (vk_loader.cpp:366-375)
* missing primitive material falls back to material 0 (vk_loader.cpp:360-364)
* node transforms: matrix column-major, or T*R*S (vk_loader.cpp:397-412)
* alphaMode BLEND -> transparent pass, everything else opaque
  (vk_loader.cpp:259-264)
* sampler filters: NEAREST family -> nearest, LINEAR/default -> linear
  (vk_loader.cpp:26-54); missing mag/min filter defaults to Nearest
  (value_or(Filter::Nearest), vk_loader.cpp:204-206)
* non-indexed primitives get generated indices (fastgltf
  Options::GenerateMeshIndices, vk_loader.cpp:176-178)
* sparse accessors substitute over the (possibly absent) base view, like
  fastgltf's iterateAccessor (vk_loader.cpp:306-308)
* TRIANGLE_STRIP / TRIANGLE_FAN primitives are triangulated; point/line
  topologies are skipped with a warning (the reference only ever builds a
  TRIANGLE_LIST pipeline, vk_engine.cpp:1661)
* KHR_texture_transform is parsed (the reference enables the extension,
  vk_loader.cpp:169-171) and — beyond the reference, whose shader ignores
  it — baked into the primitive's uvs
* KHR_materials_variants is parsed (variant names + per-primitive material
  mappings — the reference enables it in fastgltf, vk_loader.cpp:169-191);
  the default render uses the primitive's base material like the reference,
  and scene.select_variant switches materials by variant name/index
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import logging
import os
import struct
from typing import Dict, List, Optional

import numpy as np

from tpu_renderer_torch.resources import (
    FILTER_MAG_LINEAR,
    FILTER_MIN_LINEAR,
    FILTER_MIP_LINEAR,
)

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_COMPONENT_SIZES = {k: np.dtype(v).itemsize for k, v in _COMPONENT_DTYPES.items()}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT2": 4, "MAT3": 9, "MAT4": 16}

# glTF sampler filter enums
_NEAREST = 9728
_LINEAR = 9729
_NEAREST_MIPMAP_NEAREST = 9984
_LINEAR_MIPMAP_NEAREST = 9985
_NEAREST_MIPMAP_LINEAR = 9986
_LINEAR_MIPMAP_LINEAR = 9987


@dataclasses.dataclass
class ParsedSampler:
    filter_flags: int


@dataclasses.dataclass
class ParsedMaterial:
    name: str
    color_factors: np.ndarray        # (4,) f32
    metal_rough_factors: np.ndarray  # (4,) f32 (x=metallic, y=roughness)
    transparent: bool
    base_color_image: Optional[int]  # index into parsed images, None = white
    base_color_sampler: Optional[int]
    # KHR_texture_transform on baseColorTexture, as a (2,3) affine uv matrix
    # (None = identity). The reference *parses* the extension
    # (vk_loader.cpp:169-171) but its shader never applies it; we bake it
    # into the primitive's uvs at load time so transformed files render
    # correctly.
    uv_transform: Optional[np.ndarray] = None


@dataclasses.dataclass
class ParsedSurface:
    start_index: int
    count: int
    material: Optional[int]
    bounds_origin: np.ndarray
    bounds_extents: np.ndarray
    # KHR_materials_variants: variant index -> material index. The DEFAULT
    # render uses `material` (the reference enables the extension in fastgltf
    # but its engine never selects a variant, vk_loader.cpp:169-191); callers
    # switch via scene.select_variant.
    variant_materials: Optional[Dict[int, int]] = None


@dataclasses.dataclass
class ParsedMesh:
    name: str
    indices: np.ndarray    # (I,) u32, mesh-local (offset by surface vertex base)
    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray
    colors: np.ndarray     # (V, 4)
    uvs: np.ndarray        # (V, 2)
    surfaces: List[ParsedSurface]


@dataclasses.dataclass
class ParsedNode:
    name: str
    mesh: Optional[int]
    local_transform: np.ndarray  # (4,4) f32, M @ v convention
    children: List[int]


@dataclasses.dataclass
class ParsedGLTF:
    meshes: List[ParsedMesh]
    nodes: List[ParsedNode]
    top_nodes: List[int]
    materials: List[ParsedMaterial]
    images: List[Optional[np.ndarray]]  # (h, w, 4) u8, None = failed to load
    samplers: List[ParsedSampler]
    variants: List[str] = dataclasses.field(default_factory=list)


def _filter_flags(mag: int, min_: int) -> int:
    """vk_loader.cpp:26-54 filter conversion, flattened to bits."""
    flags = 0
    # extract_filter (vk_loader.cpp:26-41) returns NEAREST only for the three
    # Nearest* enums; everything else — plain/mipmapped Linear AND any
    # out-of-enum value — falls to the default LINEAR branch. A *missing*
    # filter was already substituted with Nearest by the caller
    # (value_or(Nearest), vk_loader.cpp:204-206).
    _nearest = (_NEAREST, _NEAREST_MIPMAP_NEAREST, _NEAREST_MIPMAP_LINEAR)
    if mag not in _nearest:
        flags |= FILTER_MAG_LINEAR
    if min_ not in _nearest:
        flags |= FILTER_MIN_LINEAR
    # extract_mipmap_mode (vk_loader.cpp:43-54) returns MIPMAP_MODE_NEAREST
    # only for *MipMapNearest; every other min filter — including plain
    # LINEAR/NEAREST and a missing filter (caller defaults it to Nearest,
    # vk_loader.cpp:206) — falls to the default MIPMAP_MODE_LINEAR branch.
    if min_ not in (_NEAREST_MIPMAP_NEAREST, _LINEAR_MIPMAP_NEAREST):
        flags |= FILTER_MIP_LINEAR
    return flags


DEFAULT_SAMPLER_FLAGS = _filter_flags(_LINEAR, _LINEAR_MIPMAP_LINEAR)


class _Buffers:
    def __init__(self, gltf: dict, bin_chunk: Optional[bytes], base_dir: str):
        self.gltf = gltf
        self.bin_chunk = bin_chunk
        self.base_dir = base_dir
        self._cache: Dict[int, bytes] = {}

    def buffer(self, idx: int) -> bytes:
        if idx in self._cache:
            return self._cache[idx]
        b = self.gltf["buffers"][idx]
        uri = b.get("uri")
        if uri is None:
            data = self.bin_chunk
        elif uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            with open(os.path.join(self.base_dir, uri), "rb") as f:
                data = f.read()
        self._cache[idx] = data
        return data

    def view_bytes(self, view_idx: int) -> tuple[bytes, int, Optional[int]]:
        v = self.gltf["bufferViews"][view_idx]
        data = self.buffer(v.get("buffer", 0))
        off = v.get("byteOffset", 0)
        length = v["byteLength"]
        return data[off:off + length], v.get("byteStride") or 0, length


def read_accessor(gltf: dict, buffers: _Buffers, accessor_idx: int) -> np.ndarray:
    """Accessor -> (count, n) float32 or integer array (not normalized).

    Sparse accessors are substituted like fastgltf's iterateAccessor does for
    the reference (vk_loader.cpp:306-308): base data (zeros when the accessor
    has no bufferView) with sparse indices/values patched in.
    """
    acc = gltf["accessors"][accessor_idx]
    count = acc["count"]
    n = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    elem_size = _COMPONENT_SIZES[acc["componentType"]] * n

    if "bufferView" not in acc:
        out = np.zeros((count, n), dtype)
    else:
        raw, stride, _ = buffers.view_bytes(acc["bufferView"])
        off = acc.get("byteOffset", 0)
        if stride and stride != elem_size:
            # strided interleaved data: native C++ fast path when available
            # (the fastgltf iterateAccessor analog), numpy fancy-index fallback
            from tpu_renderer_torch.utils import native

            if acc["componentType"] != 5125 and (
                    acc.get("normalized") or acc["componentType"] == 5126):
                nat = native.decode_accessor_f32(
                    raw[off:], count, n, acc["componentType"], stride,
                    bool(acc.get("normalized")))
                if nat is not None:
                    return nat
            rows = np.frombuffer(raw, np.uint8)
            idx = off + stride * np.arange(count)[:, None] + np.arange(elem_size)[None, :]
            out = np.frombuffer(rows[idx].tobytes(), dtype).reshape(count, n)
        else:
            out = np.frombuffer(raw, dtype, count=count * n, offset=off).reshape(count, n)

    if "sparse" in acc:
        sp = acc["sparse"]
        scount = sp["count"]
        si = sp["indices"]
        idx_dtype = _COMPONENT_DTYPES[si["componentType"]]
        raw_i, _, _ = buffers.view_bytes(si["bufferView"])
        sidx = np.frombuffer(raw_i, idx_dtype, count=scount,
                             offset=si.get("byteOffset", 0)).astype(np.int64)
        sv = sp["values"]
        raw_v, _, _ = buffers.view_bytes(sv["bufferView"])
        svals = np.frombuffer(raw_v, dtype, count=scount * n,
                              offset=sv.get("byteOffset", 0)).reshape(scount, n)
        out = out.copy()
        out[sidx] = svals

    if acc.get("normalized"):
        info = np.iinfo(dtype)
        if info.min < 0:  # signed: max(v / max, -1)
            out = np.maximum(out.astype(np.float32) / info.max, -1.0)
        else:
            out = out.astype(np.float32) / info.max
    return out


def _uv_transform_matrix(offset, rotation, scale) -> np.ndarray:
    """KHR_texture_transform: uv' = T * R * S * uv as a (2,3) affine matrix
    (spec composition order; R rotates clockwise in UV space)."""
    c = np.cos(rotation)
    s = np.sin(rotation)
    sx, sy = scale
    ox, oy = offset
    return np.asarray(
        [[sx * c, sy * s, ox],
         [-sx * s, sy * c, oy]], np.float32)


def read_indices(gltf: dict, buffers: _Buffers, accessor_idx: int) -> np.ndarray:
    """Index accessor -> (n,) uint32, via the native decoder when the data is
    plain (the fastgltf iterateAccessor<uint32_t> analog, vk_loader.cpp:304-308)."""
    acc = gltf["accessors"][accessor_idx]
    if "sparse" not in acc and "bufferView" in acc and acc["type"] == "SCALAR":
        from tpu_renderer_torch.utils import native

        raw, stride, _ = buffers.view_bytes(acc["bufferView"])
        off = acc.get("byteOffset", 0)
        out = native.decode_indices_u32(
            raw[off:], acc["count"], acc["componentType"],
            stride or _COMPONENT_SIZES[acc["componentType"]])
        if out is not None:
            return out
    return read_accessor(gltf, buffers, accessor_idx).reshape(-1).astype(np.uint32)


def _triangulate(idx: np.ndarray, mode: int) -> Optional[np.ndarray]:
    """glTF primitive modes -> triangle list; None = non-triangle topology
    (skipped with a warning — graceful degradation; the reference's pipeline
    only ever draws TRIANGLE_LIST topology, vk_engine.cpp:1661)."""
    if mode == 4:  # TRIANGLES
        return idx
    if mode == 5:  # TRIANGLE_STRIP: flip winding on odd triangles
        n = idx.shape[0] - 2
        if n <= 0:
            return idx[:0]
        i = np.arange(n)
        a = np.where(i % 2 == 0, idx[i], idx[i + 1])
        b = np.where(i % 2 == 0, idx[i + 1], idx[i])
        return np.stack([a, b, idx[i + 2]], axis=1).reshape(-1).astype(np.uint32)
    if mode == 6:  # TRIANGLE_FAN
        n = idx.shape[0] - 2
        if n <= 0:
            return idx[:0]
        i = np.arange(n)
        return np.stack([np.broadcast_to(idx[0], (n,)), idx[i + 1], idx[i + 2]],
                        axis=1).reshape(-1).astype(np.uint32)
    return None  # POINTS / LINES / LINE_LOOP / LINE_STRIP


def _decode_image(data: bytes) -> Optional[np.ndarray]:
    try:
        from PIL import Image

        img = Image.open(io.BytesIO(data)).convert("RGBA")
        return np.asarray(img, np.uint8)
    except Exception:
        return None


def _load_images(gltf: dict, buffers: _Buffers, base_dir: str) -> List[Optional[np.ndarray]]:
    out = []
    for img in gltf.get("images", []):
        data = None
        try:
            if "uri" in img:
                uri = img["uri"]
                if uri.startswith("data:"):
                    data = base64.b64decode(uri.split(",", 1)[1])
                else:
                    with open(os.path.join(base_dir, uri), "rb") as f:
                        data = f.read()
            elif "bufferView" in img:
                data, _, _ = buffers.view_bytes(img["bufferView"])
        except Exception:
            data = None
        out.append(_decode_image(data) if data is not None else None)
    return out


def _node_transform(node: dict) -> np.ndarray:
    if "matrix" in node:
        # glTF stores column-major; numpy M @ v convention wants the transpose
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    from tpu_renderer_torch import math3d

    t = node.get("translation", [0, 0, 0])
    r = node.get("rotation", [0, 0, 0, 1])  # x, y, z, w
    s = node.get("scale", [1, 1, 1])
    tm = math3d.translate(t)
    rm = math3d.quat_to_mat4(math3d.quat(r[3], r[0], r[1], r[2]))
    sm = math3d.scale(s)
    return (tm @ rm @ sm).astype(np.float32)  # vk_loader.cpp:408-412: T*R*S


def load_gltf(path: str) -> ParsedGLTF:
    """Parse a .glb or .gltf file into numpy structures."""
    with open(path, "rb") as f:
        blob = f.read()
    base_dir = os.path.dirname(os.path.abspath(path))

    if blob[:4] == b"glTF":
        if len(blob) < 12:
            raise ValueError("truncated GLB header")
        magic, version, _length = struct.unpack_from("<III", blob, 0)
        if version != 2:
            raise ValueError(f"unsupported GLB version {version}")
        off = 12
        gltf_json = None
        bin_chunk = None
        while off + 8 <= len(blob):
            clen, ctype = struct.unpack_from("<II", blob, off)
            off += 8
            if off + clen > len(blob):
                raise ValueError("GLB chunk extends past end of file")
            chunk = blob[off:off + clen]
            off += clen
            if ctype == 0x4E4F534A:  # 'JSON'
                gltf_json = json.loads(chunk.decode("utf-8"))
            elif ctype == 0x004E4942:  # 'BIN\0'
                bin_chunk = chunk
            # unknown chunk types are skipped (GLB spec: readers must ignore)
        if gltf_json is None:
            raise ValueError("GLB has no JSON chunk")
        gltf = gltf_json
    else:
        gltf = json.loads(blob.decode("utf-8"))
        bin_chunk = None

    buffers = _Buffers(gltf, bin_chunk, base_dir)

    samplers = []
    for s in gltf.get("samplers", []):
        mag = s.get("magFilter", _NEAREST)  # value_or(Nearest), vk_loader.cpp:204
        min_ = s.get("minFilter", _NEAREST)
        samplers.append(ParsedSampler(filter_flags=_filter_flags(mag, min_)))

    images = _load_images(gltf, buffers, base_dir)

    materials = []
    for m in gltf.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        cf = np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)
        mr = np.array(
            [pbr.get("metallicFactor", 1.0), pbr.get("roughnessFactor", 1.0), 0, 0],
            np.float32,
        )
        img_idx = None
        smp_idx = None
        uv_tf = None
        if "baseColorTexture" in pbr:
            bct = pbr["baseColorTexture"]
            tex = gltf["textures"][bct["index"]]
            img_idx = tex.get("source")
            smp_idx = tex.get("sampler")
            ktt = bct.get("extensions", {}).get("KHR_texture_transform")
            if ktt is not None:
                uv_tf = _uv_transform_matrix(
                    ktt.get("offset", [0.0, 0.0]),
                    ktt.get("rotation", 0.0),
                    ktt.get("scale", [1.0, 1.0]))
        materials.append(
            ParsedMaterial(
                name=m.get("name", ""),
                color_factors=cf,
                metal_rough_factors=mr,
                transparent=m.get("alphaMode") == "BLEND",
                base_color_image=img_idx,
                base_color_sampler=smp_idx,
                uv_transform=uv_tf,
            )
        )

    meshes = []
    for mesh in gltf.get("meshes", []):
        indices_all: List[np.ndarray] = []
        pos_all: List[np.ndarray] = []
        nrm_all: List[np.ndarray] = []
        col_all: List[np.ndarray] = []
        uv_all: List[np.ndarray] = []
        surfaces: List[ParsedSurface] = []
        n_indices = 0
        n_vertices = 0
        for prim in mesh.get("primitives", []):
            mode = prim.get("mode", 4)
            attrs = prim["attributes"]
            pos = read_accessor(gltf, buffers, attrs["POSITION"]).astype(np.float32)
            vcount = pos.shape[0]
            if "indices" in prim:
                idx = read_indices(gltf, buffers, prim["indices"])
            else:
                idx = np.arange(vcount, dtype=np.uint32)  # GenerateMeshIndices
            idx = _triangulate(idx, mode)
            if idx is None:
                logging.getLogger(__name__).warning(
                    "skipping non-triangle primitive (mode %d) in mesh %r",
                    mode, mesh.get("name", ""))
                continue

            nrm = np.tile(np.array([1, 0, 0], np.float32), (vcount, 1))
            if "NORMAL" in attrs:
                nrm = read_accessor(gltf, buffers, attrs["NORMAL"]).astype(np.float32)[:, :3]
            col = np.ones((vcount, 4), np.float32)
            if "COLOR_0" in attrs:
                c = read_accessor(gltf, buffers, attrs["COLOR_0"]).astype(np.float32)
                col[:, : c.shape[1]] = c
            uv = np.zeros((vcount, 2), np.float32)
            if "TEXCOORD_0" in attrs:
                uv = read_accessor(gltf, buffers, attrs["TEXCOORD_0"]).astype(np.float32)[:, :2]
            mat_i = prim.get("material")
            if (mat_i is not None and mat_i < len(materials)
                    and materials[mat_i].uv_transform is not None):
                M = materials[mat_i].uv_transform
                uv = (uv @ M[:, :2].T + M[:, 2]).astype(np.float32)

            vmap = None
            mappings = prim.get("extensions", {}).get(
                "KHR_materials_variants", {}).get("mappings")
            if mappings:
                vmap = {v: mp["material"] for mp in mappings
                        for v in mp.get("variants", [])}

            start_index = n_indices
            indices_all.append(idx + np.uint32(n_vertices))
            pos_all.append(pos)
            nrm_all.append(nrm)
            col_all.append(col)
            uv_all.append(uv)
            n_indices += idx.shape[0]
            n_vertices += vcount

            # Reference quirk (vk_loader.cpp:366-375): bounds span every
            # vertex accumulated in the mesh so far, not just this surface.
            verts_so_far = np.concatenate(pos_all, axis=0)
            mn = verts_so_far.min(axis=0)
            mx = verts_so_far.max(axis=0)
            surfaces.append(
                ParsedSurface(
                    start_index=start_index,
                    count=int(idx.shape[0]),
                    material=prim.get("material"),
                    bounds_origin=((mx + mn) / 2).astype(np.float32),
                    bounds_extents=((mx - mn) / 2).astype(np.float32),
                    variant_materials=vmap,
                )
            )

        meshes.append(
            ParsedMesh(
                name=mesh.get("name", ""),
                indices=np.concatenate(indices_all) if indices_all else np.zeros(0, np.uint32),
                positions=np.concatenate(pos_all) if pos_all else np.zeros((0, 3), np.float32),
                normals=np.concatenate(nrm_all) if nrm_all else np.zeros((0, 3), np.float32),
                colors=np.concatenate(col_all) if col_all else np.zeros((0, 4), np.float32),
                uvs=np.concatenate(uv_all) if uv_all else np.zeros((0, 2), np.float32),
                surfaces=surfaces,
            )
        )

    nodes = []
    for node in gltf.get("nodes", []):
        nodes.append(
            ParsedNode(
                name=node.get("name", ""),
                mesh=node.get("mesh"),
                local_transform=_node_transform(node),
                children=list(node.get("children", [])),
            )
        )

    has_parent = set()
    for n in nodes:
        has_parent.update(n.children)
    top_nodes = [i for i in range(len(nodes)) if i not in has_parent]

    variants = [v.get("name", str(i)) for i, v in enumerate(
        gltf.get("extensions", {}).get("KHR_materials_variants", {})
        .get("variants", []))]

    return ParsedGLTF(
        meshes=meshes,
        nodes=nodes,
        top_nodes=top_nodes,
        materials=materials,
        images=images,
        samplers=samplers,
        variants=variants,
    )

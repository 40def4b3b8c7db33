"""Minimal GLB (glTF 2.0 binary) writer: the benchmark's frozen copy of
tpu_renderer_torch/utils/glb_writer.py, so that a change to the program
cannot change the scenes the benchmark hands it. The cells' scenes reach
the program as a GLB file, through its own loader (tpu_renderer_torch.gltf).
"""

from __future__ import annotations

import io
import json
import struct
from typing import List, Optional

import numpy as np


class GLBBuilder:
    def __init__(self) -> None:
        self._bin = bytearray()
        self.gltf = {
            "asset": {"version": "2.0", "generator": "tpu_renderer"},
            "buffers": [],
            "bufferViews": [],
            "accessors": [],
            "meshes": [],
            "nodes": [],
            "scenes": [{"nodes": []}],
            "scene": 0,
        }

    # -- low level ---------------------------------------------------------

    def _append(self, data: bytes, align: int = 4) -> int:
        while len(self._bin) % align:
            self._bin.append(0)
        off = len(self._bin)
        self._bin.extend(data)
        return off

    def add_buffer_view(self, data: bytes, stride: Optional[int] = None) -> int:
        off = self._append(data)
        view = {"buffer": 0, "byteOffset": off, "byteLength": len(data)}
        if stride:
            view["byteStride"] = stride
        self.gltf["bufferViews"].append(view)
        return len(self.gltf["bufferViews"]) - 1

    def add_accessor(self, array: np.ndarray, type_: str, component: int,
                     normalized: bool = False, with_minmax: bool = False) -> int:
        view = self.add_buffer_view(array.tobytes())
        acc = {
            "bufferView": view,
            "componentType": component,
            "count": int(array.shape[0]),
            "type": type_,
        }
        if normalized:
            acc["normalized"] = True
        if with_minmax:
            acc["min"] = [float(v) for v in np.min(array, axis=0).reshape(-1)]
            acc["max"] = [float(v) for v in np.max(array, axis=0).reshape(-1)]
        self.gltf["accessors"].append(acc)
        return len(self.gltf["accessors"]) - 1

    # -- content -------------------------------------------------------------

    def add_image(self, rgba: np.ndarray) -> int:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(rgba, mode="RGBA").save(buf, format="PNG")
        view = self.add_buffer_view(buf.getvalue())
        self.gltf.setdefault("images", []).append(
            {"bufferView": view, "mimeType": "image/png"})
        return len(self.gltf["images"]) - 1

    def add_sampler(self, mag: Optional[int] = 9729,
                    min_: Optional[int] = 9987) -> int:
        s = {}
        if mag is not None:
            s["magFilter"] = mag
        if min_ is not None:
            s["minFilter"] = min_
        self.gltf.setdefault("samplers", []).append(s)
        return len(self.gltf["samplers"]) - 1

    def add_texture(self, image: int, sampler: Optional[int] = None) -> int:
        tex = {"source": image}
        if sampler is not None:
            tex["sampler"] = sampler
        self.gltf.setdefault("textures", []).append(tex)
        return len(self.gltf["textures"]) - 1

    def add_material(self, base_color=(1, 1, 1, 1), texture: Optional[int] = None,
                     metallic: float = 1.0, roughness: float = 1.0,
                     alpha_mode: str = "OPAQUE", name: str = "") -> int:
        pbr = {
            "baseColorFactor": list(map(float, base_color)),
            "metallicFactor": float(metallic),
            "roughnessFactor": float(roughness),
        }
        if texture is not None:
            pbr["baseColorTexture"] = {"index": texture}
        mat = {"name": name, "pbrMetallicRoughness": pbr}
        if alpha_mode != "OPAQUE":
            mat["alphaMode"] = alpha_mode
        self.gltf.setdefault("materials", []).append(mat)
        return len(self.gltf["materials"]) - 1

    def add_mesh(self, primitives: List[dict], name: str = "") -> int:
        prims = []
        for p in primitives:
            pos = np.asarray(p["positions"], np.float32)
            attrs = {"POSITION": self.add_accessor(pos, "VEC3", 5126, with_minmax=True)}
            if "normals" in p:
                attrs["NORMAL"] = self.add_accessor(
                    np.asarray(p["normals"], np.float32), "VEC3", 5126)
            if "uvs" in p:
                attrs["TEXCOORD_0"] = self.add_accessor(
                    np.asarray(p["uvs"], np.float32), "VEC2", 5126)
            if "colors" in p:
                attrs["COLOR_0"] = self.add_accessor(
                    np.asarray(p["colors"], np.float32), "VEC4", 5126)
            prim = {"attributes": attrs}
            if "indices" in p:
                prim["indices"] = self.add_accessor(
                    np.asarray(p["indices"], np.uint32).reshape(-1), "SCALAR", 5125)
            if p.get("material") is not None:
                prim["material"] = p["material"]
            prims.append(prim)
        self.gltf["meshes"].append({"name": name, "primitives": prims})
        return len(self.gltf["meshes"]) - 1

    def add_node(self, mesh: Optional[int] = None, translation=None,
                 rotation=None, scale=None, matrix=None,
                 children: Optional[List[int]] = None, name: str = "",
                 top_level: bool = True) -> int:
        node: dict = {"name": name}
        if mesh is not None:
            node["mesh"] = mesh
        if matrix is not None:
            # glTF stores column-major; our math is M @ v row-major
            node["matrix"] = [float(v) for v in np.asarray(matrix, np.float32).T.reshape(-1)]
        else:
            if translation is not None:
                node["translation"] = list(map(float, translation))
            if rotation is not None:
                node["rotation"] = list(map(float, rotation))  # x,y,z,w
            if scale is not None:
                node["scale"] = list(map(float, scale))
        if children:
            node["children"] = children
        self.gltf["nodes"].append(node)
        idx = len(self.gltf["nodes"]) - 1
        if top_level:
            self.gltf["scenes"][0]["nodes"].append(idx)
        return idx

    # -- output ----------------------------------------------------------------

    def build(self) -> bytes:
        self.gltf["buffers"] = [{"byteLength": len(self._bin)}]
        js = json.dumps(self.gltf).encode("utf-8")
        while len(js) % 4:
            js += b" "
        binc = bytes(self._bin)
        while len(binc) % 4:
            binc += b"\x00"
        total = 12 + 8 + len(js) + 8 + len(binc)
        out = bytearray()
        out += struct.pack("<III", 0x46546C67, 2, total)  # 'glTF'
        out += struct.pack("<II", len(js), 0x4E4F534A) + js
        out += struct.pack("<II", len(binc), 0x004E4942) + binc
        return bytes(out)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.build())

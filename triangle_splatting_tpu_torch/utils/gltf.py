"""Minimal GLB (binary glTF 2.0) mesh writer/reader, pure numpy.

The port's own copy of ``triangle_splatting_tpu/utils/gltf.py`` (which the
port does not import): one scene, one mesh, one triangle primitive with
float32 POSITION, uint32 indices, and per-vertex RGBA COLOR_0 (float32,
which viewers interpret with alpha blending). The writer's bytes are the
JAX package's for the same arrays: the same JSON key order, padding,
accessor layout and generator string.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

_COMPONENT = {np.dtype("f4"): 5126, np.dtype("u4"): 5125, np.dtype("u2"): 5123,
              np.dtype("u1"): 5121}


def write_glb(path, vertices: np.ndarray, faces: np.ndarray,
              vertex_colors: np.ndarray | None = None) -> None:
    """vertices (V,3) f32; faces (F,3) int; vertex_colors (V,4) f32 in [0,1]."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    vertices = np.ascontiguousarray(vertices, np.float32)
    indices = np.ascontiguousarray(faces, np.uint32).reshape(-1)

    buffers = []
    views = []
    accessors = []

    def add(data: np.ndarray, target: int, acc_type: str, normalized=False):
        data = np.ascontiguousarray(data)
        offset = sum(len(b) for b in buffers)
        raw = data.tobytes()
        pad = (-len(raw)) % 4
        buffers.append(raw + b"\x00" * pad)
        views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(raw),
                      "target": target})
        acc = {"bufferView": len(views) - 1, "componentType": _COMPONENT[data.dtype],
               "count": data.shape[0], "type": acc_type}
        if normalized:
            acc["normalized"] = True
        if acc_type == "VEC3" and data.dtype == np.dtype("f4"):
            acc["min"] = data.min(axis=0).tolist()
            acc["max"] = data.max(axis=0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    pos_acc = add(vertices, 34962, "VEC3")
    idx_acc = add(indices[:, None] if indices.ndim == 1 else indices, 34963, "SCALAR")
    attributes = {"POSITION": pos_acc}
    if vertex_colors is not None:
        col_acc = add(np.ascontiguousarray(vertex_colors, np.float32), 34962, "VEC4")
        attributes["COLOR_0"] = col_acc

    gltf = {
        "asset": {"version": "2.0", "generator": "triangle_splatting_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "name": "geometry_0"}],
        "meshes": [{"name": "geometry_0", "primitives": [
            {"attributes": attributes, "indices": idx_acc, "mode": 4,
             "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorFactor": [1, 1, 1, 1],
                                                "metallicFactor": 0.0,
                                                "roughnessFactor": 1.0},
                       "alphaMode": "BLEND", "doubleSided": True}],
        "bufferViews": views,
        "accessors": accessors,
        "buffers": [{"byteLength": sum(len(b) for b in buffers)}],
    }

    json_bytes = json.dumps(gltf, separators=(",", ":")).encode("utf-8")
    json_bytes += b" " * ((-len(json_bytes)) % 4)
    bin_bytes = b"".join(buffers)

    with open(path, "wb") as f:
        total = 12 + 8 + len(json_bytes) + 8 + len(bin_bytes)
        f.write(struct.pack("<III", 0x46546C67, 2, total))          # glTF v2
        f.write(struct.pack("<II", len(json_bytes), 0x4E4F534A))    # JSON
        f.write(json_bytes)
        f.write(struct.pack("<II", len(bin_bytes), 0x004E4942))     # BIN
        f.write(bin_bytes)


def read_glb(path):
    """Returns (vertices (V,3) f32, faces (F,3) i64, vertex_colors (V,4) f32 or None)."""
    with open(path, "rb") as f:
        magic, version, _length = struct.unpack("<III", f.read(12))
        if magic != 0x46546C67:
            raise ValueError("not a GLB file")
        chunks = {}
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            clen, ctype = struct.unpack("<II", head)
            chunks[ctype] = f.read(clen)

    gltf = json.loads(chunks[0x4E4F534A].decode("utf-8"))
    blob = chunks.get(0x004E4942, b"")

    def load_accessor(idx):
        acc = gltf["accessors"][idx]
        view = gltf["bufferViews"][acc["bufferView"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        comp = {5126: "f4", 5125: "u4", 5123: "u2", 5121: "u1",
                5122: "i2", 5120: "i1"}[acc["componentType"]]
        ncomp = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}[acc["type"]]
        count = acc["count"]
        data = np.frombuffer(blob, dtype="<" + comp,
                             count=count * ncomp,
                             offset=start).reshape(count, ncomp)
        if acc.get("normalized"):
            data = data.astype(np.float32) / np.iinfo("<" + comp).max
        return data

    prim = gltf["meshes"][0]["primitives"][0]
    vertices = load_accessor(prim["attributes"]["POSITION"]).astype(np.float32)
    faces = load_accessor(prim["indices"]).reshape(-1, 3).astype(np.int64)
    colors = None
    if "COLOR_0" in prim["attributes"]:
        colors = load_accessor(prim["attributes"]["COLOR_0"]).astype(np.float32)
        if colors.shape[1] == 3:
            colors = np.concatenate([colors, np.ones((len(colors), 1), np.float32)], 1)
    return vertices, faces, colors

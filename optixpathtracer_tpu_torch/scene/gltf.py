"""glTF 2.0 loader (and a minimal writer for round-trip tests); port of
`optixpathtracer_tpu/scene/gltf.py`, host numpy building the port's
`scene/types.py` Model (image decoding through PIL, as in the reference).

Hand-rolled (no pygltflib in the image), reproducing the reference loader's
semantics (`ModelLoader.cpp`) and fixing its documented gaps (SURVEY.md
section 2.1):

reproduced:
  * first scene only (`ModelLoader.cpp:36`)
  * one Mesh per primitive, one material per Mesh (`ModelLoader.cpp:100-102`)
  * POSITION / NORMAL / TEXCOORD_0 attributes (`ModelLoader.cpp:105-138`)
  * pbrMetallicRoughness: baseColorFactor, metallicFactor, roughnessFactor,
    baseColor/metallicRoughness/normal textures (`ModelLoader.cpp:181-193`)
  * textures decoded RGBA8, NO y-mirror (`ModelLoader.cpp:62,71-79`)
fixed (gaps in the reference):
  * child-node recursion with composed transforms (`ParseNodes` never
    recursed, `ModelLoader.cpp:97-164`)
  * all index component types, not just uint16 (`ModelLoader.cpp:145-147`)
  * .glb binary container support (reference: LoadASCIIFromFile only,
    `ModelLoader.cpp:20`)

Loaded materials default to the reference's runtime material model
(`metallic_mix`: stochastic conductor-vs-layered by metallic).
"""
from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from .types import Material, Mesh, Model, Texture

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_SIZES = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_buffers(doc, base_dir, glb_chunk=None):
    buffers = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(glb_chunk[:buf["byteLength"]])
        elif uri.startswith("data:"):
            b64 = uri.split(",", 1)[1]
            buffers.append(base64.b64decode(b64))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                buffers.append(f.read())
    return buffers


def _read_accessor(doc, buffers, acc_idx):
    acc = doc["accessors"][acc_idx]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
    n_comp = _TYPE_SIZES[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", 0)
    raw = buffers[view["buffer"]]

    elem_bytes = dtype.itemsize * n_comp
    if stride in (0, elem_bytes):
        arr = np.frombuffer(raw, dtype, count * n_comp, offset)
    else:  # interleaved: strided byte view over the window, one copy
        window = np.frombuffer(raw, np.uint8,
                               (count - 1) * stride + elem_bytes, offset)
        rows = np.lib.stride_tricks.as_strided(
            window, shape=(count, elem_bytes), strides=(stride, 1))
        arr = np.ascontiguousarray(rows).view(dtype)
    return arr.reshape(count, n_comp) if n_comp > 1 else arr.reshape(count)


def _node_matrix(node):
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    t = np.asarray(node.get("translation", [0, 0, 0]), np.float64)
    # glTF stores quaternions xyzw; engine order is w-first
    # (reference reorder at `ModelLoader.cpp:236-241`)
    qx, qy, qz, qw = node.get("rotation", [0, 0, 0, 1])
    s = np.asarray(node.get("scale", [1, 1, 1]), np.float64)
    r = np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
    ])
    m = np.eye(4)
    m[:3, :3] = r @ np.diag(s)
    m[:3, 3] = t
    return m


def _load_image(doc, buffers, base_dir, img_idx):
    from PIL import Image
    img = doc["images"][img_idx]
    if "uri" in img and not img["uri"].startswith("data:"):
        pil = Image.open(os.path.join(base_dir, img["uri"]))
    else:
        if "uri" in img:
            data = base64.b64decode(img["uri"].split(",", 1)[1])
        else:
            view = doc["bufferViews"][img["bufferView"]]
            off = view.get("byteOffset", 0)
            data = buffers[view["buffer"]][off:off + view["byteLength"]]
        import io
        pil = Image.open(io.BytesIO(data))
    pil = pil.convert("RGBA")
    # no y-mirror, matching the reference (`ModelLoader.cpp:71-79`)
    return np.asarray(pil, np.float32) / 255.0


def _parse_material(doc, mat_idx):
    mat = Material()
    if mat_idx is None:
        return mat
    m = doc["materials"][mat_idx]
    pbr = m.get("pbrMetallicRoughness", {})
    mat.base_color = np.asarray(
        pbr.get("baseColorFactor", [1, 1, 1, 1])[:3], np.float32)
    mat.metallic = float(pbr.get("metallicFactor", 1.0))
    mat.roughness = float(pbr.get("roughnessFactor", 1.0))
    if "baseColorTexture" in pbr:
        mat.albedo_texture = pbr["baseColorTexture"]["index"]
    if "metallicRoughnessTexture" in pbr:
        mat.metal_rough_texture = pbr["metallicRoughnessTexture"]["index"]
    if "normalTexture" in m:
        mat.normal_texture = m["normalTexture"]["index"]
    # extras.mat_type lets scene files pick explicit lobes; default is the
    # reference's stochastic metallic mix
    extras = m.get("extras", {})
    if "mat_type" in extras:
        mat.mat_type = extras["mat_type"]
    if "ior" in extras:
        mat.ior = float(extras["ior"])
    return mat


def load_gltf(path: str, reference_compat: bool = False) -> Model:
    """Load a .gltf (ASCII) or .glb (binary) file into a Model.

    reference_compat=True reproduces the reference's no-child-recursion
    behavior (`ModelLoader.cpp:97-164`: only root nodes' own meshes load).
    """
    base_dir = os.path.dirname(path)
    glb_chunk = None
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        if head == b"glTF":  # binary container
            magic, version, length = struct.unpack("<III", f.read(12))
            doc = None
            while f.tell() < length:
                chunk_len, chunk_type = struct.unpack("<II", f.read(8))
                data = f.read(chunk_len)
                if chunk_type == 0x4E4F534A:  # JSON
                    doc = json.loads(data)
                elif chunk_type == 0x004E4942:  # BIN
                    glb_chunk = data
        else:
            doc = json.load(open(path, "r"))

    buffers = _load_buffers(doc, base_dir, glb_chunk)

    # first scene only (reference `ModelLoader.cpp:36`)
    scene_idx = doc.get("scene", 0)
    scene = doc["scenes"][scene_idx]

    model = Model()
    tex_source = {}
    for ti, tex in enumerate(doc.get("textures", [])):
        tex_source[ti] = tex["source"]
    img_cache = {}

    def _texture_id(gltf_tex_idx):
        if gltf_tex_idx < 0:
            return -1
        src = tex_source[gltf_tex_idx]
        if src not in img_cache:
            pixels = _load_image(doc, buffers, base_dir, src)
            img_cache[src] = len(model.textures)
            model.textures.append(Texture(pixels=pixels, name=f"img{src}"))
        return img_cache[src]

    def _visit(node_idx, parent_mat):
        node = doc["nodes"][node_idx]
        mat = parent_mat @ _node_matrix(node)
        if "mesh" in node:
            gmesh = doc["meshes"][node["mesh"]]
            for prim in gmesh["primitives"]:
                attrs = prim["attributes"]
                pos = _read_accessor(doc, buffers, attrs["POSITION"])
                pos = pos.astype(np.float64)
                nrm = None
                if "NORMAL" in attrs:
                    nrm = _read_accessor(doc, buffers,
                                         attrs["NORMAL"]).astype(np.float64)
                uv = None
                if "TEXCOORD_0" in attrs:
                    uv = _read_accessor(doc, buffers,
                                        attrs["TEXCOORD_0"]).astype(np.float32)
                if "indices" in prim:
                    idx = _read_accessor(doc, buffers, prim["indices"])
                    idx = idx.astype(np.int64).reshape(-1, 3)
                else:
                    idx = np.arange(len(pos), dtype=np.int64).reshape(-1, 3)

                # bake the composed node transform (fix for the reference's
                # missing recursion; its per-mesh TRS becomes our identity)
                pos_w = pos @ mat[:3, :3].T + mat[:3, 3]
                nrm_w = None
                if nrm is not None:
                    nrm_w = nrm @ np.linalg.inv(mat[:3, :3]).T
                    nrm_w /= np.maximum(
                        np.linalg.norm(nrm_w, axis=-1, keepdims=True), 1e-20)

                material = _parse_material(doc, prim.get("material"))
                material.albedo_texture = _texture_id(material.albedo_texture)
                material.metal_rough_texture = _texture_id(
                    material.metal_rough_texture)
                material.normal_texture = _texture_id(material.normal_texture)

                model.meshes.append(Mesh(
                    positions=pos_w.astype(np.float32),
                    indices=idx.astype(np.int32),
                    normals=None if nrm_w is None
                    else nrm_w.astype(np.float32),
                    uvs=uv,
                    material=material,
                    name=node.get("name", f"node{node_idx}"),
                ))
        if not reference_compat:
            for child in node.get("children", []):
                _visit(child, mat)

    for node_idx in scene["nodes"]:
        _visit(node_idx, np.eye(4))
    return model


# ---------------------------------------------------------------------------
# Writer (for loader round-trip tests and asset generation)
# ---------------------------------------------------------------------------

def save_gltf(path: str, model: Model) -> None:
    """Write a Model to a single-file .gltf with an embedded base64 buffer.
    World-space baked (mesh TRS applied)."""
    bin_parts = []
    offset = 0
    buffer_views = []
    accessors = []

    def _add(arr, target):
        nonlocal offset
        data = arr.tobytes()
        buffer_views.append({
            "buffer": 0, "byteOffset": offset, "byteLength": len(data),
            "target": target})
        offset += len(data)
        # 4-byte alignment
        if offset % 4:
            pad = 4 - offset % 4
            bin_parts.append(data + b"\x00" * pad)
            offset += pad
        else:
            bin_parts.append(data)
        return len(buffer_views) - 1

    meshes_out = []
    nodes_out = []
    materials_out = []
    for mi, mesh in enumerate(model.meshes):
        m = mesh.model_matrix()
        pos = (mesh.positions.astype(np.float64) @ m[:3, :3].T
               + m[:3, 3]).astype(np.float32)
        view = _add(pos, 34962)
        accessors.append({
            "bufferView": view, "componentType": 5126, "count": len(pos),
            "type": "VEC3",
            "min": pos.min(axis=0).tolist(), "max": pos.max(axis=0).tolist()})
        pos_acc = len(accessors) - 1

        attrs = {"POSITION": pos_acc}
        if mesh.normals is not None:
            nrm = mesh.normals.astype(np.float32)
            view = _add(nrm, 34962)
            accessors.append({"bufferView": view, "componentType": 5126,
                              "count": len(nrm), "type": "VEC3"})
            attrs["NORMAL"] = len(accessors) - 1
        if mesh.uvs is not None:
            uv = mesh.uvs.astype(np.float32)
            view = _add(uv, 34962)
            accessors.append({"bufferView": view, "componentType": 5126,
                              "count": len(uv), "type": "VEC2"})
            attrs["TEXCOORD_0"] = len(accessors) - 1

        idx = mesh.indices.astype(np.uint32).reshape(-1)
        view = _add(idx, 34963)
        accessors.append({"bufferView": view, "componentType": 5125,
                          "count": len(idx), "type": "SCALAR"})
        idx_acc = len(accessors) - 1

        mat = mesh.material
        materials_out.append({
            "name": f"mat{mi}",
            "pbrMetallicRoughness": {
                "baseColorFactor": list(map(float, mat.base_color)) + [1.0],
                "metallicFactor": float(mat.metallic),
                "roughnessFactor": float(mat.roughness),
            },
            "extras": {"mat_type": mat.mat_type, "ior": float(mat.ior)},
        })
        meshes_out.append({"primitives": [{
            "attributes": attrs, "indices": idx_acc, "material": mi}]})
        nodes_out.append({"mesh": mi, "name": mesh.name})

    blob = b"".join(bin_parts)
    doc = {
        "asset": {"version": "2.0",
                  "generator": "optixpathtracer_tpu_torch"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes_out)))}],
        "nodes": nodes_out,
        "meshes": meshes_out,
        "materials": materials_out,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{
            "byteLength": len(blob),
            "uri": "data:application/octet-stream;base64,"
                   + base64.b64encode(blob).decode()}],
    }
    with open(path, "w") as f:
        json.dump(doc, f)

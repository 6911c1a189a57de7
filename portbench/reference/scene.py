"""The reference's own scene arrays and camera, worked out from the
benchmark's plain scene description (`portbench/scenes/`), with nothing
taken from the program.

Triangles stay in mesh order (the program reorders them by its BVH). The
arithmetic that makes each triangle is the program's flatten, so that the
same triangle has the same float32 corners and edges on both sides: world
positions in float64, cast to float32, edges subtracted in float32; vertex
normals normalised in float64, then cast (a mesh without normals gets the
geometric normal at every corner; one without uvs, zeros). Each mesh also
gets a bounding sphere, the only acceleration structure the reference uses
(`reference/intersect.py`).

Textures are the description's raw [H, W, 4] arrays, each resampled to
`TEXTURE_RES` as the program's flatten resamples them
(`reference/textures.py`). A material may use an albedo texture; a
metal-rough or a normal texture makes `flatten` raise, since the reference
does not shade them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .textures import TEXTURE_RES, resize_texture

MAT_TYPES = {"diffuse": 0, "conductor": 1, "dielectric": 2,
             "glossy_diffuse": 3, "metallic_mix": 4}
UNSHADED_TEXTURES = ("metal_rough_texture", "normal_texture")


@dataclasses.dataclass
class RefScene:
    tri_v0: torch.Tensor       # [T, 3]
    tri_e1: torch.Tensor       # [T, 3]
    tri_e2: torch.Tensor       # [T, 3]
    tri_normals: torch.Tensor  # [T, 3, 3]
    tri_uvs: torch.Tensor      # [T, 3, 2]
    tri_mat: torch.Tensor      # [T] int64
    mat_albedo: torch.Tensor   # [M, 3]
    mat_metallic: torch.Tensor  # [M]
    mat_roughness: torch.Tensor  # [M]
    mat_ior: torch.Tensor      # [M]
    mat_type: torch.Tensor     # [M] int32
    mat_albedo_tex: torch.Tensor  # [M] int64, -1 = none
    textures: torch.Tensor     # [K, R, R, 4] raw values, K >= 1
    light_pos: torch.Tensor    # [L, 3]
    light_color: torch.Tensor  # [L, 3]
    # per mesh: first triangle, end, bounding-sphere centre and radius
    groups: list
    # every corner normal is its triangle's geometric normal (within 1e-5,
    # the program's `scene_flat_shading`): shade with the geometric normal
    flat_shading: bool

    def replace(self, **fields) -> "RefScene":
        return dataclasses.replace(self, **fields)


def _corner_normals(mesh, pos, idx):
    """[F, 3 corners, 3] float64: the mesh's normals, normalised, or the
    geometric normal at every corner where it has none."""
    if mesh.get("normals") is None:
        gn = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]],
                      pos[idx[:, 2]] - pos[idx[:, 0]])
        gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True),
                             1e-20)
        return np.stack([gn, gn, gn], axis=1)
    nrm = mesh["normals"].astype(np.float64)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                           1e-20)
    return np.stack([nrm[idx[:, 0]], nrm[idx[:, 1]], nrm[idx[:, 2]]],
                    axis=1)


def _corner_uvs(mesh, idx):
    if mesh.get("uvs") is None:
        return np.zeros((len(idx), 3, 2))
    uv = mesh["uvs"].astype(np.float64)
    return np.stack([uv[idx[:, 0]], uv[idx[:, 1]], uv[idx[:, 2]]], axis=1)


def _albedo_texture(material, n_textures) -> int:
    """The material's albedo texture index; raises on a texture the
    reference does not shade or an index past the description's list."""
    for key in UNSHADED_TEXTURES:
        if material.get(key, -1) >= 0:
            raise NotImplementedError(
                f"the reference does not shade a {key.replace('_', ' ')}")
    tex = int(material.get("albedo_texture", -1))
    if tex >= n_textures:
        raise ValueError(f"albedo texture {tex} of {n_textures}")
    return tex


def _flat_shading(v0, v1, v2, normals) -> bool:
    """The program's `scene_flat_shading`, on the reference's own float32
    arrays."""
    g = np.cross(v1 - v0, v2 - v0)
    g = g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-20)
    return bool(np.all(np.abs(normals - g[:, None, :]) < 1e-5))


def flatten(desc: dict, device) -> RefScene:
    v0s, v1s, v2s, nrms, uvs, mat_ids, groups = [], [], [], [], [], [], []
    start = 0
    for mi, mesh in enumerate(desc["meshes"]):
        pos = mesh["positions"].astype(np.float64)
        idx = mesh["indices"].astype(np.int64)
        v0s.append(pos[idx[:, 0]])
        v1s.append(pos[idx[:, 1]])
        v2s.append(pos[idx[:, 2]])
        nrms.append(_corner_normals(mesh, pos, idx))
        uvs.append(_corner_uvs(mesh, idx))
        mat_ids.append(np.full(len(idx), mi, np.int64))
        centre = 0.5 * (pos.min(axis=0) + pos.max(axis=0))
        radius = float(np.linalg.norm(pos - centre, axis=-1).max())
        groups.append((start, start + len(idx), centre, radius))
        start += len(idx)
    v0 = np.concatenate(v0s).astype(np.float32)
    v1 = np.concatenate(v1s).astype(np.float32)
    v2 = np.concatenate(v2s).astype(np.float32)
    normals = np.concatenate(nrms).astype(np.float32)
    mats = [m["material"] for m in desc["meshes"]]
    raw = desc.get("textures") or []
    albedo_tex = [_albedo_texture(m, len(raw)) for m in mats]
    textures = (np.stack([resize_texture(np.asarray(t), TEXTURE_RES)
                          for t in raw]) if raw else
                np.zeros((1, TEXTURE_RES, TEXTURE_RES, 4), np.float32))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return RefScene(
        tri_v0=t(v0), tri_e1=t(v1 - v0), tri_e2=t(v2 - v0),
        tri_normals=t(normals),
        tri_uvs=t(np.concatenate(uvs).astype(np.float32)),
        tri_mat=t(np.concatenate(mat_ids)),
        mat_albedo=t(np.stack([m["base_color"] for m in mats])
                     .astype(np.float32)),
        mat_metallic=t(np.array([m["metallic"] for m in mats], np.float32)),
        mat_roughness=t(np.array([m["roughness"] for m in mats],
                                 np.float32)),
        mat_ior=t(np.array([m["ior"] for m in mats], np.float32)),
        mat_type=t(np.array([MAT_TYPES[m["mat_type"]] for m in mats],
                            np.int32)),
        mat_albedo_tex=t(np.array(albedo_tex, np.int64)),
        textures=t(textures.astype(np.float32)),
        light_pos=t(np.stack([np.asarray(p, np.float32)
                              for p, _ in desc["lights"]])),
        light_color=t(np.stack([np.asarray(c, np.float32)
                                for _, c in desc["lights"]])),
        groups=groups, flat_shading=_flat_shading(v0, v1, v2, normals))


# The camera: glm's lookAt and perspective in float64 on the host, as the
# reference renderer builds them (`Camera.cpp`), then inverted and cast.

def _forward(rotation):
    r = np.radians(rotation)
    v = np.array([np.sin(r[1]) * np.cos(r[0]), -np.sin(r[0]),
                  np.cos(r[0]) * np.cos(r[1])])
    return v / np.linalg.norm(v)


def _look_at(eye, center, up):
    eye = np.asarray(eye, np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def _perspective(fovy_radians, aspect, near=0.1, far=100.0):
    t = np.tan(fovy_radians / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -2.0 * far * near / (far - near)
    m[3, 2] = -1.0
    return m


def camera_params(cam: dict, width: int, height: int, device):
    """(position, inverse view, inverse projection) as float32 tensors."""
    pos = np.asarray(cam["position"], np.float64)
    view = _look_at(pos, pos + _forward(cam["rotation"]),
                    np.array([0.0, 1.0, 0.0]))
    proj = _perspective(np.radians(cam["fov_degrees"]), width / height)
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in (pos, np.linalg.inv(view), np.linalg.inv(proj)))

"""Flatten a host Model into one device-resident SoA `SceneData`
(port of `optixpathtracer_tpu/scene/flatten.py`).

The host side is the reference's numpy code, unchanged, so both packages
produce the same leaves through the same padding (PAD_MULTIPLE=8, padding
triangles at v0=1e10 with zero edges) and the same BVH triangle order; only
the last step differs: leaves become torch tensors on a chosen device.

`scene_from_jax` is the other way in: it carries a scene the JAX package
flattened (its leaves as numpy arrays) across unchanged. The material table
(`mat_*`) is the scene's learnable state.

A scene that mixes alpha-cutout and opaque meshes also carries two
sub-scenes, flattened on their own (reference `flatten.py:355-387`): the
opaque meshes and the cutout ones, each with `tri_outer_id` mapping its
triangles to the outer scene's ids. `integrate/cutout.py` queries them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bsdf.dispatch import MATERIAL_NAMES
from . import bvh as bvh_mod
from .types import Model

TEXTURE_RES = 256  # uniform texture array resolution (bilinear-resampled)
PAD_MULTIPLE = 8   # pad triangle count so wavefront gathers stay aligned
MAX_WALK_CHUNKS = 2048  # chunk-BVH leaf count cap of the walk layout


def _walk_chunk_size(t_pad: int) -> int:
    """Triangles per walk chunk: 128 scaled up in powers of two so
    n_chunks <= MAX_WALK_CHUNKS."""
    chunk = 128
    while t_pad > chunk * MAX_WALK_CHUNKS:
        chunk *= 2
    return chunk


def _build_walk_arrays(v0, e1, e2, valid):
    """Pack triangles as [n_chunks, 16, CHUNK] (9 component rows v0/e1/e2
    xyz, 7 zero rows) and build the chunk-level skip-link BVH and the
    128-triangle subchunk AABBs of the walk and packet engines. Triangles
    are already in triangle-BVH leaf order, so consecutive chunks are
    spatially tight."""
    t = len(v0)
    chunk = _walk_chunk_size(t)
    n_chunks = -(-t // chunk)
    t_pad = n_chunks * chunk
    pad = t_pad - t

    def _pad(a, fill):
        return np.concatenate(
            [a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) if pad else a

    v0p = _pad(v0.astype(np.float32), 1e10)
    e1p = _pad(e1.astype(np.float32), 0.0)
    e2p = _pad(e2.astype(np.float32), 0.0)
    validp = np.concatenate([valid, np.zeros(pad, bool)]) if pad else valid

    tris = np.concatenate([v0p, e1p, e2p], axis=1)  # [T_pad, 9]
    walk_tris = np.zeros((n_chunks, 16, chunk), np.float32)
    walk_tris[:, :9, :] = tris.reshape(n_chunks, chunk, 9).transpose(0, 2, 1)

    # chunk AABBs over valid triangles; empty chunks get a far-away point
    # box that fails every slab test
    v1p = v0p + e1p
    v2p = v0p + e2p
    big = np.float32(3.4e38)
    bb_min = np.where(validp[:, None],
                      np.minimum(np.minimum(v0p, v1p), v2p), big)
    bb_max = np.where(validp[:, None],
                      np.maximum(np.maximum(v0p, v1p), v2p), -big)
    c_min = bb_min.reshape(n_chunks, chunk, 3).min(axis=1)
    c_max = bb_max.reshape(n_chunks, chunk, 3).max(axis=1)
    empty = c_min[:, :1] > c_max[:, :1]
    c_min = np.where(empty, big, c_min)
    c_max = np.where(empty, big, c_max)

    n_sub = chunk // 128
    s_min = bb_min.reshape(n_chunks * n_sub, 128, 3).min(axis=1)
    s_max = bb_max.reshape(n_chunks * n_sub, 128, 3).max(axis=1)
    s_empty = s_min[:, :1] > s_max[:, :1]
    s_min = np.where(s_empty, big, s_min)
    s_max = np.where(s_empty, big, s_max)
    sub_box = np.concatenate([s_min.T, s_max.T], axis=0)  # [6, C*n_sub]

    tree = bvh_mod.build_chunk_bvh(c_min, c_max)
    return walk_tris, tree.node_box, tree.node_link, sub_box


@dataclasses.dataclass
class SceneData:
    """Device-side scene: the reference's SceneData fields as tensors on one
    device. `cache` holds per-scene derived arrays (the dense engine's
    triangle planes and chunk boxes) and is never copied by `to`."""
    # geometry (world space, padded to PAD_MULTIPLE)
    tri_v0: torch.Tensor      # [T, 3]
    tri_e1: torch.Tensor      # [T, 3] v1 - v0
    tri_e2: torch.Tensor      # [T, 3] v2 - v0
    tri_normals: torch.Tensor  # [T, 3, 3] per-corner shading normals
    tri_uvs: torch.Tensor     # [T, 3, 2]
    tri_mat: torch.Tensor     # [T] int32 material id
    tri_valid: torch.Tensor   # [T] bool (False for padding)
    # material table
    mat_albedo: torch.Tensor    # [M, 3]
    mat_metallic: torch.Tensor  # [M]
    mat_roughness: torch.Tensor  # [M]
    mat_ior: torch.Tensor       # [M]
    mat_type: torch.Tensor      # [M] int32
    mat_albedo_tex: torch.Tensor  # [M] int32, -1 = none
    mat_mr_tex: torch.Tensor      # [M] int32
    mat_normal_tex: torch.Tensor  # [M] int32
    # textures (uniform res, raw [0,1] values - decode after filtering)
    textures: torch.Tensor    # [K, R, R, 4]
    # lights
    light_pos: torch.Tensor    # [L, 3]
    light_color: torch.Tensor  # [L, 3]
    # BVH (skip-link layout, scene/bvh.py)
    bvh_min: torch.Tensor     # [N, 3]
    bvh_max: torch.Tensor     # [N, 3]
    bvh_skip: torch.Tensor    # [N] int32
    bvh_first: torch.Tensor   # [N] int32
    bvh_count: torch.Tensor   # [N] int32
    # walk/packet engine layout (empty when built with build_bvh=False)
    walk_tris: torch.Tensor
    walk_node_box: torch.Tensor
    walk_node_link: torch.Tensor
    walk_sub_box: torch.Tensor
    # opaque/cutout split (integrate/cutout.py): sub-scenes over just the
    # opaque and just the cutout-capable meshes, or None
    opaque_scene: object = None
    cutout_sub: object = None
    # output slot -> pre-BVH triangle index (-1 for padding)
    tri_src: object = None
    # sub-scenes only: output slot -> the outer scene's triangle id
    tri_outer_id: object = None
    cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    @property
    def num_triangles(self):
        return self.tri_v0.shape[0]

    @property
    def walk_chunk(self):
        return self.walk_tris.shape[2]

    @property
    def num_lights(self):
        return self.light_pos.shape[0]

    def to(self, device) -> "SceneData":
        """A copy with every tensor on `device`, sub-scenes included (each
        with an empty cache)."""
        subs = {k: None if getattr(self, k) is None
                else getattr(self, k).to(device)
                for k in ("opaque_scene", "cutout_sub")}
        return dataclasses.replace(self, cache={}, **subs, **{
            k: v.to(device) for k, v in self.leaves().items()})

    def leaves(self) -> dict:
        """{field name: tensor} for every tensor field."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}


def _device(device) -> torch.device:
    """The device an entry point builds on. The default, "cuda", raises
    where there is no CUDA device rather than building on the CPU; the CPU
    is used only when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' "
            "to build on the CPU")
    return device


def scene_from_jax(leaves: dict, device="cuda") -> SceneData:
    """The port's SceneData from the leaves of a JAX-flattened scene.

    `leaves` maps field names to numpy arrays, and a sub-scene
    (`opaque_scene`, `cutout_sub`) to a dict of its own leaves, since a
    NamedTuple is no array (for a JAX SceneData `s`: `{k: None if v is None
    else leaves_of(v) if hasattr(v, "_asdict") else np.asarray(v) for k, v
    in s._asdict().items()}`). Values are carried across unchanged."""
    device = _device(device)
    names = [f.name for f in dataclasses.fields(SceneData)
             if f.name not in ("opaque_scene", "cutout_sub", "cache")]
    subs = {k: None if leaves.get(k) is None
            else scene_from_jax(leaves[k], device)
            for k in ("opaque_scene", "cutout_sub")}
    return SceneData(**subs, **{
        k: None if leaves.get(k) is None
        else torch.as_tensor(np.array(leaves[k], order="C"), device=device)
        for k in names})


def scene_active_lobes(scene: SceneData):
    """The static tuple of BSDF lobe ids present in the material table
    (METALLIC_MIX activates conductor and layered)."""
    from ..bsdf import dispatch as _d
    lobes = set()
    for t in set(int(t) for t in scene.mat_type.cpu().tolist()):
        if t == _d.METALLIC_MIX:
            lobes.update((_d.CONDUCTOR, _d.GLOSSY_DIFFUSE))
        else:
            lobes.add(t)
    return tuple(sorted(lobes))


def scene_uses_textures(scene: SceneData) -> bool:
    """Does any material reference a texture?"""
    return bool((scene.mat_albedo_tex >= 0).any()
                or (scene.mat_mr_tex >= 0).any()
                or (scene.mat_normal_tex >= 0).any())


def scene_flat_shading(scene: SceneData) -> bool:
    """Do the vertex normals equal the geometric normal on every real
    triangle? (Host-side numpy, as in the reference.)"""
    valid = scene.tri_valid.cpu().numpy()
    e1 = scene.tri_e1.cpu().numpy()[valid]
    e2 = scene.tri_e2.cpu().numpy()[valid]
    n = scene.tri_normals.cpu().numpy()[valid]  # [T, 3 corners, 3]
    g = np.cross(e1, e2)
    g = g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-20)
    return bool(np.all(np.abs(n - g[:, None, :]) < 1e-5))


def _resize_texture(pixels: np.ndarray, res: int) -> np.ndarray:
    """Bilinear resample [H, W, 4] -> [res, res, 4] via PIL."""
    if pixels.shape[0] == res and pixels.shape[1] == res:
        return pixels.astype(np.float32)
    from PIL import Image
    out = np.zeros((res, res, 4), np.float32)
    for c in range(4):
        img = Image.fromarray(pixels[..., c].astype(np.float32), mode="F")
        out[..., c] = np.asarray(img.resize((res, res), Image.BILINEAR))
    return out


def _mat_is_cutout_capable(mat, textures, texture_res) -> bool:
    """Does this material's albedo texture contain decoded alpha < 0.9?
    (the anyhit-cutout trigger, `devicePrograms.cu:534,543`; texture_res
    is unused, as in the reference)"""
    if mat.albedo_texture < 0 or mat.albedo_texture >= len(textures):
        return False
    alpha = np.asarray(textures[mat.albedo_texture].pixels)[..., 3]
    decoded = np.where(alpha <= 0.04045, alpha / 12.92,
                       ((alpha + 0.055) / 1.055) ** 2.4)
    return bool((decoded < 0.9).any())


def flatten_model(model: Model, lights=None, texture_res: int = TEXTURE_RES,
                  build_bvh: bool = True, device="cuda",
                  _split_cutout: bool = True) -> SceneData:
    """Bake a Model + lights into a SceneData on `device` (the GPU unless
    the caller asks for the CPU)."""
    device = _device(device)
    v0s, v1s, v2s, n_list, uv_list, mat_ids = [], [], [], [], [], []
    mats = []

    for mesh in model.meshes:
        m = mesh.model_matrix()
        pos = mesh.positions.astype(np.float64) @ m[:3, :3].T + m[:3, 3]
        if mesh.normals is not None:
            # rotation*scale part applied, then normalized
            # (reference `devicePrograms.cu:100`)
            nrm = mesh.normals.astype(np.float64) @ m[:3, :3].T
            nlen = np.linalg.norm(nrm, axis=-1, keepdims=True)
            nrm = nrm / np.maximum(nlen, 1e-20)
        else:
            nrm = None
        idx = mesh.indices.astype(np.int64)
        tv0, tv1, tv2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
        v0s.append(tv0)
        v1s.append(tv1)
        v2s.append(tv2)
        if nrm is not None:
            n_list.append(np.stack([nrm[idx[:, 0]], nrm[idx[:, 1]],
                                    nrm[idx[:, 2]]], axis=1))
        else:
            # the geometric normal at every corner
            gn = np.cross(tv1 - tv0, tv2 - tv0)
            gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True),
                                 1e-20)
            n_list.append(np.stack([gn, gn, gn], axis=1))
        if mesh.uvs is not None:
            uv = mesh.uvs.astype(np.float64)
            uv_list.append(np.stack([uv[idx[:, 0]], uv[idx[:, 1]],
                                     uv[idx[:, 2]]], axis=1))
        else:
            uv_list.append(np.zeros((len(idx), 3, 2)))
        mat_ids.append(np.full(len(idx), len(mats), np.int64))
        mats.append(mesh.material)

    v0 = np.concatenate(v0s).astype(np.float32)
    v1 = np.concatenate(v1s).astype(np.float32)
    v2 = np.concatenate(v2s).astype(np.float32)
    normals = np.concatenate(n_list).astype(np.float32)
    uvs = np.concatenate(uv_list).astype(np.float32)
    tri_mat = np.concatenate(mat_ids).astype(np.int32)
    t_real = len(v0)

    # --- BVH over real triangles, then reorder attributes to match leaves
    if build_bvh:
        tree = bvh_mod.build_bvh(v0, v1, v2)
        order = tree.tri_order
        tri_src_np = np.asarray(order, np.int32)
        v0, v1, v2 = v0[order], v1[order], v2[order]
        normals, uvs, tri_mat = normals[order], uvs[order], tri_mat[order]
        bvh_arrays = (tree.node_min, tree.node_max, tree.node_skip,
                      tree.node_first, tree.node_count)
        walk_arrays = _build_walk_arrays(
            v0, v1 - v0, v2 - v0, np.ones(len(v0), bool))
    else:
        bvh_arrays = (np.zeros((1, 3), np.float32),
                      np.zeros((1, 3), np.float32),
                      np.ones(1, np.int32), np.zeros(1, np.int32),
                      np.zeros(1, np.int32))
        walk_arrays = (np.zeros((0, 16, 1), np.float32),
                       np.zeros((6, 0), np.float32),
                       np.zeros((3, 0), np.int32),
                       np.zeros((6, 0), np.float32))
        tri_src_np = np.arange(t_real, dtype=np.int32)

    # --- pad to multiple (degenerate far-away triangles never hit)
    t_pad = -(-t_real // PAD_MULTIPLE) * PAD_MULTIPLE
    pad = t_pad - t_real

    def _pad(a, fill=0.0):
        return np.concatenate(
            [a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) if pad else a

    e1 = _pad(v1 - v0, 0.0)
    e2 = _pad(v2 - v0, 0.0)
    v0 = _pad(v0, 1e10)
    normals = _pad(normals, 0.0)
    uvs = _pad(uvs, 0.0)
    tri_mat = _pad(tri_mat, 0)
    tri_valid = np.concatenate(
        [np.ones(t_real, bool), np.zeros(pad, bool)])

    # --- material table
    mat_albedo = np.stack([mt.base_color for mt in mats]).astype(np.float32)
    mat_metallic = np.array([mt.metallic for mt in mats], np.float32)
    mat_roughness = np.array([mt.roughness for mt in mats], np.float32)
    mat_ior = np.array([mt.ior for mt in mats], np.float32)
    mat_type = np.array([MATERIAL_NAMES[mt.mat_type] for mt in mats],
                        np.int32)
    mat_albedo_tex = np.array([mt.albedo_texture for mt in mats], np.int32)
    mat_mr_tex = np.array([mt.metal_rough_texture for mt in mats], np.int32)
    mat_normal_tex = np.array([mt.normal_texture for mt in mats], np.int32)

    # --- textures
    if model.textures:
        tex = np.stack([_resize_texture(t.pixels, texture_res)
                        for t in model.textures])
    else:
        tex = np.zeros((1, texture_res, texture_res, 4), np.float32)

    # --- lights
    lights = lights or []
    if lights:
        light_pos = np.stack([np.asarray(l.position, np.float32)
                              for l in lights])
        light_color = np.stack([np.asarray(l.color, np.float32)
                                for l in lights])
    else:
        light_pos = np.zeros((0, 3), np.float32)
        light_color = np.zeros((0, 3), np.float32)

    # --- opaque/cutout scene split for the occlusion and closest fast paths
    opaque_scene = cutout_sub = None
    if _split_cutout and build_bvh and model.textures:
        cut_flags = [_mat_is_cutout_capable(m.material, model.textures,
                                            texture_res)
                     for m in model.meshes]
        cut_meshes = [m for m, f in zip(model.meshes, cut_flags) if f]
        opq_meshes = [m for m, f in zip(model.meshes, cut_flags) if not f]
        if cut_meshes and opq_meshes:
            # pre-BVH triangle index ranges of each mesh in the OUTER
            # concat order, for mapping sub-scene hits to outer ids
            mesh_tris = [len(m.indices) for m in model.meshes]
            starts = np.concatenate([[0], np.cumsum(mesh_tris)[:-1]])
            outer_pre_to_post = np.full(t_real, -1, np.int32)
            outer_pre_to_post[tri_src_np] = np.arange(t_real, dtype=np.int32)

            def _sub(meshes, flags_sel):
                sub = flatten_model(
                    Model(meshes=meshes, textures=model.textures), [],
                    texture_res, build_bvh, device, _split_cutout=False)
                pre_map = np.concatenate(
                    [np.arange(starts[i], starts[i] + mesh_tris[i],
                               dtype=np.int32)
                     for i, f in enumerate(cut_flags) if f == flags_sel]
                ) if meshes else np.zeros(0, np.int32)
                src = sub.tri_src.cpu().numpy()
                outer_id = np.full(len(src), -1, np.int32)
                valid = src >= 0
                outer_id[valid] = outer_pre_to_post[pre_map[src[valid]]]
                sub.tri_outer_id = torch.as_tensor(outer_id, device=device)
                return sub

            opaque_scene = _sub(opq_meshes, False)
            cutout_sub = _sub(cut_meshes, True)

    tri_src_pad = np.concatenate(
        [tri_src_np, np.full(pad, -1, np.int32)]) if pad else tri_src_np

    def _t(a):  # C order: the kernels take contiguous tensors
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return SceneData(
        opaque_scene=opaque_scene, cutout_sub=cutout_sub,
        tri_src=_t(tri_src_pad),
        tri_v0=_t(v0), tri_e1=_t(e1), tri_e2=_t(e2),
        tri_normals=_t(normals), tri_uvs=_t(uvs),
        tri_mat=_t(tri_mat), tri_valid=_t(tri_valid),
        mat_albedo=_t(mat_albedo), mat_metallic=_t(mat_metallic),
        mat_roughness=_t(mat_roughness), mat_ior=_t(mat_ior),
        mat_type=_t(mat_type), mat_albedo_tex=_t(mat_albedo_tex),
        mat_mr_tex=_t(mat_mr_tex), mat_normal_tex=_t(mat_normal_tex),
        textures=_t(tex),
        light_pos=_t(light_pos), light_color=_t(light_color),
        bvh_min=_t(bvh_arrays[0]), bvh_max=_t(bvh_arrays[1]),
        bvh_skip=_t(bvh_arrays[2]), bvh_first=_t(bvh_arrays[3]),
        bvh_count=_t(bvh_arrays[4]),
        walk_tris=_t(walk_arrays[0]), walk_node_box=_t(walk_arrays[1]),
        walk_node_link=_t(walk_arrays[2]), walk_sub_box=_t(walk_arrays[3]),
    )

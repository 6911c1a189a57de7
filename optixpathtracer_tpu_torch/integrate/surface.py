"""Hit -> shading context (port of `optixpathtracer_tpu/integrate/surface.py`,
reference closest-hit preamble `devicePrograms.cu:343-424`): barycentric
interpolation, face-forwarded geometric and shading normals with the
backface flip, texture modulation (albedo sRGB decode, metal/rough
channels, normal map), material resolution and the shading frame.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..bsdf.dispatch import MaterialParams, resolve_stochastic_lobe
from ..core.math import (build_tangent_space, cross, dot, normalize,
                         to_local, to_world)
from ..scene.textures import sample_bilinear, srgb_to_linear


class Surface(NamedTuple):
    """Per-lane hit-point bundle (reference `Surface.h:5-21`)."""
    position: torch.Tensor   # [R, 3] world
    g_normal: torch.Tensor   # [R, 3] geometric normal (outward convention)
    s_normal: torch.Tensor   # [R, 3] shading normal
    tangent: torch.Tensor    # [R, 3]
    bitangent: torch.Tensor  # [R, 3]
    wo_local: torch.Tensor   # [R, 3] outgoing direction in shading space
    uv: torch.Tensor         # [R, 2]
    mat: MaterialParams      # resolved per-lane material

    def to_world(self, v_local):
        return to_world(self.tangent, self.bitangent, self.s_normal, v_local)

    def to_local(self, v_world):
        return to_local(self.tangent, self.bitangent, self.s_normal, v_world)


def make_surface(seed, scene, o, d, hit, reference_compat: bool = False,
                 use_textures: bool = True, flat_shading: bool = False):
    """Build the shading context for every lane (misses produce values that
    callers mask with hit.hit). Returns (seed, Surface).

    use_textures=False (from scene_uses_textures) skips every texture
    gather and the per-corner uv gather. flat_shading=True (static, from
    scene_flat_shading) uses the geometric normal as the shading normal
    instead of interpolating corner normals.

    reference_compat=True reproduces two reference bugs: metallic read from
    the texture's R channel instead of glTF's B (`devicePrograms.cu:163`),
    and the metal-rough and normal has-flags taken from the albedo
    texture's (`OptixRenderer.cpp:535,540`)."""
    safe_id = hit.tri_id.clamp(min=0).long()
    v0 = scene.tri_v0[safe_id]
    e1 = scene.tri_e1[safe_id]
    e2 = scene.tri_e2[safe_id]
    mat_id = scene.tri_mat[safe_id].long()

    u = hit.u[..., None]
    v = hit.v[..., None]
    w0 = 1.0 - u - v

    wo = normalize(-d)
    position = v0 + u * e1 + v * e2
    if use_textures:
        tri_uv = scene.tri_uvs[safe_id]      # [R, 3, 2]
        uv = w0 * tri_uv[:, 0] + u * tri_uv[:, 1] + v * tri_uv[:, 2]
    else:
        uv = torch.zeros(position.shape[:-1] + (2,), device=position.device)

    # geometric normal, face-forwarded to wo (`devicePrograms.cu:92,107-108`)
    ng = normalize(cross(e1, e2))
    ng = torch.where(dot(wo, ng)[..., None] < 0.0, -ng, ng)

    if flat_shading:
        ns = ng
    else:
        # interpolated vertex normals, flipped into ng's hemisphere
        # (`devicePrograms.cu:96-113`)
        tri_n = scene.tri_normals[safe_id]   # [R, 3, 3]
        ns = normalize(w0 * tri_n[:, 0] + u * tri_n[:, 1] + v * tri_n[:, 2])
        no_ns = ns.abs().sum(dim=-1, keepdim=True) < 1e-12
        ns = torch.where(no_ns, ng, ns)
        ns = torch.where(dot(ng, ns)[..., None] < 0.0, -ns, ns)
        ns = normalize(ns)

    # backface hits flip both normals outward (`devicePrograms.cu:379-382`)
    back = hit.back_face[..., None]
    ng = torch.where(back, -ng, ng)
    ns = torch.where(back, -ns, ns)

    # material and textures (`devicePrograms.cu:143-166,390-409`)
    albedo = scene.mat_albedo[mat_id]
    metallic = scene.mat_metallic[mat_id]
    roughness = scene.mat_roughness[mat_id]
    ior = scene.mat_ior[mat_id]
    mat_type = scene.mat_type[mat_id]

    if use_textures:
        albedo_tex = scene.mat_albedo_tex[mat_id]
        if reference_compat:
            # the reference's SBT keys every has-flag off the albedo texture
            mr_tex = torch.where(albedo_tex >= 0, scene.mat_mr_tex[mat_id], -1)
            nrm_tex = torch.where(albedo_tex >= 0,
                                  scene.mat_normal_tex[mat_id], -1)
        else:
            mr_tex = scene.mat_mr_tex[mat_id]
            nrm_tex = scene.mat_normal_tex[mat_id]

        has_albedo = albedo_tex >= 0
        tex_a = srgb_to_linear(sample_bilinear(scene.textures, albedo_tex,
                                               uv[..., 0], uv[..., 1]))
        albedo = torch.where(has_albedo[..., None], albedo * tex_a[..., :3],
                             albedo)

        has_mr = mr_tex >= 0
        tex_mr = sample_bilinear(scene.textures, mr_tex, uv[..., 0],
                                 uv[..., 1])
        if reference_compat:
            # the reference reads metallic from R (`devicePrograms.cu:163`)
            metallic = torch.where(has_mr, tex_mr[..., 0], metallic)
            rough_from_tex = tex_mr[..., 1]
        else:
            # glTF: metallic = B, roughness = G, each times its factor
            metallic = torch.where(has_mr, metallic * tex_mr[..., 2],
                                   metallic)
            rough_from_tex = roughness * tex_mr[..., 1]
        roughness = torch.where(has_mr, rough_from_tex, roughness)

        # normal mapping in a tangent frame built from the shading normal
        # (`devicePrograms.cu:168-212,403-409`; the mesh tangents are
        # ignored, as in the reference)
        has_nrm = nrm_tex >= 0
        tex_n = sample_bilinear(scene.textures, nrm_tex, uv[..., 0],
                                uv[..., 1])
        t0, b0 = build_tangent_space(ns)
        mapped = normalize(to_world(t0, b0, ns, tex_n[..., :3] * 2.0 - 1.0))
        ns = torch.where(has_nrm[..., None], mapped, ns)

    mat = MaterialParams(albedo=albedo, metallic=metallic,
                         roughness=roughness, ior=ior, mat_type=mat_type)

    # final shading frame (`devicePrograms.cu:412-416`)
    tangent, bitangent = build_tangent_space(ns)
    wo_local = to_local(tangent, bitangent, ns, wo)

    # stochastic conductor-vs-layered pick for METALLIC_MIX lanes
    # (`devicePrograms.cu:400`), one draw per hit
    seed, mat = resolve_stochastic_lobe(seed, mat)

    return seed, Surface(position=position, g_normal=ng, s_normal=ns,
                         tangent=tangent, bitangent=bitangent,
                         wo_local=wo_local, uv=uv, mat=mat)

"""The plain reference path tracer: camera rays, closest hit, the shading
context, next-event estimation toward one uniformly picked point light,
BSDF sampling and the throughput update, for any set of (pixel, frame)
lanes, and the running-mean accumulation and the material-fitting step
built on it.

The semantics are those of the program's `integrate/path.py` with the
options `render` derives from the scene (no ray or material sort; albedo
textures where a material has one; alpha cutout where a used albedo
texture has holes, `reference/cutout.py`; the geometric normal for
shading where every corner normal is its triangle's, else interpolated
normals), written out again in plain PyTorch over the frozen lobes of this
folder (diffuse, conductor, dielectric, glossy-diffuse, and metallic-mix
as conductor or glossy-diffuse by one draw a hit) and the intersection of
`reference/intersect.py`. Every pixel's path is independent of the
others, so lanes are worked in blocks of any size.

`Precision` lowers the reference for the control that `correct` is
checked against: in bfloat16 mode every stored floating-point tensor (the
scene, the camera, the rays, throughput and radiance after each bounce,
the frames and the accumulator) is rounded to bfloat16.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import conductor as _conductor
from . import cutout
from . import dielectric as _dielectric
from . import diffuse as _diffuse
from . import glossy_diffuse as _glossy
from . import intersect, rng
from .base import BSDFSample, where_sample
from .pmath import (abs_cos_theta, build_tangent_space, cross, div, dot,
                    length, length_sqr, normalize, to_local, to_world)
from .textures import sample_bilinear, srgb_to_linear

RAY_TMAX = 100.0
SHADOW_OFFSET = 1e-3
BETA_EPS = 1e-5
DIFFUSE, CONDUCTOR, DIELECTRIC, GLOSSY_DIFFUSE, METALLIC_MIX = range(5)
LANES_PER_BLOCK = 1 << 20


class Precision:
    """Identity in float32; in bfloat16 mode rounds every float tensor it
    is handed to bfloat16 (kept in a float32 tensor)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "bfloat16"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def __call__(self, x):
        if self.name == "float32" or not x.is_floating_point():
            return x
        return x.to(torch.bfloat16).to(x.dtype)


FP32 = Precision()


def lowered(scene, q: Precision):
    """The scene with every float array passed through q."""
    return scene.replace(**{
        k: q(getattr(scene, k)) for k in (
            "tri_v0", "tri_e1", "tri_e2", "tri_normals", "tri_uvs",
            "mat_albedo", "mat_metallic", "mat_roughness", "mat_ior",
            "textures", "light_pos", "light_color")})


def active_lobes(scene):
    """The lobes present in the material table."""
    lobes = set()
    for t in set(int(t) for t in scene.mat_type.cpu().tolist()):
        lobes.update((CONDUCTOR, GLOSSY_DIFFUSE) if t == METALLIC_MIX
                     else (t,))
    unknown = lobes - {DIFFUSE, CONDUCTOR, DIELECTRIC, GLOSSY_DIFFUSE}
    if unknown:
        raise NotImplementedError(f"the reference has no lobe {unknown}")
    return tuple(sorted(lobes))


class Mat(NamedTuple):
    albedo: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    ior: torch.Tensor
    mat_type: torch.Tensor


def _mirror_z(v):
    return torch.cat([v[..., :2], -v[..., 2:]], dim=-1)


# The program's dispatch (`bsdf/dispatch.py`): every lobe present is
# evaluated on every lane in this order and lane-selected. The one-sided
# lobes (diffuse, conductor) see wo and wi mirrored through the tangent
# plane where wo.z < 0; the dielectric and the layered lobe take the true
# orientation. The dielectric is tinted by the albedo.

def bsdf_f(seed, mat, wo, wi, lobes):
    """BSDF value per lane; only the layered lobe hands its seed on."""
    t = mat.mat_type[..., None]
    flip = (wo[..., 2] < 0.0)[..., None]
    wo_m = torch.where(flip, _mirror_z(wo), wo)
    wi_m = torch.where(flip, _mirror_z(wi), wi)
    out = torch.zeros(wo.shape[:-1] + (3,), device=wo.device)
    if DIFFUSE in lobes:
        out = torch.where(t == DIFFUSE, _diffuse.f(mat.albedo, wo_m, wi_m),
                          out)
    if CONDUCTOR in lobes:
        out = torch.where(t == CONDUCTOR, _conductor.f(
            mat.albedo, mat.roughness, wo_m, wi_m), out)
    if DIELECTRIC in lobes:
        out = torch.where(t == DIELECTRIC, _dielectric.f(
            mat.roughness, wo, wi, eta=mat.ior) * mat.albedo, out)
    if GLOSSY_DIFFUSE in lobes:
        seed, f_g = _glossy.f(seed, mat.albedo, mat.roughness, wo, wi,
                              eta=mat.ior)
        out = torch.where(t == GLOSSY_DIFFUSE, f_g, out)
    return seed, out


def bsdf_sample(seed, mat, wo, lobes):
    """BSDF sample per lane; every lobe present hands its seed on."""
    t = mat.mat_type
    flip = (wo[..., 2] < 0.0)[..., None]
    wo_m = torch.where(flip, _mirror_z(wo), wo)

    def unflip(s):
        return s._replace(direction=torch.where(flip, _mirror_z(s.direction),
                                                s.direction))

    out = BSDFSample.invalid(wo.shape[:-1], wo.device)
    if DIFFUSE in lobes:
        seed, s = _diffuse.sample(seed, mat.albedo, wo_m)
        out = where_sample(t == DIFFUSE, unflip(s), out)
    if CONDUCTOR in lobes:
        seed, s = _conductor.sample(seed, mat.albedo, mat.roughness, wo_m)
        out = where_sample(t == CONDUCTOR, unflip(s), out)
    if DIELECTRIC in lobes:
        seed, s = _dielectric.sample(seed, mat.roughness, wo, eta=mat.ior)
        out = where_sample(t == DIELECTRIC,
                           s._replace(color=s.color * mat.albedo), out)
    if GLOSSY_DIFFUSE in lobes:
        seed, s = _glossy.sample(seed, mat.albedo, mat.roughness, wo,
                                 eta=mat.ior)
        out = where_sample(t == GLOSSY_DIFFUSE, s, out)
    return seed, out


def albedo_at(scene, mat_id, albedo, u, v, tri_id):
    """The albedo times the decoded albedo texture at the hit's uv, where
    the material has one."""
    tri_uv = scene.tri_uvs[tri_id]
    w0 = 1.0 - u - v
    uv = w0 * tri_uv[:, 0] + u * tri_uv[:, 1] + v * tri_uv[:, 2]
    tex_id = scene.mat_albedo_tex[mat_id]
    texel = srgb_to_linear(sample_bilinear(scene.textures, tex_id,
                                           uv[..., 0], uv[..., 1]))
    return torch.where((tex_id >= 0)[..., None], albedo * texel[..., :3],
                       albedo)


def surface(seed, scene, d, tri_id, u, v, back_face):
    """(seed, position, g_normal, (tangent, bitangent, s_normal), wo_local,
    mat) at the hit of each lane."""
    safe = tri_id.clamp(min=0)
    e1 = scene.tri_e1[safe]
    e2 = scene.tri_e2[safe]
    mat_id = scene.tri_mat[safe]
    u = u[..., None]
    v = v[..., None]
    w0 = 1.0 - u - v
    wo = normalize(-d)
    position = scene.tri_v0[safe] + u * e1 + v * e2
    ng = normalize(cross(e1, e2))
    ng = torch.where(dot(wo, ng)[..., None] < 0.0, -ng, ng)
    if scene.flat_shading:
        ns = ng
    else:
        tri_n = scene.tri_normals[safe]
        ns = normalize(w0 * tri_n[:, 0] + u * tri_n[:, 1] + v * tri_n[:, 2])
        ns = torch.where(ns.abs().sum(dim=-1, keepdim=True) < 1e-12, ng, ns)
        ns = torch.where(dot(ng, ns)[..., None] < 0.0, -ns, ns)
        ns = normalize(ns)
    back = back_face[..., None]
    ng = torch.where(back, -ng, ng)
    ns = torch.where(back, -ns, ns)
    albedo = scene.mat_albedo[mat_id]
    if bool((scene.mat_albedo_tex >= 0).any()):
        albedo = albedo_at(scene, mat_id, albedo, u, v, safe)
    mat = Mat(albedo, scene.mat_metallic[mat_id],
              scene.mat_roughness[mat_id], scene.mat_ior[mat_id],
              scene.mat_type[mat_id])
    tangent, bitangent = build_tangent_space(ns)
    wo_local = to_local(tangent, bitangent, ns, wo)
    # the metallic-mix lobe pick draws on every lane
    seed, r = rng.rnd(seed)
    picked = torch.where(r < mat.metallic, CONDUCTOR, GLOSSY_DIFFUSE)
    mat = mat._replace(mat_type=torch.where(
        mat.mat_type == METALLIC_MIX, picked, mat.mat_type).to(torch.int32))
    return seed, position, ng, (tangent, bitangent, ns), wo_local, mat


def trace(scene, o, d, seed, bounces, lobes, q=FP32):
    """Radiance [R, 3] of one path per lane."""
    r = o.shape[0]
    radiance = torch.zeros((r, 3), device=o.device)
    beta = torch.ones((r, 3), device=o.device)
    alive = torch.ones((r,), dtype=torch.bool, device=o.device)
    n_lights = scene.light_pos.shape[0]
    if n_lights == 0:
        raise NotImplementedError("the reference traces scenes with lights")
    query = cutout if cutout.uses_alpha_cutout(scene) else intersect
    for bounce in range(bounces):
        tmax = (torch.where(alive, RAY_TMAX, -1.0) if bounce else
                torch.full((r,), RAY_TMAX, device=o.device))
        tri, _ = query.closest(scene, o.detach(), d.detach(), 0.0, tmax)
        _, u, v, hit, back = intersect.refine(scene, o, d, tri, tmax)
        alive = alive & hit
        seed, pos, ng, frame, wo_local, mat = surface(seed, scene, d, tri, u,
                                                      v, back)
        # next-event estimation toward one light picked uniformly (a
        # single light takes no draw)
        if n_lights > 1:
            seed, ul = rng.rnd(seed)
            light = (ul * n_lights).to(torch.long).clamp(max=n_lights - 1)
        else:
            light = torch.zeros((r,), dtype=torch.long, device=o.device)
        lp = scene.light_pos[light]
        lc = scene.light_color[light]
        to_light = lp - pos
        dist = length(to_light)
        wl = normalize(to_light)
        toward = torch.where(dot(wl, ng) < 0.0, -1.0, 1.0)
        shadow_o = pos + (SHADOW_OFFSET * toward)[..., None] * ng
        blocked = query.occluded(scene, shadow_o.detach(), wl.detach(), 0.0,
                                 torch.where(alive, dist, -1.0).detach())
        visible = ~blocked & alive
        wl_local = to_local(*frame, wl)
        seed, f_val = bsdf_f(seed, mat, wo_local, wl_local, lobes)
        lrad = lc / torch.clamp(length_sqr(to_light), min=1e-12)[..., None]
        contrib = div(beta * f_val * wl_local[..., 2].abs()[..., None] * lrad,
                      1.0 / n_lights)
        contrib = torch.where(visible[..., None], contrib, 0.0)
        radiance = radiance + torch.where(alive[..., None], contrib, 0.0)
        # BSDF sample and throughput update
        seed, bs = bsdf_sample(seed, mat, wo_local, lobes)
        ok = bs.valid & (bs.pdf > 0.0)
        new_beta = (beta * bs.color * abs_cos_theta(bs.direction)[..., None]
                    / torch.where(bs.pdf == 0.0, 1.0, bs.pdf)[..., None])
        alive = alive & ok
        wi_world = normalize(to_world(*frame, bs.direction))
        sign = torch.where(bs.direction[..., 2] < 0.0, -1.0, 1.0)
        new_o = pos + (SHADOW_OFFSET * sign)[..., None] * ng
        beta = q(torch.where(alive[..., None], new_beta, beta))
        o = q(torch.where(alive[..., None], new_o, o))
        d = q(torch.where(alive[..., None], wi_world, d))
        alive = alive & (length(beta) > BETA_EPS)
        radiance = q(radiance)
    return radiance


def camera_rays(cam, width, height, px, py, q=FP32):
    """World-space rays through pixel centres px, py (float32 [N]); row 0
    is the bottom row. The 4x4 products are written out term by term in
    index order, each rounded to float32."""
    position, inv_view, inv_proj = (q(c) for c in cam)
    x_ndc = div(px + 0.5, float(width)) * 2.0 - 1.0
    y_ndc = div(py + 0.5, float(height)) * 2.0 - 1.0
    one = torch.ones_like(x_ndc)

    def mat_vec(m, x):
        out = []
        for j in range(4):
            acc = x[0] * m[j, 0]
            for k in range(1, 4):
                acc = acc + x[k] * m[j, k]
            out.append(acc)
        return out

    p_view = mat_vec(inv_proj, (x_ndc, y_ndc, one, one))
    p_view[3] = torch.zeros_like(x_ndc)
    p_world = mat_vec(inv_view, p_view)
    d = normalize(torch.stack(p_world[:3], dim=-1))
    return q(position.expand_as(d)), q(d)


def radiance_of(scene, cam, width, height, px, py, frame_ids, bounces,
                q=FP32):
    """Radiance [N, 3] of the 1-spp paths of lanes (px, py, frame id), in
    blocks of LANES_PER_BLOCK lanes. px, py: int64 [N]; frame_ids: int64."""
    lobes = active_lobes(scene)
    scene = lowered(scene, q)
    out = []
    for b in range(0, px.shape[0], LANES_PER_BLOCK):
        x = px[b:b + LANES_PER_BLOCK]
        y = py[b:b + LANES_PER_BLOCK]
        o, d = camera_rays(cam, width, height, x.to(torch.float32),
                           y.to(torch.float32), q)
        seed = rng.pixel_seed(width, x, y, frame_ids[b:b + LANES_PER_BLOCK])
        out.append(q(trace(scene, o, d, seed, bounces, lobes, q)))
    return torch.cat(out)


@torch.no_grad()
def accumulate(scene, cam, width, height, px, py, first_frame, n_frames,
               bounces, q=FP32):
    """The running mean acc + (frame - acc) / (s + 1) over frames
    first_frame .. first_frame + n_frames - 1, started from zero, at the
    pixels (px, py): [P, 3]."""
    p = px.shape[0]
    frames = torch.arange(first_frame, first_frame + n_frames,
                          device=px.device)
    lanes = radiance_of(scene, cam, width, height, px.repeat(n_frames),
                        py.repeat(n_frames), frames.repeat_interleave(p),
                        bounces, q).reshape(n_frames, p, 3)
    acc = torch.zeros((p, 3), device=px.device)
    for i in range(n_frames):
        count = torch.tensor(first_frame + i, dtype=torch.float32,
                             device=px.device)
        acc = q(acc + (lanes[i] - acc) / (count + 1.0))
    return acc


FIT_FIELDS = ("mat_albedo", "mat_metallic", "mat_roughness", "mat_ior")


def fit_step(scene, cam, target, frame_id, bounces, lr, rows_per_block,
             q=FP32, rows=None):
    """One material-fitting step: the L2 loss (mean over the image) of a
    1-spp frame against target [H, W, 3], its gradient with respect to the
    material table by autograd, taken in blocks of rows, and the SGD update
    clamped as the program clamps it. Returns (new material fields, loss,
    {field: gradient}). `rows` (default: all) takes the loss over only the
    first that many rows, its mean over them: a fault for the check's
    readings, never the program's semantics."""
    h, w = target.shape[:2]
    rows_taken = h if rows is None else rows
    params = {f: getattr(scene, f).detach().clone().requires_grad_(True)
              for f in FIT_FIELDS}
    grads = [torch.zeros_like(p) for p in params.values()]
    loss = torch.zeros((), device=target.device)
    lobes = active_lobes(scene)
    for y0 in range(0, rows_taken, rows_per_block):
        rows = min(rows_per_block, rows_taken - y0)
        py, px = torch.meshgrid(
            torch.arange(y0, y0 + rows, device=target.device),
            torch.arange(w, device=target.device), indexing="ij")
        px = px.reshape(-1)
        py = py.reshape(-1)
        sc = lowered(scene.replace(
            **{f: q(p) for f, p in params.items()}), q)
        o, d = camera_rays(cam, w, h, px.to(torch.float32),
                           py.to(torch.float32), q)
        seed = rng.pixel_seed(w, px, py, torch.full_like(px, frame_id))
        img = q(trace(sc, o, d, seed, bounces, lobes, q)).reshape(rows, w, 3)
        err = img - target[y0:y0 + rows]
        part = div((err * err).sum(), float(rows_taken * w * 3))
        g = torch.autograd.grad(part, list(params.values()),
                                allow_unused=True)
        grads = [a if b is None else a + b for a, b in zip(grads, g)]
        loss = loss + part.detach()
    new = {f: q(getattr(scene, f).detach() - lr * g)
           for f, g in zip(FIT_FIELDS, grads)}
    for f in ("mat_albedo", "mat_roughness", "mat_metallic"):
        new[f] = torch.clamp(new[f], 0.0, 1.0)
    return new, loss, dict(zip(FIT_FIELDS, grads))

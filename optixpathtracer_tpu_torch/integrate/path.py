"""Wavefront path integrator with next-event estimation
(port of `optixpathtracer_tpu/integrate/path.py`).

Rays, throughput and radiance live as SoA tensors over the whole
wavefront; each bounce is one batched pass (closest hit -> surface -> NEE
shadow query + BSDF f -> BSDF sample -> throughput update), with per-lane
`alive` masks in place of the reference's endPath/break control flow.

Reference semantics kept (SURVEY.md quirk list): point-light falloff
color/d^2 with no 1/4pi, uniform light pick with pdf 1/N, NEE not
MIS-weighted, miss -> black, ray tmax = 100, kill threshold |beta| > 1e-5,
1e-3 geometric-normal ray offsets, per-(pixel, frame) TEA seeding.

Forward only: rendering runs under torch.no_grad(). With
`use_alpha_cutout` (the default for scenes with cutout texels) closest hits
and shadow rays go through `integrate/cutout.py`. The ray sort
(`sort_rays`), segmented shading (`compact_shading`), material sort and
`debug_pixel` are not ported yet and raise NotImplementedError.
"""
from __future__ import annotations

import torch

from ..bsdf import dispatch
from ..camera.camera import generate_rays
from ..core import rng
from ..core.math import abs_cos_theta, div, dot, length, length_sqr, normalize
from ..intersect import intersect_any, intersect_closest
from .cutout import (intersect_any_cutout, intersect_closest_cutout,
                     scene_uses_alpha_cutout)
from .surface import make_surface

RAY_TMAX = 100.0
SHADOW_OFFSET = 1e-3
BETA_EPS = 1e-5


def _nee(seed, scene, surf, beta, alive, intersect_method, active_lobes,
         use_alpha_cutout=False):
    """Direct light from one uniformly picked point light
    (`devicePrograms.cu:444-472`, `LightMethods.h`). Returns (seed,
    contrib)."""
    n_lights = scene.light_pos.shape[0]
    if n_lights == 0:
        return seed, torch.zeros_like(beta)

    if n_lights == 1:
        light_idx = torch.zeros(beta.shape[0], dtype=torch.long,
                                device=beta.device)
        p_light = 1.0
    else:
        seed, u = rng.rnd(seed)
        light_idx = (u * n_lights).to(torch.long).clamp(max=n_lights - 1)
        p_light = 1.0 / n_lights

    lp = scene.light_pos[light_idx]
    lc = scene.light_color[light_idx]

    to_light = lp - surf.position
    dist = length(to_light)
    wl = normalize(to_light)

    # Shadow ray offset along the geometric normal toward the light's side.
    # Dead lanes get tmax = -1, so the intersection kernels skip them.
    toward_light = torch.where(dot(wl, surf.g_normal) < 0.0, -1.0, 1.0)
    shadow_o = (surf.position
                + (SHADOW_OFFSET * toward_light)[..., None] * surf.g_normal)
    shadow_tmax = torch.where(alive, dist, -1.0)
    if use_alpha_cutout:
        blocked = intersect_any_cutout(scene, shadow_o, wl, 0.0, shadow_tmax,
                                       method=intersect_method)
    else:
        blocked = intersect_any(scene, shadow_o, wl, 0.0, shadow_tmax,
                                method=intersect_method)
    visible = ~blocked & alive

    wl_local = surf.to_local(wl)
    seed, f_val = dispatch.f(seed, surf.mat, surf.wo_local, wl_local,
                             active_lobes)
    cos_term = wl_local[..., 2].abs()

    # L = color / d^2 (`LightMethods.h:17-23`)
    radiance = lc / torch.clamp(length_sqr(to_light), min=1e-12)[..., None]
    contrib = div(beta * f_val * cos_term[..., None] * radiance, p_light)
    return seed, torch.where(visible[..., None], contrib, 0.0)


def _shade_wave(scene, o, d, seed, hit, beta, alive, radiance,
                reference_compat, use_textures, flat_shading,
                intersect_method, active_lobes, use_alpha_cutout):
    """Surface context, NEE, BSDF sample and throughput/ray update for one
    wavefront. Returns (seed, radiance, beta, o, d, alive)."""
    seed, surf = make_surface(seed, scene, o, d, hit,
                              reference_compat=reference_compat,
                              use_textures=use_textures,
                              flat_shading=flat_shading)

    seed, nee_contrib = _nee(seed, scene, surf, beta, alive,
                             intersect_method, active_lobes,
                             use_alpha_cutout)
    radiance = radiance + torch.where(alive[..., None], nee_contrib, 0.0)

    seed, bs = dispatch.sample(seed, surf.mat, surf.wo_local, active_lobes)
    ok = bs.valid & (bs.pdf > 0.0)
    new_beta = (beta * bs.color * abs_cos_theta(bs.direction)[..., None]
                / torch.where(bs.pdf == 0.0, 1.0, bs.pdf)[..., None])
    alive = alive & ok

    wi_world = normalize(surf.to_world(bs.direction))
    offset_sign = torch.where(bs.direction[..., 2] < 0.0, -1.0, 1.0)
    new_o = (surf.position
             + (SHADOW_OFFSET * offset_sign)[..., None] * surf.g_normal)

    beta = torch.where(alive[..., None], new_beta, beta)
    o = torch.where(alive[..., None], new_o, o)
    d = torch.where(alive[..., None], wi_world, d)
    alive = alive & (length(beta) > BETA_EPS)
    return seed, radiance, beta, o, d, alive


def _not_ported(debug_pixel, sort_rays, compact_shading, material_sort):
    opts = {"debug_pixel": debug_pixel, "sort_rays": sort_rays,
            "compact_shading": compact_shading,
            "material_sort": material_sort}
    given = [k for k, v in opts.items() if v not in (None, False, 0)]
    if given:
        raise NotImplementedError(
            f"trace_paths options {given} are not ported yet")


def trace_paths(scene, o, d, seed, max_bounces: int,
                intersect_method: str = "auto",
                reference_compat: bool = False,
                active_lobes=dispatch.ALL_LOBES,
                use_textures: bool = True,
                use_alpha_cutout: bool = False,
                debug_pixel: int | None = None,
                sort_rays: bool | None = None,
                flat_shading: bool = False,
                compact_shading: int = 0,
                material_sort: int = 0):
    """Trace one path per lane. o, d: [R, 3]; seed: [R] (int64 holding
    u32). Returns (radiance [R, 3], seed)."""
    _not_ported(debug_pixel, sort_rays, compact_shading, material_sort)
    r = o.shape[0]
    radiance = torch.zeros((r, 3), device=o.device)
    beta = torch.ones((r, 3), device=o.device)
    alive = torch.ones((r,), dtype=torch.bool, device=o.device)

    for bounce in range(max_bounces):
        # Dead lanes trace with tmax = -1: they cannot hit anything, and
        # the dense kernels skip them.
        ray_tmax = (torch.where(alive, RAY_TMAX, -1.0) if bounce
                    else RAY_TMAX)
        # Secondary bounces carry the "auto:bounce" routing hint.
        closest_method = ("auto:bounce" if bounce
                          and intersect_method == "auto"
                          else intersect_method)
        if use_alpha_cutout:
            hit = intersect_closest_cutout(scene, o, d, 0.0, ray_tmax,
                                           method=closest_method)
        else:
            hit = intersect_closest(scene, o, d, 0.0, ray_tmax,
                                    method=closest_method)
        # miss -> background is black; the path dies with radiance unchanged
        alive = alive & hit.hit
        # the NEE shadow query inherits the bounce hint too
        seed, radiance, beta, o, d, alive = _shade_wave(
            scene, o, d, seed, hit, beta, alive, radiance, reference_compat,
            use_textures, flat_shading, closest_method, active_lobes,
            use_alpha_cutout)
    return radiance, seed


@torch.no_grad()
def render_sample(scene, cam_position, cam_inv_view, cam_inv_proj,
                  width: int, height: int, frame_id,
                  max_bounces: int = 2,
                  intersect_method: str = "auto",
                  reference_compat: bool = False,
                  active_lobes=dispatch.ALL_LOBES,
                  use_textures: bool = True,
                  use_alpha_cutout: bool = False,
                  debug_pixel: int | None = None,
                  sort_rays: bool | None = None,
                  flat_shading: bool = False,
                  compact_shading: int = 0,
                  material_sort: int = 0):
    """Render one 1-spp frame: [H, W, 3] linear radiance (row 0 = bottom,
    GL convention like the reference framebuffer)."""
    o, d = generate_rays(cam_position, cam_inv_view, cam_inv_proj,
                         width, height)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    dev = o.device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    seed = rng.pixel_seed(width, xs.reshape(-1), ys.reshape(-1),
                          int(frame_id))
    radiance, _ = trace_paths(scene, o, d, seed, max_bounces,
                              intersect_method, reference_compat,
                              active_lobes, use_textures,
                              use_alpha_cutout, debug_pixel,
                              sort_rays, flat_shading, compact_shading,
                              material_sort)
    return radiance.reshape(height, width, 3)


@torch.no_grad()
def render_chunk(scene, cam_position, cam_inv_view, cam_inv_proj,
                 width: int, height: int, accum, start_frame: int,
                 chunk: int, max_bounces: int = 2,
                 intersect_method: str = "auto",
                 reference_compat: bool = False,
                 active_lobes=dispatch.ALL_LOBES, use_textures: bool = True,
                 use_alpha_cutout: bool = False,
                 sort_rays: bool | None = None, flat_shading: bool = False,
                 material_sort: int = 0):
    """Accumulate `chunk` consecutive 1-spp frames into the running mean,
    with the reference's recurrence acc + (frame - acc) / (s + 1)."""
    for i in range(chunk):
        s = start_frame + i
        frame = render_sample(scene, cam_position, cam_inv_view,
                              cam_inv_proj, width, height, s, max_bounces,
                              intersect_method, reference_compat,
                              active_lobes, use_textures, use_alpha_cutout,
                              sort_rays=sort_rays, flat_shading=flat_shading,
                              material_sort=material_sort)
        count = torch.tensor(s, dtype=torch.float32, device=accum.device)
        accum = accum + (frame - accum) / (count + 1.0)
    return accum


@torch.no_grad()
def render(scene, camera, width: int, height: int, spp: int,
           max_bounces: int = 2, intersect_method: str = "auto",
           reference_compat: bool = False, start_frame: int = 0,
           accum=None, callback=None, active_lobes=None,
           use_textures=None, use_alpha_cutout=None, flat_shading=None,
           frames_per_launch: int = 32):
    """Progressive render: accumulate `spp` 1-spp frames into a running mean
    on the scene's device (the reference's accumulation shader,
    `AddPathtracedFrame.frag:13-25`, weight 1/samples).

    Frames go through `render_chunk` in `frames_per_launch` groups; with a
    `callback` (preview/heartbeat consumers) every frame is accumulated one
    by one with the weight 1/(s+1) and handed to callback(s, accum), as in
    the reference. Resume by passing `accum` (the running mean) and
    `start_frame` from a checkpoint. Returns the [H, W, 3] image."""
    if active_lobes is None:
        from ..scene.flatten import scene_active_lobes
        active_lobes = scene_active_lobes(scene)
    if use_textures is None:
        from ..scene.flatten import scene_uses_textures
        use_textures = scene_uses_textures(scene)
    if use_alpha_cutout is None:
        use_alpha_cutout = scene_uses_alpha_cutout(scene)
    if flat_shading is None:
        from ..scene.flatten import scene_flat_shading
        flat_shading = scene_flat_shading(scene)
    dev = scene.tri_v0.device
    pos, inv_view, inv_proj = camera.raygen_params(width, height, dev)
    if accum is None:
        accum = torch.zeros((height, width, 3), device=dev)

    if callback is None and frames_per_launch > 1:
        s = start_frame
        end = start_frame + spp
        while s < end:
            chunk = min(frames_per_launch, end - s)
            accum = render_chunk(scene, pos, inv_view, inv_proj, width,
                                 height, accum, s, chunk, max_bounces,
                                 intersect_method, reference_compat,
                                 active_lobes, use_textures,
                                 use_alpha_cutout, flat_shading=flat_shading)
            s += chunk
        return accum

    for s in range(start_frame, start_frame + spp):
        frame = render_sample(scene, pos, inv_view, inv_proj, width, height,
                              s, max_bounces, intersect_method,
                              reference_compat, active_lobes, use_textures,
                              use_alpha_cutout, flat_shading=flat_shading)
        # running mean: mix(prev, new, 1/(s+1))
        accum = accum + (frame - accum) * (1.0 / (s + 1))
        if callback is not None:
            callback(s, accum)
    return accum

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

`render_sample` follows autograd (material-table gradients, `diff/`);
`render_chunk` and `render` run under torch.no_grad(). With
`use_alpha_cutout` (the default for scenes with cutout texels) closest hits
and shadow rays go through `integrate/cutout.py`. The `trace_paths`
options (ray sort, segmented shading, material sort, `debug_pixel`) are
the reference's, under its conditions; where it branches on the device
(`lax.cond`), the port branches on the host after one copy a bounce.
"""
from __future__ import annotations

import torch

from .. import spans
from ..bsdf import dispatch
from ..camera.camera import generate_rays
from ..core import rng
from ..core.math import abs_cos_theta, div, dot, length, length_sqr, normalize
from ..intersect import intersect_any, intersect_closest
from ..intersect.types import Hit
from .cutout import (intersect_any_cutout, intersect_closest_cutout,
                     scene_uses_alpha_cutout)
from .surface import make_surface

RAY_TMAX = 100.0
SHADOW_OFFSET = 1e-3
BETA_EPS = 1e-5
MORTON_BITS = 4  # per-axis origin quantisation of the coherence sort
DEAD_KEY = 0xFFFFFFFF  # the uint32 key of a dead lane: after every live one


def _spread3(x):
    """Spread the low MORTON_BITS bits of x so consecutive bits land 3
    apart (for interleaved Morton codes)."""
    out = torch.zeros_like(x)
    for b in range(MORTON_BITS):
        out = out | (((x >> b) & 1) << (3 * b))
    return out


def _octant(d):
    return ((d[:, 0] >= 0).long() | ((d[:, 1] >= 0).long() << 1)
            | ((d[:, 2] >= 0).long() << 2))


def _coherence_sort_key(scene, o, d, alive):
    """Sort key grouping rays by direction octant within origin Morton
    cells, dead lanes last. The reference's uint32 key, held in int64 so
    that DEAD_KEY sorts after every live key."""
    root_min, root_max = _scene_bounds(scene)
    root_ext = torch.clamp(root_max - root_min, min=1e-6)
    scale = float(1 << MORTON_BITS)
    q = torch.clamp((o - root_min) / root_ext * scale, 0.0,
                    scale - 1.0).long()
    morton = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
              | (_spread3(q[:, 2]) << 2))
    key = (morton << 3) | _octant(d)
    return torch.where(alive, key, DEAD_KEY)


N_CELLS = 8    # coarse origin cells (2x2x2 halves of the scene AABB)
N_BUCKETS = N_CELLS * 8 + 1  # x direction octants, +1 for dead lanes


def _scene_bounds(scene):
    if scene.bvh_min.shape[0] > 0:
        return scene.bvh_min[0], scene.bvh_max[0]
    v0 = scene.tri_v0
    v1 = v0 + scene.tri_e1
    v2 = v0 + scene.tri_e2
    ok = scene.tri_valid[:, None]
    root_min = torch.where(ok, torch.minimum(torch.minimum(v0, v1), v2),
                           float("inf")).amin(dim=0)
    root_max = torch.where(ok, torch.maximum(torch.maximum(v0, v1), v2),
                           float("-inf")).amax(dim=0)
    return root_min, root_max


def _perm_from_key(key, n_buckets: int):
    """The permutation that orders lanes by integer key in [0, n_buckets),
    then by lane: the reference's stable counting sort. Its [R, K] one-hot
    cumsum would take 1 GB at 1080p, so a stable argsort gives the same
    permutation."""
    del n_buckets  # the argsort needs no bucket count
    return torch.argsort(key, stable=True)


def _bucket_permutation(scene, o, d, alive):
    """Counting-sort permutation over N_BUCKETS coherence buckets (origin
    2x2x2 cell x direction octant; dead lanes last)."""
    root_min, root_max = _scene_bounds(scene)
    mid = 0.5 * (root_min + root_max)
    cell = ((o[:, 0] >= mid[0]).long() | ((o[:, 1] >= mid[1]).long() << 1)
            | ((o[:, 2] >= mid[2]).long() << 2))
    key = torch.where(alive, cell * 8 + _octant(d), N_BUCKETS - 1)
    return _perm_from_key(key, N_BUCKETS)


def _index(tree, idx):
    """Every tensor of a (nested) tuple or NamedTuple of tensors, indexed
    by `idx` (a permutation or a slice)."""
    if isinstance(tree, torch.Tensor):
        return tree[idx]
    items = [_index(a, idx) for a in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def _light_query(seed, scene, surf, alive, intersect_method,
                 use_alpha_cutout):
    """Pick one light uniformly (`LightMethods.h`) and trace the shadow
    ray toward it. Returns (seed, None) when the scene has no lights, else
    (seed, (light colour, squared distance, local light direction, visible,
    light pick pdf))."""
    n_lights = scene.light_pos.shape[0]
    if n_lights == 0:
        return seed, None

    if n_lights == 1:
        light_idx = torch.zeros(alive.shape[0], dtype=torch.long,
                                device=alive.device)
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
    return seed, (lc, length_sqr(to_light), surf.to_local(wl), visible,
                  p_light)


@spans.traced(spans.NEE)
def _nee(seed, scene, surf, beta, alive, intersect_method, active_lobes,
         use_alpha_cutout=False):
    """Direct light from one uniformly picked point light
    (`devicePrograms.cu:444-472`, `LightMethods.h`). Returns (seed,
    contrib)."""
    seed, light = _light_query(seed, scene, surf, alive, intersect_method,
                               use_alpha_cutout)
    if light is None:
        return seed, torch.zeros_like(beta)
    lc, dist2, wl_local, visible, p_light = light
    seed, f_val = dispatch.f(seed, surf.mat, surf.wo_local, wl_local,
                             active_lobes)
    cos_term = wl_local[..., 2].abs()

    # L = color / d^2 (`LightMethods.h:17-23`)
    radiance = lc / torch.clamp(dist2, min=1e-12)[..., None]
    contrib = div(beta * f_val * cos_term[..., None] * radiance, p_light)
    return seed, torch.where(visible[..., None], contrib, 0.0)


@spans.traced(spans.NEE)
def _nee_geom(seed, scene, surf, alive, intersect_method,
              use_alpha_cutout):
    """The material-independent half of _nee: light pick, shadow query,
    local light direction and radiance term. Returns (seed, (wl_local,
    visible, lrad)), or (seed, None) when the scene has no lights."""
    seed, light = _light_query(seed, scene, surf, alive, intersect_method,
                               use_alpha_cutout)
    if light is None:
        return seed, None
    lc, dist2, wl_local, visible, p_light = light
    lrad = div(lc / torch.clamp(dist2, min=1e-12)[..., None], p_light)
    return seed, (wl_local, visible, lrad)


@spans.traced(spans.ADVANCE)
def _advance(surf, o, d, beta, alive, bs):
    """Throughput and ray update from a BSDF sample. Returns (beta, o, d,
    alive)."""
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
    return beta, o, d, alive


def _shade_mat_segment(seed, surf, o, d, beta, alive, nee, gates,
                       active_lobes):
    """The material-dependent shading tail for one contiguous segment of a
    material-sorted wavefront: NEE f and contribution, BSDF sample,
    throughput and ray update, with per-lobe gates (dispatch._gated).
    Returns (seed, radiance_add, beta, o, d, alive)."""
    radiance_add = torch.zeros_like(beta)
    if nee is not None:
        wl_local, visible, lrad = nee
        seed, f_val = dispatch.f(seed, surf.mat, surf.wo_local, wl_local,
                                 active_lobes, gates)
        cos_term = wl_local[..., 2].abs()
        contrib = beta * f_val * cos_term[..., None] * lrad
        radiance_add = torch.where(visible[..., None], contrib, 0.0)

    seed, bs = dispatch.sample(seed, surf.mat, surf.wo_local, active_lobes,
                               gates)
    return (seed, radiance_add) + _advance(surf, o, d, beta, alive, bs)


N_MAT_BUCKETS = 6  # 5 material types + dead lanes


@spans.traced(spans.SHADE)
def _shade_wave_material_sorted(scene, o, d, seed, hit, beta, alive,
                                radiance, pix, n_seg,
                                reference_compat, use_textures,
                                flat_shading, intersect_method,
                                active_lobes, use_alpha_cutout):
    """Material-sorted shading: the surface and the NEE shadow query run
    on the full wavefront, then lanes are sorted by their resolved material
    type (dead last) and the material-dependent tail (NEE f, BSDF sample)
    runs per contiguous segment, each lobe only in the segments that hold
    a live lane of its type. The gates of every segment are copied to the
    host once. Returns (seed, radiance, beta, o, d, alive, pix), all
    permuted."""
    seed, surf = make_surface(seed, scene, o, d, hit,
                              reference_compat=reference_compat,
                              use_textures=use_textures,
                              flat_shading=flat_shading)
    seed, nee = _nee_geom(seed, scene, surf, alive, intersect_method,
                          use_alpha_cutout)

    key = torch.where(alive, surf.mat.mat_type.long(), N_MAT_BUCKETS - 1)
    perm = _perm_from_key(key, N_MAT_BUCKETS)
    o, d, seed, beta, radiance, alive, pix, surf, nee = _index(
        (o, d, seed, beta, radiance, alive, pix, surf, nee), perm)

    size = o.shape[0] // n_seg
    mt = surf.mat.mat_type.reshape(n_seg, size)
    live = alive.reshape(n_seg, size)
    gates = torch.stack([((mt == lobe) & live).any(dim=1)
                         for lobe in active_lobes], dim=1).tolist()
    pieces = []
    for si in range(n_seg):
        sl = slice(si * size, (si + 1) * size)
        pieces.append(_shade_mat_segment(
            seed[sl], _index(surf, sl), o[sl], d[sl], beta[sl], alive[sl],
            None if nee is None else _index(nee, sl),
            dict(zip(active_lobes, gates[si])), active_lobes))
    seed, radiance_add, beta, o, d, alive = (
        torch.cat([p[k] for p in pieces]) for k in range(6))
    radiance = radiance + radiance_add  # already gated by NEE visibility
    return seed, radiance, beta, o, d, alive, pix


@spans.traced(spans.SHADE)
def _shade_wave(scene, o, d, seed, hit, beta, alive, radiance,
                reference_compat, use_textures, flat_shading,
                intersect_method, active_lobes, use_alpha_cutout):
    """Surface context, NEE, BSDF sample and throughput/ray update for one
    wavefront (or one segment of it, under compact_shading). Returns
    (seed, radiance, beta, o, d, alive)."""
    seed, surf = make_surface(seed, scene, o, d, hit,
                              reference_compat=reference_compat,
                              use_textures=use_textures,
                              flat_shading=flat_shading)

    seed, nee_contrib = _nee(seed, scene, surf, beta, alive,
                             intersect_method, active_lobes,
                             use_alpha_cutout)
    radiance = radiance + torch.where(alive[..., None], nee_contrib, 0.0)

    seed, bs = dispatch.sample(seed, surf.mat, surf.wo_local, active_lobes)
    return (seed, radiance) + _advance(surf, o, d, beta, alive, bs)


def _debug_print(bounce, surf, alive, i):
    """One host line of lane i's surface, with the reference's fields."""
    def v(x):
        return x[i].detach().cpu().numpy()
    print(f"debug ray bounce {bounce}: pos={v(surf.position)} "
          f"albedo={v(surf.mat.albedo)} ns={v(surf.s_normal)} "
          f"ng={v(surf.g_normal)} rough={v(surf.mat.roughness)} "
          f"metal={v(surf.mat.metallic)} alive={v(alive)}", flush=True)


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
    u32). Returns (radiance [R, 3], seed), in the lanes' order.

    debug_pixel: lane whose surface is printed at every bounce (the
    reference's debug-ray printf); it turns every sort off.
    sort_rays: re-sort the wavefront by coherence before every secondary
    bounce: True by N_BUCKETS buckets (origin cell x direction octant),
    "morton" by the Morton key. Per-lane arithmetic does not depend on the
    order, so the image is the unsorted one.
    compact_shading: shade every secondary bounce in this many contiguous
    segments, skipping those with no live lane; implies sort_rays (dead
    lanes last); only where it divides the wavefront.
    material_sort: sort each bounce's lanes by resolved material type and
    run the material-dependent shading in this many segments with per-lobe
    gates (_shade_wave_material_sorted); only where it divides the
    wavefront. Unbiased, but not the unsorted image: skipped lobes burn no
    random numbers."""
    r = o.shape[0]
    if compact_shading and not sort_rays:
        sort_rays = True  # segments only pay off with dead lanes last
    radiance = torch.zeros((r, 3), device=o.device)
    beta = torch.ones((r, 3), device=o.device)
    alive = torch.ones((r,), dtype=torch.bool, device=o.device)
    pix = torch.arange(r, device=o.device)

    for bounce in range(max_bounces):
        with spans.span(spans.BOUNCE):
            if sort_rays and bounce and debug_pixel is None:
                if sort_rays == "morton":
                    perm = torch.argsort(
                        _coherence_sort_key(scene, o, d, alive), stable=True)
                else:
                    perm = _bucket_permutation(scene, o, d, alive)
                o, d, seed, beta, radiance, alive, pix = _index(
                    (o, d, seed, beta, radiance, alive, pix), perm)
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
            # miss -> background is black; the path dies with radiance
            # unchanged
            alive = alive & hit.hit

            if debug_pixel is not None:
                _, surf = make_surface(seed, scene, o, d, hit,
                                       reference_compat=reference_compat,
                                       use_textures=use_textures,
                                       flat_shading=flat_shading)
                _debug_print(bounce, surf, alive, debug_pixel)

            # the NEE shadow query inherits the bounce hint too
            shade_args = (reference_compat, use_textures, flat_shading,
                          closest_method, active_lobes, use_alpha_cutout)
            if material_sort and debug_pixel is None \
                    and r % material_sort == 0:
                (seed, radiance, beta, o, d, alive,
                 pix) = _shade_wave_material_sorted(
                    scene, o, d, seed, hit, beta, alive, radiance, pix,
                    material_sort, *shade_args)
            elif compact_shading and bounce and debug_pixel is None \
                    and r % compact_shading == 0:
                # dead lanes sort last, so trailing segments skip the whole
                # shading stage; one copy to the host for every segment
                size = r // compact_shading
                pieces = []
                live = alive.reshape(compact_shading,
                                     size).any(dim=1).tolist()
                for si, any_live in enumerate(live):
                    sl = slice(si * size, (si + 1) * size)
                    carry = (seed[sl], radiance[sl], beta[sl], o[sl], d[sl],
                             alive[sl])
                    if any_live:
                        carry = _shade_wave(
                            scene, o[sl], d[sl], seed[sl],
                            Hit(*[f[sl] for f in hit]), beta[sl], alive[sl],
                            radiance[sl], *shade_args)
                    pieces.append(carry)
                seed, radiance, beta, o, d, alive = (
                    torch.cat([p[k] for p in pieces]) for k in range(6))
            else:
                seed, radiance, beta, o, d, alive = _shade_wave(
                    scene, o, d, seed, hit, beta, alive, radiance, *shade_args)

    sorted_any = ((sort_rays and max_bounces > 1)
                  or (material_sort and r % material_sort == 0))
    if sorted_any and debug_pixel is None:
        # back to pixel order (pix is a permutation)
        radiance = torch.zeros_like(radiance).index_copy(0, pix, radiance)
        seed = torch.zeros_like(seed).index_copy(0, pix, seed)
    return radiance, seed


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
                  material_sort: int = 0,
                  y0=0, h_local: int | None = None):
    """Render one 1-spp frame: [H, W, 3] linear radiance (row 0 = bottom,
    GL convention like the reference framebuffer). With `h_local`, only
    the pixel rows [y0, y0 + h_local) of the height x width frame:
    [h_local, W, 3], each pixel as in the full frame (rows are offset in
    float32, as the reference's `render_rows` does; `dist/` shards rows
    this way). It follows autograd: a scene field that requires grad gets
    its gradient (`diff/`); with none, no graph is recorded."""
    if h_local is None:
        h_local = height
    dev = cam_inv_proj.device
    with spans.span(spans.RAYGEN):
        ys = torch.arange(h_local, dtype=torch.float32, device=dev)[:, None]
        py = (ys + torch.tensor(float(y0), dtype=torch.float32, device=dev)
              ).expand(h_local, width)
        px = torch.arange(width, dtype=torch.float32,
                          device=dev)[None, :].expand(h_local, width)
        o, d = generate_rays(cam_position, cam_inv_view, cam_inv_proj,
                             width, height, px, py)
        seed = rng.pixel_seed(width, px.to(torch.int64).reshape(-1),
                              py.to(torch.int64).reshape(-1), int(frame_id))
    radiance, _ = trace_paths(scene, o.reshape(-1, 3), d.reshape(-1, 3),
                              seed, max_bounces, intersect_method,
                              reference_compat, active_lobes, use_textures,
                              use_alpha_cutout, debug_pixel, sort_rays,
                              flat_shading, compact_shading, material_sort)
    return radiance.reshape(h_local, width, 3)


@torch.no_grad()
def render_chunk(scene, cam_position, cam_inv_view, cam_inv_proj,
                 width: int, height: int, accum, start_frame: int,
                 chunk: int, max_bounces: int = 2,
                 intersect_method: str = "auto",
                 reference_compat: bool = False,
                 active_lobes=dispatch.ALL_LOBES, use_textures: bool = True,
                 use_alpha_cutout: bool = False,
                 sort_rays: bool | None = None, flat_shading: bool = False,
                 material_sort: int = 0, y0=0):
    """Accumulate `chunk` consecutive 1-spp frames into the running mean,
    with the reference's recurrence acc + (frame - acc) / (s + 1). The
    accumulator may hold only the rows [y0, y0 + accum rows) of the
    frame (`render_sample`'s row window)."""
    for s in range(start_frame, start_frame + chunk):
        with spans.span(spans.FRAME):
            frame = render_sample(
                scene, cam_position, cam_inv_view, cam_inv_proj, width,
                height, s, max_bounces, intersect_method, reference_compat,
                active_lobes, use_textures, use_alpha_cutout,
                sort_rays=sort_rays, flat_shading=flat_shading,
                material_sort=material_sort, y0=y0, h_local=accum.shape[0])
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
        with spans.span(spans.FRAME):
            frame = render_sample(scene, pos, inv_view, inv_proj, width,
                                  height, s, max_bounces, intersect_method,
                                  reference_compat, active_lobes,
                                  use_textures, use_alpha_cutout,
                                  flat_shading=flat_shading)
            # running mean: mix(prev, new, 1/(s+1))
            accum = accum + (frame - accum) * (1.0 / (s + 1))
        if callback is not None:
            callback(s, accum)
    return accum

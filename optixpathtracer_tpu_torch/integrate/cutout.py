"""Alpha-cutout-aware intersection (port of
`optixpathtracer_tpu/integrate/cutout.py`): the wavefront form of the
reference's anyhit programs (`devicePrograms.cu:518-561`, AlphaCutout):
hits whose albedo-texture alpha, sRGB-decoded, is below 0.9 are ignored,
for radiance and shadow rays alike.

OptiX re-enters traversal on optixIgnoreIntersection; here a bounded
re-trace takes its place: find the closest hit, evaluate the alpha there,
and re-trace the cut lanes with tmin just past the hit, at most
MAX_CUTOUT_LAYERS times (layers beyond that occlude). The reference gates
each layer with `jax.lax.cond` on "any lane still open"; here that is a
host-side `if`, which skips the query as the cond does.

A scene flattened with the opaque/cutout split (`SceneData.opaque_scene`,
`cutout_sub`) takes the fast paths: one closest or occlusion query over
the opaque triangles, and the re-trace chain only over the few cutout
ones, whose ids map back to the outer scene through `tri_outer_id`.
"""
from __future__ import annotations

import torch

from .. import spans
from ..intersect import intersect_any, intersect_closest
from ..intersect.api import _refine
from ..intersect.types import Hit
from ..scene.textures import sample_bilinear, srgb_to_linear

MAX_CUTOUT_LAYERS = 4
ALPHA_THRESHOLD = 0.9  # decoded albedo alpha below this is a hole
REENTRY_EPS = 1e-4


def scene_uses_alpha_cutout(scene) -> bool:
    """Any material with an albedo texture containing decoded alpha < 0.9?
    (reference `devicePrograms.cu:534,543`; the machinery is skipped when
    every texel is opaque: the same image, less work)"""
    tex_ids = scene.mat_albedo_tex
    if not bool((tex_ids >= 0).any()):
        return False
    used = tex_ids[tex_ids >= 0].unique().long()
    alpha = srgb_to_linear(scene.textures[used, :, :, 3])
    return bool((alpha < ALPHA_THRESHOLD).any())


def _hit_alpha(scene, hit: Hit):
    """Decoded albedo alpha at the hit point; 1.0 where the material has no
    albedo texture (no cutout, `devicePrograms.cu:534,546`)."""
    safe_id = hit.tri_id.clamp(min=0).long()
    tri_uv = scene.tri_uvs[safe_id]
    mat_id = scene.tri_mat[safe_id].long()
    tex_id = scene.mat_albedo_tex[mat_id]
    u = hit.u[..., None]
    v = hit.v[..., None]
    uv = (1.0 - u - v) * tri_uv[:, 0] + u * tri_uv[:, 1] + v * tri_uv[:, 2]
    texel = sample_bilinear(scene.textures, tex_id, uv[..., 0], uv[..., 1])
    alpha = srgb_to_linear(texel[..., 3])
    return torch.where(tex_id >= 0, alpha, 1.0)


def _per_ray(x, r, device):
    return torch.as_tensor(x, dtype=torch.float32,
                           device=device).expand(r).clone()


def intersect_closest_cutout(scene, o, d, tmin=0.0, tmax=100.0,
                             method="auto"):
    """Closest hit skipping cutout surfaces (the radiance-ray anyhit).

    Split scenes: one closest hit over the opaque sub-scene, the cutout
    chain over the cutout sub-scene bounded by it, the winner mapped to
    its outer id (t-ties between the two go to the lower outer id, as the
    full-scene chain and brute break them) and refined against the outer
    geometry. Other scenes: the full-scene chain, re-tracing only the cut
    lanes (the others dead at tmax = -1)."""
    r, dev = o.shape[0], o.device
    tmin = _per_ray(tmin, r, dev)
    tmax_b = _per_ray(tmax, r, dev)

    if scene.opaque_scene is not None and scene.cutout_sub is not None:
        opq = scene.opaque_scene
        sub = scene.cutout_sub
        h_o = intersect_closest(opq, o, d, tmin, tmax_b, method=method)
        # the cutout chain over the subset, bounded by the opaque hit
        sub_bound = torch.where(h_o.hit, h_o.t + REENTRY_EPS, tmax_b)
        cur_tmin = tmin
        open_ = torch.ones(r, dtype=torch.bool, device=dev)
        best_t = torch.full((r,), float("inf"), device=dev)
        best_id = torch.full((r,), -1, dtype=torch.int32, device=dev)
        # the deepest cut hit: an exhausted chain occludes there
        last_cut_t = torch.full((r,), float("inf"), device=dev)
        last_cut_id = torch.full((r,), -1, dtype=torch.int32, device=dev)
        with spans.span(spans.CUTOUT):
            for _ in range(MAX_CUTOUT_LAYERS + 1):
                if not bool(open_.any()):
                    break
                lane_tmax = torch.where(open_, sub_bound, -1.0)
                h = intersect_closest(sub, o, d, cur_tmin, lane_tmax,
                                      method=method)
                solid = h.hit & (_hit_alpha(sub, h) >= ALPHA_THRESHOLD)
                take = open_ & solid
                best_t = torch.where(take, h.t, best_t)
                best_id = torch.where(take, h.tri_id, best_id)
                open_ = open_ & h.hit & ~solid
                cur_tmin = torch.where(open_, h.t + REENTRY_EPS, cur_tmin)
                last_cut_t = torch.where(open_ & h.hit, h.t, last_cut_t)
                last_cut_id = torch.where(open_ & h.hit, h.tri_id, last_cut_id)
        exhausted = open_ & (last_cut_id >= 0)
        best_t = torch.where(exhausted, last_cut_t, best_t)
        best_id = torch.where(exhausted, last_cut_id, best_id)

        sub_hit = best_id >= 0
        n_sub = sub.tri_outer_id.shape[0]
        sub_outer = sub.tri_outer_id[best_id.clamp(0, n_sub - 1).long()]
        n_opq = opq.tri_outer_id.shape[0]
        opq_outer = opq.tri_outer_id[h_o.tri_id.clamp(0, n_opq - 1).long()]
        sub_wins = sub_hit & (~h_o.hit | (best_t < h_o.t)
                              | ((best_t == h_o.t) & (sub_outer < opq_outer)))
        final_id = torch.where(sub_wins, sub_outer,
                               torch.where(h_o.hit, opq_outer, -1))
        zeros = torch.zeros(r, device=dev)
        raw = Hit(t=torch.where(sub_wins, best_t, h_o.t),
                  tri_id=final_id.detach(), u=zeros, v=zeros,
                  hit=sub_wins | h_o.hit,
                  back_face=torch.zeros(r, dtype=torch.bool, device=dev))
        # differentiable refinement against the OUTER geometry, the
        # contract of api.intersect_closest
        return _refine(scene, o, d, raw, tmax_b)

    best = intersect_closest(scene, o, d, tmin, tmax_b, method=method)
    with spans.span(spans.CUTOUT):
        for _ in range(MAX_CUTOUT_LAYERS):
            cut = best.hit & (_hit_alpha(scene, best) < ALPHA_THRESHOLD)
            if not bool(cut.any()):
                break
            new_tmin = torch.where(cut, best.t + REENTRY_EPS, tmin)
            lane_tmax = torch.where(cut, tmax_b, -1.0)
            again = intersect_closest(scene, o, d, new_tmin, lane_tmax,
                                      method=method)
            best = Hit(*[torch.where(cut, a, b) for a, b in zip(again, best)])
    return best


@spans.traced(spans.CUTOUT)
def _any_cutout_chain(scene, o, d, tmin, tmax_b, gate0, method):
    """The closest-hit cutout chain over `scene`: a ray is blocked only by
    a hit whose alpha passes the threshold, and re-enters behind cutout
    hits. gate0 masks the lanes that need the query at all."""
    blocked = torch.zeros_like(gate0)
    open_ = gate0
    cur_tmin = tmin
    for _ in range(MAX_CUTOUT_LAYERS + 1):
        if not bool(open_.any()):
            break
        lane_tmax = torch.where(open_, tmax_b, -1.0)
        hit = intersect_closest(scene, o, d, cur_tmin, lane_tmax,
                                method=method)
        opaque = hit.hit & (_hit_alpha(scene, hit) >= ALPHA_THRESHOLD)
        blocked = blocked | (open_ & opaque)
        # keep searching only through cutout hits
        open_ = open_ & hit.hit & ~opaque
        cur_tmin = torch.where(open_, hit.t + REENTRY_EPS, cur_tmin)
    # layers beyond the bound conservatively occlude
    return blocked | open_


def intersect_any_cutout(scene, o, d, tmin=0.0, tmax=100.0, method="auto"):
    """Occlusion honouring cutout (the shadow-ray anyhit,
    `devicePrograms.cu:556-561`): a ray is blocked only by a hit whose
    alpha passes the threshold.

    Split scenes: a plain occlusion query over the opaque sub-scene, OR'd
    with the cutout chain over the cutout sub-scene on the lanes it left
    unblocked. Other scenes: the chain over the whole scene."""
    r, dev = o.shape[0], o.device
    tmin = _per_ray(tmin, r, dev)
    tmax_b = _per_ray(tmax, r, dev)

    if scene.opaque_scene is not None and scene.cutout_sub is not None:
        blocked_o = intersect_any(scene.opaque_scene, o, d, tmin, tmax_b,
                                  method=method)
        blocked_c = _any_cutout_chain(scene.cutout_sub, o, d, tmin,
                                      torch.where(blocked_o, -1.0, tmax_b),
                                      ~blocked_o, method)
        return blocked_o | blocked_c

    return _any_cutout_chain(scene, o, d, tmin, tmax_b,
                             torch.ones(r, dtype=torch.bool, device=dev),
                             method)

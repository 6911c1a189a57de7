"""Alpha cutout over the reference's brute-force queries: a hit whose
albedo-texture alpha, sRGB-decoded, is below ALPHA_THRESHOLD is no hit,
for radiance and shadow rays alike (the program's `integrate/cutout.py`,
after the reference renderer's anyhit programs).

The rule, written out plainly: take the closest hit; while it is a hole,
take the closest hit again from just past it (tmin = its t +
REENTRY_EPS). At most MAX_CUTOUT_LAYERS holes are passed: the hit after
the last of them counts whatever its alpha. A shadow ray is blocked by the
first hit that counts. OptiX re-enters traversal behind any number of
holes; the program bounds the layers, and so does this rule.
"""
from __future__ import annotations

import torch

from . import intersect
from .textures import sample_bilinear, srgb_to_linear

MAX_CUTOUT_LAYERS = 4
ALPHA_THRESHOLD = 0.9
REENTRY_EPS = 1e-4


def uses_alpha_cutout(scene) -> bool:
    """Does an albedo texture that a material uses hold a decoded alpha
    below the threshold? Where none does, no hit is a hole."""
    used = scene.mat_albedo_tex[scene.mat_albedo_tex >= 0].unique()
    alpha = srgb_to_linear(scene.textures[used, :, :, 3])
    return bool((alpha < ALPHA_THRESHOLD).any())


def hit_alpha(scene, o, d, tri_id, tmax):
    """Decoded albedo alpha at each hit; 1 where the material has no
    albedo texture or the ray missed."""
    _, u, v, _, _ = intersect.refine(scene, o, d, tri_id, tmax)
    safe = tri_id.clamp(min=0)
    tri_uv = scene.tri_uvs[safe]
    tex_id = scene.mat_albedo_tex[scene.tri_mat[safe]]
    u = u[..., None]
    v = v[..., None]
    uv = (1.0 - u - v) * tri_uv[:, 0] + u * tri_uv[:, 1] + v * tri_uv[:, 2]
    texel = sample_bilinear(scene.textures, tex_id, uv[..., 0], uv[..., 1])
    alpha = srgb_to_linear(texel[..., 3])
    return torch.where((tex_id >= 0) & (tri_id >= 0), alpha, 1.0)


@torch.no_grad()
def closest(scene, o, d, tmin, tmax):
    """(tri_id, t) of the closest hit that counts."""
    tmin, tmax = intersect._bounds(o, tmin, tmax)
    tri, t = intersect.closest(scene, o, d, tmin, tmax)
    for _ in range(MAX_CUTOUT_LAYERS):
        hole = hit_alpha(scene, o, d, tri, tmax) < ALPHA_THRESHOLD
        if not bool(hole.any()):
            break
        again, t_again = intersect.closest(
            scene, o, d, torch.where(hole, t + REENTRY_EPS, tmin),
            torch.where(hole, tmax, -1.0))
        tri = torch.where(hole, again, tri)
        t = torch.where(hole, t_again, t)
    return tri, t


@torch.no_grad()
def occluded(scene, o, d, tmin, tmax):
    """True where a hit that counts lies on the segment (tmin, tmax)."""
    tri, _ = closest(scene, o, d, tmin, tmax)
    return tri >= 0

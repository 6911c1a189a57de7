"""Frozen copy of `optixpathtracer_tpu_torch/core/microfacet.py` for the benchmark's
plain reference (imports rewritten; nothing else changed), so that a
later change to the port does not move the yardstick. The original
docstring follows.

Trowbridge-Reitz (GGX) microfacet distribution: NDF, Smith masking and
visible-normal sampling (port of `optixpathtracer_tpu/core/microfacet.py`,
reference `PBRT/Microfacet.h`).

Mask-based like the reference port: where `Microfacet.h` early-returns 0 on
degenerate inputs, the value comes from `where` selects, with the same
guards (alpha >= 1e-4, tan^2 clamped to 1e6) so that a later backward pass
finds no NaN at masked lanes. Only the isotropic entry points are used; the
anisotropic forms take alpha as an (alpha_x, alpha_y) pair.
"""
from __future__ import annotations

import torch

from . import rng
from .pmath import (PI, abs_cos_theta, abs_dot, cos2_theta, cos_phi, cross,
                   normalize, sin_phi, sqr, sqrt, tan2_theta, vec3)


def d_anisotropic(wm, ax, ay):
    """GGX NDF D(wm) (reference `Microfacet.h:9-20`)."""
    a0 = torch.clamp(ax, min=1e-4)
    a1 = torch.clamp(ay, min=1e-4)
    t2 = tan2_theta(wm)
    t2_ok = torch.isfinite(t2)
    t2s = torch.clamp(torch.where(t2_ok, t2, 0.0), max=1e6)
    cos4 = sqr(cos2_theta(wm))
    e = t2s * (sqr(cos_phi(wm) / a0) + sqr(sin_phi(wm) / a1))
    denom = PI * a0 * a1 * cos4 * sqr(1.0 + e)
    ok = t2_ok & (cos4 >= 1e-16) & torch.isfinite(e)
    return torch.where(ok, 1.0 / torch.where(ok, denom, 1.0), 0.0)


def _alpha(alpha, like):
    return torch.as_tensor(alpha, dtype=torch.float32,
                           device=like.device).expand(like.shape[:-1])


def d(wm, alpha):
    """Isotropic NDF (reference `Microfacet.h:22-24`)."""
    a = _alpha(alpha, wm)
    return d_anisotropic(wm, a, a)


def lambda_anisotropic(w, ax, ay):
    """Smith Lambda (reference `Microfacet.h:46-52`)."""
    t2 = tan2_theta(w)
    a2 = sqr(cos_phi(w) * ax) + sqr(sin_phi(w) * ay)
    ok = torch.isfinite(t2)
    val = (sqrt(1.0 + a2 * torch.where(ok, t2, 0.0)) - 1.0) / 2.0
    return torch.where(ok, val, 0.0)


def smith_g(wo, wi, alpha):
    """Bidirectional Smith masking-shadowing G (reference
    `Microfacet.h:62-68`)."""
    a = _alpha(alpha, wo)
    return 1.0 / (1.0 + lambda_anisotropic(wo, a, a)
                  + lambda_anisotropic(wi, a, a))


def smith_g1(w, alpha):
    """Unidirectional Smith G1 (reference `Microfacet.h:71-77`)."""
    a = _alpha(alpha, w)
    return 1.0 / (1.0 + lambda_anisotropic(w, a, a))


def d_visible(w, wm, alpha):
    """D_w(wm) = G1(w) / |cos w| D(wm) |w . wm| (reference
    `Microfacet.h:81-84`)."""
    ct = abs_cos_theta(w)
    return (smith_g1(w, alpha) * d(wm, alpha) * abs_dot(w, wm)
            / torch.where(ct == 0.0, 1.0, ct))


def pdf(w, wm, alpha):
    """VNDF sampling pdf == D_visible (reference `Microfacet.h:86-88`)."""
    return d_visible(w, wm, alpha)


def sample_wm(seed, w, alpha):
    """Sample a visible microfacet normal (VNDF, hemispherical warp;
    reference `Microfacet.h:90-119`). Returns (seed, wm). alpha is
    detached: sample locations carry no parameter gradient."""
    a = _alpha(alpha, w).detach()
    wh = normalize(vec3(a * w[..., 0], a * w[..., 1], w[..., 2]))
    wh = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)

    zero = torch.zeros_like(wh[..., 0])
    one = torch.ones_like(zero)
    t1_general = normalize(cross(vec3(zero, zero, one), wh))
    t1 = torch.where((wh[..., 2] < 0.99999)[..., None], t1_general,
                     vec3(one, zero, zero))
    t2 = cross(wh, t1)

    seed, p = rng.sample_uniform_disk_polar(seed)
    h = sqrt(torch.clamp(1.0 - sqr(p[..., 0]), min=0.0))
    lerp_t = (1.0 + wh[..., 2]) / 2.0
    py = (1.0 - lerp_t) * h + lerp_t * p[..., 1]
    p = torch.stack([p[..., 0], py], dim=-1)

    pz = sqrt(torch.clamp(
        1.0 - (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]), min=0.0))
    nh = (p[..., 0:1] * t1 + p[..., 1:2] * t2 + pz[..., None] * wh)
    wm = normalize(vec3(a * nh[..., 0], a * nh[..., 1],
                        torch.clamp(nh[..., 2], min=1e-6)))
    return seed, wm

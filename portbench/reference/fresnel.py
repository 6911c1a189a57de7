"""Frozen copy of `optixpathtracer_tpu_torch/core/fresnel.py` for the benchmark's
plain reference (imports rewritten; nothing else changed), so that a
later change to the port does not move the yardstick. The original
docstring follows.

Fresnel terms: exact complex-IOR conductor Fresnel, real dielectric
Fresnel with TIR, refraction, Schlick and F82 (port of
`optixpathtracer_tpu/core/fresnel.py`, reference `PBRT/Complex.h`,
`PBRT/Conductor.h:13-92`, `PBRT/Dielectric.h:20-92`).

Complex numbers are (re, im) pairs of float32 tensors, in the reference's
operation order.
"""
from __future__ import annotations

import torch

from .pmath import div, dot, ipow, safe_sqrt, sqr, sqrt


def _c_mul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _c_div(ar, ai, br, bi):
    scale = 1.0 / (br * br + bi * bi)
    return (ar * br + ai * bi) * scale, (ai * br - ar * bi) * scale


def _c_sqrt(ar, ai):
    """Principal complex sqrt (reference `Complex.h` sqrt)."""
    n = sqrt(ar * ar + ai * ai)
    t1 = sqrt(0.5 * (n + ar.abs()))
    t2 = 0.5 * ai / torch.where(t1 == 0.0, 1.0, t1)
    re = torch.where(ar >= 0.0, t1, t2.abs())
    im = torch.where(ar >= 0.0, t2, torch.where(ai >= 0.0, t1, -t1))
    return re, im


def _c_norm(ar, ai):
    return ar * ar + ai * ai


def fr_complex(cos_theta_i, eta_re, eta_im):
    """Exact Fresnel reflectance for the complex IOR eta - i k
    (reference `Conductor.h:42-52` FrComplex)."""
    ci = torch.clamp(cos_theta_i, 0.0, 1.0)
    sin2_i = 1.0 - sqr(ci)
    e2r, e2i = _c_mul(eta_re, eta_im, eta_re, eta_im)
    s2t_r, s2t_i = _c_div(sin2_i, torch.zeros_like(sin2_i), e2r, e2i)
    ct_r, ct_i = _c_sqrt(1.0 - s2t_r, -s2t_i)
    eci_r, eci_i = eta_re * ci, eta_im * ci
    parl_r, parl_i = _c_div(eci_r - ct_r, eci_i - ct_i, eci_r + ct_r,
                            eci_i + ct_i)
    ect_r, ect_i = _c_mul(eta_re, eta_im, ct_r, ct_i)
    perp_r, perp_i = _c_div(ci - ect_r, -ect_i, ci + ect_r, ect_i)
    return 0.5 * (_c_norm(parl_r, parl_i) + _c_norm(perp_r, perp_i))


def conductor_eta_k(reflectance):
    """eta = 1, k = 2 sqrt(r) / sqrt(1 - r) with r clamped to [0, 0.9999]
    (reference `Conductor.h:54-70`)."""
    r = torch.clamp(reflectance, 0.0, 0.9999)
    k = 2.0 * safe_sqrt(r) / safe_sqrt(torch.clamp(1.0 - r, min=0.0) + 1e-12)
    return torch.ones_like(r), k


def fresnel_conductor(cos_theta_i, reflectance):
    """RGB conductor Fresnel from a reflectance color
    (reference `Conductor.h:54-92` FresnelComplex)."""
    eta, k = conductor_eta_k(reflectance)
    ci = (cos_theta_i[..., None] if reflectance.ndim > cos_theta_i.ndim
          else cos_theta_i)
    return fr_complex(ci, eta, k)


def fresnel_schlick(f0, mu):
    """Schlick approximation (reference `Conductor.h:13-15`); a Python
    number mu is raised in double precision, as in the reference."""
    m5 = (1.0 - mu) ** 5 if isinstance(mu, float) else ipow(1.0 - mu, 5)
    return f0 + (1.0 - f0) * m5


def fresnel_82(specular_color, f0, abs_cos_theta):
    """OpenPBR F82 conductor tint (reference `Conductor.h:26-40`)."""
    mu = abs_cos_theta
    mu_bar = 1.0 / 7.0
    f_mu = fresnel_schlick(f0, mu)
    f_mu_bar = fresnel_schlick(f0, mu_bar)
    middle = div(mu * ipow(1.0 - mu, 6), mu_bar * (1.0 - mu_bar) ** 6)
    return f_mu - middle * (f_mu_bar - specular_color * f_mu_bar)


def fresnel_dielectric(cos_theta_i, ior=1.5):
    """Real dielectric Fresnel with orientation flip and TIR -> 1
    (reference `Dielectric.h:20-42`)."""
    ci = torch.clamp(cos_theta_i, -1.0, 1.0)
    ior = torch.as_tensor(ior, dtype=torch.float32, device=ci.device)
    eta = torch.where(ci < 0.0, 1.0 / ior, ior)
    ci = ci.abs()
    sin2_i = 1.0 - sqr(ci)
    sin2_t = sin2_i / sqr(eta)
    tir = sin2_t >= 1.0
    ct = safe_sqrt(1.0 - torch.clamp(sin2_t, max=1.0))
    den_parl = eta * ci + ct
    den_perp = ci + eta * ct
    r_parl = (eta * ci - ct) / torch.where(den_parl == 0.0, 1.0, den_parl)
    r_perp = (ci - eta * ct) / torch.where(den_perp == 0.0, 1.0, den_perp)
    fr = 0.5 * (sqr(r_parl) + sqr(r_perp))
    return torch.where(tir, 1.0, fr)


def refract(wi, n, eta):
    """Snell refraction with orientation flip (reference
    `Dielectric.h:68-92`). Returns (valid, etap, wt): valid is False on
    total internal reflection, where wt = 0."""
    eta = torch.as_tensor(eta, dtype=torch.float32,
                          device=wi.device).expand(wi.shape[:-1])
    ci = dot(n, wi)
    flip = ci < 0.0
    eta_eff = torch.where(flip, 1.0 / eta, eta)
    ci = ci.abs()
    n_eff = torch.where(flip[..., None], -n, n)
    sin2_i = torch.clamp(1.0 - sqr(ci), min=0.0)
    sin2_t = sin2_i / sqr(eta_eff)
    valid = sin2_t < 1.0
    ct = safe_sqrt(1.0 - torch.clamp(sin2_t, max=1.0))
    wt = (-wi / eta_eff[..., None]
          + (ci / eta_eff - ct)[..., None] * n_eff)
    return valid, eta_eff, torch.where(valid[..., None], wt, 0.0)

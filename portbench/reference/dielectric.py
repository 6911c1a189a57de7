"""Frozen copy of `optixpathtracer_tpu_torch/bsdf/dielectric.py` for the benchmark's
plain reference (imports rewritten; nothing else changed), so that a
later change to the port does not move the yardstick. The original
docstring follows.

Smooth and rough dielectric BSDF, reflection and transmission (port of
`optixpathtracer_tpu/bsdf/dielectric.py`, reference `PBRT/Dielectric.h`).

eta is a per-lane parameter defaulting to the reference's 1.5. Radiance
mode divides transmitted throughput by eta_rel^2 (`Dielectric.h:134-135,
198-199, 271-273`); `radiance_mode`, `reflection` and `transmission` are
Python bools, as every caller passes them.
"""
from __future__ import annotations

import torch

from . import microfacet, rng
from .fresnel import fresnel_dielectric, refract
from .pmath import (abs_cos_theta, abs_dot, cos_theta, dot, length_sqr,
                         normalize, same_hemisphere, splat3, sqr, vec3)
from .base import (BSDFSample, is_effectively_smooth, roughness_to_alpha,
                   where_sample)

DEFAULT_IOR = 1.5


def _eta(eta, like):
    return torch.as_tensor(eta, dtype=torch.float32,
                           device=like.device).expand(like.shape[:-1])


def _generalized_half_vector(wo, wi, eta):
    """wm = wi * etap + wo face-forwarded to +z, with its validity mask
    (reference `Dielectric.h:104-122`)."""
    ct_o = cos_theta(wo)
    ct_i = cos_theta(wi)
    is_reflect = ct_i * ct_o > 0.0
    etap = torch.where(is_reflect, 1.0,
                       torch.where(ct_o > 0.0, eta, 1.0 / eta))
    wm_raw = wi * etap[..., None] + wo
    degenerate = (ct_i == 0.0) | (ct_o == 0.0) | (length_sqr(wm_raw) == 0.0)
    wm = normalize(wm_raw)
    wm = torch.where((wm[..., 2] < 0.0)[..., None], -wm, wm)
    backfacing = (dot(wm, wi) * ct_i < 0.0) | (dot(wm, wo) * ct_o < 0.0)
    return wm, etap, is_reflect, ~degenerate & ~backfacing


def f(roughness, wo, wi, eta=DEFAULT_IOR, radiance_mode=True):
    """Rough dielectric BSDF value (reference `Dielectric.h:96-139`); 0 for
    smooth (delta) surfaces. Returns [..., 3]."""
    eta = _eta(eta, wo)
    alpha = roughness_to_alpha(roughness)
    wm, etap, is_reflect, valid = _generalized_half_vector(wo, wi, eta)
    ct_o = cos_theta(wo)
    ct_i = cos_theta(wi)
    fr = fresnel_dielectric(dot(wo, wm), eta)
    d_val = microfacet.d(wm, alpha)
    g_val = microfacet.smith_g(wo, wi, alpha)

    denom_r = (4.0 * ct_i * ct_o).abs()
    f_reflect = d_val * g_val * fr / torch.where(denom_r == 0.0, 1.0, denom_r)

    denom_t = sqr(dot(wi, wm) + dot(wo, wm) / etap) * ct_i * ct_o
    ft = (d_val * (1.0 - fr) * g_val
          * (dot(wi, wm) * dot(wo, wm)
             / torch.where(denom_t == 0.0, 1.0, denom_t)).abs())
    if radiance_mode:
        ft = ft / sqr(etap)
    val = torch.where(is_reflect, f_reflect, ft)
    ok = (valid & ~is_effectively_smooth(alpha) & (eta != 1.0)
          & (denom_t != 0.0))
    return splat3(torch.where(ok, val, 0.0))


def sample(seed, roughness, wo, eta=DEFAULT_IOR, radiance_mode=True,
           reflection=True, transmission=True):
    """Sample the dielectric BSDF (reference `Dielectric.h:146-288`).
    Draws one uniform for the lobe choice, then two for the microfacet
    normal, on every lane. Returns (seed, BSDFSample)."""
    shape = wo.shape[:-1]
    dev = wo.device
    eta = _eta(eta, wo)
    alpha = roughness_to_alpha(roughness).expand(shape)
    smooth = is_effectively_smooth(alpha) | (eta == 1.0)
    true_ = torch.ones(shape, dtype=torch.bool, device=dev)
    false_ = torch.zeros(shape, dtype=torch.bool, device=dev)

    def _lobe_probs(r):
        t = 1.0 - r
        pr = r if reflection else torch.zeros_like(r)
        pt = t if transmission else torch.zeros_like(t)
        psum = pr + pt
        return t, pr, pt, psum, psum > 0.0

    seed, uc = rng.rnd(seed)

    # smooth (delta) case (`Dielectric.h:151-214`)
    r_s = fresnel_dielectric(cos_theta(wo), eta)
    t_s, pr_s, pt_s, psum_s, any_s = _lobe_probs(r_s)
    psum_s_safe = torch.where(any_s, psum_s, 1.0)
    choose_r_s = uc < pr_s / psum_s_safe

    wi_sr = vec3(-wo[..., 0], -wo[..., 1], wo[..., 2])
    ct_sr = abs_cos_theta(wi_sr)
    samp_sr = BSDFSample(
        color=splat3(r_s / torch.where(ct_sr == 0.0, 1.0, ct_sr)),
        direction=wi_sr, pdf=pr_s / psum_s_safe, valid=any_s,
        reflection=true_, transmission=false_, specular=true_, glossy=false_)

    z_up = vec3(torch.zeros_like(uc), torch.zeros_like(uc),
                torch.ones_like(uc))
    valid_t, etap_s, wi_st = refract(wo, z_up, eta)
    ct_st = abs_cos_theta(wi_st)
    ft_s = t_s / torch.where(ct_st == 0.0, 1.0, ct_st)
    if radiance_mode:
        ft_s = ft_s / sqr(etap_s)
    samp_st = BSDFSample(
        color=splat3(ft_s), direction=wi_st, pdf=pt_s / psum_s_safe,
        valid=any_s & valid_t, reflection=false_, transmission=true_,
        specular=true_, glossy=false_)
    smooth_sample = where_sample(choose_r_s, samp_sr, samp_st)

    # rough case (`Dielectric.h:215-287`)
    seed, wm = microfacet.sample_wm(seed, wo, alpha)
    r_r = fresnel_dielectric(dot(wo, wm), eta)
    t_r, pr_r, pt_r, psum_r, any_r = _lobe_probs(r_r)
    psum_r_safe = torch.where(any_r, psum_r, 1.0)
    choose_r_r = uc < pr_r / psum_r_safe
    d_val = microfacet.d(wm, alpha)
    vndf = microfacet.pdf(wo, wm, alpha)

    wi_rr = -wo + 2.0 * dot(wo, wm)[..., None] * wm
    awm = abs_dot(wo, wm)
    pdf_rr = (vndf / torch.where(awm == 0.0, 1.0, 4.0 * awm)
              * pr_r / psum_r_safe)
    denom_rr = 4.0 * cos_theta(wi_rr) * cos_theta(wo)
    f_rr = (d_val * microfacet.smith_g(wo, wi_rr, alpha) * r_r
            / torch.where(denom_rr == 0.0, 1.0, denom_rr))
    samp_rr = BSDFSample(
        color=splat3(f_rr), direction=wi_rr, pdf=pdf_rr,
        valid=any_r & same_hemisphere(wo, wi_rr) & (awm != 0.0),
        reflection=true_, transmission=false_, specular=false_, glossy=true_)

    valid_rt, etap_r, wi_rt = refract(wo, wm, eta)
    denom_gt = sqr(dot(wi_rt, wm) + dot(wo, wm) / etap_r)
    dwm_dwi = abs_dot(wi_rt, wm) / torch.where(denom_gt == 0.0, 1.0, denom_gt)
    pdf_rt = vndf * dwm_dwi * pt_r / psum_r_safe
    denom_ft = cos_theta(wi_rt) * cos_theta(wo) * denom_gt
    ft_r = (t_r * d_val * microfacet.smith_g(wo, wi_rt, alpha)
            * (dot(wi_rt, wm) * dot(wo, wm)
               / torch.where(denom_ft == 0.0, 1.0, denom_ft)).abs())
    if radiance_mode:
        ft_r = ft_r / sqr(etap_r)
    samp_rt = BSDFSample(
        color=splat3(ft_r), direction=wi_rt, pdf=pdf_rt,
        valid=(any_r & valid_rt & ~same_hemisphere(wo, wi_rt)
               & (wi_rt[..., 2] != 0.0)),
        reflection=false_, transmission=true_, specular=false_, glossy=true_)
    rough_sample = where_sample(choose_r_r, samp_rr, samp_rt)
    return seed, where_sample(smooth, smooth_sample, rough_sample)


def pdf(roughness, wo, wi, eta=DEFAULT_IOR, reflection=True,
        transmission=True):
    """Sampling pdf of the rough dielectric (reference
    `Dielectric.h:290-343`); 0 for smooth surfaces."""
    eta = _eta(eta, wo)
    alpha = roughness_to_alpha(roughness)
    wm, etap, is_reflect, valid = _generalized_half_vector(wo, wi, eta)
    r = fresnel_dielectric(dot(wo, wm), eta)
    t = 1.0 - r
    pr = r if reflection else torch.zeros_like(r)
    pt = t if transmission else torch.zeros_like(t)
    psum = pr + pt
    any_p = psum > 0.0
    psum_safe = torch.where(any_p, psum, 1.0)
    vndf = microfacet.pdf(wo, wm, alpha)
    awm = abs_dot(wo, wm)
    pdf_r = vndf / torch.where(awm == 0.0, 1.0, 4.0 * awm) * pr / psum_safe
    denom = sqr(dot(wi, wm) + dot(wo, wm) / etap)
    dwm_dwi = abs_dot(wi, wm) / torch.where(denom == 0.0, 1.0, denom)
    pdf_t = vndf * dwm_dwi * pt / psum_safe
    val = torch.where(is_reflect, pdf_r, pdf_t)
    ok = valid & any_p & ~is_effectively_smooth(alpha) & (eta != 1.0)
    return torch.where(ok, val, 0.0)

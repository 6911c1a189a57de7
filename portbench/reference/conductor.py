"""Frozen copy of `optixpathtracer_tpu_torch/bsdf/conductor.py` for the benchmark's
plain reference (imports rewritten; nothing else changed), so that a
later change to the port does not move the yardstick. The original
docstring follows.

Rough and smooth conductor BRDF: Torrance-Sparrow with exact complex
Fresnel (port of `optixpathtracer_tpu/bsdf/conductor.py`, reference
`PBRT/Conductor.h:97-190`).

The complex IOR comes from the clamped reflectance color (eta = 1,
k = 2 sqrt(r) / sqrt(1 - r)); alpha < 1e-3 is a perfect mirror.
"""
from __future__ import annotations

import torch

from . import microfacet
from .fresnel import fresnel_conductor
from .pmath import (abs_cos_theta, abs_dot, length_sqr, normalize, reflect,
                    same_hemisphere, vec3)
from .base import (BSDFSample, is_effectively_smooth, roughness_to_alpha,
                   where_sample)


def f(reflectance, roughness, wo, wi):
    """D F G / (4 cos_i cos_o) (reference `Conductor.h:97-120`); zero for
    smooth (delta) surfaces."""
    alpha = roughness_to_alpha(roughness)
    ct_o = abs_cos_theta(wo)
    ct_i = abs_cos_theta(wi)
    wm_raw = wi + wo
    degenerate = (length_sqr(wm_raw) == 0.0) | (ct_i == 0.0) | (ct_o == 0.0)
    wm = normalize(wm_raw)
    fr = fresnel_conductor(abs_dot(wo, wm), reflectance)
    denom = 4.0 * ct_i * ct_o
    scale = (microfacet.d(wm, alpha) * microfacet.smith_g(wo, wi, alpha)
             / torch.where(denom == 0.0, 1.0, denom))
    ok = same_hemisphere(wo, wi) & ~is_effectively_smooth(alpha) & ~degenerate
    return torch.where(ok[..., None], scale[..., None] * fr, 0.0)


def sample(seed, reflectance, roughness, wo):
    """Perfect mirror when smooth, VNDF half-vector + reflect when rough
    (reference `Conductor.h:122-190`). Returns (seed, BSDFSample)."""
    shape = wo.shape[:-1]
    dev = wo.device
    alpha = roughness_to_alpha(roughness).expand(shape)
    smooth = is_effectively_smooth(alpha)
    true_ = torch.ones(shape, dtype=torch.bool, device=dev)
    false_ = torch.zeros(shape, dtype=torch.bool, device=dev)

    wi_s = vec3(-wo[..., 0], -wo[..., 1], wo[..., 2])
    ct = abs_cos_theta(wi_s)
    f_s = (fresnel_conductor(ct, reflectance)
           / torch.where(ct == 0.0, 1.0, ct)[..., None])
    smooth_sample = BSDFSample(
        color=f_s, direction=wi_s, pdf=torch.ones(shape, device=dev),
        valid=ct > 0.0, reflection=true_, transmission=false_,
        specular=true_, glossy=false_)

    seed, wm = microfacet.sample_wm(seed, wo, alpha)
    wi_r = reflect(wo, wm)
    awm = abs_dot(wo, wm)
    pdf_r = (microfacet.pdf(wo, wm, alpha)
             / torch.where(awm == 0.0, 1.0, 4.0 * awm))
    ct_o = abs_cos_theta(wo)
    ct_i = abs_cos_theta(wi_r)
    fr = fresnel_conductor(awm, reflectance)
    denom = 4.0 * ct_i * ct_o
    f_r = (microfacet.d(wm, alpha) * microfacet.smith_g(wo, wi_r, alpha)
           / torch.where(denom == 0.0, 1.0, denom))[..., None] * fr
    rough_valid = ((wo[..., 2] != 0.0) & same_hemisphere(wo, wi_r)
                   & (ct_i != 0.0) & (ct_o != 0.0) & (awm != 0.0))
    rough_sample = BSDFSample(
        color=f_r, direction=wi_r, pdf=pdf_r, valid=rough_valid,
        reflection=true_, transmission=false_, specular=false_, glossy=true_)
    return seed, where_sample(smooth, smooth_sample, rough_sample)


def pdf(roughness, wo, wi):
    """VNDF pdf of the rough lobe, 0 for smooth or invalid pairs (the pdf
    inside the reference's Sample_f)."""
    alpha = roughness_to_alpha(roughness)
    wm_raw = wo + wi
    ok = (same_hemisphere(wo, wi) & ~is_effectively_smooth(alpha)
          & (length_sqr(wm_raw) > 0.0))
    wm = normalize(wm_raw)
    awm = abs_dot(wo, wm)
    val = (microfacet.pdf(wo, wm, alpha)
           / torch.where(awm == 0.0, 1.0, 4.0 * awm))
    return torch.where(ok, val, 0.0)

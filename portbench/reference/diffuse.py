"""Frozen copy of `optixpathtracer_tpu_torch/bsdf/diffuse.py` for the benchmark's
plain reference (imports rewritten; nothing else changed), so that a
later change to the port does not move the yardstick. The original
docstring follows.

Lambertian diffuse BRDF (port of `optixpathtracer_tpu/bsdf/diffuse.py`,
reference `PBRT/LambertDiffuse.h:86-140`).

f = albedo/pi in the upper hemisphere, cosine-weighted sampling via the
concentric disk map, pdf = cos(theta)/pi.
"""
from __future__ import annotations

import torch

from . import rng
from .pmath import INV_PI, abs_cos_theta, same_hemisphere
from .base import BSDFSample


def f(albedo, wo, wi):
    """albedo/pi when wo, wi share a hemisphere."""
    mask = same_hemisphere(wo, wi)
    return torch.where(mask[..., None], albedo * INV_PI, 0.0)


def sample(seed, albedo, wo, reflection=True):
    """Cosine-hemisphere importance sample. Like the reference, the
    direction is always in the +z hemisphere (callers flip)."""
    seed, d = rng.sample_cosine_hemisphere(seed)
    d = torch.cat([d[..., :2], d[..., 2:].abs()], dim=-1)
    pdf_val = abs_cos_theta(d) * INV_PI
    shape = wo.shape[:-1]
    valid = (pdf_val > 0.0) & reflection
    return seed, BSDFSample(
        color=torch.broadcast_to(albedo * INV_PI, shape + (3,)),
        direction=d,
        pdf=pdf_val,
        valid=valid,
        reflection=torch.ones(shape, dtype=torch.bool, device=wo.device),
        transmission=torch.zeros(shape, dtype=torch.bool, device=wo.device),
        specular=torch.zeros(shape, dtype=torch.bool, device=wo.device),
        glossy=torch.zeros(shape, dtype=torch.bool, device=wo.device),
    )


def pdf(wo, wi, reflection=True):
    """cos(theta)/pi in the shared hemisphere."""
    ok = same_hemisphere(wo, wi) & reflection
    return torch.where(ok, abs_cos_theta(wi) * INV_PI, 0.0)

"""Frozen copy of `optixpathtracer_tpu_torch/bsdf/base.py` for the benchmark's
plain reference (imports rewritten; nothing else changed), so that a
later change to the port does not move the yardstick. The original
docstring follows.

BSDF sample record (port of `optixpathtracer_tpu/bsdf/base.py`).

Every lobe exposes f(params, wo, wi), sample(seed, params, wo) and
pdf(params, wo, wi) in the local shading frame (normal = +z), batched over
leading wavefront axes. Invalid samples are flagged, never early-returned:
`valid=False` plays the role of the reference's `return false`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BSDFSample(NamedTuple):
    """A sampled direction with its BSDF value and pdf
    (reference `BSDFSample.h`), plus a validity mask."""
    color: torch.Tensor        # [..., 3] BSDF value f
    direction: torch.Tensor    # [..., 3] sampled wi (shading space)
    pdf: torch.Tensor          # [...]
    valid: torch.Tensor        # [...] bool
    reflection: torch.Tensor   # [...] bool
    transmission: torch.Tensor  # [...] bool
    specular: torch.Tensor     # [...] bool
    glossy: torch.Tensor       # [...] bool

    @staticmethod
    def invalid(shape, device):
        z3 = torch.zeros(tuple(shape) + (3,), device=device)
        z = torch.zeros(tuple(shape), device=device)
        false = torch.zeros(tuple(shape), dtype=torch.bool, device=device)
        return BSDFSample(z3, z3, z, false, false, false, false, false)


def where_sample(mask, a: BSDFSample, b: BSDFSample) -> BSDFSample:
    """Lane-select between two samples; mask has the wavefront shape."""
    m1 = mask[..., None]
    return BSDFSample(
        color=torch.where(m1, a.color, b.color),
        direction=torch.where(m1, a.direction, b.direction),
        pdf=torch.where(mask, a.pdf, b.pdf),
        valid=torch.where(mask, a.valid, b.valid),
        reflection=torch.where(mask, a.reflection, b.reflection),
        transmission=torch.where(mask, a.transmission, b.transmission),
        specular=torch.where(mask, a.specular, b.specular),
        glossy=torch.where(mask, a.glossy, b.glossy),
    )


def roughness_to_alpha(roughness):
    """alpha = roughness^2 (reference `Surface.h:26-30` GetAlpha)."""
    return roughness * roughness


def is_effectively_smooth(alpha):
    """alpha < 1e-3 is a perfect specular lobe (reference
    `Surface.h:22-24`)."""
    return alpha < 1e-3

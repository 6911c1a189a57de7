"""Material model + wavefront BSDF dispatch
(port of `optixpathtracer_tpu/bsdf/dispatch.py`).

Materials carry a first-class type enum. Dispatch evaluates every lobe in
the static `active_lobes` tuple on every lane and lane-selects, so the
wavefront stays dense and every lobe advances the RNG streams the same way
on every lane, as in the reference. The material-sorted shading of
`trace_paths` (`material_sort`) also passes `gates`, one host bool a lobe,
and a lobe gated off is skipped outright (`_gated`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng
from . import conductor as _conductor
from . import dielectric as _dielectric
from . import diffuse as _diffuse
from . import glossy_diffuse as _glossy
from .base import BSDFSample, where_sample

DIFFUSE = 0
CONDUCTOR = 1
DIELECTRIC = 2
GLOSSY_DIFFUSE = 3
METALLIC_MIX = 4

MATERIAL_NAMES = {
    "diffuse": DIFFUSE,
    "conductor": CONDUCTOR,
    "dielectric": DIELECTRIC,
    "glossy_diffuse": GLOSSY_DIFFUSE,
    "metallic_mix": METALLIC_MIX,
}

ALL_LOBES = (DIFFUSE, CONDUCTOR, DIELECTRIC, GLOSSY_DIFFUSE)


class MaterialParams(NamedTuple):
    """Per-lane material parameters (SoA over the wavefront)."""
    albedo: torch.Tensor     # [..., 3] linear
    metallic: torch.Tensor   # [...]
    roughness: torch.Tensor  # [...]
    ior: torch.Tensor        # [...]
    mat_type: torch.Tensor   # [...] int32 enum above


def resolve_stochastic_lobe(seed, mat: MaterialParams):
    """Resolve METALLIC_MIX into CONDUCTOR / GLOSSY_DIFFUSE with one draw
    per lane (reference `devicePrograms.cu:400`). Every lane draws, as in
    the reference, so the RNG streams stay aligned. Returns (seed, mat)."""
    seed, u = rng.rnd(seed)
    is_mix = mat.mat_type == METALLIC_MIX
    picked = torch.where(u < mat.metallic, CONDUCTOR, GLOSSY_DIFFUSE)
    new_type = torch.where(is_mix, picked, mat.mat_type)
    return seed, mat._replace(mat_type=new_type.to(torch.int32))


def _mirror_z(v):
    """Reflect a local-frame direction through the tangent plane."""
    return torch.cat([v[..., :2], -v[..., 2:]], dim=-1)


# Two-sidedness: surfaces keep their winding orientation, so backface hits
# see wo.z < 0. The one-sided lobes (diffuse, conductor) are made two-sided
# PBRT-style here: mirror wo/wi through the tangent plane when wo.z < 0.
# The dielectric needs the true orientation and the layered lobe flips
# itself (`GlossyDiffuse.h:110-135`).


def _gated(gates, lobe, seed, eval_fn, zero_fn):
    """`eval_fn(seed)` (returning (seed, value)), unless `gates` is given
    and gates[lobe] is false: then the lobe is skipped and (seed,
    zero_fn()) returned. The reference's lax.cond becomes a host `if`.

    A skipped lobe does not advance the RNG streams it would have used, so
    material-sorted images differ from unsorted ones by decorrelated
    samples (as unbiased, not bit-identical)."""
    if gates is None or gates[lobe]:
        return eval_fn(seed)
    return seed, zero_fn()


def f(seed, mat: MaterialParams, wo, wi, active_lobes=ALL_LOBES,
      gates=None):
    """Evaluate the BSDF for every lane (resolved types only: call
    `resolve_stochastic_lobe` first). Returns (seed, rgb). `active_lobes`
    (static) prunes lobes absent from the scene; `gates` (lobe -> bool)
    skips lobes at run time (`_gated`). Only the layered lobe hands its
    seed on, as in the reference."""
    t = mat.mat_type[..., None]
    flip = (wo[..., 2] < 0.0)[..., None]
    wo_m = torch.where(flip, _mirror_z(wo), wo)
    wi_m = torch.where(flip, _mirror_z(wi), wi)

    def zero3():
        return torch.zeros(wo.shape[:-1] + (3,), device=wo.device)

    out = zero3()
    if DIFFUSE in active_lobes:
        _, f_d = _gated(gates, DIFFUSE, seed,
                        lambda s: (s, _diffuse.f(mat.albedo, wo_m, wi_m)),
                        zero3)
        out = torch.where(t == DIFFUSE, f_d, out)
    if CONDUCTOR in active_lobes:
        _, f_c = _gated(gates, CONDUCTOR, seed,
                        lambda s: (s, _conductor.f(mat.albedo, mat.roughness,
                                                   wo_m, wi_m)), zero3)
        out = torch.where(t == CONDUCTOR, f_c, out)
    if DIELECTRIC in active_lobes:
        # the pure dielectric lobe tinted by albedo, as in the reference's
        # commented dispatch (`devicePrograms.cu:333`); it needs the true
        # orientation (the signed cosine picks the eta side), so no mirror
        _, f_x = _gated(gates, DIELECTRIC, seed,
                        lambda s: (s, _dielectric.f(mat.roughness, wo, wi,
                                                    eta=mat.ior)
                                   * mat.albedo), zero3)
        out = torch.where(t == DIELECTRIC, f_x, out)
    if GLOSSY_DIFFUSE in active_lobes:
        seed, f_glossy = _gated(
            gates, GLOSSY_DIFFUSE, seed,
            lambda s: _glossy.f(s, mat.albedo, mat.roughness, wo, wi,
                                eta=mat.ior), zero3)
        out = torch.where(t == GLOSSY_DIFFUSE, f_glossy, out)
    return seed, out


def sample(seed, mat: MaterialParams, wo, active_lobes=ALL_LOBES,
           gates=None):
    """Importance-sample the BSDF per lane. Returns (seed, BSDFSample).
    `gates`: see f()."""
    t = mat.mat_type
    flip = (wo[..., 2] < 0.0)[..., None]
    wo_m = torch.where(flip, _mirror_z(wo), wo)

    def _unflip(s):
        return s._replace(direction=torch.where(flip, _mirror_z(s.direction),
                                                s.direction))

    def invalid():
        return BSDFSample.invalid(wo.shape[:-1], wo.device)

    def sample_x(s):
        s, sx = _dielectric.sample(s, mat.roughness, wo, eta=mat.ior)
        return s, sx._replace(color=sx.color * mat.albedo)

    out = invalid()
    if DIFFUSE in active_lobes:
        seed, s = _gated(gates, DIFFUSE, seed,
                         lambda s: _diffuse.sample(s, mat.albedo, wo_m),
                         invalid)
        out = where_sample(t == DIFFUSE, _unflip(s), out)
    if CONDUCTOR in active_lobes:
        seed, s = _gated(gates, CONDUCTOR, seed,
                         lambda s: _conductor.sample(s, mat.albedo,
                                                     mat.roughness, wo_m),
                         invalid)
        out = where_sample(t == CONDUCTOR, _unflip(s), out)
    if DIELECTRIC in active_lobes:
        seed, s = _gated(gates, DIELECTRIC, seed, sample_x, invalid)
        out = where_sample(t == DIELECTRIC, s, out)
    if GLOSSY_DIFFUSE in active_lobes:
        seed, s = _gated(gates, GLOSSY_DIFFUSE, seed,
                         lambda s: _glossy.sample(s, mat.albedo,
                                                  mat.roughness, wo,
                                                  eta=mat.ior), invalid)
        out = where_sample(t == GLOSSY_DIFFUSE, s, out)
    return seed, out


def pdf(mat: MaterialParams, wo, wi, layered: str = "error"):
    """Sampling pdf per lane of the deterministic lobes. The layered lobe
    has no closed-form pdf (the integrator has no MIS: its only lights are
    delta point lights): layered="error" gives its lanes NaN, so a misuse
    shows; layered="approx" gives them 0.5 * (diffuse + coat reflection),
    a usable MIS proxy."""
    if layered not in ("error", "approx"):
        raise ValueError(f"layered={layered!r} (want 'error' or 'approx')")
    flip = (wo[..., 2] < 0.0)[..., None]
    wo_m = torch.where(flip, _mirror_z(wo), wo)
    wi_m = torch.where(flip, _mirror_z(wi), wi)
    p_diffuse = _diffuse.pdf(wo_m, wi_m)
    p_conductor = _conductor.pdf(mat.roughness, wo_m, wi_m)
    p_dielectric = _dielectric.pdf(mat.roughness, wo, wi, eta=mat.ior)
    if layered == "approx":
        p_glossy = 0.5 * (p_diffuse + _dielectric.pdf(
            mat.roughness, wo, wi, eta=mat.ior, transmission=False))
    else:
        p_glossy = torch.full_like(p_diffuse, float("nan"))
    t = mat.mat_type
    out = torch.where(t == DIELECTRIC, p_dielectric, p_glossy)
    out = torch.where(t == CONDUCTOR, p_conductor, out)
    return torch.where(t == DIFFUSE, p_diffuse, out)

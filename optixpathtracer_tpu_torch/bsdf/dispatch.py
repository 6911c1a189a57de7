"""Material model + wavefront BSDF dispatch
(port of `optixpathtracer_tpu/bsdf/dispatch.py`).

Materials carry a first-class type enum. The plain dispatch (`f_plain`,
`sample_plain`) evaluates every lobe in `lobes` on every lane and
lane-selects, so the wavefront stays dense and every lobe advances the RNG
streams the same way on every lane, as in the reference. This module alone
chooses how the BSDF runs: on CUDA inputs that autograd does not record
(`uses_kernel`), `f` and `sample` run the kernels of `csrc/layered_bsdf.cu`
(`f_kernel`, `sample_kernel`, launched by `kernels.py`), bit for bit the
plain dispatch: each lane evaluates only its own lobe, and steps its seed
past the other lobes' draws (`SAMPLE_DRAWS`). Everywhere else, on the CPU
and under autograd, they run the plain dispatch, whose lobes are plain on
every device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import spans
from ..core import rng
from . import conductor as _conductor
from . import dielectric as _dielectric
from . import diffuse as _diffuse
from . import glossy_diffuse as _glossy
from . import kernels as _kernels
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

# The lcg steps each lobe's sample takes on every lane, whatever the lane's
# type: the sample kernel steps a lane past the lobes it skips by these.
SAMPLE_DRAWS = {DIFFUSE: 2, CONDUCTOR: 2, DIELECTRIC: 3,
                GLOSSY_DIFFUSE: _glossy.sample_draws()}


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


def _on_cuda(x):
    return x.is_cuda


def uses_kernel(seed, mat: MaterialParams, wo, *wi):
    """Whether `f` and `sample` run as the kernels on these inputs: they lie
    on CUDA and autograd records none of them (the kernels have no
    backward)."""
    inputs = (wo, *wi, seed, mat.albedo, mat.roughness, mat.ior)
    return _on_cuda(wo) and not (
        torch.is_grad_enabled() and any(x.requires_grad for x in inputs))


@spans.traced(spans.BSDF_F)
def f(seed, mat: MaterialParams, wo, wi, active_lobes=ALL_LOBES):
    """Evaluate the BSDF for every lane (resolved types only: call
    `resolve_stochastic_lobe` first). Returns (seed, rgb). `active_lobes`
    (static) prunes lobes absent from the scene: a lane of an absent lobe
    gets zeros. The seed is handed back unchanged, as the layered lobe
    hands it back in the reference."""
    run = f_kernel if uses_kernel(seed, mat, wo, wi) else f_plain
    return run(seed, mat, wo, wi, active_lobes)


@spans.traced(spans.BSDF_SAMPLE)
def sample(seed, mat: MaterialParams, wo, active_lobes=ALL_LOBES):
    """Importance-sample the BSDF per lane. Returns (seed, BSDFSample); a
    lane of a lobe absent from `active_lobes` gets the invalid sample."""
    run = sample_kernel if uses_kernel(seed, mat, wo) else sample_plain
    return run(seed, mat, wo, active_lobes)


def f_plain(seed, mat: MaterialParams, wo, wi, lobes):
    """`f` as PyTorch ops: every lobe of `lobes` on every lane, then each
    lane's own selected."""
    t = mat.mat_type[..., None]
    flip = (wo[..., 2] < 0.0)[..., None]
    wo_m = torch.where(flip, _mirror_z(wo), wo)
    wi_m = torch.where(flip, _mirror_z(wi), wi)

    out = torch.zeros(wo.shape[:-1] + (3,), device=wo.device)
    if DIFFUSE in lobes:
        out = torch.where(t == DIFFUSE, _diffuse.f(mat.albedo, wo_m, wi_m),
                          out)
    if CONDUCTOR in lobes:
        f_c = _conductor.f(mat.albedo, mat.roughness, wo_m, wi_m)
        out = torch.where(t == CONDUCTOR, f_c, out)
    if DIELECTRIC in lobes:
        # the pure dielectric lobe tinted by albedo, as in the reference's
        # commented dispatch (`devicePrograms.cu:333`); it needs the true
        # orientation (the signed cosine picks the eta side), so no mirror
        f_x = _dielectric.f(mat.roughness, wo, wi, eta=mat.ior) * mat.albedo
        out = torch.where(t == DIELECTRIC, f_x, out)
    if GLOSSY_DIFFUSE in lobes:
        seed, f_glossy = _glossy.f(seed, mat.albedo, mat.roughness, wo, wi,
                                   eta=mat.ior)
        out = torch.where(t == GLOSSY_DIFFUSE, f_glossy, out)
    return seed, out


def sample_plain(seed, mat: MaterialParams, wo, lobes):
    """`sample` as PyTorch ops: every lobe of `lobes` samples every lane,
    then each lane's own sample is selected."""
    t = mat.mat_type
    flip = (wo[..., 2] < 0.0)[..., None]
    wo_m = torch.where(flip, _mirror_z(wo), wo)

    def _unflip(s):
        return s._replace(direction=torch.where(flip, _mirror_z(s.direction),
                                                s.direction))

    out = BSDFSample.invalid(wo.shape[:-1], wo.device)
    if DIFFUSE in lobes:
        seed, s = _diffuse.sample(seed, mat.albedo, wo_m)
        out = where_sample(t == DIFFUSE, _unflip(s), out)
    if CONDUCTOR in lobes:
        seed, s = _conductor.sample(seed, mat.albedo, mat.roughness, wo_m)
        out = where_sample(t == CONDUCTOR, _unflip(s), out)
    if DIELECTRIC in lobes:
        seed, s = _dielectric.sample(seed, mat.roughness, wo, eta=mat.ior)
        s = s._replace(color=s.color * mat.albedo)
        out = where_sample(t == DIELECTRIC, s, out)
    if GLOSSY_DIFFUSE in lobes:
        seed, s = _glossy.sample(seed, mat.albedo, mat.roughness, wo,
                                 eta=mat.ior)
        out = where_sample(t == GLOSSY_DIFFUSE, s, out)
    return seed, out


def lobe_mask(lobes):
    """The kernels' lobe mask: bit t set for each lobe t of `lobes`."""
    return sum(1 << lobe for lobe in lobes)


def f_kernel(seed, mat: MaterialParams, wo, wi, lobes, ops=None):
    """`f_plain` through the kernels, each lane evaluating its own lobe
    only, into one buffer: the layered lobe's walks (`kernels.layered_f`,
    on the layered lanes) and the closed-form lobes' kernel (on the
    others), each launched only where `lobes` needs it. ops: see
    kernels.layered_f (both kernels add to it)."""
    out = torch.empty(wo.shape, dtype=torch.float32, device=wo.device)
    closed = [lobe for lobe in lobes if lobe != GLOSSY_DIFFUSE]
    layered = GLOSSY_DIFFUSE in lobes
    if layered:
        _kernels.layered_f(seed, mat.mat_type, mat.albedo, mat.roughness, wo,
                           wi, mat.ior, out, others=not closed, ops=ops)
    if closed or not layered:
        _kernels.lobes_f(mat.mat_type, mat.albedo, mat.roughness, wo, wi,
                         mat.ior, lobe_mask(lobes), out, ops)
    return seed, out


def sample_kernel(seed, mat: MaterialParams, wo, lobes, ops=None):
    """`sample_plain` through one kernel, each lane sampling its own lobe
    only. ops: see f_kernel."""
    draws = [SAMPLE_DRAWS[lobe] if lobe in lobes else 0 for lobe in ALL_LOBES]
    return _kernels.lobes_sample(seed, mat.mat_type, mat.albedo,
                                 mat.roughness, wo, mat.ior,
                                 lobe_mask(lobes), draws, ops=ops)


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

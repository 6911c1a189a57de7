"""Layered glossy-diffuse BSDF: a dielectric coat over a Lambertian base
(port of `optixpathtracer_tpu/bsdf/glossy_diffuse.py`, reference
`PBRT/GlossyDiffuse.h`: PBRT-v4's LayeredBxDF with thickness 0.01,
maxDepth 10, nSamples 5, g 0, mediaAlbedo 0).

As in the reference port, mediaAlbedo == 0 makes the walk alternate
between the two interfaces, so the loop is unrolled with a static
interface parity (even depth: the Lambert base, odd depth: the coat), and
`continue`/`break` become per-lane `alive` masks. f() is nonzero only for
same-hemisphere pairs (an opposite-hemisphere pair needs a Lambert
transmission sample, which always fails).

Two RNG streams, as in the reference: the caller's stream drives interface
sampling, and a TEA-folded stream keyed by `float_hash_seed` drives Russian
roulette. f() evaluates its n_samples estimator walks as one leading axis,
each with its own TEA-folded stream, and leaves the caller's seed as it
was.

This is the plain lobe, on every device. Its CUDA kernels
(`csrc/layered_bsdf.cu`, bit for bit this lobe) run only where
`dispatch.py` chooses them.
"""
from __future__ import annotations

import torch

from ..core import rng
from ..core.math import abs_cos_theta, div, exp, same_hemisphere, sqr
from . import dielectric as _dielectric
from . import diffuse as _diffuse
from .base import (BSDFSample, is_effectively_smooth, roughness_to_alpha,
                   where_sample)

THICKNESS = 0.01
MAX_DEPTH = 10
N_SAMPLES = 5
DEFAULT_IOR = 1.5
_F32_TINY = 1.1754943508222875e-38  # smallest normal float32


def power_heuristic(f_pdf, g_pdf):
    """Balance-squared MIS weight, nf = ng = 1 (`GlossyDiffuse.h:91-95`)."""
    f2 = sqr(f_pdf)
    g2 = sqr(g_pdf)
    denom = f2 + g2
    return torch.where(denom > 0.0,
                       f2 / torch.where(denom > 0.0, denom, 1.0), 0.0)


def transmittance(dz: float, w):
    """exp(-|dz / w.z|), 1 at dz ~ 0 (`GlossyDiffuse.h:97-105`). Guarded
    at |w.z| > 1e-8 so a backward pass through it finds no NaN; below that
    the forward value is 0 in float32 anyway."""
    if abs(dz) <= _F32_TINY:
        return torch.ones_like(w[..., 2])
    wz = w[..., 2].abs()
    ok = wz > 1e-8
    tr = exp(div(-abs(dz), torch.where(ok, wz, 1.0)))
    return torch.where(ok, tr, 0.0)


def _nonzero3(c):
    return (c != 0.0).any(dim=-1)


def _ok(bs):
    return (bs.valid & _nonzero3(bs.color) & (bs.pdf != 0.0)
            & (bs.direction[..., 2] != 0.0))


def _per_pdf(color, cos, pdf):
    """color * cos / pdf, with pdf == 0 lanes divided by 1."""
    return (color * cos[..., None]
            / torch.where(pdf == 0.0, 1.0, pdf)[..., None])


def f(seed, albedo, roughness, wo, wi, eta=DEFAULT_IOR,
            n_samples=N_SAMPLES, max_depth=MAX_DEPTH, thickness=THICKNESS):
    """Stochastic estimate of the layered BSDF value, the mean of n_samples
    random walks (reference `GlossyDiffuse.h:141-367`). Returns
    (seed, rgb) with the caller's seed unchanged."""
    batch = wo.shape[:-1]
    lead = (n_samples,) + batch
    alpha = roughness_to_alpha(roughness).expand(batch)
    exit_specular = is_effectively_smooth(alpha)

    flip = (wo[..., 2] < 0.0)[..., None]  # two-sided (`:162-165`)
    wo = torch.where(flip, -wo, wo)
    wi = torch.where(flip, -wi, wi)
    same_hemi = same_hemisphere(wo, wi)

    # entrance reflection off the coat, counted n_samples times
    # (`GlossyDiffuse.h:206-207`)
    f_acc = torch.where(
        same_hemi[..., None],
        float(n_samples) * _dielectric.f(roughness, wo, wi, eta=eta,
                                         radiance_mode=True), 0.0)

    s_idx = torch.arange(n_samples, dtype=torch.int64, device=wo.device)
    s_idx = s_idx.reshape((n_samples,) + (1,) * len(batch))
    seed_outer = rng.tea(seed.expand(lead), s_idx)
    seed_rr = rng.float_hash_seed(wo[..., 0], wo[..., 1], wi[..., 0],
                                  wi[..., 1], seed)
    seed_rr = rng.tea(seed_rr.expand(lead), s_idx + 0x9E37)

    wo_b = wo.expand(lead + (3,))
    wi_b = wi.expand(lead + (3,))
    alb_b = albedo.expand(lead + (3,))
    rough_b = roughness.expand(lead)
    exit_spec_b = exit_specular.expand(lead)

    # the entrance transmission sample (wos) and the virtual light's
    # transmission sample (wis) through the coat (`GlossyDiffuse.h:229-240`)
    seed_outer, wos = _dielectric.sample(
        seed_outer, rough_b, wo_b, eta=eta, radiance_mode=True,
        reflection=False, transmission=True)
    seed_outer, wis = _dielectric.sample(
        seed_outer, rough_b, wi_b, eta=eta, radiance_mode=False,
        reflection=False, transmission=True)

    alive = same_hemi.expand(lead) & _ok(wos) & _ok(wis)
    beta = _per_pdf(wos.color, abs_cos_theta(wos.direction), wos.pdf)
    w = wos.direction
    walk_f = torch.zeros_like(beta)
    wis_weight = (abs_cos_theta(wis.direction)[..., None]
                  * transmittance(thickness, wis.direction)[..., None]
                  * wis.color
                  / torch.where(wis.pdf == 0.0, 1.0, wis.pdf)[..., None])

    for depth in range(max_depth):
        if depth > 3:  # Russian roulette (`GlossyDiffuse.h:253-260`)
            beta_max = beta.amax(dim=-1)
            rr_on = alive & (beta_max < 0.25)
            q = torch.clamp(1.0 - beta_max, min=0.0)
            seed_rr, u_rr = rng.rnd(seed_rr)
            die = rr_on & (u_rr < q)
            boost = torch.where(rr_on & ~die,
                                1.0 / torch.where(q < 1.0, 1.0 - q, 1.0),
                                1.0)
            beta = beta * boost[..., None]
            alive = alive & ~die

        beta = beta * transmittance(thickness, w)[..., None]

        if depth % 2 == 0:
            # bottom (Lambert): NEE toward the presampled wis direction
            # (`GlossyDiffuse.h:328-337`)
            ph_w = power_heuristic(wis.pdf,
                                   _diffuse.pdf(-w, -wis.direction))
            wt1 = torch.where(exit_spec_b, 1.0, ph_w)
            nee1 = (beta * _diffuse.f(alb_b, -w, -wis.direction)
                    * wt1[..., None] * wis_weight)
            walk_f = walk_f + torch.where(alive[..., None], nee1, 0.0)

            # sample the base (`:342-347`), then NEE through the exit coat
            # along the new direction (`:349-361`)
            seed_outer, bs = _diffuse.sample(seed_outer, alb_b, -w)
            bs_ok = _ok(bs)
            new_beta = _per_pdf(beta * bs.color, abs_cos_theta(bs.direction),
                                bs.pdf)
            f_exit = _dielectric.f(rough_b, -bs.direction, wi_b, eta=eta,
                                   radiance_mode=True)
            exit_pdf = _dielectric.pdf(rough_b, -bs.direction, wi_b, eta=eta,
                                       reflection=False, transmission=True)
            wt2 = power_heuristic(bs.pdf, exit_pdf)
            nee2 = (new_beta
                    * transmittance(thickness, bs.direction)[..., None]
                    * f_exit * wt2[..., None])
            on2 = alive & bs_ok & ~exit_spec_b & _nonzero3(f_exit)
            walk_f = walk_f + torch.where(on2[..., None], nee2, 0.0)
        else:
            # top (dielectric): reflection back down (`:315-325`)
            seed_outer, bs = _dielectric.sample(
                seed_outer, rough_b, -w, eta=eta, radiance_mode=True,
                reflection=True, transmission=False)
            bs_ok = _ok(bs)
            new_beta = _per_pdf(beta * bs.color, abs_cos_theta(bs.direction),
                                bs.pdf)
        alive = alive & bs_ok
        beta = torch.where(alive[..., None], new_beta, beta)
        w = torch.where(alive[..., None], bs.direction, w)

    walk_sum = walk_f[0]
    for k in range(1, n_samples):  # summed in order on every device
        walk_sum = walk_sum + walk_f[k]
    total = f_acc + walk_sum
    return seed, div(total, float(n_samples))


def sample(seed, albedo, roughness, wo, eta=DEFAULT_IOR,
                 max_depth=MAX_DEPTH, thickness=THICKNESS):
    """Sample the layered BSDF with one random walk (reference
    `GlossyDiffuse.h:372-524`). The pdf is the product of the walk's pdfs,
    as in the reference. Returns (seed, BSDFSample)."""
    batch = wo.shape[:-1]
    dev = wo.device
    rough_b = roughness.expand(batch)
    true_ = torch.ones(batch, dtype=torch.bool, device=dev)
    false_ = torch.zeros(batch, dtype=torch.bool, device=dev)

    flip = wo[..., 2] < 0.0  # two-sided (`:388-392`)
    wo_up = torch.where(flip[..., None], -wo, wo)

    # entrance event at the coat (`:394-409`)
    seed, bs0 = _dielectric.sample(seed, rough_b, wo_up, eta=eta,
                                   radiance_mode=True, reflection=True,
                                   transmission=True)
    bs0_ok = _ok(bs0)
    refl_sample = BSDFSample(
        color=bs0.color,
        direction=torch.where(flip[..., None], -bs0.direction,
                              bs0.direction),
        pdf=bs0.pdf, valid=bs0_ok & bs0.reflection, reflection=true_,
        transmission=false_, specular=bs0.specular, glossy=~bs0.specular)

    # transmitted into the layer: the walk (`:408-427`)
    walking = bs0_ok & bs0.transmission
    w = bs0.direction
    f_val = bs0.color * abs_cos_theta(bs0.direction)[..., None]
    pdf_val = bs0.pdf
    specular_path = bs0.specular
    seed_rr = rng.float_hash_seed(wo_up[..., 0], wo_up[..., 1], seed)

    done = false_
    out_color = torch.zeros(batch + (3,), device=dev)
    out_dir = torch.zeros(batch + (3,), device=dev)
    out_pdf = torch.zeros(batch, device=dev)
    out_specular = false_
    alb_b = albedo.expand(batch + (3,))

    for depth in range(max_depth):
        if depth > 3:  # Russian roulette (`:432-439`)
            # a denormal pdf would make f / pdf inf and its masked backward
            # NaN; 1.0 keeps the same decision (no roulette)
            pdf_ok = pdf_val > 1e-20
            rr_beta = torch.where(
                pdf_ok,
                f_val.amax(dim=-1) / torch.where(pdf_ok, pdf_val, 1.0), 1.0)
            rr_on = walking & (rr_beta < 0.25)
            q = torch.clamp(1.0 - rr_beta, min=0.0)
            seed_rr, u_rr = rng.rnd(seed_rr)
            die = rr_on & (u_rr < q)
            pdf_val = torch.where(rr_on & ~die, pdf_val * (1.0 - q), pdf_val)
            walking = walking & ~die
        walking = walking & (w[..., 2] != 0.0)

        # advance to the other interface (`:473-477`)
        f_val = torch.where(walking[..., None],
                            f_val * transmittance(thickness, w)[..., None],
                            f_val)
        if depth % 2 == 0:  # bottom: Lambert reflection, never transmits
            seed, bs = _diffuse.sample(seed, alb_b, -w)
            bs_transmission = false_
        else:  # top: the coat reflects back down or transmits out
            seed, bs = _dielectric.sample(seed, rough_b, -w, eta=eta,
                                          radiance_mode=True,
                                          reflection=True, transmission=True)
            bs_transmission = bs.transmission

        walking = walking & _ok(bs)
        f_val = torch.where(walking[..., None], f_val * bs.color, f_val)
        pdf_val = torch.where(walking, pdf_val * bs.pdf, pdf_val)
        specular_path = specular_path & torch.where(walking, bs.specular,
                                                    True)
        w = torch.where(walking[..., None], bs.direction, w)

        # exit through the top (`:500-518`)
        first_exit = walking & bs_transmission & ~done
        out_color = torch.where(first_exit[..., None], f_val, out_color)
        out_dir = torch.where(first_exit[..., None], w, out_dir)
        out_pdf = torch.where(first_exit, pdf_val, out_pdf)
        out_specular = torch.where(first_exit, specular_path, out_specular)
        done = done | (walking & bs_transmission)
        walking = walking & ~bs_transmission

        # cosine after an in-layer scattering event (`:520-521`)
        f_val = torch.where(walking[..., None],
                            f_val * abs_cos_theta(bs.direction)[..., None],
                            f_val)

    walk_reflection = same_hemisphere(wo_up, out_dir)
    walk_sample = BSDFSample(
        color=out_color,
        direction=torch.where(flip[..., None], -out_dir, out_dir),
        pdf=out_pdf, valid=done, reflection=walk_reflection,
        transmission=~walk_reflection, specular=out_specular,
        glossy=~out_specular)
    return seed, where_sample(bs0_ok & bs0.reflection, refl_sample,
                              walk_sample)


def sample_draws(max_depth=MAX_DEPTH):
    """The lcg steps `sample` takes on every lane: the entrance coat
    event's 3, then 2 at each Lambert (even) depth and 3 at each coat (odd)
    one, whether the walk goes on or not."""
    return 3 + sum(3 if depth & 1 else 2 for depth in range(max_depth))

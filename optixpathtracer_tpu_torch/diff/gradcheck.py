"""Pixel gradients w.r.t. material parameters and their finite-difference
check (port of `optixpathtracer_tpu/diff/gradcheck.py`).

Estimator: detached sampling. Intersection runs detached and only the
refinement from the hit's triangle id is differentiated
(`intersect/api.py`); sampled directions carry no parameter gradient
(`core/microfacet.py`). So albedo and light gradients are exact per
sample and match same-seed finite differences; roughness and IOR
gradients are unbiased in expectation only; discrete decisions (lobe
picks, roulette, visibility) contribute none.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.math import div

DIFF_FIELDS = ("mat_albedo", "mat_metallic", "mat_roughness", "mat_ior",
               "light_color")


def render_loss_fn(scene, cam_params, width, height, frames,
                   max_bounces=2, intersect_method="brute",
                   loss="mean"):
    """loss(params) -> scalar tensor, where params maps differentiable scene
    fields to tensors. `frames` lists the frame ids averaged over."""
    from ..integrate.path import render_sample
    pos, inv_view, inv_proj = cam_params

    def loss_fn(params):
        s = dataclasses.replace(scene, **params)
        acc = 0.0
        for fid in frames:
            img = render_sample(s, pos, inv_view, inv_proj, width, height,
                                fid, max_bounces, intersect_method)
            acc = acc + img
        img = div(acc, float(len(frames)))
        if loss == "mean":
            return img.mean()
        raise ValueError(loss)

    return loss_fn


def param_gradients(scene, cam_params, width, height, frames,
                    fields=DIFF_FIELDS, **kw):
    """Gradients of the mean image intensity w.r.t. the given scene fields:
    {field: tensor shaped like the field}."""
    fields = [f for f in fields if hasattr(scene, f)]
    params = {f: getattr(scene, f).detach().clone().requires_grad_(True)
              for f in fields}
    loss = render_loss_fn(scene, cam_params, width, height, frames,
                          **kw)(params)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return {f: torch.zeros_like(p) if g is None else g
            for (f, p), g in zip(params.items(), grads)}


def finite_difference(scene, cam_params, width, height, frames, field,
                      index, h=1e-3, **kw):
    """Central finite difference of the same loss w.r.t. one scalar entry
    of a scene field (same seeds on both sides: the deterministic RNG makes
    it noise-free for parameters that do not steer sampling)."""
    loss_fn = render_loss_fn(scene, cam_params, width, height, frames, **kw)
    base = getattr(scene, field).detach()

    def eval_at(delta):
        arr = base.cpu().numpy().copy()
        arr[index] += delta
        with torch.no_grad():
            return float(loss_fn({field: torch.as_tensor(
                arr, device=base.device)}))

    return (eval_at(h) - eval_at(-h)) / (2.0 * h)

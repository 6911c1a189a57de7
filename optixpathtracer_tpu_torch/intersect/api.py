"""Unified intersection API with the differentiability contract
(port of `optixpathtracer_tpu/intersect/api.py`).

The discrete part of intersection (which triangle, did it hit) runs
detached, whichever engine computes it; the continuous part (t, u, v) is
then recomputed from the detached id in a few differentiable operations
(`_refine`), so gradients can reach ray origins, directions and vertices
without a backward pass through any engine.

Engines by method string (the reference's strings, so a caller passes the
same one to both packages): "brute" (oracle), "pallas" (the dense sweep),
"walk" (the walk engine) and "packet" (the packet engine), each CUDA
kernels on CUDA tensors and plain versions on the CPU, and "bvh" (the
skip-link BVH, CPU only).
"""
from __future__ import annotations

import torch

from ..core.math import cross, dot
from . import (brute, bvh_traverse, dense_kernels, packet_kernels,
               walk_kernels)
from .types import Hit

# CPU routing, as the reference routes off the TPU: below this triangle
# count the brute oracle, above it the BVH.
BRUTE_FORCE_MAX_TRIS = 2048
# Card routing, the reference's TPU table (`api.py:71-76`): below this many
# walk chunks the dense sweep, at or above it the walk engine ...
WALK_MIN_CHUNKS = 8
# ... and the packet engine for secondary bounces at this many chunks.
PACKET_BOUNCE_MIN_CHUNKS = 512

_ENGINES = {"brute": brute, "bvh": bvh_traverse, "pallas": dense_kernels,
            "walk": walk_kernels, "packet": packet_kernels}


def _resolve(method: str, scene, device) -> str:
    """The engine for `method` on `device`. "auto:bounce" is "auto" with the
    hint that the wavefront is a secondary bounce (incoherent directions),
    which the packet engine serves on scenes of many chunks."""
    bounce = method == "auto:bounce"
    if bounce:
        method = "auto"
    if method != "auto":
        return method
    if torch.device(device).type == "cuda":
        n_chunks = scene.walk_tris.shape[0]
        if n_chunks >= WALK_MIN_CHUNKS:
            if bounce and n_chunks >= PACKET_BOUNCE_MIN_CHUNKS:
                return "packet"
            return "walk"
        return "pallas"
    n = scene.tri_v0.shape[0]
    return "brute" if n <= BRUTE_FORCE_MAX_TRIS else "bvh"


def _engine(method: str):
    if method in _ENGINES:
        return _ENGINES[method]
    raise ValueError(f"unknown intersect method {method!r}")


def _refine(scene, o, d, hit: Hit, tmax):
    """Recompute (t, u, v, back_face) from the detached tri_id with
    differentiable operations."""
    safe_id = hit.tri_id.clamp(min=0).long()
    v0 = scene.tri_v0[safe_id]
    e1 = scene.tri_e1[safe_id]
    e2 = scene.tri_e2[safe_id]
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = det.abs() > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    live = hit.hit & ok
    return Hit(
        t=torch.where(live, t, tmax),
        tri_id=hit.tri_id,
        u=torch.where(live, u, 0.0),
        v=torch.where(live, v, 0.0),
        hit=live,
        back_face=live & (det < 0.0),
    )


def _bound(x, device):
    """tmin/tmax as a detached float32 tensor (a value derived from hit
    positions may carry gradients; the engines must not see them)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.float32)
    return torch.tensor(x, dtype=torch.float32, device=device)


def intersect_closest(scene, o, d, tmin=0.0, tmax=100.0, method="auto"):
    """Closest-hit query with differentiable refinement. method in
    {'auto', 'auto:bounce', 'brute', 'bvh', 'pallas', 'walk', 'packet'}."""
    engine = _engine(_resolve(method, scene, o.device))
    tmin = _bound(tmin, o.device)
    tmax = _bound(tmax, o.device)
    with torch.no_grad():
        raw = engine.intersect_closest(scene, o.detach(), d.detach(), tmin,
                                       tmax)
    tmax_arr = tmax.expand(o.shape[:-1])
    return _refine(scene, o, d, raw, tmax_arr)


def intersect_any(scene, o, d, tmin=0.0, tmax=100.0, method="auto"):
    """Occlusion query (boolean, non-differentiable by design). Every input
    is detached, tmin/tmax included."""
    engine = _engine(_resolve(method, scene, o.device))
    with torch.no_grad():
        return engine.intersect_any(scene, o.detach(), d.detach(),
                                    _bound(tmin, o.device),
                                    _bound(tmax, o.device))

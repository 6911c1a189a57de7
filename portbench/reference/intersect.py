"""Closest-hit and occlusion queries by brute force over the triangles of
each mesh whose bounding sphere the ray segment passes near.

The per-(ray, triangle) test is Moller-Trumbore with the program's
operation order and guards (`core.math`'s dot and cross), so a triangle
that both sides test gives the same t on both. The closest hit is the
least t; on an exact tie the lowest triangle id (mesh order) wins. The
bounding-sphere cull only skips work: its margin keeps every triangle the
test could accept.

The tests run in blocks of at most TRIS_PER_BLOCK triangles of one mesh
and as many rays as keep a block within PAIRS_PER_BLOCK (ray, triangle)
pairs, so that no mesh size can exhaust the device. Blocks are taken in
order of triangle id and a later block wins only by a strictly lower t,
so the blocking changes no id and no t.
"""
from __future__ import annotations

import torch

from .pmath import cross, dot

EPS_DET = 1e-12
TRIS_PER_BLOCK = 1 << 10
PAIRS_PER_BLOCK = 1 << 26
MARGIN = 1e-3


def _mt(o, d, v0, e1, e2, tmin, tmax):
    """Moller-Trumbore for all pairs: o, d [R, 3]; v0, e1, e2 [C, 3].
    Returns (t, hit) [R, C]."""
    o = o[:, None, :]
    d = d[:, None, :]
    v0 = v0[None]
    e1 = e1[None]
    e2 = e2[None]
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = det.abs() > EPS_DET
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > tmin[:, None]) & (t < tmax[:, None]))
    return t, hit


def _near(o, d, tmin, tmax, centre, radius):
    """Rays whose segment (tmin, tmax) passes within the sphere (with a
    margin); dead segments (tmax <= tmin) never do."""
    c = torch.as_tensor(centre, dtype=torch.float32, device=o.device)
    oc = c - o
    tc = dot(oc, d) / torch.clamp(dot(d, d), min=1e-30)
    tc = torch.minimum(torch.maximum(tc, tmin), tmax)
    p = o + tc[:, None] * d - c
    r = radius * (1.0 + MARGIN) + MARGIN
    return (dot(p, p) <= r * r) & (tmax > tmin)


def _blocks(scene, o, d, tmin, tmax):
    """(first id, v0, e1, e2, rays) per block, in triangle id order: at
    most TRIS_PER_BLOCK triangles of a mesh whose sphere the rays pass
    near, and at most PAIRS_PER_BLOCK // triangles of those rays (an index
    tensor)."""
    for start, end, centre, radius in scene.groups:
        near = torch.nonzero(_near(o, d, tmin, tmax, centre, radius))[:, 0]
        if not near.numel():
            continue
        for first in range(start, end, TRIS_PER_BLOCK):
            sl = slice(first, min(first + TRIS_PER_BLOCK, end))
            step = PAIRS_PER_BLOCK // (sl.stop - sl.start)
            for b in range(0, near.numel(), step):
                yield (first, scene.tri_v0[sl], scene.tri_e1[sl],
                       scene.tri_e2[sl], near[b:b + step])


def _bounds(o, tmin, tmax):
    r = o.shape[0]

    def full(x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=o.device).expand(r).contiguous()
    return full(tmin), full(tmax)


@torch.no_grad()
def closest(scene, o, d, tmin, tmax):
    """(tri_id int64 [R], -1 on a miss; t [R], inf on a miss) of the
    closest hit."""
    tmin, tmax = _bounds(o, tmin, tmax)
    best_t = torch.full_like(tmax, float("inf"))
    best_id = torch.full(tmax.shape, -1, dtype=torch.int64, device=o.device)
    for first, v0, e1, e2, r in _blocks(scene, o, d, tmin, tmax):
        t, hit = _mt(o[r], d[r], v0, e1, e2, tmin[r], tmax[r])
        t = torch.where(hit, t, float("inf"))
        ct = t.amin(dim=1)
        ids = torch.arange(v0.shape[0], device=o.device)
        low = torch.where(t == ct[:, None], ids, v0.shape[0]).amin(1)
        better = ct < best_t[r]  # strict: lower ids win ties
        best_t[r] = torch.where(better, ct, best_t[r])
        best_id[r] = torch.where(better, first + low, best_id[r])
    return best_id, best_t


@torch.no_grad()
def occluded(scene, o, d, tmin, tmax):
    """True where some triangle blocks the segment (tmin, tmax)."""
    tmin, tmax = _bounds(o, tmin, tmax)
    blocked = torch.zeros(tmax.shape, dtype=torch.bool, device=o.device)
    for _, v0, e1, e2, r in _blocks(scene, o, d, tmin, tmax):
        _, hit = _mt(o[r], d[r], v0, e1, e2, tmin[r], tmax[r])
        blocked[r] = blocked[r] | hit.any(dim=1)
    return blocked


def refine(scene, o, d, tri_id, tmax):
    """(t, u, v, hit, back_face) from a detached triangle id, by
    differentiable operations (the program's `intersect.api._refine`)."""
    safe = tri_id.clamp(min=0)
    v0 = scene.tri_v0[safe]
    e1 = scene.tri_e1[safe]
    e2 = scene.tri_e2[safe]
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = det.abs() > EPS_DET
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    live = (tri_id >= 0) & ok
    return (torch.where(live, t, tmax), torch.where(live, u, 0.0),
            torch.where(live, v, 0.0), live, live & (det < 0.0))

"""Stackless skip-link BVH traversal in plain PyTorch (port of
`optixpathtracer_tpu/intersect/bvh_traverse.py`).

Every ray walks the DFS-ordered node array (`bvh_min/max/skip/first/
count`): an AABB hit on an inner node descends to node + 1, a miss or a
leaf jumps to node_skip. The reference vmaps a per-ray while_loop; here all
rays step together under masks, each step on the rays still walking, until
every ray is done. Leaves test up to MAX_LEAF_SIZE triangles, unrolled.

It is the CPU engine that `api._resolve` picks for scenes over
BRUTE_FORCE_MAX_TRIS triangles; it is not a kernel, and a CUDA tensor is
refused (the walk engine serves such scenes on the card).
"""
from __future__ import annotations

import torch

from ..core.math import cross, dot
from ..scene.bvh import MAX_LEAF_SIZE
from .types import Hit

EPS_DET = 1e-12


def _slab_test(o, inv_d, nmin, nmax, tmin, tmax):
    t0 = (nmin - o) * inv_d
    t1 = (nmax - o) * inv_d
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    return (t_near <= t_far) & (t_far >= tmin) & (t_near <= tmax)


def _mt_single(o, d, v0, e1, e2, tmin, tmax):
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = det.abs() > EPS_DET
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin)
           & (t < tmax))
    return t, u, v, hit, det < 0.0


def _traverse(scene, o, d, tmin, tmax, any_hit):
    if o.device.type != "cpu":
        raise ValueError(f"the bvh engine is the CPU engine, not for "
                         f"{o.device} (the walk engine serves the card)")
    r = o.shape[0]
    tmin = torch.as_tensor(tmin, dtype=torch.float32).expand(r)
    tmax = torch.as_tensor(tmax, dtype=torch.float32).expand(r)
    n_nodes, n_tris = scene.bvh_min.shape[0], scene.tri_v0.shape[0]
    safe_d = torch.where(d.abs() < 1e-20, torch.where(d >= 0, 1e-20, -1e-20),
                         d)
    inv_d = 1.0 / safe_d

    node = torch.zeros(r, dtype=torch.long)
    best_t = tmax.clone()
    best_id = torch.full((r,), -1, dtype=torch.int32)
    best_u = torch.zeros(r)
    best_v = torch.zeros(r)
    best_back = torch.zeros(r, dtype=torch.bool)
    done = torch.zeros(r, dtype=torch.bool)
    while True:
        idx = torch.nonzero((node < n_nodes) & ~done).squeeze(1)
        if idx.numel() == 0:
            break
        nd = node[idx]
        ro, rd, rinv = o[idx], d[idx], inv_d[idx]
        rmin, rmax = tmin[idx], tmax[idx]
        bt, bi = best_t[idx], best_id[idx]
        bu, bv, bb = best_u[idx], best_v[idx], best_back[idx]
        first = scene.bvh_first[nd].long()
        count = scene.bvh_count[nd].long()
        box_hit = _slab_test(ro, rinv, scene.bvh_min[nd], scene.bvh_max[nd],
                             rmin, torch.minimum(rmax, bt))
        is_leaf = count > 0
        for k in range(MAX_LEAF_SIZE):
            in_range = (k < count) & box_hit & is_leaf
            tri = torch.clamp(first + k, max=n_tris - 1)
            t, u, v, h, back = _mt_single(
                ro, rd, scene.tri_v0[tri], scene.tri_e1[tri],
                scene.tri_e2[tri], rmin, torch.minimum(rmax, bt))
            better = h & in_range & scene.tri_valid[tri] & (t < bt)
            bt = torch.where(better, t, bt)
            bi = torch.where(better, tri.to(torch.int32), bi)
            bu = torch.where(better, u, bu)
            bv = torch.where(better, v, bv)
            bb = torch.where(better, back, bb)
        best_t[idx], best_id[idx] = bt, bi
        best_u[idx], best_v[idx], best_back[idx] = bu, bv, bb
        node[idx] = torch.where(box_hit & ~is_leaf, nd + 1,
                                scene.bvh_skip[nd].long())
        if any_hit:
            done[idx] = bi >= 0
    return Hit(t=best_t, tri_id=best_id, u=best_u, v=best_v,
               hit=best_id >= 0, back_face=best_back)


def intersect_closest(scene, o, d, tmin=0.0, tmax=100.0):
    """Closest hit via the BVH. o, d: [R, 3]. Returns Hit [R]."""
    return _traverse(scene, o, d, tmin, tmax, any_hit=False)


def intersect_any(scene, o, d, tmin=0.0, tmax=100.0):
    """Occlusion via the BVH, each ray stopping at its first hit."""
    return _traverse(scene, o, d, tmin, tmax, any_hit=True).hit

"""The dense intersection engine: closest hit and occlusion over
128-triangle chunks in id order (port of
`optixpathtracer_tpu/intersect/pallas_kernels.py`).

Each query has two implementations of one contract:

* the CUDA kernel in `csrc/dense_intersect.cu` (replacing the Pallas
  `_closest_kernel` / `_any_kernel`), launched on CUDA tensors; and
* a plain PyTorch version, a chunked all-pairs sweep with no culling and
  the kernel's arithmetic, used for CPU tensors and as the kernel's check.

The contract: closest returns (t, id) with t = 3.4e38, id = -1 on a miss
and the lowest id among equal t; occlusion returns blocked where some
triangle has tmin < t < tmax. A wrapper picks the plain version only
because its tensors lie on the CPU; on a CUDA tensor it launches the
kernel or raises, and never falls back.

`launches` on each kernel wrapper counts its launches, so a run can show
that the render went through the kernels; `swept` and `tests` hold the
last launch's chunks some ray of a 128-ray block tested and the
ray-triangle tests its rays ran, per block (int32). `needed_work` counts
the same with plain PyTorch, from what the inputs need: the kernels must
report exactly that, and the bound is computed from it, each test weighed
by where its operations can end.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build, spans
from .types import Hit

TRI_CHUNK = 128      # triangles per chunk == culling cluster
BLOCK_RAYS = 128     # rays per CUDA block of the kernels
EPS_DET = 1e-12
BIG = 3.4e38         # miss distance of the raw closest query
PLAIN_PAIRS = 1 << 24  # (ray, triangle) pairs per step of the plain sweep


def dense_arrays(scene):
    """(tris [9, T_pad], boxes [6, C], n_live) of a scene, built once and
    cached on it (`_prep` in the reference, minus the ray planes).

    tris: v0 xyz, e1 xyz, e2 xyz planes, padded to a multiple of TRI_CHUNK
    with far-away degenerate triangles (v0 = 1e10, zero edges).
    boxes: per-chunk AABBs over the valid triangles (min xyz, max xyz);
    a chunk with no valid triangle gets the point box at BIG, which no slab
    test passes (an inverted box would pass every one).
    n_live: the last valid triangle's index + 1, the triangles the kernels
    sweep. Every slot from n_live on is padding (the flatten pads the
    scene's own arrays the same way): its zero edges give det = 0, so no
    ray hits it, and skipping it changes no answer."""
    cached = scene.cache.get("dense")
    if cached is not None:
        return cached
    t = scene.tri_v0.shape[0]
    n_chunks = -(-t // TRI_CHUNK)
    pad = n_chunks * TRI_CHUNK - t
    dev = scene.tri_v0.device

    def _pad(x, fill):
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill,
                                        dtype=x.dtype, device=dev)])

    v0 = _pad(scene.tri_v0.detach(), 1e10)
    e1 = _pad(scene.tri_e1.detach(), 0.0)
    e2 = _pad(scene.tri_e2.detach(), 0.0)
    valid = _pad(scene.tri_valid, False)[:, None]
    tris = torch.cat([v0, e1, e2], dim=1).T.contiguous()

    v1 = v0 + e1
    v2 = v0 + e2
    bb_min = torch.where(valid, torch.minimum(torch.minimum(v0, v1), v2), BIG)
    bb_max = torch.where(valid, torch.maximum(torch.maximum(v0, v1), v2),
                         -BIG)
    c_min = bb_min.view(n_chunks, TRI_CHUNK, 3).amin(dim=1)
    c_max = bb_max.view(n_chunks, TRI_CHUNK, 3).amax(dim=1)
    empty = c_min[:, :1] > c_max[:, :1]
    c_min = torch.where(empty, BIG, c_min)
    c_max = torch.where(empty, BIG, c_max)
    boxes = torch.cat([c_min.T, c_max.T]).contiguous()
    live = torch.nonzero(scene.tri_valid)
    n_live = int(live.max()) + 1 if live.numel() else 0
    if (tris[3:, n_live:] != 0).any():
        raise ValueError("a triangle past the last valid one has edges: "
                         "the dense kernels would skip a possible hit")
    scene.cache["dense"] = (tris, boxes, n_live)
    return tris, boxes, n_live


def _rays(o, d, tmin, tmax):
    """Contiguous float32 o, d [R, 3] and per-ray tmin, tmax [R]."""
    r = o.shape[0]
    if o.shape != (r, 3) or d.shape != (r, 3):
        raise ValueError(f"rays must be [R, 3], got {tuple(o.shape)} and "
                         f"{tuple(d.shape)}")

    def _per_ray(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=o.device)
        return x.expand(r).contiguous()

    return (o.detach().float().contiguous(), d.detach().float().contiguous(),
            _per_ray(tmin), _per_ray(tmax))


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the same contract and arithmetic, no culling.
# ---------------------------------------------------------------------------

def _mt_terms(o, d, tri):
    """Moller-Trumbore of rays [..., r] against triangle planes (nine
    planes broadcastable to [..., 1, c]) in the kernel's operation order:
    (ok, u, v, t), each [..., r, c]; ok where |det| > EPS_DET."""
    ox, oy, oz = o[..., 0:1], o[..., 1:2], o[..., 2:3]
    dx, dy, dz = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = det.abs() > EPS_DET
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    return ok, u, v, t


def _mt_hit(terms, tmin, limit):
    """The hits among `_mt_terms`: inside the triangle, tmin < t < limit
    (tmin, limit [..., r])."""
    ok, u, v, t = terms
    return (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > tmin[..., None]) & (t < limit[..., None]))


def _mt_plain(o, d, tmin, limit, tri):
    """Moller-Trumbore of rays [..., r] against triangle planes in the
    kernel's operation order: (t, hit), each [..., r, c]."""
    terms = _mt_terms(o, d, tri)
    return terms[3], _mt_hit(terms, tmin, limit)


def _exit_counts(ran, terms, dim):
    """[..., 3] int64: of the tests `ran` marks, summed over `dim`, those
    a test can leave once u rules the hit out (|det| too small, or u
    outside [0, 1]), those it can leave once v does (v < 0 or u + v > 1),
    and those that must go on to t: where the operations each needs end
    (`NeededWork.exits`)."""
    ok, u, v, _ = terms
    in_u = ok & (u >= 0.0) & (u <= 1.0)
    in_v = in_u & (v >= 0.0) & (u + v <= 1.0)
    return torch.stack([(ran & ~in_u).sum(dim), (ran & in_u & ~in_v).sum(dim),
                        (ran & in_v).sum(dim)], dim=-1)


def _steps(r, t_pad):
    """(rays, triangles) per step: about PLAIN_PAIRS pairs, whole chunks."""
    tc = max(TRI_CHUNK, min(t_pad, PLAIN_PAIRS // max(r, 1))
             // TRI_CHUNK * TRI_CHUNK)
    return max(1, PLAIN_PAIRS // tc), tc


def closest_plain(tris, o, d, tmin, tmax):
    """Plain version of the closest kernel: (t [R], id [R] int32)."""
    r, t_pad = o.shape[0], tris.shape[1]
    best_t = torch.full((r,), BIG, device=o.device)
    best_id = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    rc, tc = _steps(r, t_pad)
    for r0 in range(0, r, rc):
        rs = slice(r0, r0 + rc)
        bt, bi = best_t[rs], best_id[rs]
        for c0 in range(0, t_pad, tc):
            t, hit = _mt_plain(o[rs], d[rs], tmin[rs], tmax[rs],
                               tris[:, c0:c0 + tc])
            ct, arg = torch.where(hit, t, BIG).min(dim=1)  # lowest id on ties
            better = ct < bt  # strict: an earlier chunk keeps a tie
            bt = torch.where(better, ct, bt)
            bi = torch.where(better, (arg + c0).to(torch.int32), bi)
        best_t[rs], best_id[rs] = bt, bi
    return best_t, best_id


def any_plain(tris, o, d, tmin, tmax):
    """Plain version of the occlusion kernel: blocked [R] bool."""
    r, t_pad = o.shape[0], tris.shape[1]
    blocked = torch.zeros(r, dtype=torch.bool, device=o.device)
    rc, tc = _steps(r, t_pad)
    for r0 in range(0, r, rc):
        rs = slice(r0, r0 + rc)
        for c0 in range(0, t_pad, tc):
            _, hit = _mt_plain(o[rs], d[rs], tmin[rs], tmax[rs],
                               tris[:, c0:c0 + tc])
            blocked[rs] |= hit.any(dim=1)
    return blocked


def _safe_inv(d):
    """The kernels' reciprocal directions, |d| clamped to 1e-20 (no 0*inf
    in the slab tests)."""
    tiny = torch.where(d >= 0, 1e-20, -1e-20)
    return 1.0 / torch.where(d.abs() < 1e-20, tiny, d)


def _slab_plain(o, inv, tmin, limit, box):
    """The kernels' slab test of rays (o, inv [..., 3]) against boxes
    (min xyz, max xyz in box [..., 6], broadcast against the rays):
    [...] bool."""
    t0 = (box[..., :3] - o) * inv
    t1 = (box[..., 3:] - o) * inv
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    t_near = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    t_far = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    return (t_near <= t_far) & (t_far >= tmin) & (t_near <= limit)


class NeededWork(NamedTuple):
    """The work a sweep of given inputs needs, per ray block (int64).

    tests: ray-triangle tests; chunks: chunks some ray of the block tests;
    exits [n_blocks, 3]: the tests by where Moller-Trumbore's operations
    can end (`_exit_counts`): once u rules the hit out, once v does, or at
    t; they sum to tests. below, above: how far a kernel's reported tests
    may lie below and above tests (zero where the kernel reports exactly
    tests)."""
    tests: torch.Tensor
    chunks: torch.Tensor
    exits: torch.Tensor
    below: torch.Tensor
    above: torch.Tensor


def needed_work(kind, tris, boxes, n_live, o, d, tmin, tmax):
    """The work a dense sweep of these inputs needs, per 128-ray block, by
    a plain count model (a `NeededWork`). Chunks in id order; a live ray
    (tmax > tmin) whose slab test passes a chunk (bounded by min(best t,
    tmax) for "closest", tmax for "any") tests that chunk's real triangles
    (those before n_live), and an occlusion ray only up to its first
    blocker and no chunk after it. Padding triangles and dead rays cost
    nothing. The CUDA kernels report exactly these tests and chunks."""
    r = o.shape[0]
    inv = _safe_inv(d)
    bt = torch.full((r,), BIG, device=o.device)
    open_ = tmax > tmin
    n_blocks = -(-r // BLOCK_RAYS)
    exits = torch.zeros((n_blocks * BLOCK_RAYS, 3), dtype=torch.long,
                        device=o.device)
    chunks = torch.zeros(n_blocks, dtype=torch.long, device=o.device)
    for c in range(-(-n_live // TRI_CHUNK)):
        k0, k1 = c * TRI_CHUNK, min((c + 1) * TRI_CHUNK, n_live)
        limit = torch.minimum(bt, tmax) if kind == "closest" else tmax
        can = open_ & _slab_plain(o, inv, tmin, limit, boxes[:, c])
        per_block = torch.zeros(n_blocks * BLOCK_RAYS, dtype=torch.bool,
                                device=o.device)
        per_block[:r] = can
        chunks += per_block.view(n_blocks, BLOCK_RAYS).any(dim=1)
        idx = torch.nonzero(can).flatten()
        step = max(1, PLAIN_PAIRS // (k1 - k0))
        slot = torch.arange(k1 - k0, device=o.device)
        for s0 in range(0, idx.numel(), step):
            ix = idx[s0:s0 + step]
            terms = _mt_terms(o[ix], d[ix], tris[:, k0:k1])
            hit = _mt_hit(terms, tmin[ix], limit[ix])
            if kind == "closest":
                ran = torch.ones_like(hit)
                bt[ix] = torch.minimum(
                    bt[ix], torch.where(hit, terms[3], BIG).amin(dim=1))
            else:
                blocker = hit.any(dim=1)
                last = torch.where(blocker, hit.int().argmax(dim=1),
                                   k1 - k0 - 1)
                ran = slot <= last[:, None]
                open_[ix] &= ~blocker
            exits[ix] += _exit_counts(ran, terms, 1)
    exits = exits.view(n_blocks, BLOCK_RAYS, 3).sum(dim=1)
    zero = torch.zeros_like(chunks)
    return NeededWork(exits.sum(dim=1), chunks, exits, zero, zero)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/dense_intersect.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_ARGTYPES = {
    "dense_closest": [_P, _P, _P, _P, ctypes.c_int, _P, _P, ctypes.c_int,
                      ctypes.c_int, _P, _P, _P, _P, _P],
    "dense_any": [_P, _P, _P, _P, ctypes.c_int, _P, _P, ctypes.c_int,
                  ctypes.c_int, _P, _P, _P, _P],
    # the alpha-cutout chains (launched from integrate/cutout.py)
    "cutout_closest": [_P, _P, _P, _P, ctypes.c_int, _P, _P, ctypes.c_int,
                       ctypes.c_int, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                       _P, _P, _P, _P],
    "cutout_any": [_P, _P, _P, _P, _P, ctypes.c_int, _P, _P, ctypes.c_int,
                   ctypes.c_int, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P,
                   _P, _P],
}


def _fn(name):
    fn = getattr(_build.load("dense_intersect"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(tris, boxes, n_live, o, d, tmin, tmax):
    """Raise unless the inputs are what the kernels take: float32,
    contiguous, on o's CUDA device; rays [R, 3], bounds [R], tris
    [9, 128 C], boxes [6, C], 0 <= n_live <= 128 C. Returns the input
    pointers in kernel order."""
    r, n_chunks = o.shape[0], boxes.shape[-1]
    want = ((o, (r, 3)), (d, (r, 3)), (tmin, (r,)), (tmax, (r,)),
            (tris, (9, n_chunks * TRI_CHUNK)), (boxes, (6, n_chunks)))
    for x, shape in want:
        if not (x.is_cuda and x.device == o.device
                and x.dtype == torch.float32 and x.is_contiguous()
                and tuple(x.shape) == shape):
            raise ValueError(
                f"kernel input {tuple(x.shape)} {x.dtype} on {x.device}: "
                f"expected contiguous float32 {shape} on one CUDA device")
    if r >= 2**31:
        raise ValueError("too many rays for one launch")
    if not 0 <= n_live <= n_chunks * TRI_CHUNK:
        raise ValueError(f"n_live {n_live} outside "
                         f"[0, {n_chunks * TRI_CHUNK}]")
    return [x.data_ptr() for x, _ in want]


def closest_kernel(tris, boxes, n_live, o, d, tmin, tmax):
    """Launch the closest-hit kernel: (t [R], id [R] int32) on o's device."""
    o_p, d_p, tmin_p, tmax_p, tris_p, boxes_p = _check_cuda(
        tris, boxes, n_live, o, d, tmin, tmax)
    r = o.shape[0]
    out_t = torch.empty(r, dtype=torch.float32, device=o.device)
    out_id = torch.empty(r, dtype=torch.int32, device=o.device)
    counts = _count_buffer(o)
    with torch.cuda.device(o.device):
        err = _fn("dense_closest")(
            o_p, d_p, tmin_p, tmax_p, r, tris_p, boxes_p, boxes.shape[1],
            n_live, out_t.data_ptr(), out_id.data_ptr(),
            counts[0].data_ptr(), counts[1].data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"dense_closest launch failed: CUDA error {err}")
    closest_kernel.launches += 1
    closest_kernel.swept, closest_kernel.tests = counts
    return out_t, out_id


def any_kernel(tris, boxes, n_live, o, d, tmin, tmax):
    """Launch the occlusion kernel: blocked [R] bool on o's device."""
    o_p, d_p, tmin_p, tmax_p, tris_p, boxes_p = _check_cuda(
        tris, boxes, n_live, o, d, tmin, tmax)
    r = o.shape[0]
    out = torch.empty(r, dtype=torch.int32, device=o.device)
    counts = _count_buffer(o)
    with torch.cuda.device(o.device):
        err = _fn("dense_any")(
            o_p, d_p, tmin_p, tmax_p, r, tris_p, boxes_p, boxes.shape[1],
            n_live, out.data_ptr(), counts[0].data_ptr(),
            counts[1].data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"dense_any launch failed: CUDA error {err}")
    any_kernel.launches += 1
    any_kernel.swept, any_kernel.tests = counts
    return out > 0


def _count_buffer(o):
    """The kernels' int32 outputs per 128-ray block: row 0 the chunks swept,
    row 1 the ray-triangle tests run."""
    return torch.empty((2, -(-o.shape[0] // BLOCK_RAYS)), dtype=torch.int32,
                       device=o.device)


closest_kernel.launches = 0
any_kernel.launches = 0
closest_kernel.swept = any_kernel.swept = None
closest_kernel.tests = any_kernel.tests = None


def _require_cpu(o):
    if o.device.type != "cpu":
        raise ValueError(f"the dense engine runs on CUDA or the CPU, not on "
                         f"{o.device}")


# ---------------------------------------------------------------------------
# Engine interface (as the reference's brute/bvh/pallas engines)
# ---------------------------------------------------------------------------

def intersect_closest_raw(scene, o, d, tmin=0.0, tmax=100.0):
    """(t, tri_id) per ray; t = BIG and id = -1 on a miss."""
    tris, boxes, n_live = dense_arrays(scene)
    with spans.span(spans.ISECT_ORDER):
        rays = _rays(o, d, tmin, tmax)
    with spans.span(spans.ISECT_KERNEL), spans.span(spans.DENSE):
        if rays[0].is_cuda:
            return closest_kernel(tris, boxes, n_live, *rays)
        _require_cpu(rays[0])
        return closest_plain(tris, *rays)


@spans.traced(spans.ISECT_UNSORT)
def _hit_record(scene, o, best_t, best_id, tmax):
    """The Hit of raw (t, id): ids of padding triangles (dense, walk or
    flat padding) are misses, and misses report tmax."""
    n_real = scene.tri_valid.shape[0]
    valid = ((best_id >= 0) & (best_id < n_real)
             & scene.tri_valid[best_id.clamp(0, n_real - 1).long()])
    tmax_arr = torch.as_tensor(tmax, dtype=torch.float32,
                               device=o.device).expand(o.shape[:-1])
    zeros = torch.zeros_like(best_t)
    return Hit(t=torch.where(valid, best_t, tmax_arr),
               tri_id=torch.where(valid, best_id, -1),
               u=zeros, v=zeros, hit=valid,
               back_face=torch.zeros_like(valid))


def intersect_closest(scene, o, d, tmin=0.0, tmax=100.0):
    """Hit record; ids of padding triangles are rejected as misses."""
    best_t, best_id = intersect_closest_raw(scene, o, d, tmin, tmax)
    return _hit_record(scene, o, best_t, best_id, tmax)


def intersect_any(scene, o, d, tmin=0.0, tmax=100.0):
    """True where some triangle blocks the segment (tmin, tmax)."""
    tris, boxes, n_live = dense_arrays(scene)
    with spans.span(spans.ISECT_ORDER):
        rays = _rays(o, d, tmin, tmax)
    with spans.span(spans.ISECT_KERNEL), spans.span(spans.DENSE):
        if rays[0].is_cuda:
            return any_kernel(tris, boxes, n_live, *rays)
        _require_cpu(rays[0])
        return any_plain(tris, *rays)

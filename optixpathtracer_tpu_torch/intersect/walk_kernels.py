"""The walk engine: per-block candidate chunk lists sorted front to back,
then closest-hit and occlusion sweeps over them (port of
`optixpathtracer_tpu/intersect/walk_kernels.py`).

A query sorts its rays by a coherence key (`_coherence_perm`), cuts them
into blocks of `block_rays` rays, lists for each block the chunks some ray
of it can reach, sorted by entry distance (`_candidates`), sweeps each
block's list and undoes the sort. Three functions carry the work, each
with two implementations of one contract:

* CUDA kernels in `csrc/walk_intersect.cu`, launched on CUDA tensors:
  `walk_candidates` (replacing the Pallas `_make_cand_kernel`),
  `walk_closest` (`_make_sweep_kernel`) and `walk_any`
  (`_make_any_sweep_kernel`);
* plain PyTorch versions, for CPU tensors and as the kernels' check. The
  plain sweeps test every ray of a block against every chunk of its list,
  with neither the running cull nor the early exit: both only skip chunks
  that cannot improve a ray's answer, and the tie-break to the lowest id
  makes the answer independent of the order.

The coherence sort and the sort of the candidate entries are plain torch,
as the reference leaves them to XLA outside Pallas. A wrapper picks a plain
version only because its tensors lie on the CPU; on a CUDA tensor it
launches the kernel or raises. `launches` on each kernel wrapper counts its
launches; `swept` and `tests` on a sweep wrapper hold its last launch's
chunks swept and ray-triangle tests run per block. `needed_work` counts,
with plain PyTorch, the tests and chunks the inputs need: the closest
kernel reports exactly that, the occlusion kernel within a stated slack,
and the kernels' bound is computed from it, each test weighed by where
its operations can end.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, spans
from .dense_kernels import (BIG, NeededWork, _exit_counts, _hit_record,
                            _mt_hit, _mt_terms, _rays, _safe_inv,
                            _slab_plain)

LANES = 128          # candidate rows are padded to a multiple of this
BLOCK_RAYS = 256     # rays per block (one CUDA block); the reference: 1024
BLOCK_SIZES = (128, 256, 512, 1024)
CHUNK_STEP = 128     # walk chunks are a multiple of this many tris
PLAIN_ELEMS = 1 << 24  # elements per step of the plain versions
_MORT_O = 5  # origin Morton bits per axis in the coherence key
_MORT_D = 4  # direction Morton bits per axis


# ---------------------------------------------------------------------------
# Plain torch around the kernels: ray order, chunk boxes, candidate sort
# ---------------------------------------------------------------------------

def _spread3(x, bits):
    out = torch.zeros_like(x)
    for b in range(bits):
        out = out | (((x >> b) & 1) << (3 * b))
    return out


def _coherence_perm(scene, o, d):
    """The ray permutation that packs coherent rays into the same block:
    key = direction octant | origin Morton code | direction Morton code,
    stably sorted (keys in int64: torch's uint32 has no shifts)."""
    nb = scene.walk_node_box
    root_min = nb[0:3, 0]
    root_max = nb[3:6, 0]
    ext = torch.clamp(root_max - root_min, min=1e-6)
    so = float(1 << _MORT_O)
    qo = torch.clamp((o - root_min) / ext * so, 0.0, so - 1.0).to(torch.int64)
    om = (_spread3(qo[:, 0], _MORT_O) | (_spread3(qo[:, 1], _MORT_O) << 1)
          | (_spread3(qo[:, 2], _MORT_O) << 2))
    sd = float(1 << _MORT_D)
    qd = torch.clamp((d * 0.5 + 0.5) * sd, 0.0, sd - 1.0).to(torch.int64)
    dm = (_spread3(qd[:, 0], _MORT_D) | (_spread3(qd[:, 1], _MORT_D) << 1)
          | (_spread3(qd[:, 2], _MORT_D) << 2))
    octant = ((d[:, 0] >= 0).to(torch.int64)
              | ((d[:, 1] >= 0).to(torch.int64) << 1)
              | ((d[:, 2] >= 0).to(torch.int64) << 2))
    key = (octant << 27) | (om << 12) | dm
    # the key has 30 bits: sorting it as int32 gives the same permutation
    return torch.argsort(key.to(torch.int32), stable=True)


def _chunk_boxes(scene):
    """Chunk AABBs [6, C] (min xyz, max xyz) in walk order, taken from the
    chunk-BVH leaf nodes (walk_node_link[2] == 1, chunk id in
    walk_node_link[1]); built once and cached on the scene."""
    cached = scene.cache.get("walk_boxes")
    if cached is not None:
        return cached
    c = scene.walk_tris.shape[0]
    link = scene.walk_node_link.long()
    is_leaf = link[2] == 1
    node_of_chunk = torch.zeros(c, dtype=torch.long, device=link.device)
    node_of_chunk[link[1][is_leaf]] = torch.arange(
        link.shape[1], device=link.device)[is_leaf]
    boxes = scene.walk_node_box[:, node_of_chunk].float().contiguous()
    scene.cache["walk_boxes"] = boxes
    return boxes


def _check_walkable(scene):
    if scene.walk_tris.shape[0] == 0:
        raise ValueError(
            "scene has no walk arrays (flattened with build_bvh=False); "
            "the walk engine needs build_bvh=True")


def _n_blocks(r, block_rays):
    if block_rays not in BLOCK_SIZES:
        raise ValueError(f"block_rays {block_rays} not in {BLOCK_SIZES}")
    return -(-r // block_rays)


def _blocked(o, d, tmin, tmax, block_rays):
    """Rays as [n_blocks, block_rays, ...], padded with dead rays (origin
    0, direction 1, tmax = -1) as the kernels pad them."""
    r = o.shape[0]
    nb = _n_blocks(r, block_rays)
    pad = nb * block_rays - r

    def _pad(x, fill):
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill,
                                        dtype=x.dtype, device=x.device)])

    return (_pad(o, 0.0).view(nb, block_rays, 3),
            _pad(d, 1.0).view(nb, block_rays, 3),
            _pad(tmin, 0.0).view(nb, block_rays),
            _pad(tmax, -1.0).view(nb, block_rays))


@spans.traced(spans.ISECT_CANDIDATES)
def sort_candidates(entry):
    """(cand int32, tnear, count int32) from the entry distances
    [n_blocks, maxc_pad]: each row's chunks stably sorted by entry, and the
    number of chunks some ray of the block reaches."""
    tnear, order = torch.sort(entry, dim=1, stable=True)
    count = (entry < BIG).sum(dim=1, dtype=torch.int32)
    return order.to(torch.int32), tnear, count


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the three kernels
# ---------------------------------------------------------------------------

def candidates_plain(boxes, o, d, tmin, tmax, block_rays=BLOCK_RAYS):
    """Plain version of the candidate kernel: entry [n_blocks, maxc_pad],
    the min over each block's live rays (tmax >= 0) passing a chunk's slab
    test of max(t_near, 0), BIG where none passes and in padded slots."""
    o, d, tmin, tmax = _blocked(o, d, tmin, tmax, block_rays)
    inv = _safe_inv(d)
    nb, n_chunks = o.shape[0], boxes.shape[1]
    entry = torch.full((nb, -(-n_chunks // LANES) * LANES), BIG,
                       device=o.device)
    step = max(1, PLAIN_ELEMS // (block_rays * n_chunks))
    for b0 in range(0, nb, step):
        bs = slice(b0, b0 + step)
        ob, ib = o[bs][..., None], inv[bs][..., None]  # [s, B, 3, 1]
        t0 = (boxes[None, None, :3] - ob) * ib          # [s, B, 3, C]
        t1 = (boxes[None, None, 3:] - ob) * ib
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        t_near = torch.maximum(torch.maximum(lo[:, :, 0], lo[:, :, 1]),
                               lo[:, :, 2])
        t_far = torch.minimum(torch.minimum(hi[:, :, 0], hi[:, :, 1]),
                              hi[:, :, 2])
        mn, mx = tmin[bs][..., None], tmax[bs][..., None]
        can = (t_near <= t_far) & (t_far >= mn) & (t_near <= mx) & (mx >= 0.0)
        entry[bs, :n_chunks] = torch.where(
            can, torch.clamp(t_near, min=0.0), BIG).amin(dim=1)
    return entry


def _sweep_steps(cand, count, block_rays, chunk):
    """Yield (candidate rank j, block ids, chunk ids) over every listed
    (block, chunk) pair, about PLAIN_ELEMS (ray, triangle) pairs a step."""
    step = max(1, PLAIN_ELEMS // (block_rays * chunk))
    for j in range(int(count.max()) if count.numel() else 0):
        blocks = torch.nonzero(count > j).squeeze(1)
        for s0 in range(0, blocks.shape[0], step):
            bs = blocks[s0:s0 + step]
            yield bs, cand[bs, j].long()


def _sweep_terms(walk_tris, c, o, d):
    """Moller-Trumbore's terms (ok, u, v, t) of the rays of blocks [s, B]
    against chunks c [s], each [s, B, chunk]."""
    tri = walk_tris[c, :9]  # [s, 9, chunk]
    return _mt_terms(o, d, [p[:, None, :] for p in tri.unbind(1)])


def _sweep_mt(walk_tris, c, o, d, tmin, tmax):
    """Moller-Trumbore of the rays of blocks [s, B] against chunks c [s]:
    (t, hit), each [s, B, chunk]."""
    terms = _sweep_terms(walk_tris, c, o, d)
    return terms[3], _mt_hit(terms, tmin, tmax)


def closest_plain(walk_tris, cand, count, o, d, tmin, tmax,
                  block_rays=BLOCK_RAYS):
    """Plain version of the closest sweep: (t [R], id [R] int32), t = BIG
    and id = -1 on a miss; equal t go to the lowest id."""
    r, chunk = o.shape[0], walk_tris.shape[2]
    o, d, tmin, tmax = _blocked(o, d, tmin, tmax, block_rays)
    best_t = torch.full(tmin.shape, BIG, device=o.device)
    best_id = torch.full(tmin.shape, -1, dtype=torch.int32, device=o.device)
    for bs, c in _sweep_steps(cand, count, block_rays, chunk):
        t, hit = _sweep_mt(walk_tris, c, o[bs], d[bs], tmin[bs], tmax[bs])
        ct, arg = torch.where(hit, t, BIG).min(dim=2)  # lowest id on ties
        cid = (c[:, None] * chunk + arg).to(torch.int32)
        bt, bi = best_t[bs], best_id[bs]
        better = (ct < bt) | ((ct == bt) & (ct < BIG) & (cid < bi))
        best_t[bs] = torch.where(better, ct, bt)
        best_id[bs] = torch.where(better, cid, bi)
    return best_t.view(-1)[:r], best_id.view(-1)[:r]


def any_plain(walk_tris, cand, count, o, d, tmin, tmax,
              block_rays=BLOCK_RAYS):
    """Plain version of the occlusion sweep: blocked [R] bool."""
    r, chunk = o.shape[0], walk_tris.shape[2]
    o, d, tmin, tmax = _blocked(o, d, tmin, tmax, block_rays)
    blocked = torch.zeros(tmin.shape, dtype=torch.bool, device=o.device)
    for bs, c in _sweep_steps(cand, count, block_rays, chunk):
        _, hit = _sweep_mt(walk_tris, c, o[bs], d[bs], tmin[bs], tmax[bs])
        blocked[bs] |= hit.any(dim=2)
    return blocked.view(-1)[:r]


def _real(walk_tris):
    """[C, chunk] bool: the slots that hold a triangle. Padding has zero
    edges (the flatten pads with v0 = 1e10 and zero edges), so det = 0
    for every ray and no ray can hit it: the sweeps skip it."""
    return (walk_tris[:, 3:9] != 0).any(dim=1)


def needed_work(kind, walk_tris, boxes, cand, tnear, count, o, d, tmin, tmax,
                block_rays=BLOCK_RAYS):
    """The work a walk sweep of these inputs needs, per ray block, by a
    plain count model (a `NeededWork`). A block's candidates go in list
    order. A live ray (tmax > tmin) tests a chunk only when its own slab
    test passes that chunk, bounded by min(best t so far, tmax) for
    "closest" and by tmax for an occlusion ray not yet blocked; it then
    tests the chunk's triangles (padding, `_real`, costs nothing), an
    occlusion ray in slot order up to its first blocker and no chunk after
    it. Dead rays cost nothing.

    The kernels' early exit (tnear of the next candidate above the block's
    max of min(best t, tmax); every ray blocked) is not modelled: for rays
    with tmin >= 0 it only skips chunks every ray's own test fails, which
    cost nothing here. The closest kernel reports exactly these tests and
    chunks. The occlusion kernel splits a chunk's triangles across warps,
    so a ray blocked in a chunk may run from 1 to all of its triangles
    there: `below` and `above` say how far under and over `tests` its
    count may lie (zero for "closest")."""
    if kind not in ("closest", "any"):
        raise ValueError(f"kind {kind!r} is not 'closest' or 'any'")
    chunk = walk_tris.shape[2]
    o, d, tmin, tmax = _blocked(o, d, tmin, tmax, block_rays)
    inv = _safe_inv(d)
    nb = o.shape[0]
    real = _real(walk_tris)
    rank = real.cumsum(dim=1)  # real triangles up to each slot, inclusive
    slot = torch.arange(chunk, device=o.device)
    best_t = torch.full(tmin.shape, BIG, device=o.device)
    open_ = tmax > tmin
    exits = torch.zeros((nb, 3), dtype=torch.long, device=o.device)
    chunks, below, above = (torch.zeros(nb, dtype=torch.long,
                                        device=o.device) for _ in range(3))
    for bs, c in _sweep_steps(cand, count, block_rays, chunk):
        limit = (torch.minimum(best_t[bs], tmax[bs]) if kind == "closest"
                 else tmax[bs])
        # the rays of blocks [s, B] against their chunks' boxes [s, 1, 6]
        can = open_[bs] & _slab_plain(o[bs], inv[bs], tmin[bs], limit,
                                      boxes[:, c].T[:, None, :])
        chunks[bs] += can.any(dim=1)
        terms = _sweep_terms(walk_tris, c, o[bs], d[bs])
        ran = can[..., None] & real[c][:, None, :]  # [s, B, chunk]
        hit = ran & _mt_hit(terms, tmin[bs], tmax[bs])
        if kind == "closest":
            best_t[bs] = torch.minimum(
                best_t[bs], torch.where(hit, terms[3], BIG).amin(dim=2))
        else:
            blocker = hit.any(dim=2)
            first_slot = hit.int().argmax(dim=2)  # [s, B]
            ran &= slot <= torch.where(blocker, first_slot, chunk)[..., None]
            first = rank[c].gather(1, first_slot)  # real tests to the blocker
            n_real = rank[c, -1][:, None]  # [s, 1]
            below[bs] += torch.where(blocker, first - 1, 0).sum(dim=1)
            above[bs] += torch.where(blocker, n_real - first, 0).sum(dim=1)
            open_[bs] &= ~blocker
        exits[bs] += _exit_counts(ran, terms, (1, 2))
    return NeededWork(exits.sum(dim=1), chunks, exits, below, above)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/walk_intersect.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "walk_candidates": [_P, _P, _P, _P, _I, _I, _P, _I, _I, _P, _P],
    "walk_closest": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _I, _P, _I,
                     _P, _P, _P, _P, _P],
    "walk_any": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _P, _I, _P, _I, _P, _P,
                 _P, _P],
}


def _fn(name):
    fn = getattr(_build.load("walk_intersect"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(want, o):
    """Raise unless every (tensor, dtype, shape) in `want` is contiguous,
    of that dtype and shape, on o's CUDA device. Returns the pointers."""
    for x, dtype, shape in want:
        if not (x.is_cuda and x.device == o.device and x.dtype == dtype
                and x.is_contiguous() and tuple(x.shape) == shape):
            raise ValueError(
                f"kernel input {tuple(x.shape)} {x.dtype} on {x.device}: "
                f"expected contiguous {dtype} {shape} on one CUDA device")
    if o.shape[0] >= 2**31:
        raise ValueError("too many rays for one launch")
    return [x.data_ptr() for x, _, _ in want]


def _ray_specs(o, d, tmin, tmax):
    r, f32 = o.shape[0], torch.float32
    return [(o, f32, (r, 3)), (d, f32, (r, 3)), (tmin, f32, (r,)),
            (tmax, f32, (r,))]


def _call(fn, name, device, *args):
    """Launch the C entry point fn(name) on the current stream of device;
    raise on a launch error."""
    with torch.cuda.device(device):
        err = fn(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def candidates_kernel(boxes, o, d, tmin, tmax, block_rays=BLOCK_RAYS):
    """Launch the candidate kernel: entry [n_blocks, maxc_pad] float32."""
    r, n_chunks = o.shape[0], boxes.shape[-1]
    nb = _n_blocks(r, block_rays)
    ptrs = _check_cuda(_ray_specs(o, d, tmin, tmax)
                       + [(boxes, torch.float32, (6, n_chunks))], o)
    maxc_pad = -(-n_chunks // LANES) * LANES
    entry = torch.empty((nb, maxc_pad), dtype=torch.float32, device=o.device)
    _call(_fn, "walk_candidates", o.device, *ptrs[:4], r, block_rays,
          ptrs[4], n_chunks, maxc_pad, entry.data_ptr())
    candidates_kernel.launches += 1
    return entry


def _sweep_ptrs(walk_tris, boxes, cand, count, o, d, tmin, tmax, block_rays,
                tnear=None):
    r, (n_chunks, _, chunk) = o.shape[0], walk_tris.shape
    nb = _n_blocks(r, block_rays)
    if chunk % CHUNK_STEP:
        raise ValueError(f"walk chunk {chunk} is not a multiple of "
                         f"{CHUNK_STEP}")
    maxc_pad = cand.shape[-1]
    want = _ray_specs(o, d, tmin, tmax) + [
        (cand, torch.int32, (nb, maxc_pad)), (count, torch.int32, (nb,)),
        (boxes, torch.float32, (6, n_chunks)),
        (walk_tris, torch.float32, (n_chunks, 16, chunk))]
    if tnear is not None:
        want.append((tnear, torch.float32, (nb, maxc_pad)))
    ptrs = _check_cuda(want, o)
    # row 0: chunks swept per block, row 1: ray-triangle tests run
    counts = torch.empty((2, nb), dtype=torch.int32, device=o.device)
    return ptrs, r, nb, maxc_pad, n_chunks, chunk, counts


def closest_kernel(walk_tris, boxes, cand, tnear, count, o, d, tmin, tmax,
                   block_rays=BLOCK_RAYS):
    """Launch the closest sweep: (t [R], id [R] int32) on o's device."""
    ptrs, r, nb, maxc_pad, n_chunks, chunk, counts = _sweep_ptrs(
        walk_tris, boxes, cand, count, o, d, tmin, tmax, block_rays, tnear)
    o_p, d_p, tmin_p, tmax_p, cand_p, count_p, boxes_p, tris_p, tnear_p = ptrs
    out_t = torch.empty(r, dtype=torch.float32, device=o.device)
    out_id = torch.empty(r, dtype=torch.int32, device=o.device)
    _call(_fn, "walk_closest", o.device, o_p, d_p, tmin_p, tmax_p, r,
          block_rays, cand_p, tnear_p, count_p, maxc_pad, boxes_p, n_chunks,
          tris_p, chunk, out_t.data_ptr(), out_id.data_ptr(),
          counts[0].data_ptr(), counts[1].data_ptr())
    closest_kernel.launches += 1
    closest_kernel.swept, closest_kernel.tests = counts
    return out_t, out_id


def any_kernel(walk_tris, boxes, cand, count, o, d, tmin, tmax,
               block_rays=BLOCK_RAYS):
    """Launch the occlusion sweep: blocked [R] bool on o's device."""
    ptrs, r, nb, maxc_pad, n_chunks, chunk, counts = _sweep_ptrs(
        walk_tris, boxes, cand, count, o, d, tmin, tmax, block_rays)
    o_p, d_p, tmin_p, tmax_p, cand_p, count_p, boxes_p, tris_p = ptrs
    out = torch.empty(r, dtype=torch.int32, device=o.device)
    _call(_fn, "walk_any", o.device, o_p, d_p, tmin_p, tmax_p, r,
          block_rays, cand_p, count_p, maxc_pad, boxes_p, n_chunks, tris_p,
          chunk, out.data_ptr(), counts[0].data_ptr(), counts[1].data_ptr())
    any_kernel.launches += 1
    any_kernel.swept, any_kernel.tests = counts
    return out > 0


candidates_kernel.launches = 0
closest_kernel.launches = 0
any_kernel.launches = 0
closest_kernel.swept = any_kernel.swept = None
closest_kernel.tests = any_kernel.tests = None


# ---------------------------------------------------------------------------
# Engine interface (as the reference's brute/bvh/pallas/walk engines)
# ---------------------------------------------------------------------------

def _sorted_query(scene, o, d, tmin, tmax, block_rays):
    """Coherence-sorted rays and their candidates: (perm, rays, boxes,
    (cand, tnear, count))."""
    _check_walkable(scene)
    with spans.span(spans.ISECT_ORDER):
        rays = _rays(o, d, tmin, tmax)
        perm = _coherence_perm(scene, rays[0], rays[1])
        rays = tuple(x[perm].contiguous() for x in rays)
        boxes = _chunk_boxes(scene)
    with spans.span(spans.ISECT_KERNEL):
        if rays[0].is_cuda:
            entry = candidates_kernel(boxes, *rays, block_rays)
        elif rays[0].device.type == "cpu":
            entry = candidates_plain(boxes, *rays, block_rays)
        else:
            raise ValueError(f"the walk engine runs on CUDA or the CPU, not "
                             f"on {rays[0].device}")
    return perm, rays, boxes, sort_candidates(entry)


@spans.traced(spans.ISECT_UNSORT)
def _unsort(perm, x):
    out = torch.empty_like(x)
    out[perm] = x
    return out


def intersect_closest_raw(scene, o, d, tmin=0.0, tmax=100.0,
                          block_rays=BLOCK_RAYS):
    """(t, tri_id) per ray; t = BIG and id = -1 on a miss. Ids are in the
    walk-padded index space."""
    perm, rays, boxes, (cand, tnear, count) = _sorted_query(
        scene, o, d, tmin, tmax, block_rays)
    with spans.span(spans.ISECT_KERNEL):
        if rays[0].is_cuda:
            t, tri_id = closest_kernel(scene.walk_tris, boxes, cand, tnear,
                                       count, *rays, block_rays)
        else:
            t, tri_id = closest_plain(scene.walk_tris, cand, count, *rays,
                                      block_rays)
    return _unsort(perm, t), _unsort(perm, tri_id)


def intersect_closest(scene, o, d, tmin=0.0, tmax=100.0,
                      block_rays=BLOCK_RAYS):
    """Hit record. Walk ids share the real-triangle prefix with the flat
    arrays (flatten packs both from one reordered triangle list), so ids of
    walk padding or flat padding are rejected as misses."""
    best_t, best_id = intersect_closest_raw(scene, o, d, tmin, tmax,
                                            block_rays)
    return _hit_record(scene, o, best_t, best_id, tmax)


def intersect_any(scene, o, d, tmin=0.0, tmax=100.0, block_rays=BLOCK_RAYS):
    """True where some triangle blocks the segment (tmin, tmax)."""
    perm, rays, boxes, (cand, _, count) = _sorted_query(
        scene, o, d, tmin, tmax, block_rays)
    with spans.span(spans.ISECT_KERNEL):
        if rays[0].is_cuda:
            blocked = any_kernel(scene.walk_tris, boxes, cand, count, *rays,
                                 block_rays)
        else:
            blocked = any_plain(scene.walk_tris, cand, count, *rays,
                                block_rays)
    return _unsort(perm, blocked)

"""The packet engine: per-8-ray-packet sweeps of 128-triangle subchunks
(port of `optixpathtracer_tpu/intersect/packet_kernels.py`).

A query runs the walk engine's front half (`walk_kernels._sorted_query`:
the coherence sort, the candidate kernel and the candidate sort), then
cuts each ray block into packets of 8 consecutive rays. A packet tests
only the subchunks (the 128-triangle pieces of its block's candidate
chunks, in sorted-union order s = j * n_sub + k, n_sub = chunk / 128) that
some of its own rays reach: an exact per-ray slab test against each
subchunk box, OR'd over the packet and packed 32 to an int32 word
(`packet_words_plain`, the reference's `_packet_words`). Two functions
carry the work, each with two implementations of one contract:

* CUDA kernels in `csrc/packet_intersect.cu`, launched on CUDA tensors:
  `packet_closest_kernel` (replacing the Pallas
  `_make_packet_closest_kernel`) and `packet_any_kernel`
  (`_make_packet_any_kernel`), one CTA per ray block. They form the words
  themselves, one warp ballot per word, so the words never reach device
  memory; the CTA stages its block's union in shared memory in tiles that
  `smem_plan` sizes (`union_tiles` lists them);
* plain PyTorch versions, for CPU tensors and as the kernels' check:
  `packet_words_plain`, then `packet_closest_plain` / `packet_any_plain`,
  which test every ray of a packet against every subchunk whose bit is
  set, with no early exit: the tie-break to the lowest id makes the
  answer independent of the order and of the exit. `plain_launch` chains
  the two, called as a kernel wrapper is.

A wrapper picks a plain version only because its tensors lie on the CPU;
on a CUDA tensor it launches the kernel or raises. `launches` on each
kernel wrapper counts its launches; `swept`, `tests` and `slabs` hold its
last launch's subchunks swept, ray-triangle tests run and ray-subchunk
slab tests run per ray block, from which the kernel's bound is computed.
With `with_words=True` a wrapper also keeps the words the kernel formed in
`words`, to be held against `packet_words_plain`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build, spans
from .dense_kernels import BIG, _hit_record, _mt_plain
from .walk_kernels import (PLAIN_ELEMS, _blocked, _call, _check_cuda,
                           _n_blocks, _ray_specs, _safe_inv, _sorted_query,
                           _unsort)

PACKET = 8           # rays per packet
SUB = 128            # triangles per subchunk
BLOCK_RAYS = 256     # rays per candidate block (the reference: 1024)
_MASK_TILE = 512     # subchunks per step of the plain word formation
ROWS = 9             # v0, e1, e2 rows of a walk chunk that a sweep reads

# The kernels' CTA (csrc/packet_intersect.cu kWarps, kCtasPerSm): WARPS
# warps sweep one ray block, each staging one subchunk's triangles at a
# time; CTAS_PER_SM CTAs share an SM (the __launch_bounds__ minimum).
WARPS = 8
CTAS_PER_SM = 4
# Shared memory: an H100 SM holds 228 KB and keeps 1 KB of it per CTA; one
# CTA may take at most 227 KB. The plan keeps a CTA to SMEM_BUDGET, so
# CTAS_PER_SM CTAs fit an SM.
SM_SHARED = 228 * 1024
SMEM_MAX = 227 * 1024
SMEM_BUDGET = SM_SHARED // CTAS_PER_SM - 1024


def _n_sub(chunk):
    if chunk % SUB:
        raise ValueError(f"walk chunk {chunk} is not a multiple of {SUB}")
    return chunk // SUB


def _n_words(maxc_pad, chunk):
    """int32 words per packet: one bit per subchunk slot of the union."""
    return maxc_pad * _n_sub(chunk) // 32


def _packets(x, block_rays):
    """[n_blocks, block_rays, ...] -> [n_blocks, packets, 8, ...]."""
    return x.view(x.shape[0], block_rays // PACKET, PACKET, *x.shape[2:])


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def packet_words_plain(sub_box, cand, tnear, o, d, tmin, tmax, chunk,
                       block_rays=BLOCK_RAYS):
    """Per-packet subchunk masks, as the reference's `_packet_words`: bit
    s % 32 of word s // 32 is set where some ray of the packet passes the
    slab test of union subchunk s (t_near <= t_far, t_far >= tmin, t_near
    <= tmax, tmax >= 0, t_near not clamped at 0) and rank s // n_sub is a
    listed candidate. Returns (words [n_blocks, packets, n_words], w0, w1
    [n_blocks, packets]) int32; w0 / w1 are the first and last nonzero
    word, 1 / 0 for an empty packet."""
    n_sub = _n_sub(chunk)
    nb, maxc_pad = cand.shape
    n_words = _n_words(maxc_pad, chunk)
    n_sub_total = sub_box.shape[1]
    o, d, tmin, tmax = (_packets(x, block_rays)
                        for x in _blocked(o, d, tmin, tmax, block_rays))
    inv = _safe_inv(d)
    valid = tmax >= 0.0

    # subchunk boxes in sorted-union order: sub id = cand * n_sub + k
    sub_ids = (cand.long().clamp(0, n_sub_total // n_sub - 1)[:, :, None]
               * n_sub + torch.arange(n_sub, device=o.device)).view(nb, -1)
    pad_cand = (tnear >= BIG).repeat_interleave(n_sub, dim=1)   # [nb, S]
    s_total = maxc_pad * n_sub
    tile = min(_MASK_TILE, s_total)
    step = max(1, PLAIN_ELEMS // (block_rays * tile))
    shifts = torch.arange(32, device=o.device)
    words = torch.empty((nb, block_rays // PACKET, n_words),
                        dtype=torch.int32, device=o.device)
    for b0 in range(0, nb, step):
        bs = slice(b0, b0 + step)
        ob, ib = o[bs][..., None], inv[bs][..., None]      # [s, P, 8, 3, 1]
        mn, mx = tmin[bs][..., None], tmax[bs][..., None]  # [s, P, 8, 1]
        live = valid[bs][..., None]
        for s0 in range(0, s_total, tile):
            ids = sub_ids[bs, s0:s0 + tile]                 # [s, T]
            t_near = torch.full(ob.shape[:3] + ids.shape[1:], -BIG,
                                device=o.device)           # [s, P, 8, T]
            t_far = torch.full_like(t_near, BIG)
            for ax in range(3):
                p0 = (sub_box[ax, ids][:, None, None] - ob[..., ax, :]) \
                    * ib[..., ax, :]
                p1 = (sub_box[ax + 3, ids][:, None, None] - ob[..., ax, :]) \
                    * ib[..., ax, :]
                t_near = torch.maximum(t_near, torch.minimum(p0, p1))
                t_far = torch.minimum(t_far, torch.maximum(p0, p1))
            ok = ((t_near <= t_far) & (t_far >= mn) & (t_near <= mx) & live
                  & ~pad_cand[bs, None, None, s0:s0 + tile])
            bits = ok.any(dim=2).view(*ok.shape[:2], -1, 32).long()
            packed = (bits << shifts).sum(dim=3)           # [0, 2^32)
            packed = torch.where(packed >= 1 << 31, packed - (1 << 32),
                                 packed)
            words[bs, :, s0 // 32:(s0 + tile) // 32] = packed.to(torch.int32)
    nz = (words != 0).to(torch.int32)
    any_nz = nz.any(dim=2)
    w0 = torch.where(any_nz, nz.argmax(dim=2), 1).to(torch.int32)
    w1 = torch.where(any_nz, n_words - 1 - nz.flip(2).argmax(dim=2),
                     0).to(torch.int32)
    return words, w0, w1


def _set_bits(words, cand, chunk):
    """Every (packet, subchunk) pair whose bit is set: packet index
    [n_pairs] (into n_blocks x packets) and first triangle id."""
    n_sub = _n_sub(chunk)
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    bits = bits.view(words.shape[0] * words.shape[1], -1)  # [packets, S]
    packet, s = torch.nonzero(bits, as_tuple=True)
    blk = packet // words.shape[1]
    j, k = s // n_sub, s % n_sub
    first = cand[blk, j].long() * chunk + k * SUB
    return packet, first


def _pair_steps(walk_tris, words, cand, o, d, tmin, tmax, block_rays):
    """Yield (packet index [p], first id [p], t [p, 8, 128], hit) over every
    set (packet, subchunk) pair, about PLAIN_ELEMS tests a step."""
    chunk = walk_tris.shape[2]
    flat = walk_tris[:, :9].permute(1, 0, 2).reshape(9, -1)  # [9, C chunk]
    rays = [_packets(x, block_rays).reshape(-1, PACKET, *x.shape[2:])
            for x in _blocked(o, d, tmin, tmax, block_rays)]
    packet, first = _set_bits(words, cand, chunk)
    step = max(1, PLAIN_ELEMS // (PACKET * SUB))
    lane = torch.arange(SUB, device=o.device)
    for p0 in range(0, packet.shape[0], step):
        pk, fi = packet[p0:p0 + step], first[p0:p0 + step]
        tri = flat[:, fi[:, None] + lane]                   # [9, p, 128]
        po, pd, pmn, pmx = (x[pk] for x in rays)
        t, hit = _mt_plain(po, pd, pmn, pmx,
                           [c[:, None, :] for c in tri.unbind(0)])
        yield pk, fi, t, hit


def packet_closest_plain(walk_tris, cand, words, o, d, tmin, tmax,
                         block_rays=BLOCK_RAYS):
    """Plain version of the closest packet sweep: (t [R], id [R] int32), t =
    BIG and id = -1 on a miss; equal t go to the lowest id."""
    r = o.shape[0]
    n_rays = _n_blocks(r, block_rays) * block_rays
    cts, cids, ray_ids = [], [], []
    for pk, fi, t, hit in _pair_steps(walk_tris, words, cand, o, d, tmin,
                                      tmax, block_rays):
        ct, arg = torch.where(hit, t, BIG).min(dim=2)  # lowest id on ties
        cts.append(ct.reshape(-1))
        cids.append((fi[:, None] + arg).reshape(-1))
        ray_ids.append((pk[:, None] * PACKET + torch.arange(
            PACKET, device=o.device)).reshape(-1))
    best_t = torch.full((n_rays,), BIG, device=o.device)
    best_id = torch.full((n_rays,), -1, dtype=torch.int64, device=o.device)
    if cts:
        ct, cid, ray = torch.cat(cts), torch.cat(cids), torch.cat(ray_ids)
        best_t.scatter_reduce_(0, ray, ct, "amin")
        win = (ct == best_t[ray]) & (ct < BIG)
        best_id.scatter_reduce_(0, ray[win], cid[win], "amin",
                                include_self=False)
    best_id = torch.where(best_t < BIG, best_id, -1)
    return best_t[:r], best_id[:r].to(torch.int32)


def plain_launch(sweep, walk_tris, sub_box, cand, tnear, count, o, d, tmin,
                 tmax, block_rays=BLOCK_RAYS):
    """A kernel launch's plain version, called as the kernel wrappers are:
    the words by `packet_words_plain`, then `sweep` (`packet_closest_plain`
    or `packet_any_plain`). count is unused: the words end with the
    union."""
    words = packet_words_plain(sub_box, cand, tnear, o, d, tmin, tmax,
                               walk_tris.shape[2], block_rays)[0]
    return sweep(walk_tris, cand, words, o, d, tmin, tmax, block_rays)


def packet_any_plain(walk_tris, cand, words, o, d, tmin, tmax,
                     block_rays=BLOCK_RAYS):
    """Plain version of the occlusion packet sweep: blocked [R] bool."""
    r = o.shape[0]
    blocked = torch.zeros(_n_blocks(r, block_rays) * block_rays,
                          dtype=torch.bool, device=o.device)
    for pk, _, _, hit in _pair_steps(walk_tris, words, cand, o, d, tmin,
                                     tmax, block_rays):
        ray = pk[:, None] * PACKET + torch.arange(PACKET, device=o.device)
        blocked[ray[hit.any(dim=2)]] = True
    return blocked[:r]


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/packet_intersect.cu)
# ---------------------------------------------------------------------------

def _align16(n):
    return -(-n // 16) * 16


def smem_bytes(tile_ranks, chunk, block_rays):
    """Dynamic shared memory of one CTA holding a tile of `tile_ranks`
    candidate ranks: the kernels' `Smem` layout (each section 16-byte
    aligned): the warps' staged subchunks and packet rays, the tile's
    subchunk boxes, cand and tnear, and every packet's answer so far."""
    n_sub, packets = _n_sub(chunk), block_rays // PACKET
    sizes = (WARPS * ROWS * SUB * 4, WARPS * PACKET * 3 * 16,
             6 * tile_ranks * n_sub * 4, tile_ranks * 4, tile_ranks * 4,
             packets * PACKET * 4, packets * PACKET * 4, packets * 4, 4 * 4)
    return sum(_align16(x) for x in sizes)


def smem_plan(chunk, block_rays, maxc_pad):
    """(tile_ranks, bytes) of a launch: the most candidate ranks a tile of
    the union holds within SMEM_BUDGET bytes of shared memory, never more
    than the row (maxc_pad), in steps that keep a tile's subchunks whole
    words (tile_ranks * n_sub a multiple of 32)."""
    n_sub = _n_sub(chunk)
    step = 32 // math.gcd(32, n_sub)
    per_step = smem_bytes(step, chunk, block_rays) - smem_bytes(
        0, chunk, block_rays)
    fit = (SMEM_BUDGET - smem_bytes(0, chunk, block_rays)) // per_step
    tile = min(max(fit, 1), -(-maxc_pad // step)) * step
    while tile > step and smem_bytes(tile, chunk, block_rays) > SMEM_BUDGET:
        tile -= step
    n_bytes = smem_bytes(tile, chunk, block_rays)
    if n_bytes > min(SMEM_BUDGET, SMEM_MAX):
        raise ValueError(f"chunk {chunk}, block_rays {block_rays}: one tile "
                         f"of the union needs {n_bytes} bytes of shared "
                         f"memory, over {min(SMEM_BUDGET, SMEM_MAX)}")
    return tile, n_bytes


def union_tiles(count, tile_ranks):
    """The tiles a CTA stages for a block with `count` candidates, as the
    kernels loop over them: [(first rank, end rank)], covering [0, count)."""
    return [(j0, min(j0 + tile_ranks, count))
            for j0 in range(0, count, tile_ranks)]


def grid(n_rays, block_rays):
    """(CTAs, threads a CTA) of a launch: one CTA per ray block."""
    return _n_blocks(n_rays, block_rays), WARPS * 32


_P = ctypes.c_void_p
_I = ctypes.c_int
# rays, n, block_rays, cand, tnear, count, maxc_pad, sub_box, n_chunks,
# tris, chunk, tile_ranks, smem bytes; then the outputs, words, the three
# counts and the stream
_IN = [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I]
_ARGTYPES = {"packet_closest": _IN + [_P] * 7,
             "packet_any": _IN + [_P] * 6}


def _fn(name):
    fn = getattr(_build.load("packet_intersect"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name, walk_tris, sub_box, cand, tnear, count, o, d, tmin, tmax,
            block_rays, with_words, outs):
    """Check the inputs, launch `name` with the output tensors `outs` and
    return (counts [3, n_blocks], words or None)."""
    r, (n_chunks, _, chunk) = o.shape[0], walk_tris.shape
    nb = _n_blocks(r, block_rays)
    n_sub = _n_sub(chunk)
    maxc_pad = cand.shape[-1]
    ptrs = _check_cuda(_ray_specs(o, d, tmin, tmax) + [
        (cand, torch.int32, (nb, maxc_pad)),
        (tnear, torch.float32, (nb, maxc_pad)), (count, torch.int32, (nb,)),
        (sub_box, torch.float32, (6, n_chunks * n_sub)),
        (walk_tris, torch.float32, (n_chunks, 16, chunk))], o)
    if walk_tris.data_ptr() % 16:
        raise ValueError("walk_tris must be 16-byte aligned (cp.async)")
    tile_ranks, n_bytes = smem_plan(chunk, block_rays, maxc_pad)
    n_words = _n_words(maxc_pad, chunk)
    words = (torch.zeros((nb, block_rays // PACKET, n_words),
                         dtype=torch.int32, device=o.device)
             if with_words else None)
    # row 0: subchunks swept, row 1: ray-triangle tests, row 2: slab tests
    counts = torch.zeros((3, nb), dtype=torch.int32, device=o.device)
    o_p, d_p, tmin_p, tmax_p, cand_p, tnear_p, count_p, box_p, tris_p = ptrs
    _call(_fn, name, o.device, o_p, d_p, tmin_p, tmax_p,
          r, block_rays, cand_p, tnear_p, count_p, maxc_pad, box_p,
          n_chunks, tris_p, chunk, tile_ranks, n_bytes,
          *[x.data_ptr() for x in outs],
          0 if words is None else words.data_ptr(), counts[0].data_ptr(),
          counts[1].data_ptr(), counts[2].data_ptr())
    return counts, words


def packet_closest_kernel(walk_tris, sub_box, cand, tnear, count, o, d, tmin,
                          tmax, block_rays=BLOCK_RAYS, with_words=False):
    """Launch the closest packet sweep: (t [R], id [R] int32) on o's
    device."""
    r = o.shape[0]
    out_t = torch.empty(r, dtype=torch.float32, device=o.device)
    out_id = torch.empty(r, dtype=torch.int32, device=o.device)
    counts, words = _launch("packet_closest", walk_tris, sub_box, cand,
                            tnear, count, o, d, tmin, tmax, block_rays,
                            with_words, (out_t, out_id))
    packet_closest_kernel.launches += 1
    k = packet_closest_kernel
    k.swept, k.tests, k.slabs = counts
    k.words = words
    return out_t, out_id


def packet_any_kernel(walk_tris, sub_box, cand, tnear, count, o, d, tmin,
                      tmax, block_rays=BLOCK_RAYS, with_words=False):
    """Launch the occlusion packet sweep: blocked [R] bool on o's
    device."""
    out = torch.empty(o.shape[0], dtype=torch.int32, device=o.device)
    counts, words = _launch("packet_any", walk_tris, sub_box, cand, tnear,
                            count, o, d, tmin, tmax, block_rays, with_words,
                            (out,))
    packet_any_kernel.launches += 1
    k = packet_any_kernel
    k.swept, k.tests, k.slabs = counts
    k.words = words
    return out > 0


packet_closest_kernel.launches = 0
packet_any_kernel.launches = 0
packet_closest_kernel.swept = packet_any_kernel.swept = None
packet_closest_kernel.tests = packet_any_kernel.tests = None
packet_closest_kernel.slabs = packet_any_kernel.slabs = None
packet_closest_kernel.words = packet_any_kernel.words = None


# ---------------------------------------------------------------------------
# Engine interface (as the reference's brute/bvh/pallas/walk/packet engines)
# ---------------------------------------------------------------------------

def intersect_closest_raw(scene, o, d, tmin=0.0, tmax=100.0,
                          block_rays=BLOCK_RAYS):
    """(t, tri_id) per ray; t = BIG and id = -1 on a miss. Ids are in the
    walk-padded index space."""
    perm, rays, _, (cand, tnear, count) = _sorted_query(
        scene, o, d, tmin, tmax, block_rays)
    args = (scene.walk_tris, scene.walk_sub_box, cand, tnear, count, *rays,
            block_rays)
    with spans.span(spans.ISECT_KERNEL), spans.span(spans.PACKET):
        if rays[0].is_cuda:
            t, tri_id = packet_closest_kernel(*args)
        else:
            t, tri_id = plain_launch(packet_closest_plain, *args)
    return _unsort(perm, t), _unsort(perm, tri_id)


def intersect_closest(scene, o, d, tmin=0.0, tmax=100.0,
                      block_rays=BLOCK_RAYS):
    """Hit record (ids of walk or flat padding are rejected as misses)."""
    best_t, best_id = intersect_closest_raw(scene, o, d, tmin, tmax,
                                            block_rays)
    return _hit_record(scene, o, best_t, best_id, tmax)


def intersect_any(scene, o, d, tmin=0.0, tmax=100.0, block_rays=BLOCK_RAYS):
    """True where some triangle blocks the segment (tmin, tmax)."""
    perm, rays, _, (cand, tnear, count) = _sorted_query(
        scene, o, d, tmin, tmax, block_rays)
    args = (scene.walk_tris, scene.walk_sub_box, cand, tnear, count, *rays,
            block_rays)
    with spans.span(spans.ISECT_KERNEL), spans.span(spans.PACKET):
        if rays[0].is_cuda:
            blocked = packet_any_kernel(*args)
        else:
            blocked = plain_launch(packet_any_plain, *args)
    return _unsort(perm, blocked)

"""Alpha-cutout-aware intersection (port of
`optixpathtracer_tpu/integrate/cutout.py`): the wavefront form of the
reference's anyhit programs (`devicePrograms.cu:518-561`, AlphaCutout):
hits whose albedo-texture alpha, sRGB-decoded, is below 0.9 are ignored,
for radiance and shadow rays alike.

OptiX re-enters traversal on optixIgnoreIntersection; here a bounded
re-trace takes its place: find the closest hit, evaluate the alpha there,
and re-trace the cut lanes with tmin just past the hit, at most
MAX_CUTOUT_LAYERS times (layers beyond that occlude). The reference gates
each layer with `jax.lax.cond` on "any lane still open"; here that is a
host-side `if`, which skips the query as the cond does.

A scene flattened with the opaque/cutout split (`SceneData.opaque_scene`,
`cutout_sub`) takes the fast paths: one closest or occlusion query over
the opaque triangles, and the re-trace chain only over the few cutout
ones, whose ids map back to the outer scene through `tri_outer_id`.

Each chain over a cutout sub-scene has two implementations of one
contract: the plain chain (`closest_chain_plain`, `any_chain_plain`), a
loop of whole-wavefront closest queries with a host test between layers,
and on the card one CUDA kernel a query (`closest_chain_kernel`,
`any_chain_kernel`, `csrc/dense_intersect.cu`), each thread running its
lane's chain to the end with the plain chain's arithmetic. Which one runs
is decided by `chain_kernel_route` alone, from what the call can see:
CUDA tensors, a split scene, and a sub-scene that the dense engine serves
and one staged tile holds. On that route the wrapper launches or raises;
every other chain is the plain one.
"""
from __future__ import annotations

import torch

from .. import spans
from ..intersect import dense_kernels, intersect_any, intersect_closest
from ..intersect.api import WALK_MIN_CHUNKS, _refine, _resolve
from ..intersect.types import Hit
from ..scene.textures import sample_bilinear, srgb_to_linear

MAX_CUTOUT_LAYERS = 4
ALPHA_THRESHOLD = 0.9  # decoded albedo alpha below this is a hole
REENTRY_EPS = 1e-4
STAGED_TRIS = 1024  # the most triangles a chain kernel's CTA stages


def scene_uses_alpha_cutout(scene) -> bool:
    """Any material with an albedo texture containing decoded alpha < 0.9?
    (reference `devicePrograms.cu:534,543`; the machinery is skipped when
    every texel is opaque: the same image, less work)"""
    tex_ids = scene.mat_albedo_tex
    if not bool((tex_ids >= 0).any()):
        return False
    used = tex_ids[tex_ids >= 0].unique().long()
    alpha = srgb_to_linear(scene.textures[used, :, :, 3])
    return bool((alpha < ALPHA_THRESHOLD).any())


def _hit_alpha(scene, hit: Hit):
    """Decoded albedo alpha at the hit point; 1.0 where the material has no
    albedo texture (no cutout, `devicePrograms.cu:534,546`)."""
    safe_id = hit.tri_id.clamp(min=0).long()
    tri_uv = scene.tri_uvs[safe_id]
    mat_id = scene.tri_mat[safe_id].long()
    tex_id = scene.mat_albedo_tex[mat_id]
    u = hit.u[..., None]
    v = hit.v[..., None]
    uv = (1.0 - u - v) * tri_uv[:, 0] + u * tri_uv[:, 1] + v * tri_uv[:, 2]
    texel = sample_bilinear(scene.textures, tex_id, uv[..., 0], uv[..., 1])
    alpha = srgb_to_linear(texel[..., 3])
    return torch.where(tex_id >= 0, alpha, 1.0)


def _per_ray(x, r, device):
    return torch.as_tensor(x, dtype=torch.float32,
                           device=device).expand(r).clone()


def chain_kernel_route(device_type: str, split: bool, engine: str,
                       n_chunks: int) -> bool:
    """Whether a cutout chain runs as one kernel a query: on CUDA tensors,
    over the cutout sub-scene of a split scene, where the query's method
    resolves to the dense engine ("pallas") and the sub-scene's live
    triangles fill fewer than WALK_MIN_CHUNKS chunks of 128, so that one
    staged tile holds them. CPU tensors, the other engines, larger
    sub-scenes and the full-scene chain of an unsplit scene take the
    plain chain."""
    return (device_type == "cuda" and split and engine == "pallas"
            and n_chunks < WALK_MIN_CHUNKS)


def _uses_chain_kernel(sub, o, method) -> bool:
    """`chain_kernel_route` for a chain over the split scene's cutout
    sub-scene `sub` with rays `o`."""
    engine = _resolve(method, sub, o.device)
    n_chunks = 0  # the dense arrays are built only where they can serve
    if o.device.type == "cuda" and engine == "pallas":
        n_live = dense_kernels.dense_arrays(sub)[2]
        n_chunks = -(-n_live // dense_kernels.TRI_CHUNK)
    return chain_kernel_route(o.device.type, True, engine, n_chunks)


# ---------------------------------------------------------------------------
# The plain chains: a whole-wavefront closest query a layer
# ---------------------------------------------------------------------------

def closest_chain_plain(sub, o, d, tmin, bound, method="auto", layers=None):
    """The radiance chain over `sub`: per lane, the first hit in (tmin,
    bound) whose alpha passes the threshold, re-entering behind holes at
    most MAX_CUTOUT_LAYERS times; a lane still open after the last layer
    takes its deepest hole (it occludes there). Returns (best_t [R],
    best_id [R] int32): +inf and -1 where nothing stops the lane. `layers`
    (int [R]), if given, gains each lane's sweeps."""
    r, dev = o.shape[0], o.device
    cur_tmin = tmin
    open_ = torch.ones(r, dtype=torch.bool, device=dev)
    best_t = torch.full((r,), float("inf"), device=dev)
    best_id = torch.full((r,), -1, dtype=torch.int32, device=dev)
    # the deepest cut hit: an exhausted chain occludes there
    last_cut_t = torch.full((r,), float("inf"), device=dev)
    last_cut_id = torch.full((r,), -1, dtype=torch.int32, device=dev)
    for _ in range(MAX_CUTOUT_LAYERS + 1):
        if not bool(open_.any()):
            break
        if layers is not None:
            layers += open_
        lane_tmax = torch.where(open_, bound, -1.0)
        h = intersect_closest(sub, o, d, cur_tmin, lane_tmax, method=method)
        solid = h.hit & (_hit_alpha(sub, h) >= ALPHA_THRESHOLD)
        take = open_ & solid
        best_t = torch.where(take, h.t, best_t)
        best_id = torch.where(take, h.tri_id, best_id)
        open_ = open_ & h.hit & ~solid
        cur_tmin = torch.where(open_, h.t + REENTRY_EPS, cur_tmin)
        last_cut_t = torch.where(open_ & h.hit, h.t, last_cut_t)
        last_cut_id = torch.where(open_ & h.hit, h.tri_id, last_cut_id)
    exhausted = open_ & (last_cut_id >= 0)
    return (torch.where(exhausted, last_cut_t, best_t),
            torch.where(exhausted, last_cut_id, best_id))


def any_chain_plain(scene, o, d, tmin, tmax, gate, method="auto",
                    layers=None):
    """The shadow chain over `scene`: a ray is blocked only by a hit whose
    alpha passes the threshold, and re-enters behind cutout hits. gate
    masks the lanes that need the query at all. `layers` as in
    `closest_chain_plain`."""
    blocked = torch.zeros_like(gate)
    open_ = gate
    cur_tmin = tmin
    for _ in range(MAX_CUTOUT_LAYERS + 1):
        if not bool(open_.any()):
            break
        if layers is not None:
            layers += open_
        lane_tmax = torch.where(open_, tmax, -1.0)
        hit = intersect_closest(scene, o, d, cur_tmin, lane_tmax,
                                method=method)
        opaque = hit.hit & (_hit_alpha(scene, hit) >= ALPHA_THRESHOLD)
        blocked = blocked | (open_ & opaque)
        # keep searching only through cutout hits
        open_ = open_ & hit.hit & ~opaque
        cur_tmin = torch.where(open_, hit.t + REENTRY_EPS, cur_tmin)
    # layers beyond the bound conservatively occlude
    return blocked | open_


def chain_reentries(kind, sub, o, d, tmin, tmax, gate=None, method="auto"):
    """The layers the plain chain's lanes re-trace beyond their first, in
    all (what the kernels add to `last_reentries`): kind "closest" or
    "any", with the chain's inputs."""
    layers = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    if kind == "closest":
        closest_chain_plain(sub, o, d, tmin, tmax, method, layers)
    else:
        any_chain_plain(sub, o, d, tmin, tmax, gate, method, layers)
    return int((layers - 1).clamp(min=0).sum())


# ---------------------------------------------------------------------------
# The chain kernels (csrc/dense_intersect.cu)
# ---------------------------------------------------------------------------

def chain_arrays(sub):
    """(tris, boxes, n_live, uvs, meta) of a cutout sub-scene for the chain
    kernels, built once and cached on it: the dense engine's arrays, the
    triangles' uvs [T, 6] and each triangle's albedo texture id (int32,
    -1 none, -2 an invalid triangle)."""
    cached = sub.cache.get("cutout_chain")
    if cached is None:
        tris, boxes, n_live = dense_kernels.dense_arrays(sub)
        tex = sub.mat_albedo_tex[sub.tri_mat.long()]
        meta = torch.where(sub.tri_valid, tex, -2).to(torch.int32)
        uvs = sub.tri_uvs.detach().reshape(-1, 6).float().contiguous()
        cached = (tris, boxes, n_live, uvs, meta.contiguous())
        sub.cache["cutout_chain"] = cached
    return cached


def _chain_args(sub, o, d, tmin, tmax):
    """The kernels' inputs, checked: the ray and scene pointers, n_chunks,
    n_live, n_tex and res."""
    tris, boxes, n_live, uvs, meta = chain_arrays(sub)
    rays = dense_kernels._rays(o, d, tmin.detach(), tmax.detach())
    ray_p = dense_kernels._check_cuda(tris, boxes, n_live, *rays)
    tex = sub.textures
    if n_live > STAGED_TRIS:
        raise ValueError(f"{n_live} live triangles: the chain kernels stage "
                         f"at most {STAGED_TRIS}")
    for x, dtype in ((uvs, torch.float32), (meta, torch.int32),
                     (tex, torch.float32)):
        if not (x.device == o.device and x.dtype == dtype
                and x.is_contiguous()):
            raise ValueError(f"chain kernel input {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}: expected contiguous {dtype} "
                             f"on {o.device}")
    if uvs.shape[0] < n_live or meta.shape[0] < n_live or tex.dim() != 4 \
            or tex.shape[1] != tex.shape[2] or tex.shape[3] != 4:
        raise ValueError("chain kernel scene arrays of the wrong shape")
    return (ray_p[:4], ray_p[4:], boxes.shape[1], n_live,
            [uvs.data_ptr(), meta.data_ptr(), tex.data_ptr()],
            tex.shape[0], tex.shape[1])


def closest_chain_kernel(sub, o, d, tmin, bound):
    """Launch the radiance chain kernel: `closest_chain_plain`'s (best_t,
    best_id) on o's CUDA device, from one launch."""
    rays, scene_p, n_chunks, n_live, arrays, n_tex, res = _chain_args(
        sub, o, d, tmin, bound)
    r = o.shape[0]
    out_t = torch.empty(r, dtype=torch.float32, device=o.device)
    out_id = torch.empty(r, dtype=torch.int32, device=o.device)
    reentries = torch.empty(1, dtype=torch.int32, device=o.device)
    with torch.cuda.device(o.device):
        err = dense_kernels._fn("cutout_closest")(
            *rays, r, *scene_p, n_chunks, n_live, *arrays, n_tex, res,
            out_t.data_ptr(), out_id.data_ptr(), reentries.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cutout_closest launch failed: CUDA error {err}")
    closest_chain_kernel.launches += 1
    closest_chain_kernel.last_reentries = reentries
    return out_t, out_id


def any_chain_kernel(sub, o, d, tmin, tmax, gate):
    """Launch the shadow chain kernel: `any_chain_plain`'s blocked [R] bool
    on o's CUDA device, from one launch."""
    rays, scene_p, n_chunks, n_live, arrays, n_tex, res = _chain_args(
        sub, o, d, tmin, tmax)
    r = o.shape[0]
    gate = gate.to(device=o.device, dtype=torch.bool).contiguous()
    if gate.shape != (r,):
        raise ValueError(f"gate {tuple(gate.shape)}: expected ({r},)")
    out = torch.empty(r, dtype=torch.bool, device=o.device)
    reentries = torch.empty(1, dtype=torch.int32, device=o.device)
    with torch.cuda.device(o.device):
        err = dense_kernels._fn("cutout_any")(
            *rays, gate.data_ptr(), r, *scene_p, n_chunks, n_live, *arrays,
            n_tex, res, out.data_ptr(), reentries.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cutout_any launch failed: CUDA error {err}")
    any_chain_kernel.launches += 1
    any_chain_kernel.last_reentries = reentries
    return out


closest_chain_kernel.launches = any_chain_kernel.launches = 0
closest_chain_kernel.last_reentries = any_chain_kernel.last_reentries = None


@spans.traced(spans.CUTOUT)
def _closest_chain(sub, o, d, tmin, bound, method):
    if _uses_chain_kernel(sub, o, method):
        return closest_chain_kernel(sub, o, d, tmin, bound)
    return closest_chain_plain(sub, o, d, tmin, bound, method)


@spans.traced(spans.CUTOUT)
def _any_chain(sub, o, d, tmin, tmax, gate, method):
    if _uses_chain_kernel(sub, o, method):
        return any_chain_kernel(sub, o, d, tmin, tmax, gate)
    return any_chain_plain(sub, o, d, tmin, tmax, gate, method)


# ---------------------------------------------------------------------------
# The queries
# ---------------------------------------------------------------------------

def intersect_closest_cutout(scene, o, d, tmin=0.0, tmax=100.0,
                             method="auto"):
    """Closest hit skipping cutout surfaces (the radiance-ray anyhit).

    Split scenes: one closest hit over the opaque sub-scene, the cutout
    chain over the cutout sub-scene bounded by it, the winner mapped to
    its outer id (t-ties between the two go to the lower outer id, as the
    full-scene chain and brute break them) and refined against the outer
    geometry. Other scenes: the full-scene chain, re-tracing only the cut
    lanes (the others dead at tmax = -1)."""
    r, dev = o.shape[0], o.device
    tmin = _per_ray(tmin, r, dev)
    tmax_b = _per_ray(tmax, r, dev)

    if scene.opaque_scene is not None and scene.cutout_sub is not None:
        opq = scene.opaque_scene
        sub = scene.cutout_sub
        h_o = intersect_closest(opq, o, d, tmin, tmax_b, method=method)
        # the cutout chain over the subset, bounded by the opaque hit
        sub_bound = torch.where(h_o.hit, h_o.t + REENTRY_EPS, tmax_b)
        best_t, best_id = _closest_chain(sub, o, d, tmin, sub_bound, method)

        sub_hit = best_id >= 0
        n_sub = sub.tri_outer_id.shape[0]
        sub_outer = sub.tri_outer_id[best_id.clamp(0, n_sub - 1).long()]
        n_opq = opq.tri_outer_id.shape[0]
        opq_outer = opq.tri_outer_id[h_o.tri_id.clamp(0, n_opq - 1).long()]
        sub_wins = sub_hit & (~h_o.hit | (best_t < h_o.t)
                              | ((best_t == h_o.t) & (sub_outer < opq_outer)))
        final_id = torch.where(sub_wins, sub_outer,
                               torch.where(h_o.hit, opq_outer, -1))
        zeros = torch.zeros(r, device=dev)
        raw = Hit(t=torch.where(sub_wins, best_t, h_o.t),
                  tri_id=final_id.detach(), u=zeros, v=zeros,
                  hit=sub_wins | h_o.hit,
                  back_face=torch.zeros(r, dtype=torch.bool, device=dev))
        # differentiable refinement against the OUTER geometry, the
        # contract of api.intersect_closest
        return _refine(scene, o, d, raw, tmax_b)

    best = intersect_closest(scene, o, d, tmin, tmax_b, method=method)
    with spans.span(spans.CUTOUT):
        for _ in range(MAX_CUTOUT_LAYERS):
            cut = best.hit & (_hit_alpha(scene, best) < ALPHA_THRESHOLD)
            if not bool(cut.any()):
                break
            new_tmin = torch.where(cut, best.t + REENTRY_EPS, tmin)
            lane_tmax = torch.where(cut, tmax_b, -1.0)
            again = intersect_closest(scene, o, d, new_tmin, lane_tmax,
                                      method=method)
            best = Hit(*[torch.where(cut, a, b) for a, b in zip(again, best)])
    return best


def intersect_any_cutout(scene, o, d, tmin=0.0, tmax=100.0, method="auto"):
    """Occlusion honouring cutout (the shadow-ray anyhit,
    `devicePrograms.cu:556-561`): a ray is blocked only by a hit whose
    alpha passes the threshold.

    Split scenes: a plain occlusion query over the opaque sub-scene, OR'd
    with the cutout chain over the cutout sub-scene on the lanes it left
    unblocked. Other scenes: the chain over the whole scene."""
    r, dev = o.shape[0], o.device
    tmin = _per_ray(tmin, r, dev)
    tmax_b = _per_ray(tmax, r, dev)

    if scene.opaque_scene is not None and scene.cutout_sub is not None:
        blocked_o = intersect_any(scene.opaque_scene, o, d, tmin, tmax_b,
                                  method=method)
        blocked_c = _any_chain(scene.cutout_sub, o, d, tmin,
                               torch.where(blocked_o, -1.0, tmax_b),
                               ~blocked_o, method)
        return blocked_o | blocked_c

    with spans.span(spans.CUTOUT):
        return any_chain_plain(scene, o, d, tmin, tmax_b,
                               torch.ones(r, dtype=torch.bool, device=dev),
                               method)

#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (optixpathtracer_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (one nvcc per source, all
started together), then runs four cells at 1920x1080, each with its own
path: scene3_cornell (16 spp, 2 bounces; 1 chunk, so the dense kernels),
`diffuse` (4 spp, 3 bounces, scenes/config1_diffuse.json; 149 chunks, so
the walk kernels), `layered` (2 spp, 2 bounces, scenes/
config4_layered.json; the walk kernels and the glossy-diffuse lobe) and
`hall` (2 spp, 2 bounces, bench.py's hall_fwd at 1080p: 338,270 textured
triangles with alpha-cutout foliage, every lobe; its opaque sub-scene's
1,322 chunks of 256 send primaries and bounce-0 shadow rays to the walk
kernels and bounce-1 rays to the packet kernels, and each alpha-cutout
chain over the 40-triangle cutout sub-scene runs as one kernel,
cutout_closest or cutout_any).

1. Kernel phase, on the wavefronts of a real trace_paths frame of each cell
   (the 1080p primary wavefront, then each bounce's closest and NEE shadow
   rays). Dense kernels on Cornell and `diffuse`, and on Cornell again at
   3840x2160 (the wavefronts of the `cornell.render-2160p` cell, 8,294,400
   rays, each checked whole against the plain sweep); the cutout chain
   kernels on hall's four chains (each bit for bit the plain chain, whose
   layers are dense sweeps, its re-traced layers equal to the plain
   count; kernel and plain chain timed, the bound from the needed tests of
   the plain chain's layers or the bytes; the re-traced layers a frame
   printed); walk kernels on `diffuse`, `layered` and hall, and on `diffuse`
   re-flattened at 256 triangles a chunk (MAX_WALK_CHUNKS = 100: 75
   chunks) for the primary wavefront; packet kernels on every hall
   wavefront. Each kernel against its plain PyTorch version on the same
   inputs: candidate entries and packet words bit-identical, hit masks,
   ids and blocked flags identical (a knife-edge tie may differ only where
   both t agree within 1e-5 relative, on at most 1e-5 of the rays). Bounce
   wavefronts (every hall wavefront) are checked on a fixed 2^18-ray
   subsample (whole ray blocks for the walk and packet sweeps), so the
   plain sweeps stay short. Kernels are timed with CUDA events after a
   warm-up at every wavefront, the engines' plain torch steps too
   (coherence sort, candidate sort); `diffuse` gets a dense-vs-walk table
   per wavefront and a 256- vs 1024-ray block table, hall a walk-vs-packet
   table per wavefront with the packet engine at 256- and 1024-ray blocks
   and, per packet kernel, its registers (ptxas -v) and shared memory a
   block (the union tile of packet_kernels.smem_plan), and at each hall
   wavefront the subchunks swept a packet, the triangle and slab tests,
   the bound and its reach (bound / kernel ms).
   Each kernel's bound is computed from this run's inputs: the FP32
   operations of its ray-triangle tests (plus the packet kernels'
   ray-subchunk slab tests, the candidate kernel's all-pairs slab tests),
   over 132 SMs x 128 lanes at the card's max SM clock, or the bytes over
   3.35 TB/s, whichever is larger. For the dense and walk sweeps the tests
   are those the inputs need, from the plain count models
   `dense_kernels.needed_work` and `walk_kernels.needed_work` (live rays
   whose own slab test passes a chunk, real triangles, occlusion up to the
   first blocker), each charged the operations up to where it can end
   (once u, or v, rules the hit out; else at t): the dense kernels' and
   the walk closest kernel's per-block counts must equal them, the walk
   occlusion kernel's chunks too and its tests lie within the model's
   slack. The packet kernels' are the tests they report, each charged a
   whole test. Every walk sweep is timed
   and bounded at every wavefront. Each kernel's row is at the wavefront
   the frame first runs it on: closest and candidates at the primary
   wavefront (hall's chain kernels at the bounce-0 chain of their kind,
   packet at bounce 1), occlusion at the bounce-0 shadow wavefront, with
   the other
   wavefronts listed. The BSDF dispatch's three kernels
   (csrc/layered_bsdf.cu, which replace no TPU kernel: the layered lobe's
   f walks, the closed-form lobes' f, and the sample of every lobe) run at
   every dispatch call of a real `diffuse`, `layered` and hall frame (f
   and sample at each bounce, 2,073,600 lanes each): the lanes' shares by
   resolved type, each call bit for bit the plain dispatch's, each
   kernel's ms alone beside the call's and the plain dispatch's, and a
   bound from the work the kernel counts itself (FP32 operations at the
   FP32 rate, float64 exp / cos / sin calls x FP64_CALL_OPS at the FP64
   rate) or the bytes its lanes need, the largest. The build's register
   counts and spills (ptxas -v) of all ten kernels are printed, the sample
   kernel's three instantiations apart.
2. Path phase. `render` (method "auto") of each cell at 1920x1080 with
   every launch counter zeroed just before and read just after; each
   cell's kernels must have launched and the image must be finite and
   non-negative. Mrays/s with bench.py's accounting (pixels x spp x
   bounces x 2 / seconds). Then torch.profiler over one 1-spp frame of
   every cell.
3. Images. Each cell, and `conductor` and `dielectric` (so every lobe runs
   on the card), at 256x256, 2 spp, through the kernels and again through
   the plain versions; and Cornell and hall_small (20,606 triangles,
   cutout live, method "packet") at 48x48 on the GPU against the CPU (the
   path the tests hold to the JAX package): by the engine-golden criterion
   (> 99.5% of pixels within atol 1e-5 / rtol 1e-4, mean within rtol
   1e-3). The GPU and CPU frames are also compared stage by stage (camera
   rays, hits, surfaces, NEE, BSDF samples, throughput) and the first
   stage that differs is printed, for Cornell, hall_small and `layered`
   (the last printed, not gated).
4. Options phase: the `trace_paths` ray sort at 1920x1080 through
   `render_sample` (method "auto"), 1 spp: unsorted, sort_rays True and
   "morton", on `diffuse` (3 bounces) and hall (2 bounces): wall ms,
   device-busy ms and launches of the frame, each sorted image held to
   the unsorted frame (bit for bit expected).
5. Backward phase, in bench.py's fwd_bwd shape: `layered` at 256x256, 2
   bounces, frames 0-3, `diff.param_gradients` over the four material
   fields of the reference's material_grad_step (mean loss), once through
   the kernels and once through the plain versions: gradients bit for
   bit. fwd+bwd and forward-only Mrays/s (pixels x frames x bounces x 2 /
   seconds), peak device memory and bytes a lane. Then hall_small at
   48x48 through "auto" (walk, the cutout chain kernels) and "packet":
   gradients finite, kernels equal plain.
6. Front-end phase, through the entry points a user calls. The shipped
   flagship config through the CLI (`cli.main(["--config",
   "scenes/config5_full.json", ...])`: scene1_spheres, 1024x1024, 1024
   spp, 2 bounces, `sharded` with one rank, so the fallback line; the
   EXR, PNG, BMP and checkpoint in a temporary directory): wall, Mrays/s,
   the walk kernels' launches, the seconds of scene load, checkpoint and
   output writes; the EXR read back is the image bit for bit, the PNG and
   BMP decode to `to_display` of it; then one 1-spp frame of that config
   through the kernels equals the plain versions' bit for bit (the walk
   kernels at the path's 1M-ray wavefronts, the conductor's specular
   bounces included). hall at 1920x1080, 2 bounces,
   through the CLI: A at 4 spp, B1 at 2 spp with a checkpoint, B2 at 4
   spp resumed from it; B2 equals A bit for bit, and A equals `render` of
   the same 4 frames, whose wall against the CLI's is the front end's
   cost. dist with NCCL at world size 1 (torchrun's variables set in the
   process, a free port): the sharded hall 1080p frame and its four
   270-row blocks equal `render_sample` bit for bit, and
   `material_grad_step` on layered at 256x256 equals the step of the
   single-process autograd gradients within rtol 1e-6. The preview,
   headless, on Cornell at 256x256 for 5 s on a free port: a PNG fetched
   over HTTP from 127.0.0.1, samples > 0. The replay: the gradients of an
   L2 loss over MaterialTestReplay's parameters (conductor, 64x64,
   "pallas") through the kernels equal the plain versions' bit for bit.
Every phase that drives a path sets the launch counters to 0 just before
and reads them just after, and fails if a kernel of that path never
launched.

Any failed check raises, so the process exits non-zero. The last lines of
standard output are JSON objects describing the engine tables and the
kernels, the card (nvidia-smi name and power limit) and the result line
{"ok": true, "device": {...}}. It exits non-zero, printing no result,
without a CUDA device or without the rest of the repository.
"""
import contextlib
import dataclasses
import functools
import io
import json
import re
import subprocess
import sys
import time

CELLS = (
    # scene, spp, max_bounces at 1920x1080
    ("scene3_cornell", 16, 2),  # bench.py headline scene: dense kernels
    ("diffuse", 4, 3),          # scenes/config1_diffuse.json: walk kernels
    ("layered", 2, 2),          # scenes/config4_layered.json: walk + glossy
    ("hall", 2, 2),             # bench.py hall_fwd: walk, packet, chains
)
WALK = ("walk_candidates", "walk_closest", "walk_any")
BSDF = ("layered_f", "lobes_f", "lobes_sample")
CELL_KERNELS = {  # the kernels each cell's render must launch
    "scene3_cornell": ("dense_closest", "dense_any"),
    "diffuse": WALK + ("lobes_f", "lobes_sample"),
    "layered": WALK + ("layered_f", "lobes_sample"),
    "hall": WALK + ("packet_closest", "packet_any", "cutout_closest",
                    "cutout_any") + BSDF,
}
BSDF_SCENES = ("diffuse", "layered", "hall")
DENSE_SCENES = ("scene3_cornell", "diffuse")
WALK_SCENES = ("diffuse", "layered")
IMAGE_SCENES = ("scene3_cornell", "diffuse", "layered", "conductor",
                "dielectric", "hall")
WIDTH, HEIGHT = 1920, 1080
WIDE = (3840, 2160)      # Cornell's dense kernels at the 2160p cell too
SMALL = 256              # kernels-vs-plain renders: SMALL x SMALL, 2 spp
SUBSAMPLE = 1 << 18      # bounce rays compared against the plain versions
KNIFE_EDGE_REL_T = 1e-5  # ids may differ only at ties this close ...
KNIFE_EDGE_FRAC = 1e-5   # ... on at most this fraction of the rays
BLOCK_COMPARE = (256, 1024)
WALK_CHUNKS_256 = 100    # MAX_WALK_CHUNKS giving `diffuse` 256-tri chunks
# FP32 operations per test, counted from the CUDA sources: Moller-Trumbore
# (mt(): 9 cross + 5 det + 2 |det| test + 1 div + 3 + 6 u + 9 q + 6 v + 6 t
# + 7 bound tests) and the candidate kernel's slab test (6 sub + 6 mul + 10
# min/max + 3 compares, then its live test, max(t_near, 0) and the min).
MT_OPS = 54
# What a needed test costs up to where it can end (mt() in
# csrc/walk_intersect.cu): 28 once u rules the hit out (cross, det, |det|
# test, division, origin offset, u and its two range tests), 46 once v
# does (+ q, v, v >= 0, u + v and its test), all 54 where it goes on to t.
MT_EXIT_OPS = (28, 46, MT_OPS)
CAND_OPS = 28
# the packet kernels' subchunk slab test (sub_slab(): per axis 2 sub, 2
# mul, 2 min/max and the running max and min, then 4 compares)
SLAB_OPS = 28
SMS, FP32_LANES = 132, 128       # H100 SXM
FP64_LANES = 64                  # H100 SXM: FP64 lanes an SM
# FP64 operations charged to one float64 exp, cos or sin of the layered
# lobe's kernels: libdevice's argument reduction and polynomial, about 20
# multiply-adds a call (an estimate, not a count of the build's code)
FP64_CALL_OPS = 20
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3


def log(*args):
    print(*args, flush=True)


def nvidia_smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_once(fn):
    """(ms, result) of one call, timed with CUDA events, no warm-up."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def cuda_time_ms(fn, reps):
    """Mean ms per call over `reps` calls, timed with CUDA events after one
    warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper (dense, walk, packet, the cutout chains
    and the BSDF dispatch's) to its plain version."""
    from optixpathtracer_tpu_torch.bsdf import dispatch
    from optixpathtracer_tpu_torch.integrate import cutout
    from optixpathtracer_tpu_torch.intersect import dense_kernels as dk
    from optixpathtracer_tpu_torch.intersect import packet_kernels as pk
    from optixpathtracer_tpu_torch.intersect import walk_kernels as wk
    saved = (dk.closest_kernel, dk.any_kernel, wk.candidates_kernel,
             wk.closest_kernel, wk.any_kernel, pk.packet_closest_kernel,
             pk.packet_any_kernel, dispatch.f_kernel, dispatch.sample_kernel,
             cutout.chain_kernel_route)
    dk.closest_kernel = (lambda tris, boxes, n_live, *rays:
                         dk.closest_plain(tris, *rays))
    dk.any_kernel = (lambda tris, boxes, n_live, *rays:
                     dk.any_plain(tris, *rays))
    wk.candidates_kernel = wk.candidates_plain
    wk.closest_kernel = (lambda tris, boxes, cand, tnear, count, *rays:
                         wk.closest_plain(tris, cand, count, *rays))
    wk.any_kernel = (lambda tris, boxes, cand, count, *rays:
                     wk.any_plain(tris, cand, count, *rays))
    pk.packet_closest_kernel = functools.partial(pk.plain_launch,
                                                 pk.packet_closest_plain)
    pk.packet_any_kernel = functools.partial(pk.plain_launch,
                                             pk.packet_any_plain)
    dispatch.f_kernel = dispatch.f_plain
    dispatch.sample_kernel = dispatch.sample_plain
    cutout.chain_kernel_route = lambda *args: False
    try:
        yield
    finally:
        (dk.closest_kernel, dk.any_kernel, wk.candidates_kernel,
         wk.closest_kernel, wk.any_kernel, pk.packet_closest_kernel,
         pk.packet_any_kernel, dispatch.f_kernel, dispatch.sample_kernel,
         cutout.chain_kernel_route) = saved


def kernel_wrappers():
    """{name: wrapper} of every hand-written kernel."""
    from optixpathtracer_tpu_torch.bsdf import kernels as bk
    from optixpathtracer_tpu_torch.integrate import cutout
    from optixpathtracer_tpu_torch.intersect import dense_kernels as dk
    from optixpathtracer_tpu_torch.intersect import packet_kernels as pk
    from optixpathtracer_tpu_torch.intersect import walk_kernels as wk
    return {"dense_closest": dk.closest_kernel, "dense_any": dk.any_kernel,
            "walk_candidates": wk.candidates_kernel,
            "walk_closest": wk.closest_kernel, "walk_any": wk.any_kernel,
            "packet_closest": pk.packet_closest_kernel,
            "packet_any": pk.packet_any_kernel,
            "cutout_closest": cutout.closest_chain_kernel,
            "cutout_any": cutout.any_chain_kernel,
            "layered_f": bk.layered_f, "lobes_f": bk.lobes_f,
            "lobes_sample": bk.lobes_sample}


@contextlib.contextmanager
def recorded_queries(*modules):
    """Record the (kind, scene, o, d, tmin, tmax) of every closest and
    occlusion query that the modules' code makes through their names for
    the queries."""
    calls = []
    saved = [(m, m.intersect_closest, m.intersect_any) for m in modules]

    def recording(kind, query):
        def run(scene, o, d, tmin, tmax, method):
            calls.append((kind, scene, o, d, tmin, tmax))
            return query(scene, o, d, tmin, tmax, method=method)
        return run

    for m, closest, any_hit in saved:
        m.intersect_closest = recording("closest", closest)
        m.intersect_any = recording("any", any_hit)
    try:
        yield calls
    finally:
        for m, closest, any_hit in saved:
            m.intersect_closest, m.intersect_any = closest, any_hit


def compare_closest(kernel, plain, what):
    """Ids identical up to knife-edge ties; returns (max |dt| where both hit
    the same triangle, number of knife-edge rays)."""
    kt, ki = kernel
    pt, pi = plain
    hit = pi >= 0
    if not (hit == (ki >= 0)).all():
        n = int((hit != (ki >= 0)).sum())
        raise AssertionError(f"{what}: hit masks differ on {n} rays")
    differ = ki != pi
    n_diff = int(differ.sum())
    if n_diff:
        rel = ((kt - pt).abs() / pt.abs())[differ]
        if not (rel <= KNIFE_EDGE_REL_T).all() or \
                n_diff > KNIFE_EDGE_FRAC * ki.numel():
            raise AssertionError(f"{what}: ids differ on {n_diff} rays, "
                                 f"max relative dt {float(rel.max()):.3g}")
    same = hit & ~differ
    err = float((kt - pt).abs()[same].max()) if same.any() else 0.0
    log(f"  {what}: {ki.numel()} rays, {int(hit.sum())} hits, "
        f"knife-edge ties {n_diff}, max |dt| {err:.3g}")
    return err


def compare_any(kernel, plain, what):
    n = int((kernel != plain).sum())
    if n:
        raise AssertionError(f"{what}: blocked differs on {n} rays")
    log(f"  {what}: {kernel.numel()} rays, {int(kernel.sum())} blocked")
    return 0.0


class Card:
    """What the bounds need: the FP32 rate at the max SM clock."""

    def __init__(self):
        self.name_power = nvidia_smi("name,power.limit")
        self.max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
        self.fp32_per_s = SMS * FP32_LANES * self.max_sm_mhz * 1e6

    def bound(self, ops, n_bytes):
        """(bound ms, "operations" or "bytes")."""
        t_ops = ops / self.fp32_per_s * 1e3
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else \
            (t_bytes, "bytes")


def scene_flags(scene):
    """The static shading options `render` derives from a scene."""
    from optixpathtracer_tpu_torch.integrate.cutout import \
        scene_uses_alpha_cutout
    from optixpathtracer_tpu_torch.scene.flatten import (scene_active_lobes,
                                                         scene_flat_shading,
                                                         scene_uses_textures)
    return {"active_lobes": scene_active_lobes(scene),
            "use_textures": scene_uses_textures(scene),
            "use_alpha_cutout": scene_uses_alpha_cutout(scene),
            "flat_shading": scene_flat_shading(scene)}


@contextlib.contextmanager
def recorded_chains():
    """Record {"closest": [...], "any": [...]}: the inputs (sub-scene, o,
    d, tmin, tmax and, for "any", the gate) and re-traced layers of every
    cutout chain kernel call. A wrapper counts on the module's name for
    it, so a recorder carries the counters while it stands in."""
    from optixpathtracer_tpu_torch.integrate import cutout
    calls = {"closest": [], "any": []}
    saved = {"closest": cutout.closest_chain_kernel,
             "any": cutout.any_chain_kernel}

    def recording(kind, fn):
        def run(*args):
            out = fn(*args)
            calls[kind].append((args, int(run.last_reentries)))
            return out
        run.launches, run.last_reentries = fn.launches, fn.last_reentries
        return run

    stand_ins = {k: recording(k, fn) for k, fn in saved.items()}
    cutout.closest_chain_kernel = stand_ins["closest"]
    cutout.any_chain_kernel = stand_ins["any"]
    try:
        yield calls
    finally:
        for k, fn in saved.items():
            fn.launches = stand_ins[k].launches
            fn.last_reentries = stand_ins[k].last_reentries
        cutout.closest_chain_kernel = saved["closest"]
        cutout.any_chain_kernel = saved["any"]


def frame_waves(scene, camera, bounces, dev, width=WIDTH, height=HEIGHT):
    """The (o, d, tmin, tmax) of every closest and shadow query of one real
    width x height trace_paths frame ("auto" routing) on the scene the
    engines sweep (the opaque sub-scene of a cutout scene), and the inputs
    and re-traced layers of each cutout chain kernel call on the cutout
    sub-scene: (closest, shadow, chains)."""
    import torch
    from optixpathtracer_tpu_torch.camera.camera import generate_rays
    from optixpathtracer_tpu_torch.core import rng
    from optixpathtracer_tpu_torch.integrate import cutout, path
    from optixpathtracer_tpu_torch.intersect import dense_kernels as dk
    o, d = generate_rays(*camera.raygen_params(width, height, dev), width,
                         height)
    o = o.reshape(-1, 3).contiguous()
    d = d.reshape(-1, 3).contiguous()
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    seed = rng.pixel_seed(width, xs.reshape(-1), ys.reshape(-1), 0)
    with torch.no_grad(), recorded_queries(path, cutout) as calls, \
            recorded_chains() as chains:
        path.trace_paths(scene, o, d, seed, bounces, "auto",
                         **scene_flags(scene))
    main = scene if scene.opaque_scene is None else scene.opaque_scene
    ours = [c for c in calls if c[1] is main]
    assert [c[0] for c in ours] == ["closest", "any"] * bounces
    assert all(c[1] is main for c in calls)  # no chain ran plain
    closest = [dk._rays(*c[2:]) for c in ours if c[0] == "closest"]
    shadow = [dk._rays(*c[2:]) for c in ours if c[0] == "any"]
    assert len(chains["closest"]) == len(chains["any"]) == \
        (bounces if scene.cutout_sub is not None else 0)
    return closest, shadow, chains


def subsample(r, dev):
    import torch
    gen = torch.Generator(device="cpu").manual_seed(0)
    return torch.randperm(r, generator=gen)[:SUBSAMPLE].sort().values.to(dev)


# ---------------------------------------------------------------------------
# Dense kernels
# ---------------------------------------------------------------------------

def needed_ops(work):
    """The FP32 operations of a count model's needed tests (a
    `NeededWork`), each up to where it can end (MT_EXIT_OPS)."""
    return sum(n * ops for n, ops in zip(work.exits.sum(dim=0).tolist(),
                                         MT_EXIT_OPS))


def exit_shares(work):
    """'u a% / v b% / t c%': the shares of the needed tests by where they
    can end."""
    n = work.exits.sum(dim=0).tolist()
    return " / ".join(f"{k} {x / max(sum(n), 1):.1%}"
                      for k, x in zip("uvt", n))


def dense_bound(card, kind, tris, boxes, n_live, rays):
    """(bound ms, bound_by, work) of a dense sweep of `rays`: the
    operations of the tests these inputs need (`dense_kernels.needed_work`,
    a `NeededWork`: live rays, real triangles, occlusion up to the first
    blocker; `needed_ops`), or the bytes (rays in, answers out, the real
    triangles and the boxes)."""
    from optixpathtracer_tpu_torch.intersect import dense_kernels as dk
    work = dk.needed_work(kind, tris, boxes, n_live, *rays)
    r = rays[0].shape[0]
    n_bytes = r * (32 + (8 if kind == "closest" else 4)) + n_live * 36 \
        + boxes.numel() * 4
    return (*card.bound(needed_ops(work), n_bytes), work)


def dense_phase(name, scene, closest, shadow, card, stats):
    """The dense kernels on a frame's closest and shadow wavefronts:
    checks against the plain versions (occlusion also at the primary
    wavefront), times at every wavefront, and each kernel's numbers at the
    wavefront the frame first runs it on: closest at the first closest
    wavefront, occlusion at the bounce-0 shadow wavefront. The kernels'
    test counts must equal the needed-work count model."""
    from optixpathtracer_tpu_torch.intersect import dense_kernels as dk
    tris, boxes, n_live = dk.dense_arrays(scene)
    r = closest[0][0].shape[0]
    sub = (subsample(r, closest[0][0].device)
           if r * tris.shape[1] > (1 << 32) else slice(None))
    labels = ["primary"] + [f"bounce-{b}" for b in range(1, len(closest))]
    closest = list(zip(labels, closest))
    shadow = [(f"bounce-{b} shadow", w) for b, w in enumerate(shadow)]
    kinds = {"dense_closest": ("closest", dk.closest_kernel, dk.closest_plain,
                               closest, closest),
             "dense_any": ("any", dk.any_kernel, dk.any_plain, shadow,
                           [("primary", closest[0][1])] + shadow)}
    for kname, (kind, launch, plain, timed, checked) in kinds.items():
        errs = []
        for i, (label, rays) in enumerate(checked):
            if i or kind == "any":
                rays = [x[sub].contiguous() for x in rays]
            k = launch(tris, boxes, n_live, *rays)
            p = plain(tris, *rays)
            what = f"{name} {kname} {label}"
            errs.append(compare_closest(k, p, what) if kind == "closest"
                        else compare_any(k, p, what))
        plain_ms, _ = cuda_time_once(lambda: plain(tris, *timed[0][1]))
        rows = []
        for b, (label, w) in enumerate(timed):
            ms = cuda_time_ms(lambda w=w: launch(tris, boxes, n_live, *w),
                              20 if b == 0 else 10)
            launch(tris, boxes, n_live, *w)
            got = int(launch.tests.sum())
            bound_ms, bound_by, work = dense_bound(card, kind, tris, boxes,
                                                   n_live, w)
            need = int(work.tests.sum())
            if got != need:
                raise AssertionError(f"{name} {kname} {label}: the kernel "
                                     f"ran {got} tests, the inputs need "
                                     f"{need}")
            live = int((w[3] > w[2]).sum())
            rows.append({"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "tests": need, "live_rays": live})
            log(f"  {name} {kname} {label}: kernel {ms:.3f} ms, bound "
                f"{bound_ms:.3f} ms ({bound_by}; {need:.4g} needed tests, "
                f"{need / max(live, 1):.1f} a live ray, ending at "
                f"{exit_shares(work)}, {live} of {w[0].shape[0]} rays "
                f"live), reach {bound_ms / ms:.1%}")
        first = rows[0]
        log(f"  {name} {kname}: kernel {first['ms']:.3f} ms, plain "
            f"{plain_ms:.1f} ms, bound {first['bound_ms']:.3f} ms at the "
            f"{timed[0][0]} wavefront ({n_live} live triangles of "
            f"{tris.shape[1]})")
        stats[(name, kname)] = {
            "max_abs_err": max(errs), "ms": first["ms"],
            "plain_ms": plain_ms, "bounce_ms": [x["ms"] for x in rows],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "tests": first["tests"],
            "bounce_bound_ms": [x["bound_ms"] for x in rows]}


# ---------------------------------------------------------------------------
# The alpha-cutout chain kernels
# ---------------------------------------------------------------------------

def chain_layers(kind, args):
    """The (o, d, tmin, tmax) of every layer the plain chain sweeps on these
    inputs (the closest queries it makes on the cutout sub-scene)."""
    from optixpathtracer_tpu_torch.integrate import cutout
    from optixpathtracer_tpu_torch.intersect import dense_kernels as dk
    plain = (cutout.closest_chain_plain if kind == "closest"
             else cutout.any_chain_plain)
    with recorded_queries(cutout) as calls:
        plain(*args)
    return [dk._rays(*c[2:]) for c in calls]


def chain_bound(card, kind, args):
    """(bound ms, bound_by, needed tests) of a chain: the operations of the
    tests that the plain chain's layers need (`dense_kernels.needed_work`
    of each, `needed_ops`), or the bytes (o, d, tmin, tmax in and the
    answer out a lane, the gate for "any", the staged sub-scene)."""
    from optixpathtracer_tpu_torch.integrate import cutout
    from optixpathtracer_tpu_torch.intersect import dense_kernels as dk
    tris, boxes, n_live = dk.dense_arrays(args[0])
    ops = tests = 0
    for rays in chain_layers(kind, args):
        work = dk.needed_work("closest", tris, boxes, n_live, *rays)
        ops += needed_ops(work)
        tests += int(work.tests.sum())
    r = args[1].shape[0]
    n_bytes = r * (32 + (8 if kind == "closest" else 2)) + n_live * 64 \
        + boxes.numel() * 4
    return (*card.bound(ops, n_bytes), tests)


def chain_phase(name, chains, card, stats):
    """The cutout chain kernels on every chain of a frame (the inputs and
    re-traced layers `frame_waves` recorded): bit for bit the plain chain
    (its layers the dense kernels' sweeps) and re-traced layers equal to
    the plain count; each timed (CUDA events) beside the plain chain's
    time and the bound; the kernel's row at the bounce-0 chain."""
    from optixpathtracer_tpu_torch.integrate import cutout
    kernels = {"closest": ("cutout_closest", cutout.closest_chain_kernel,
                           cutout.closest_chain_plain),
               "any": ("cutout_any", cutout.any_chain_kernel,
                       cutout.any_chain_plain)}
    per_frame = sum(n for calls in chains.values() for _, n in calls)
    log(f"  {name} cutout chains: {per_frame} layers re-traced beyond the "
        f"first in one frame (last_reentries of its "
        f"{sum(len(c) for c in chains.values())} launches)")
    for kind, calls in chains.items():
        kname, launch, plain = kernels[kind]
        rows = []
        for b, (args, reentries) in enumerate(calls):
            what = f"{name} {kname} bounce-{b}"
            got = launch(*args)
            want = plain(*args)
            if kind == "closest":
                same = torch_equal(got[0], want[0]) and \
                    torch_equal(got[1], want[1])
                hits = int((got[1] >= 0).sum())
            else:
                same = torch_equal(got, want)
                hits = int(got.sum())
            if not same:
                raise AssertionError(f"{what}: the kernel differs from the "
                                     f"plain chain")
            count = cutout.chain_reentries(kind, *args)
            if int(launch.last_reentries) != count or reentries != count:
                raise AssertionError(
                    f"{what}: {int(launch.last_reentries)} (in the frame "
                    f"{reentries}) layers re-traced, the plain chain "
                    f"{count}")
            ms = cuda_time_ms(lambda a=args: launch(*a), 20 if b == 0 else 10)
            plain_ms = cuda_time_ms(lambda a=args: plain(*a), 3)
            bound_ms, bound_by, tests = chain_bound(card, kind, args)
            live = int((args[4] > args[3]).sum()) if kind == "closest" \
                else int(((args[4] > args[3]) & args[5]).sum())
            rows.append({"ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "tests": tests, "reentries": count})
            log(f"  {what}: kernel {ms:.3f} ms, plain chain {plain_ms:.2f} "
                f"ms, bound {bound_ms:.4f} ms ({bound_by}; {tests} needed "
                f"tests), reach {bound_ms / ms:.1%}; {live} of "
                f"{args[1].shape[0]} lanes live, {hits} "
                f"{'hits' if kind == 'closest' else 'blocked'}, {count} "
                f"layers re-traced; bit for bit the plain chain")
        first = rows[0]
        stats[(name, kname)] = {
            "max_abs_err": 0.0, "ms": first["ms"],
            "plain_ms": first["plain_ms"],
            "bounce_ms": [x["ms"] for x in rows],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "tests": first["tests"],
            "bounce_bound_ms": [x["bound_ms"] for x in rows],
            "bounce_plain_ms": [x["plain_ms"] for x in rows],
            "reentries": [x["reentries"] for x in rows]}


def torch_equal(a, b):
    import torch
    return bool(torch.equal(a, b))


# ---------------------------------------------------------------------------
# Walk kernels
# ---------------------------------------------------------------------------

def walk_prepare(scene, rays, block_rays):
    """Coherence-sorted rays, the candidate entries and sorted candidates,
    through the kernels."""
    from optixpathtracer_tpu_torch.intersect import walk_kernels as wk
    perm = wk._coherence_perm(scene, rays[0], rays[1])
    srays = tuple(x[perm].contiguous() for x in rays)
    boxes = wk._chunk_boxes(scene)
    entry = wk.candidates_kernel(boxes, *srays, block_rays)
    return srays, boxes, entry, wk.sort_candidates(entry)


def walk_block_rays(srays, cand, count, block_rays, n_sub):
    """A fixed subset of whole ray blocks (about n_sub rays): the rays,
    their ray indices, their candidate rows and the blocks' indices."""
    import torch
    nb = cand.shape[0]
    keep = nb if nb * block_rays <= n_sub else n_sub // block_rays
    gen = torch.Generator(device="cpu").manual_seed(0)
    blocks = torch.randperm(nb, generator=gen)[:keep].sort().values.to(
        cand.device)
    idx = (blocks[:, None] * block_rays + torch.arange(
        block_rays, device=cand.device)).reshape(-1)
    idx = idx[idx < srays[0].shape[0]]
    return (tuple(x[idx].contiguous() for x in srays), idx,
            cand[blocks].contiguous(), count[blocks].contiguous(), blocks)


def walk_bound(card, kind, scene, boxes, cand, tnear, count, srays,
               block_rays):
    """(bound ms, bound_by, work) of a walk sweep of the sorted rays
    `srays`: the operations of the tests these inputs need
    (`walk_kernels.needed_work`, a `NeededWork`: live rays whose own slab
    test passes a candidate chunk, its real triangles, occlusion up to the
    first blocker; `needed_ops`), or the bytes (rays in, answers out, the
    candidate rows, the chunk triangles and boxes)."""
    from optixpathtracer_tpu_torch.intersect import walk_kernels as wk
    work = wk.needed_work(kind, scene.walk_tris, boxes, cand, tnear, count,
                          *srays, block_rays)
    r = srays[0].shape[0]
    nb, maxc_pad = cand.shape
    n_bytes = (r * (40 if kind == "closest" else 36)
               + nb * maxc_pad * (8 if kind == "closest" else 4) + nb * 4
               + scene.walk_tris.numel() * 4 + boxes.numel() * 4)
    return (*card.bound(needed_ops(work), n_bytes), work)


def walk_check(name, label, scene, rays, kind, n_sub=None):
    """Each walk kernel of one query against its plain version: entries
    bit-identical over the whole wavefront, sweep results on whole blocks
    (all of them, or about n_sub rays). Returns the max |dt|."""
    import torch
    from optixpathtracer_tpu_torch.intersect import walk_kernels as wk
    block = wk.BLOCK_RAYS
    srays, boxes, entry, (cand, tnear, count) = walk_prepare(scene, rays,
                                                             block)
    want = wk.candidates_plain(boxes, *srays, block)
    torch.cuda.synchronize()
    if not torch.equal(entry, want):
        n = int((entry != want).sum())
        raise AssertionError(f"{name} walk_candidates {label}: entries "
                             f"differ in {n} slots")
    log(f"  {name} walk_candidates {label}: {entry.shape[0]} blocks x "
        f"{entry.shape[1]} slots identical, mean {float(count.float().mean()):.1f}"
        f" candidates a block")
    tris = scene.walk_tris
    if kind == "closest":
        kt, ki = wk.closest_kernel(tris, boxes, cand, tnear, count, *srays,
                                   block)
        sub, idx, scand, scount, _ = walk_block_rays(
            srays, cand, count, block, n_sub or srays[0].shape[0])
        pt, pi = wk.closest_plain(tris, scand, scount, *sub, block)
        torch.cuda.synchronize()
        return compare_closest((kt[idx], ki[idx]), (pt, pi),
                               f"{name} walk_closest {label}")
    kb = wk.any_kernel(tris, boxes, cand, count, *srays, block)
    sub, idx, scand, scount, _ = walk_block_rays(srays, cand, count, block,
                                                 n_sub or srays[0].shape[0])
    pb = wk.any_plain(tris, scand, scount, *sub, block)
    torch.cuda.synchronize()
    return compare_any(kb[idx], pb, f"{name} walk_any {label}")


def walk_times(scene, rays, kind, block_rays, reps=10, card=None):
    """ms of each step of one walk query: coherence sort, candidates,
    candidate sort, sweep. With `card`, also the sweep's bound from the
    needed work (`walk_bound`), after checking the kernel's per-block
    counts against it: chunks swept equal, closest tests equal, occlusion
    tests within the model's slack."""
    import torch
    from optixpathtracer_tpu_torch.intersect import walk_kernels as wk
    srays, boxes, entry, (cand, tnear, count) = walk_prepare(scene, rays,
                                                             block_rays)
    tris = scene.walk_tris

    def perm():
        p = wk._coherence_perm(scene, rays[0], rays[1])
        return [x[p].contiguous() for x in rays]

    if kind == "closest":
        def sweep():
            return wk.closest_kernel(tris, boxes, cand, tnear, count, *srays,
                                     block_rays)
    else:
        def sweep():
            return wk.any_kernel(tris, boxes, cand, count, *srays,
                                 block_rays)
    out = {"perm": cuda_time_ms(perm, reps),
           "candidates": cuda_time_ms(
               lambda: wk.candidates_kernel(boxes, *srays, block_rays), reps),
           "sort": cuda_time_ms(lambda: wk.sort_candidates(entry), reps),
           "sweep": cuda_time_ms(sweep, reps)}
    sweep()
    kernel = wk.closest_kernel if kind == "closest" else wk.any_kernel
    out["tests"] = int(kernel.tests.sum())
    out["mean_swept"] = float(kernel.swept.float().mean())
    out["total"] = out["perm"] + out["candidates"] + out["sort"] + out["sweep"]
    out["mean_candidates"] = float(count.float().mean())
    out["live"] = int((srays[3] > srays[2]).sum())
    if card is not None:
        got_tests, got_swept = kernel.tests.long(), kernel.swept.long()
        out["bound_ms"], out["bound_by"], work = walk_bound(
            card, kind, scene, boxes, cand, tnear, count, srays, block_rays)
        need, chunks, below, above = (work.tests, work.chunks, work.below,
                                      work.above)
        if not torch.equal(got_swept, chunks):
            raise AssertionError(f"walk_{kind}: the kernel swept "
                                 f"{int(got_swept.sum())} chunks, the inputs "
                                 f"need {int(chunks.sum())}")
        # closest: below = above = 0, so the counts must be equal
        ok = bool(((got_tests >= need - below)
                   & (got_tests <= need + above)).all())
        if not ok:
            raise AssertionError(f"walk_{kind}: the kernel ran "
                                 f"{out['tests']} tests, the inputs need "
                                 f"{int(need.sum())}")
        out["needed_tests"] = int(need.sum())
        out["exits"] = exit_shares(work)
    return out


def walk_phase(name, scene, waves, card, stats, dense_table=False,
               primary_sub=None):
    import torch
    from optixpathtracer_tpu_torch.intersect import dense_kernels as dk
    from optixpathtracer_tpu_torch.intersect import walk_kernels as wk
    closest, shadow = waves
    primary = closest[0]
    r = primary[0].shape[0]
    errs = {"walk_candidates": [0.0], "walk_closest": [], "walk_any": []}
    errs["walk_closest"].append(walk_check(name, "primary", scene, primary,
                                           "closest", primary_sub))
    errs["walk_any"].append(walk_check(name, "primary", scene, primary,
                                       "any", primary_sub))
    for b, w in enumerate(closest[1:], start=1):
        errs["walk_closest"].append(walk_check(name, f"bounce-{b}", scene, w,
                                               "closest", SUBSAMPLE))
    for b, w in enumerate(shadow):
        errs["walk_any"].append(walk_check(name, f"bounce-{b} shadow", scene,
                                           w, "any", SUBSAMPLE))

    block = wk.BLOCK_RAYS
    # every wavefront, each sweep read against the work its rays need; each
    # kernel's row: the wavefront the frame first runs it on
    per = {"closest": [walk_times(scene, w, "closest", block,
                                  20 if b == 0 else 10, card)
                       for b, w in enumerate(closest)],
           "any": [walk_times(scene, w, "any", block, 20 if b == 0 else 10,
                              card) for b, w in enumerate(shadow)]}
    for kind, rows in per.items():
        for b, t in enumerate(rows):
            log(f"  {name} walk {kind} bounce-{b}: perm {t['perm']:.3f} + "
                f"candidates {t['candidates']:.3f} + sort {t['sort']:.3f} + "
                f"sweep {t['sweep']:.3f} = {t['total']:.3f} ms "
                f"({t['mean_candidates']:.1f} candidates, "
                f"{t['mean_swept']:.1f} swept a block)")
            log(f"  {name} walk_{kind} bounce-{b}"
                f"{' shadow' if kind == 'any' else ''}: sweep "
                f"{t['sweep']:.3f} ms, bound {t['bound_ms']:.3f} ms "
                f"({t['bound_by']}; {t['needed_tests']:.4g} needed tests, "
                f"ending at {t['exits']}, {t['tests']:.4g} run, "
                f"{t['live']} live rays), reach "
                f"{t['bound_ms'] / t['sweep']:.1%}")
    prim = {"closest": per["closest"][0], "any": per["any"][0]}

    # plain versions at those wavefronts: one call each
    srays, boxes, entry, (cand, tnear, count) = walk_prepare(scene, primary,
                                                             block)
    s_srays, _, _, (s_cand, _, s_count) = walk_prepare(scene, shadow[0],
                                                       block)
    plain_ms = {
        "walk_candidates": cuda_time_ms(
            lambda: wk.candidates_plain(boxes, *srays, block), 1),
        "walk_closest": cuda_time_ms(
            lambda: wk.closest_plain(scene.walk_tris, cand, count, *srays,
                                     block), 1),
        "walk_any": cuda_time_ms(
            lambda: wk.any_plain(scene.walk_tris, s_cand, s_count, *s_srays,
                                 block), 1)}
    n_chunks = scene.walk_tris.shape[0]
    nb, maxc_pad = cand.shape
    bounds = {
        "walk_candidates": card.bound(
            r * n_chunks * CAND_OPS,
            r * 32 + nb * maxc_pad * 4 + boxes.numel() * 4),
        "walk_closest": (prim["closest"]["bound_ms"],
                         prim["closest"]["bound_by"]),
        "walk_any": (prim["any"]["bound_ms"], prim["any"]["bound_by"])}
    ms = {"walk_candidates": prim["closest"]["candidates"],
          "walk_closest": prim["closest"]["sweep"],
          "walk_any": prim["any"]["sweep"]}
    bounce_ms = {"walk_candidates": [t["candidates"] for t in per["closest"]],
                 "walk_closest": [t["sweep"] for t in per["closest"]],
                 "walk_any": [t["sweep"] for t in per["any"]]}
    bounce_bound = {"walk_candidates": [bounds["walk_candidates"][0]],
                    "walk_closest": [t["bound_ms"] for t in per["closest"]],
                    "walk_any": [t["bound_ms"] for t in per["any"]]}
    for kname in ms:
        bound_ms, bound_by = bounds[kname]
        log(f"  {name} {kname}: kernel {ms[kname]:.3f} ms, plain "
            f"{plain_ms[kname]:.1f} ms, bound {bound_ms:.3f} ms ({bound_by})"
            f" at the {r}-ray "
            f"{'bounce-0 shadow' if kname == 'walk_any' else 'primary'} "
            f"wavefront (block {block})")
        stats[(name, kname)] = {
            "max_abs_err": max(errs[kname]), "ms": ms[kname],
            "plain_ms": plain_ms[kname], "bounce_ms": bounce_ms[kname],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bounce_bound_ms": bounce_bound[kname],
            "walk_total_ms": {k: [t["total"] for t in v]
                              for k, v in per.items()}}

    if dense_table:
        tris, dboxes, n_live = dk.dense_arrays(scene)
        log(f"  {name} dense vs walk per wavefront (ms; walk = perm + "
            f"candidates + sort + sweep, block {block}):")
        rows = []
        for kind, waves_k in (("closest", closest), ("any", shadow)):
            fn = dk.closest_kernel if kind == "closest" else dk.any_kernel
            for b, w in enumerate(waves_k):
                dense_ms = cuda_time_ms(lambda: fn(tris, dboxes, n_live, *w),
                                        10)
                walk = per[kind][b]["total"]
                rows.append({"kind": kind, "bounce": b, "dense_ms": dense_ms,
                             "walk_ms": walk})
                log(f"    {kind} bounce-{b}: dense {dense_ms:.3f}, walk "
                    f"{walk:.3f} ({dense_ms / walk:.2f}x)")
        stats[(name, "dense_vs_walk")] = rows
        log(f"  {name} walk block size (ms, candidates + sweep):")
        blocks = {}
        for b_rays in BLOCK_COMPARE:
            for kind, w in (("closest", closest[0]),
                            ("closest b1", closest[min(1, len(closest) - 1)]),
                            ("any b0", shadow[0])):
                t = walk_times(scene, w, kind.split()[0], b_rays)
                blocks[f"{kind}@{b_rays}"] = t["candidates"] + t["sweep"]
                log(f"    {kind} block {b_rays}: candidates "
                    f"{t['candidates']:.3f} + sweep {t['sweep']:.3f}")
        stats[(name, "block_compare")] = blocks


# ---------------------------------------------------------------------------
# Packet kernels
# ---------------------------------------------------------------------------

def packet_check(name, label, scene, rays, kind):
    """One packet kernel against the plain words and sweep on whole blocks
    (about SUBSAMPLE rays) of one query: words bit-identical, then ids or
    blocked flags. Returns the max |dt|."""
    import torch
    from optixpathtracer_tpu_torch.intersect import packet_kernels as pk
    block = pk.BLOCK_RAYS
    srays, _, _, (cand, tnear, count) = walk_prepare(scene, rays, block)
    kernel = (pk.packet_closest_kernel if kind == "closest" else
              pk.packet_any_kernel)
    got = kernel(scene.walk_tris, scene.walk_sub_box, cand, tnear, count,
                 *srays, block, with_words=True)
    sub, idx, scand, _, blocks = walk_block_rays(srays, cand, count, block,
                                                 SUBSAMPLE)
    stnear = tnear[blocks].contiguous()
    words = pk.packet_words_plain(scene.walk_sub_box, scand, stnear, *sub,
                                  scene.walk_chunk, block)[0]
    torch.cuda.synchronize()
    if not torch.equal(kernel.words[blocks], words):
        n = int((kernel.words[blocks] != words).sum())
        raise AssertionError(f"{name} packet words {label}: {n} words "
                             f"differ")
    bits = sum(int(((words >> b) & 1).sum()) for b in range(32))
    log(f"  {name} packet words {label}: {words.numel()} words identical, "
        f"mean {bits / (words.shape[0] * words.shape[1]):.1f} subchunks a "
        f"packet of {words.shape[2] * 32}")
    what = f"{name} packet_{kind} {label}"
    if kind == "closest":
        pt, pi = pk.packet_closest_plain(scene.walk_tris, scand, words, *sub,
                                         block)
        return compare_closest((got[0][idx], got[1][idx]), (pt, pi), what)
    pb = pk.packet_any_plain(scene.walk_tris, scand, words, *sub, block)
    return compare_any(got[idx], pb, what)


def packet_times(scene, rays, kind, block_rays, reps=10):
    """ms of each step of one packet query (coherence sort, candidates,
    candidate sort, packet sweep) and the sweep's counts."""
    from optixpathtracer_tpu_torch.intersect import packet_kernels as pk
    from optixpathtracer_tpu_torch.intersect import walk_kernels as wk
    srays, boxes, entry, (cand, tnear, count) = walk_prepare(scene, rays,
                                                             block_rays)
    kernel = (pk.packet_closest_kernel if kind == "closest" else
              pk.packet_any_kernel)

    def sweep():
        return kernel(scene.walk_tris, scene.walk_sub_box, cand, tnear,
                      count, *srays, block_rays)

    def perm():
        p = wk._coherence_perm(scene, rays[0], rays[1])
        return [x[p].contiguous() for x in rays]

    out = {"perm": cuda_time_ms(perm, reps),
           "candidates": cuda_time_ms(
               lambda: wk.candidates_kernel(boxes, *srays, block_rays), reps),
           "sort": cuda_time_ms(lambda: wk.sort_candidates(entry), reps),
           "sweep": cuda_time_ms(sweep, reps)}
    sweep()
    tile = pk.smem_plan(scene.walk_chunk, block_rays, cand.shape[1])[0]
    out.update(tests=int(kernel.tests.sum()), slabs=int(kernel.slabs.sum()),
               swept=int(kernel.swept.sum()),
               total=out["perm"] + out["candidates"] + out["sort"]
               + out["sweep"], rays=srays[0].shape[0], blocks=cand.shape[0],
               maxc_pad=cand.shape[1], tile=tile,
               mean_candidates=float(count.float().mean()),
               tiles=sum(len(pk.union_tiles(c, tile))
                         for c in count.tolist()))
    return out


def packet_bound(card, scene, kind, t):
    """(bound ms, bound_by) of one packet sweep from its reported counts:
    tests x MT_OPS + slab tests x SLAB_OPS, or the bytes it must move (rays
    and answers, the candidate rows, the subchunk boxes and triangles)."""
    n_bytes = (t["rays"] * (40 if kind == "closest" else 36)
               + t["blocks"] * t["maxc_pad"] * 8 + t["blocks"] * 4
               + scene.walk_sub_box.numel() * 4
               + scene.walk_tris.numel() * 4)
    return card.bound(t["tests"] * MT_OPS + t["slabs"] * SLAB_OPS, n_bytes)


def ptxas_usage(report):
    """{kernel name: (registers, static shared bytes, spill store bytes)}
    from a ptxas -v report."""
    usage, name, spill = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            usage[name] = (int(m.group(1)), int(m.group(2) or 0), spill)
    return usage


# the sample kernel's instantiations (kCount, kClosed, kLayered) on the
# main path, by the lobes they take
SAMPLE_VARIANTS = {"ILb0ELb1ELb0E": "closed", "ILb0ELb0ELb1E": "layered",
                   "ILb0ELb1ELb1E": "both"}


def kernel_registers(reports):
    """{kernel: (registers, static shared bytes, spill store bytes)} of the
    kernels, from the ptxas reports of the build: the BSDF kernels' main-path
    instantiations, not those that count their work, and the sample
    kernel's three also as `lobes_sample[closed|layered|both]`, the most
    registers of them as `lobes_sample`."""
    usage = {}
    for report in reports.values():
        for mangled, v in ptxas_usage(report).items():
            for kname in KERNEL_SOURCES:
                if f"{kname}_kernel" not in mangled or (
                        kname in BSDF and "ILb1E" in mangled):
                    continue
                variant = [t for k, t in SAMPLE_VARIANTS.items()
                           if kname == "lobes_sample" and k in mangled]
                if variant:
                    usage[f"{kname}[{variant[0]}]"] = v
                    v = max(v, usage.get(kname, v))
                usage[kname] = v
    return usage


def packet_phase(name, scene, waves, card, stats):
    """The packet kernels on every wavefront of the frame: checks, times at
    256- and 1024-ray blocks, the walk-vs-packet table, and the kernels'
    numbers at the bounce-1 wavefront, where `auto` runs them."""
    from optixpathtracer_tpu_torch.intersect import packet_kernels as pk
    closest, shadow = waves
    kinds = {"closest": closest, "any": shadow}
    errs = {"packet_closest": [], "packet_any": []}
    for kind, waves_k in kinds.items():
        for b, w in enumerate(waves_k):
            label = f"bounce-{b}" + (" shadow" if kind == "any" else "")
            errs[f"packet_{kind}"].append(
                packet_check(name, label, scene, w, kind))
    per = {(kind, b_rays): [packet_times(scene, w, kind, b_rays)
                            for w in waves_k]
           for kind, waves_k in kinds.items() for b_rays in BLOCK_COMPARE}
    walk_total = stats[(name, "walk_closest")]["walk_total_ms"]
    rows = []
    log(f"  {name} walk vs packet per wavefront (ms; each = perm + "
        f"candidates + sort + sweep; walk at block {pk.BLOCK_RAYS}):")
    for kind, waves_k in kinds.items():
        for b in range(len(waves_k)):
            p256, p1024 = (per[(kind, br)][b] for br in BLOCK_COMPARE)
            walk = walk_total[kind][b]
            rows.append({"kind": kind, "bounce": b, "walk_ms": walk,
                         "packet_ms": p256["total"],
                         "packet_sweep_ms": p256["sweep"],
                         "packet_1024_ms": p1024["total"],
                         "packet_1024_sweep_ms": p1024["sweep"]})
            log(f"    {kind} bounce-{b}: walk {walk:.3f}, packet "
                f"{p256['total']:.3f} (sweep {p256['sweep']:.3f}; block "
                f"1024: {p1024['total']:.3f}, sweep {p1024['sweep']:.3f}) "
                f"-> walk / packet {walk / p256['total']:.2f}x")
    stats[(name, "walk_vs_packet")] = rows
    usage = ptxas_usage(stats.get("ptxas", {}).get("packet_intersect", ""))
    for kind, waves_k in kinds.items():
        kname = f"packet_{kind}"
        regs = [v for k, v in usage.items() if kname in k]
        t0 = per[(kind, pk.BLOCK_RAYS)][0]
        n_bytes = pk.smem_plan(scene.walk_chunk, pk.BLOCK_RAYS,
                               t0["maxc_pad"])[1]
        ctas, threads = pk.grid(t0["rays"], pk.BLOCK_RAYS)
        log(f"  {name} {kname}: "
            + (f"{regs[0][0]} registers, {regs[0][1]} bytes static"
               if regs else "no ptxas report")
            + f" + {n_bytes} bytes dynamic shared memory a {threads}-thread "
            f"block, {ctas} blocks (union tile {t0['tile']} ranks)")
        for b, t in enumerate(per[(kind, pk.BLOCK_RAYS)]):
            bound_ms, bound_by = packet_bound(card, scene, kind, t)
            packets = -(-t["rays"] // pk.PACKET)
            log(f"    bounce-{b}: {t['swept'] / packets:.2f} subchunks swept"
                f" a packet, {t['tests']:.4g} triangle tests, "
                f"{t['slabs']:.4g} slab tests; kernel {t['sweep']:.3f} ms, "
                f"bound {bound_ms:.3f} ms ({bound_by}), reach "
                f"{bound_ms / t['sweep']:.1%}; {t['mean_candidates']:.1f} "
                f"candidates a block, {t['tiles']} union tiles staged for "
                f"{t['blocks']} blocks")
    for kind in kinds:
        kname = f"packet_{kind}"
        t = per[(kind, pk.BLOCK_RAYS)][-1]  # the bounce-1 wavefront
        srays, _, _, (cand, tnear, count) = walk_prepare(
            scene, kinds[kind][-1], pk.BLOCK_RAYS)
        sweep = (pk.packet_closest_plain if kind == "closest" else
                 pk.packet_any_plain)
        plain_ms, _ = cuda_time_once(lambda: pk.plain_launch(
            sweep, scene.walk_tris, scene.walk_sub_box, cand, tnear, count,
            *srays, pk.BLOCK_RAYS))
        r = srays[0].shape[0]
        bound_ms, bound_by = packet_bound(card, scene, kind, t)
        log(f"  {name} {kname}: kernel {t['sweep']:.3f} ms, plain "
            f"{plain_ms:.1f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
            f"{t['tests']:.4g} triangle tests, {t['slabs']:.4g} slab tests,"
            f" {t['swept']} subchunks swept) at the {r}-ray bounce-1 "
            f"wavefront (block {pk.BLOCK_RAYS})")
        stats[(name, kname)] = {
            "max_abs_err": max(errs[kname]), "ms": t["sweep"],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bounce_ms": [x["sweep"] for x in per[(kind, pk.BLOCK_RAYS)]],
            "tests": t["tests"], "slabs": t["slabs"]}


def chunk256_phase(model, lights, camera, dev, stats):
    from optixpathtracer_tpu_torch.scene import flatten as flatten_mod
    saved = flatten_mod.MAX_WALK_CHUNKS
    flatten_mod.MAX_WALK_CHUNKS = WALK_CHUNKS_256
    try:
        scene = flatten_mod.flatten_model(model, lights, device=dev)
    finally:
        flatten_mod.MAX_WALK_CHUNKS = saved
    assert scene.walk_chunk == 256, scene.walk_chunk
    log(f"diffuse at chunk {scene.walk_chunk}: {scene.walk_tris.shape[0]} "
        f"chunks")
    closest, _, _ = frame_waves(scene, camera, 1, dev)
    err = walk_check("diffuse@256", "primary", scene, closest[0], "closest")
    walk_check("diffuse@256", "primary", scene, closest[0], "any")
    stats["chunk256_err"] = err


# ---------------------------------------------------------------------------
# The BSDF dispatch's kernels
# ---------------------------------------------------------------------------

def dispatch_calls(scene, camera, bounces, dev):
    """Every call of the BSDF dispatch's kernel path in one real 1080p
    trace_paths frame of the scene ("auto" routing), in call order:
    [(kind, args)], args being (seed, mat, wo, wi, lobes) for "f" and
    (seed, mat, wo, lobes) for "sample"."""
    import torch
    from optixpathtracer_tpu_torch.bsdf import dispatch
    from optixpathtracer_tpu_torch.camera.camera import generate_rays
    from optixpathtracer_tpu_torch.core import rng
    from optixpathtracer_tpu_torch.integrate import path
    calls, saved = [], (dispatch.f_kernel, dispatch.sample_kernel)

    def recorded(kind, fn):
        def run(*args):
            calls.append((kind, args))
            return fn(*args)
        return run

    o, d = generate_rays(*camera.raygen_params(WIDTH, HEIGHT, dev), WIDTH,
                         HEIGHT)
    ys, xs = torch.meshgrid(torch.arange(HEIGHT, device=dev),
                            torch.arange(WIDTH, device=dev), indexing="ij")
    seed = rng.pixel_seed(WIDTH, xs.reshape(-1), ys.reshape(-1), 0)
    dispatch.f_kernel = recorded("f", saved[0])
    dispatch.sample_kernel = recorded("sample", saved[1])
    try:
        with torch.no_grad():
            path.trace_paths(scene, o.reshape(-1, 3).contiguous(),
                             d.reshape(-1, 3).contiguous(), seed, bounces,
                             "auto", **scene_flags(scene))
    finally:
        dispatch.f_kernel, dispatch.sample_kernel = saved
    assert [c[0] for c in calls] == ["f", "sample"] * bounces
    return calls


def _lobe_outputs(out):
    """The tensors of a dispatch call's (seed, rgb) or (seed, BSDFSample)."""
    seed, rest = out
    return [seed] + (list(rest) if isinstance(rest, tuple) else [rest])


def _bits(x):
    """x's bits: a float32 tensor viewed as int32, others as they are."""
    import torch
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def bsdf_bound(card, ops, n_bytes):
    """(bound ms, what bounds it) of one BSDF kernel call from the work it
    counted (FP32 operations, float64 calls): FP32 operations at the FP32
    rate, float64 calls x FP64_CALL_OPS at the FP64 rate, or bytes at
    3.35 TB/s, whichever is largest."""
    fp32, fp64 = (int(v) for v in ops.tolist())
    times = {"fp32 operations": fp32 / card.fp32_per_s * 1e3,
             "fp64 calls": fp64 * FP64_CALL_OPS / (
                 SMS * FP64_LANES * card.max_sm_mhz * 1e6) * 1e3,
             "bytes": n_bytes / HBM_BYTES_PER_S * 1e3}
    by = max(times, key=times.get)
    return times[by], by, fp32, fp64


def bsdf_bytes(kname, own, closed, lanes):
    """The bytes a call of the kernel reads and writes, from its lanes:
    `own` those of the layered type where the layered lobe is asked for,
    `closed` those of an asked-for closed-form lobe. layered_f reads a
    lane's type, and an own lane's seed, albedo, roughness, wo, wi and eta
    and writes its rgb (68 bytes); lobes_f reads the type, and an asked-for
    closed-form lane's inputs (60 bytes with its rgb), and writes zeros on
    the others not its own (16); lobes_sample reads seed, type, albedo,
    roughness, wo and eta and writes seed, color, direction, pdf and five
    flags on every lane (85)."""
    if kname == "layered_f":
        return own * 68 + (lanes - own) * 4
    if kname == "lobes_f":
        return closed * 60 + (lanes - own - closed) * 16 + own * 4
    return lanes * 85


def type_shares(mat_type):
    """{lobe name: share of the lanes of that resolved type}."""
    import torch
    from optixpathtracer_tpu_torch.bsdf import dispatch
    counts = torch.bincount(mat_type.long().clamp(0, 4), minlength=5)
    names = {v: k for k, v in dispatch.MATERIAL_NAMES.items()}
    return {names[t]: round(float(c) / mat_type.numel(), 4)
            for t, c in enumerate(counts.tolist())}


def bsdf_phase(name, scene, camera, bounces, dev, card, stats):
    """The dispatch's kernels at every call of one real 1080p frame: the
    lanes' shares by resolved type; each call through the kernels against
    the plain dispatch bit for bit (the kernels' counting instantiations
    too); each kernel timed alone with CUDA events, the whole kernel path
    and the plain dispatch too, and bounded from the work it counted and
    the bytes its lanes need."""
    import torch
    from optixpathtracer_tpu_torch.bsdf import dispatch
    from optixpathtracer_tpu_torch.bsdf import kernels as bk
    paths = {"f": dispatch.f_kernel, "sample": dispatch.sample_kernel}
    plains = {"f": dispatch.f_plain, "sample": dispatch.sample_plain}
    rows = {}
    with torch.no_grad():
        for i, (kind, args) in enumerate(dispatch_calls(scene, camera,
                                                        bounces, dev)):
            bounce = i // 2
            seed, mat, wo, lobes = args[0], args[1], args[2], args[-1]
            wi = args[3] if kind == "f" else None
            lanes = wo.shape[0]
            layered = dispatch.GLOSSY_DIFFUSE in lobes
            closed_lobes = [t for t in lobes if t != dispatch.GLOSSY_DIFFUSE]
            own = int((mat.mat_type == dispatch.GLOSSY_DIFFUSE).sum()) \
                if layered else 0
            closed = int(torch.isin(mat.mat_type, torch.tensor(
                closed_lobes or [-1], device=dev, dtype=torch.int32)).sum())
            ops = torch.zeros(2, dtype=torch.int64, device=dev)
            got = _lobe_outputs(paths[kind](*args))
            counted = _lobe_outputs(paths[kind](*args, ops=ops))
            with plain_kernels():
                want = _lobe_outputs(plains[kind](*args))
            torch.cuda.synchronize()
            for a, c, b in zip(got, counted, want):
                if not (torch.equal(_bits(a), _bits(b))
                        and torch.equal(_bits(c), _bits(b))):
                    raise AssertionError(f"{name} bsdf {kind} bounce "
                                         f"{bounce}: kernels != plain")
            if kind == "f":
                shares = type_shares(mat.mat_type)
                log(f"  {name} bounce {bounce}: {lanes} lanes by resolved "
                    f"type {shares}")
                stats.setdefault((name, "type_shares"), []).append(shares)
            path_ms = cuda_time_ms(lambda: paths[kind](*args), 10)
            with plain_kernels():
                plain_ms = cuda_time_ms(lambda: plains[kind](*args), 2)
            out = torch.empty(wo.shape, dtype=torch.float32, device=dev)
            mask = dispatch.lobe_mask(lobes)
            launches = {
                "layered_f": lambda o=None: bk.layered_f(
                    seed, mat.mat_type, mat.albedo, mat.roughness, wo, wi,
                    mat.ior, out, others=not closed_lobes, ops=o),
                "lobes_f": lambda o=None: bk.lobes_f(
                    mat.mat_type, mat.albedo, mat.roughness, wo, wi,
                    mat.ior, mask, out, o),
                "lobes_sample": lambda o=None: dispatch.sample_kernel(
                    seed, mat, wo, lobes, o)}
            knames = (["lobes_sample"] if kind == "sample" else
                      ["layered_f"] * layered
                      + ["lobes_f"] * (bool(closed_lobes) or not layered))
            for kname in knames:
                k_ops = torch.zeros(2, dtype=torch.int64, device=dev)
                launches[kname](k_ops)
                ms = cuda_time_ms(launches[kname], 10)
                bound_ms, by, fp32, fp64 = bsdf_bound(
                    card, k_ops, bsdf_bytes(kname, own, closed, lanes))
                rows.setdefault(kname, []).append({
                    "bounce": bounce, "lanes": lanes, "ms": ms,
                    "path_ms": path_ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by, "fp32_ops": fp32,
                    "fp64_calls": fp64})
                log(f"  {name} {kname} bounce {bounce}: {lanes} lanes "
                    f"({own} layered, {closed} closed-form asked for); "
                    f"kernel {ms:.3f} ms (the {kind} call's kernels "
                    f"{path_ms:.3f} ms, bit for bit the plain dispatch's "
                    f"{plain_ms:.1f} ms); {fp32 / lanes:.0f} FP32 operations "
                    f"and {fp64 / lanes:.1f} float64 calls a lane; bound "
                    f"{bound_ms:.3f} ms ({by}), reach {bound_ms / ms:.1%}")
    for kname, krows in rows.items():
        first = krows[0]
        stats[(name, kname)] = {
            "max_abs_err": 0.0, "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "bounce_ms": [r["ms"] for r in krows],
            "bounce_bound_ms": [r["bound_ms"] for r in krows],
            "bounces": krows}


# ---------------------------------------------------------------------------
# Path phase and images
# ---------------------------------------------------------------------------

def path_phase(name, scene, camera, spp, bounces, dev, stats, card):
    import numpy as np
    import torch
    from optixpathtracer_tpu_torch.integrate import path
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    img = path.render(scene, camera, WIDTH, HEIGHT, spp=spp,
                      max_bounces=bounces, intersect_method="auto")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    img = img.cpu().numpy()
    if img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(img).all() \
            or (img < 0).any() or img.mean() <= 0:
        raise AssertionError(f"{name}: bad image")
    for kname in CELL_KERNELS[name]:
        if launches[kname] == 0:
            raise AssertionError(f"{name}: {kname} was never launched")
        stats[(name, kname)]["launches"] = launches[kname]
    mrays = WIDTH * HEIGHT * spp * bounces * 2 / seconds / 1e6
    log(f"  {name} render {WIDTH}x{HEIGHT} {spp} spp {bounces} bounces: "
        f"{seconds:.3f} s, {mrays:.2f} Mrays/s on {card.name_power}; "
        f"launches {launches} ({spp} frames); mean {img.mean():.5f}")
    stats[(name, "render")] = {"seconds": seconds, "mrays_per_s": mrays}


def device_profile(fn):
    """torch.profiler (device activity only) over one call of fn: {"wall":
    ms, "device": busy ms, "ours": {kernel: ms}, "launches": kernel
    launches}, or None where the profiler saw no device time. The raw
    trace events are summed: key_averages() takes ~60 us an event, tens of
    seconds for a 200k-launch frame."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device_us, ours_us, launches = 0.0, {}, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        dev_us = ev.duration_ns() / 1e3
        if dev_us <= 0:
            continue
        device_us += dev_us
        launches += 1
        name = ev.name()
        for tag in KERNEL_SOURCES:
            if tag in name:
                ours_us[tag] = ours_us.get(tag, 0.0) + dev_us
    if device_us == 0:
        return None
    return {"wall": wall, "device": device_us / 1e3, "launches": launches,
            "ours": {k: round(v / 1e3, 3) for k, v in ours_us.items()}}


def profile_frame(name, scene, camera, bounces, dev):
    """torch.profiler over one 1-spp 1080p frame: wall ms, device busy ms,
    the walk and dense kernels' ms and the number of kernel launches."""
    from optixpathtracer_tpu_torch.integrate import path
    path.render(scene, camera, WIDTH, HEIGHT, spp=1, max_bounces=bounces)
    p = device_profile(lambda: path.render(scene, camera, WIDTH, HEIGHT,
                                           spp=1, max_bounces=bounces))
    if p is None:
        log(f"  {name} profile: the profiler saw no device time")
        return
    log(f"  {name} profile, one 1-spp frame: wall {p['wall']:.1f} ms, device "
        f"busy {p['device']:.1f} ms ({p['device'] / p['wall']:.0%}), "
        f"intersection kernels {p['ours']} ms, other "
        f"{p['device'] - sum(p['ours'].values()):.1f} ms, "
        f"{p['launches']} kernel launches")


def render_close(img, want):
    import numpy as np
    close = np.isclose(img, want, atol=1e-5, rtol=1e-4).all(axis=-1)
    return float(close.mean()), float(abs(img.mean() / want.mean() - 1.0))


def assert_render_match(img, want, what, gate=True):
    frac, mean_rel = render_close(img, want)
    log(f"  {what}: {frac:.5f} of pixels match, mean rel diff "
        f"{mean_rel:.2e}")
    if gate and not (frac > 0.995 and mean_rel <= 1e-3):
        raise AssertionError(f"{what}: images disagree")


def images_phase(scenes, dev):
    from optixpathtracer_tpu_torch.integrate import path
    for name in IMAGE_SCENES:
        scene, camera, _, bounces = scenes[name]
        small = path.render(scene, camera, SMALL, SMALL, spp=2,
                            max_bounces=bounces)
        with plain_kernels():
            plain = path.render(scene, camera, SMALL, SMALL, spp=2,
                                max_bounces=bounces)
        assert_render_match(small.cpu().numpy(), plain.cpu().numpy(),
                            f"{name} {SMALL}x{SMALL} 2 spp kernels vs plain")


@contextlib.contextmanager
def recorded_stages(path, records):
    """Record, in the order a frame makes them, every stage of one render:
    camera rays, closest hits, surfaces, shadow queries, NEE, BSDF samples
    and the throughput after each bounce."""
    saved = (path.generate_rays, path.intersect_closest, path.make_surface,
             path.intersect_any, path._nee, path.dispatch.sample,
             path._shade_wave, path.intersect_closest_cutout,
             path.intersect_any_cutout)

    def rec(stage, **tensors):
        records.append((stage, tensors))

    def generate_rays(*a):
        o, d = saved[0](*a)
        rec("camera rays", o=o, d=d)
        return o, d

    def recording_closest(query):
        def closest(*a, **k):
            hit = query(*a, **k)
            rec("closest hits", t=hit.t, tri_id=hit.tri_id, u=hit.u, v=hit.v)
            return hit
        return closest

    def surface(*a, **k):
        seed, s = saved[2](*a, **k)
        rec("surfaces", position=s.position, s_normal=s.s_normal,
            wo_local=s.wo_local)
        return seed, s

    def recording_any(query):
        def any_hit(*a, **k):
            blocked = query(*a, **k)
            rec("shadow rays", o=a[1], d=a[2], blocked=blocked)
            return blocked
        return any_hit

    def nee(*a, **k):
        seed, contrib = saved[4](*a, **k)
        rec("NEE", contrib=contrib)
        return seed, contrib

    def sample(*a, **k):
        seed, bs = saved[5](*a, **k)
        rec("BSDF samples", direction=bs.direction, pdf=bs.pdf,
            color=bs.color)
        return seed, bs

    def shade(*a, **k):
        out = saved[6](*a, **k)
        rec("throughput", beta=out[2], radiance=out[1])
        return out

    (path.generate_rays, path.intersect_closest, path.make_surface,
     path.intersect_any, path._nee, path.dispatch.sample, path._shade_wave,
     path.intersect_closest_cutout, path.intersect_any_cutout) = (
        generate_rays, recording_closest(saved[1]), surface,
        recording_any(saved[3]), nee, sample, shade,
        recording_closest(saved[7]), recording_any(saved[8]))
    try:
        yield
    finally:
        (path.generate_rays, path.intersect_closest, path.make_surface,
         path.intersect_any, path._nee, path.dispatch.sample,
         path._shade_wave, path.intersect_closest_cutout,
         path.intersect_any_cutout) = saved


def _ulps(a, b):
    """Max distance in float32 units in the last place."""
    import torch
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def stage_trace(name, scene, camera, size, bounces, method):
    """Render one 1-spp frame on the GPU and on the CPU, recording every
    stage, and print the first stage that differs and by how much."""
    import torch
    from optixpathtracer_tpu_torch.integrate import path
    runs = []
    for dev_scene in (scene, scene.to("cpu")):
        records = []
        params = camera.raygen_params(size, size, dev_scene.device)
        with recorded_stages(path, records):
            path.render_sample(
                dev_scene, *params, size, size, 0, max_bounces=bounces,
                intersect_method=method, **scene_flags(dev_scene))
        runs.append(records)
    gpu, cpu = runs
    assert [s for s, _ in gpu] == [s for s, _ in cpu]
    first = None
    bounce = -1
    for (stage, g), (_, c) in zip(gpu, cpu):
        bounce += stage == "closest hits"
        for k, gv in g.items():
            gv, cv = gv.cpu(), c[k]
            if torch.equal(gv, cv):
                continue
            n = int((gv != cv).sum())
            if gv.is_floating_point():
                size_txt = (f"max |diff| {float((gv - cv).abs().max()):.3g}, "
                            f"max {_ulps(gv, cv)} ulp")
            else:
                size_txt = "values differ"
            where = "before the first bounce" if bounce < 0 else \
                f"bounce {bounce}"
            log(f"  {name} GPU vs CPU: {stage}.{k} ({where}) differs in {n} "
                f"of {gv.numel()} values, {size_txt}")
            if first is None:
                first = (stage, k, bounce, n, size_txt)
    if first is None:
        log(f"  {name} GPU vs CPU: every stage identical")
    else:
        log(f"  {name} GPU vs CPU: first difference at {first[0]}."
            f"{first[1]} (bounce {max(first[2], 0)}), in {first[3]} values, "
            f"{first[4]}")
    return first


def gpu_vs_cpu_phase(scenes, dev):
    from optixpathtracer_tpu_torch.integrate import path
    from optixpathtracer_tpu_torch.scene import flatten_model
    from optixpathtracer_tpu_torch.scene.procedural import PRESETS
    scene, camera, _, _ = scenes["scene3_cornell"]
    gpu = path.render(scene, camera, 48, 48, spp=2, max_bounces=2)
    cpu = path.render(scene.to("cpu"), camera, 48, 48, spp=2, max_bounces=2)
    assert_render_match(gpu.cpu().numpy(), cpu.numpy(),
                        "scene3_cornell 48x48 2 spp GPU vs CPU")
    stage_trace("scene3_cornell", scene, camera, 48, 2, "auto")
    # textures and cutout; the packet kernels against the plain versions
    # the CPU tests hold to the JAX package
    model, camera, lights = PRESETS["hall_small"]()
    scene = flatten_model(model, lights, device=dev)
    gpu = path.render(scene, camera, 48, 48, spp=2, max_bounces=2,
                      intersect_method="packet")
    cpu = path.render(scene.to("cpu"), camera, 48, 48, spp=2,
                      max_bounces=2, intersect_method="packet")
    assert_render_match(gpu.cpu().numpy(), cpu.numpy(),
                        "hall_small 48x48 2 spp GPU vs CPU (packet)")
    stage_trace("hall_small", scene, camera, 48, 2, "packet")
    scene, camera, _, _ = scenes["layered"]
    gpu = path.render(scene, camera, 48, 48, spp=2, max_bounces=2,
                      intersect_method="walk")
    cpu = path.render(scene.to("cpu"), camera, 48, 48, spp=2,
                      max_bounces=2, intersect_method="walk")
    assert_render_match(gpu.cpu().numpy(), cpu.numpy(),
                        "layered 48x48 2 spp GPU vs CPU (not gated)",
                        gate=False)
    stage_trace("layered", scene, camera, 48, 2, "walk")


# ---------------------------------------------------------------------------
# Options phase (the trace_paths options) and backward phase
# ---------------------------------------------------------------------------

SORTS = ({"sort_rays": True}, {"sort_rays": "morton"})
GRAD_FIELDS = ("mat_albedo", "mat_metallic", "mat_roughness", "mat_ior")
GRAD_SIZE, GRAD_FRAMES, GRAD_BOUNCES = 256, (0, 1, 2, 3), 2


@contextlib.contextmanager
def counted(what, kernels):
    """Zero every launch counter just before the block and read them just
    after; fail if one of `kernels` never launched. Yields the dict the
    counts are written into."""
    import torch
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    counts = {}
    yield counts
    torch.cuda.synchronize()
    counts.update({k: w.launches for k, w in wrappers.items()})
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched")


def frame_runs(what, scene, camera, bounces, kernels, **options):
    """One 1-spp 1080p frame through render_sample ("auto"), twice: a
    profiled run (also the warm-up), then a timed run with the launch
    counters. Returns (image, {"wall_ms", "launches", "profile",
    "seconds"})."""
    import torch
    from optixpathtracer_tpu_torch.integrate import path
    t_start = time.perf_counter()
    params = camera.raygen_params(WIDTH, HEIGHT, scene.device)
    flags = scene_flags(scene)

    def frame():
        return path.render_sample(scene, *params, WIDTH, HEIGHT, 0,
                                  bounces, "auto", **flags, **options)

    profile = device_profile(frame)
    with counted(what, kernels) as launches:
        t0 = time.perf_counter()
        img = frame()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return img, {"wall_ms": wall, "launches": launches, "profile": profile,
                 "seconds": time.perf_counter() - t_start}


def run_line(what, run):
    p = run["profile"] or {}
    busy = p.get("device", float("nan"))
    log(f"  {what}: wall {run['wall_ms']:.1f} ms, device busy "
        f"{busy:.1f} ms of a profiled {p.get('wall', float('nan')):.1f} ms "
        f"(idle {1 - busy / p.get('wall', float('nan')):.0%}), "
        f"{p.get('launches')} kernel launches; ours "
        f"{ {k: v for k, v in run['launches'].items() if v} } "
        f"({run['seconds']:.1f} s with the profile)")


def options_phase(scenes, dev, stats):
    import torch
    out = {"sorts": {}}
    for name, bounces in (("diffuse", 3), ("hall", 2)):
        scene, camera, _, _ = scenes[name]
        unsorted, run = frame_runs(f"{name} unsorted", scene, camera,
                                   bounces, CELL_KERNELS[name])
        if not torch.isfinite(unsorted).all() or unsorted.mean() <= 0:
            raise AssertionError(f"{name} unsorted: bad image")
        run_line(f"{name} 1 spp unsorted", run)
        out["sorts"][f"{name} unsorted"] = run
        for opt in SORTS:
            what = f"{name} {opt}"
            img, run = frame_runs(what, scene, camera, bounces,
                                  CELL_KERNELS[name], **opt)
            diff = float((img - unsorted).abs().max())
            same = bool(torch.equal(img, unsorted))
            run_line(f"{name} 1 spp {opt}", run)
            log("    image bit for bit the unsorted one" if same else
                f"    image differs from the unsorted one: max |diff| "
                f"{diff:.3g}")
            if not same:
                assert_render_match(img.cpu().numpy(),
                                    unsorted.cpu().numpy(),
                                    f"{what} vs unsorted")
            out["sorts"][what] = dict(run, bit_identical=same,
                                      max_abs_diff=diff)
    stats["options"] = out


def grads_of(loss_fn, params):
    """{field: gradient} of loss_fn(params) for fresh leaves (zeros for a
    field the loss does not depend on, as param_gradients gives)."""
    import torch
    leaves = {f: p.detach().clone().requires_grad_(True)
              for f, p in params.items()}
    grads = torch.autograd.grad(loss_fn(leaves), list(leaves.values()),
                                allow_unused=True)
    return {f: torch.zeros_like(p) if g is None else g
            for (f, p), g in zip(leaves.items(), grads)}


def assert_grads_equal(got, want, what):
    import torch
    for f in GRAD_FIELDS:
        if not torch.isfinite(got[f]).all():
            raise AssertionError(f"{what}: {f} gradient not finite")
        if not torch.equal(got[f], want[f]):
            n = int((got[f] != want[f]).sum())
            raise AssertionError(f"{what}: {f} gradients differ in {n} "
                                 f"entries")
    log(f"  {what}: gradients bit for bit, max |g| "
        f"{ {f: float(got[f].abs().max()) for f in GRAD_FIELDS} }")


def backward_phase(scenes, dev, card, stats):
    import torch
    from optixpathtracer_tpu_torch.diff import param_gradients, render_loss_fn
    from optixpathtracer_tpu_torch.integrate import path
    from optixpathtracer_tpu_torch.scene import flatten_model
    from optixpathtracer_tpu_torch.scene.procedural import PRESETS
    scene, camera, _, _ = scenes["layered"]
    size, frames, bounces = GRAD_SIZE, list(GRAD_FRAMES), GRAD_BOUNCES
    cam = camera.raygen_params(size, size, dev)
    kw = dict(fields=GRAD_FIELDS, max_bounces=bounces, intersect_method="auto")
    # warm-up: one frame's fwd+bwd, profiled for the device's busy share
    prof = device_profile(lambda: param_gradients(scene, cam, size, size,
                                                  frames[:1], **kw))
    if prof is not None:
        log(f"  layered {size}x{size} one frame fwd+bwd, profiled: wall "
            f"{prof['wall']:.1f} ms, device busy {prof['device']:.1f} ms "
            f"({prof['device'] / prof['wall']:.0%}), {prof['launches']} "
            f"kernel launches, ours {prof['ours']}")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with counted("layered backward", WALK) as launches:
        t0 = time.perf_counter()
        got = param_gradients(scene, cam, size, size, frames, **kw)
        torch.cuda.synchronize()
        fwd_bwd_s = time.perf_counter() - t0
    max_allocated = torch.cuda.max_memory_allocated()
    peak = max_allocated - base
    with plain_kernels():
        want = param_gradients(scene, cam, size, size, frames, **kw)
    assert_grads_equal(got, want, f"layered {size}x{size} frames {frames} "
                       f"kernels vs plain")
    loss_fn = render_loss_fn(scene, cam, size, size, frames,
                             max_bounces=bounces, intersect_method="auto")
    params = {f: getattr(scene, f) for f in GRAD_FIELDS}
    with torch.no_grad():
        loss_fn(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_fn(params)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    rays = size * size * len(frames) * bounces * 2
    lanes = size * size * len(frames)
    out = {"fwd_bwd_s": fwd_bwd_s, "fwd_s": fwd_s,
           "fwd_bwd_mrays_per_s": rays / fwd_bwd_s / 1e6,
           "fwd_mrays_per_s": rays / fwd_s / 1e6,
           "max_memory_allocated": max_allocated, "peak_bytes": peak,
           "bytes_per_lane": peak / lanes,
           "launches": launches, "profile_one_frame": prof}
    log(f"  layered {size}x{size} {len(frames)} frames {bounces} bounces: "
        f"fwd+bwd {fwd_bwd_s:.3f} s = {out['fwd_bwd_mrays_per_s']:.3f} "
        f"Mrays/s, forward {fwd_s:.3f} s = {out['fwd_mrays_per_s']:.3f} "
        f"Mrays/s on {card.name_power}; max_memory_allocated "
        f"{max_allocated / 2**30:.3f} GiB, {peak / 2**30:.3f} GiB above "
        f"the scene, {peak / lanes:.0f} bytes a lane ({lanes} lanes); "
        f"launches {launches}")
    # textures, cutout chains; the dense, walk and packet kernels
    model, camera, lights = PRESETS["hall_small"]()
    small = flatten_model(model, lights, device=dev)
    pos, iv, ip = camera.raygen_params(48, 48, dev)
    params = {f: getattr(small, f) for f in GRAD_FIELDS}
    for method, kernels in (("auto", WALK + ("cutout_closest",
                                              "cutout_any")),
                            ("packet", ("walk_candidates", "packet_closest",
                                        "packet_any"))):
        def loss_fn(p, method=method):
            s = dataclasses.replace(small, **p)
            return path.render_sample(s, pos, iv, ip, 48, 48, 0, 2, method,
                                      **scene_flags(small)).mean()

        with counted(f"hall_small backward ({method})", kernels) as n:
            got = grads_of(loss_fn, params)
        with plain_kernels():
            want = grads_of(loss_fn, params)
        assert_grads_equal(got, want, f"hall_small 48x48 ({method}, cutout) "
                           f"kernels vs plain")
        out[f"hall_small {method} launches"] = n
    stats["backward"] = out


# ---------------------------------------------------------------------------
# Front-end phase: the CLI and render_config, dist, preview and replay
# ---------------------------------------------------------------------------

CONFIG5 = "scenes/config5_full.json"  # run as shipped: 56-71 s on an H100
ROW_BLOCKS = 4           # dist: the frame recomputed as 4 row blocks
HALL_KERNELS = CELL_KERNELS["hall"]
PREVIEW_SECONDS = 5.0
REPLAY_SIZE = 64
GRAD_STEP_RTOL = 1e-6


class Tee:
    """Standard output that is also kept, to read the CLI's lines; the
    heartbeat lines are kept but not echoed."""

    def __init__(self, out):
        self.out, self.lines, self.pending = out, [], ""

    def write(self, s):
        self.lines.append(s)
        self.pending += s
        while "\n" in self.pending:
            line, self.pending = self.pending.split("\n", 1)
            if not line.startswith("at Sample:"):
                self.out.write(line + "\n")
        return len(s)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.lines)


@contextlib.contextmanager
def front_end_records():
    """Wrap render.py's scene load, checkpoint and output writes with
    timers, and keep what render_config returns: yields {"load_s",
    "checkpoint_s", "output_s", "checkpoints", "images"}."""
    from optixpathtracer_tpu_torch import render
    rec = {"load_s": 0.0, "checkpoint_s": 0.0, "output_s": 0.0,
           "checkpoints": 0, "images": []}
    names = ("load_scene", "save_checkpoint", "write_exr", "write_png",
             "write_bmp", "render_config")
    saved = {n: getattr(render, n) for n in names}

    def timed(name, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = saved[name](*a, **k)
            rec[key] += time.perf_counter() - t0
            if name == "save_checkpoint":
                rec["checkpoints"] += 1
            return out
        return run

    render.load_scene = timed("load_scene", "load_s")
    render.save_checkpoint = timed("save_checkpoint", "checkpoint_s")
    for n in ("write_exr", "write_png", "write_bmp"):
        setattr(render, n, timed(n, "output_s"))

    def render_config(*a, **k):
        img = saved["render_config"](*a, **k)
        rec["images"].append(img)
        return img

    render.render_config = render_config
    try:
        yield rec
    finally:
        for n, f in saved.items():
            setattr(render, n, f)


def run_cli(what, argv, kernels):
    """cli.main(argv) with the launch counters zeroed just before and read
    just after, its output kept: (wall s, launches, records, stdout)."""
    import torch
    from optixpathtracer_tpu_torch import cli
    tee = Tee(sys.stdout)
    with counted(what, kernels) as launches, front_end_records() as rec, \
            contextlib.redirect_stdout(tee):
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{what}: the CLI returned {rc}")
    log(f"  {what}: {wall:.3f} s wall (scene load {rec['load_s']:.3f} s, "
        f"{rec['checkpoints']} checkpoints {rec['checkpoint_s']:.3f} s, "
        f"outputs {rec['output_s']:.3f} s); launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return wall, launches, rec, tee.text()


def check_outputs(img, exr, png, bmp, what):
    """The EXR read back is the image bit for bit; the PNG and BMP decode
    to its display transform."""
    import numpy as np
    from PIL import Image
    from optixpathtracer_tpu_torch.film import read_exr, to_display
    want = to_display(img)
    if not np.array_equal(read_exr(exr), img):
        raise AssertionError(f"{what}: the EXR is not the image")
    if not np.array_equal(np.asarray(Image.open(png).convert("RGB"))[::-1],
                          want):
        raise AssertionError(f"{what}: the PNG is not to_display(image)")
    if not np.array_equal(np.asarray(Image.open(bmp))[::-1], want):
        raise AssertionError(f"{what}: the BMP is not to_display(image)")


def config5_frame(cfg, dev):
    """One 1-spp frame of the config5 path (the CLI's scene, size, bounces
    and engine) through the kernels, its launches counted, then through
    the plain versions on the same inputs: bit for bit, so the walk
    kernels hold at this path's 1M-ray wavefronts, the conductor's
    specular bounces included. Returns (launches, kernel s, plain s)."""
    import torch
    from optixpathtracer_tpu_torch.integrate import path
    from optixpathtracer_tpu_torch.render import load_scene
    scene, camera = load_scene(cfg, dev)
    args = (scene, *camera.raygen_params(cfg.width, cfg.height, dev),
            cfg.width, cfg.height, 0, cfg.max_bounces, cfg.intersect,
            cfg.reference_compat)
    flags = scene_flags(scene)
    times = []
    with counted("config5 1-spp frame", WALK) as launches:
        t0 = time.perf_counter()
        frame = path.render_sample(*args, **flags)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    with plain_kernels():
        t0 = time.perf_counter()
        plain = path.render_sample(*args, **flags)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not torch.equal(frame, plain):
        n = int((frame != plain).any(dim=-1).sum())
        raise AssertionError(f"config5: the kernels' frame differs from the "
                             f"plain versions' on {n} pixels")
    log(f"  config5 {cfg.width}x{cfg.height} 1-spp frame, "
        f"{cfg.max_bounces} bounces: kernels ({times[0]:.3f} s) equal the "
        f"plain versions ({times[1]:.3f} s) bit for bit; launches "
        f"{ {k: launches[k] for k in WALK} }")
    return launches, times[0], times[1]


def config5_cli(tmp, dev, card):
    import numpy as np
    from optixpathtracer_tpu_torch.config import RenderConfig
    cfg = RenderConfig.from_json(CONFIG5)
    spp = cfg.spp
    out = {e: f"{tmp}/full.{e}" for e in ("exr", "png", "bmp", "ckpt")}
    argv = ["--config", CONFIG5, "--out-exr", out["exr"], "--out-png",
            out["png"], "--out-bmp", out["bmp"], "--checkpoint", out["ckpt"]]
    wall, launches, rec, text = run_cli(f"config5 CLI ({cfg.scene}, "
                                        f"{cfg.width}x{cfg.height}, {spp} "
                                        f"spp)", argv, WALK)
    img = rec["images"][0]
    if img.shape != (cfg.height, cfg.width, 3) or not np.isfinite(img).all() \
            or img.mean() <= 0:
        raise AssertionError("config5: bad image")
    if "sharded: falling back to single-device (1 devices" not in text \
            or f"at Sample: {spp}/{spp}" not in text:
        raise AssertionError("config5: no fallback line or heartbeat")
    check_outputs(img, out["exr"], out["png"], out["bmp"], "config5")
    mrays = cfg.width * cfg.height * spp * cfg.max_bounces * 2 / wall / 1e6
    writes = rec["checkpoint_s"] + rec["output_s"]
    log(f"  config5: {wall:.3f} s, {mrays:.2f} Mrays/s on "
        f"{card.name_power}; walk launches "
        f"{ {k: launches[k] for k in WALK} }; checkpoint + output writes "
        f"{writes:.3f} s ({writes / wall:.1%} of the wall); EXR, PNG and "
        f"BMP hold the image; mean {img.mean():.5f}")
    frame_launches, frame_s, plain_s = config5_frame(cfg, dev)
    return {"spp": spp, "wall_s": wall, "mrays_per_s": mrays,
            "launches": launches, "load_s": rec["load_s"],
            "checkpoint_s": rec["checkpoint_s"],
            "checkpoints": rec["checkpoints"],
            "output_s": rec["output_s"], "frame_launches": frame_launches,
            "frame_s": frame_s, "plain_frame_s": plain_s}


def hall_cli(tmp, scenes, card):
    """Hall at 1080p through the CLI: A uninterrupted, B1 stopped at a
    checkpoint, B2 resumed from it; B2 equals A bit for bit. Then
    `render` of the same 4 frames on the flattened scene."""
    import numpy as np
    import torch
    from optixpathtracer_tpu_torch.integrate import path
    ck = f"{tmp}/hall.ckpt"
    runs = {}
    for tag, extra in (("A", ["--spp", "4"]),
                       ("B1", ["--spp", "2", "--checkpoint", ck,
                               "--checkpoint-every", "2"]),
                       ("B2", ["--spp", "4", "--checkpoint", ck,
                               "--checkpoint-every", "2"])):
        wall, launches, rec, text = run_cli(
            f"hall CLI run {tag}",
            ["--scene", "hall", "--width", str(WIDTH), "--height",
             str(HEIGHT), "--max-bounces", "2", "--out-exr",
             f"{tmp}/hall_{tag}.exr"] + extra, HALL_KERNELS)
        runs[tag] = {"wall_s": wall, "launches": launches,
                     "load_s": rec["load_s"],
                     "checkpoint_s": rec["checkpoint_s"],
                     "output_s": rec["output_s"],
                     "image": rec["images"][0]}
    if "resumed from" not in text or "at sample 2" not in text:
        raise AssertionError("hall run B2 did not resume at sample 2")
    a, b2 = runs["A"].pop("image"), runs["B2"].pop("image")
    runs["B1"].pop("image")
    if not np.array_equal(a, b2):
        n = int((a != b2).any(axis=-1).sum())
        raise AssertionError(f"hall: resumed run differs on {n} pixels")
    scene, camera, _, _ = scenes["hall"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = path.render(scene, camera, WIDTH, HEIGHT, spp=4, max_bounces=2)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    if not np.array_equal(ref.cpu().numpy(), a):
        raise AssertionError("hall: the CLI's image is not render's")
    cost = runs["A"]["wall_s"] - render_s
    log(f"  hall CLI: B2 (resumed at 2) equals A bit for bit, and render's "
        f"4 frames; CLI wall {runs['A']['wall_s']:.3f} s against render "
        f"{render_s:.3f} s: front end {cost:.3f} s "
        f"({cost / runs['A']['wall_s']:.1%}; scene load "
        f"{runs['A']['load_s']:.3f} s, EXR {runs['A']['output_s']:.3f} s) "
        f"on {card.name_power}")
    return {"runs": runs, "render_s": render_s, "front_end_s": cost}


def dist_card(scenes, dev):
    """torch.distributed with NCCL at world size 1 (torchrun's variables
    set in-process, a free port): the sharded frame, the frame as
    ROW_BLOCKS row blocks (lost-shard recovery) and a material gradient
    step, each against the single-process path."""
    import os
    import numpy as np
    import torch
    import torch.distributed as tdist
    from optixpathtracer_tpu_torch.dist import (initialize_distributed,
                                                make_mesh,
                                                material_grad_step,
                                                render_rows,
                                                render_sample_sharded)
    from optixpathtracer_tpu_torch.dist.sharding import GRAD_FIELDS as FIELDS
    from optixpathtracer_tpu_torch.integrate import path
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    os.environ.update(env)
    out = {}
    try:
        multi = initialize_distributed(device="cuda")
        mesh = make_mesh()
        if multi or tdist.get_backend() != "nccl" or mesh.size != 1:
            raise AssertionError("dist: not NCCL at world size 1")
        scene, camera, _, _ = scenes["hall"]
        params = camera.raygen_params(WIDTH, HEIGHT, dev)
        flags = scene_flags(scene)
        with counted("dist: hall render_sample_sharded",
                     HALL_KERNELS) as n:
            sharded = render_sample_sharded(mesh, scene, *params, WIDTH,
                                            HEIGHT, 0, 2, "auto", **flags)
        out["launches sharded"] = n
        block = HEIGHT // ROW_BLOCKS
        with counted(f"dist: hall render_rows x{ROW_BLOCKS}",
                     HALL_KERNELS) as n:
            rows = [render_rows(scene, *params, WIDTH, HEIGHT, 0, y0, block,
                                2, "auto", **flags)
                    for y0 in range(0, HEIGHT, block)]
        out["launches rows"] = n
        full = path.render_sample(scene, *params, WIDTH, HEIGHT, 0, 2,
                                  "auto", **flags)
        if not torch.equal(sharded, full):
            raise AssertionError("dist: sharded frame differs")
        for i, r in enumerate(rows):
            if not torch.equal(r, full[block * i:block * (i + 1)]):
                raise AssertionError(f"dist: rows block {i} differs")
        log(f"  dist (NCCL, world 1): hall {WIDTH}x{HEIGHT} sharded frame "
            f"and {ROW_BLOCKS} {block}-row blocks equal render_sample bit "
            f"for bit")
        # a gradient step on layered against the single-process autograd
        scene, camera, _, _ = scenes["layered"]
        size = GRAD_SIZE
        cam = camera.raygen_params(size, size, dev)
        lobes = scene_flags(scene)["active_lobes"]
        target = torch.as_tensor(np.random.default_rng(0).uniform(
            0.0, 0.1, (size, size, 3)).astype(np.float32), device=dev)
        lr = 0.05
        with counted("dist: layered material_grad_step", WALK) as n:
            new, loss = material_grad_step(mesh, scene, cam, target, size,
                                           size, 0, lr=lr, max_bounces=2,
                                           intersect_method="auto",
                                           active_lobes=lobes)
        out["launches grad step"] = n

        def loss_fn(p):
            img = path.render_sample(dataclasses.replace(scene, **p), *cam,
                                     size, size, 0, 2, "auto",
                                     active_lobes=lobes)
            return ((img - target) ** 2).mean()

        grads = grads_of(loss_fn, {f: getattr(scene, f) for f in FIELDS})
        worst = 0.0
        for f in FIELDS:
            want = getattr(scene, f) - lr * grads[f]
            if f != "mat_ior":
                want = torch.clamp(want, 0.0, 1.0)
            got = getattr(new, f)
            if not torch.allclose(got, want, rtol=GRAD_STEP_RTOL, atol=0.0):
                raise AssertionError(f"dist: {f} step differs")
            worst = max(worst, float(((got - want).abs()
                                      / want.abs().clamp_min(1e-30)).max()))
        log(f"  dist: layered {size}x{size} material_grad_step equals the "
            f"single-process autograd step within rtol {GRAD_STEP_RTOL} "
            f"(max rel {worst:.2e}); loss {float(loss):.6f}")
        out["grad_step_max_rel"] = worst
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    return out


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def preview_card(scenes):
    """run_preview on Cornell at its default 256x256 for PREVIEW_SECONDS on
    a free port, headless; one PNG fetched over HTTP from 127.0.0.1."""
    import io
    import threading
    import urllib.request
    from PIL import Image
    from optixpathtracer_tpu_torch import preview
    scene, camera, _, _ = scenes["scene3_cornell"]
    states, result = [], {}

    class Recorded(preview.PreviewState):
        def __init__(self, cam):
            super().__init__(cam)
            states.append(self)

    port = free_port()
    saved = preview.PreviewState
    preview.PreviewState = Recorded
    heartbeat = io.StringIO()
    try:
        with counted("preview", ("dense_closest", "dense_any")) as n, \
                contextlib.redirect_stdout(heartbeat):
            thread = threading.Thread(target=lambda: result.update(
                img=preview.run_preview(scene, camera, port=port,
                                        max_seconds=PREVIEW_SECONDS)))
            thread.start()
            png = b""
            while not png and thread.is_alive():
                time.sleep(0.2)
                try:  # once a frame is published, fetch it
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/state",
                            timeout=5) as resp:
                        if json.loads(resp.read())["samples"] > 0:
                            with urllib.request.urlopen(
                                    f"http://127.0.0.1:{port}/frame.png",
                                    timeout=5) as frame:
                                png = frame.read()
                except OSError:
                    continue
            thread.join(120)
    finally:
        preview.PreviewState = saved
    if thread.is_alive() or "img" not in result:
        raise AssertionError("preview: the render loop did not end")
    if Image.open(io.BytesIO(png)).size != (256, 256):
        raise AssertionError("preview: bad PNG")
    samples = states[0].samples
    if samples <= 0:
        raise AssertionError("preview: no sample")
    beats = heartbeat.getvalue().count("at Sample:")
    log(f"  preview: {samples} samples in {PREVIEW_SECONDS} s "
        f"({states[0].spp_per_s:.1f} spp/s at 256x256, {beats} heartbeat "
        f"lines), a {len(png)}-byte PNG over HTTP; launches {n}")
    return {"samples": samples, "spp_per_s": states[0].spp_per_s,
            "launches": n}


def replay_card(dev):
    """One gradient of an L2 loss over MaterialTestReplay's parameters
    through "pallas": through the kernels and the plain versions, bit for
    bit."""
    import numpy as np
    import torch
    from optixpathtracer_tpu_torch.diff.replay import MaterialTestReplay
    from optixpathtracer_tpu_torch.integrate import path
    replay = MaterialTestReplay("conductor", device=dev)
    size = REPLAY_SIZE
    lobes = scene_flags(replay.scene0)["active_lobes"]
    target = torch.as_tensor(np.random.default_rng(1).uniform(
        0.0, 0.2, (size, size, 3)).astype(np.float32), device=dev)

    def loss_fn(p):
        img = path.render_sample(replay.scene_with(p),
                                 *replay.raygen_with(p, size, size), size,
                                 size, 0, 2, "pallas", False, lobes)
        return ((img - target) ** 2).mean()

    params = replay.init_params()
    with counted("replay", ("dense_closest", "dense_any")) as n:
        got = grads_of(loss_fn, params)
    with plain_kernels():
        want = grads_of(loss_fn, params)
    for k in params:
        if not torch.isfinite(got[k]).all() or not torch.equal(got[k],
                                                               want[k]):
            raise AssertionError(f"replay: {k} gradients differ")
    log(f"  replay (conductor, {size}x{size}, pallas): gradients of "
        f"{len(params)} parameters bit for bit the plain versions'; max |g| "
        f"{ {k: float(v.abs().max()) for k, v in got.items()} }; "
        f"launches {n}")
    return {"launches": n}


def frontend_launches(fe):
    """{path: launches} of every front-end run."""
    return {
        "frontend: config5 CLI": fe["config5"]["launches"],
        "frontend: config5 1-spp frame": fe["config5"]["frame_launches"],
        **{f"frontend: hall CLI {tag}": r["launches"]
           for tag, r in fe["hall_cli"]["runs"].items()},
        "frontend: dist hall sharded": fe["dist"]["launches sharded"],
        "frontend: dist hall rows": fe["dist"]["launches rows"],
        "frontend: dist layered grad step": fe["dist"]["launches grad step"],
        "frontend: preview": fe["preview"]["launches"],
        "frontend: replay": fe["replay"]["launches"]}


def frontend_phase(scenes, dev, card, stats):
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["config5"] = config5_cli(tmp, dev, card)
        out["hall_cli"] = hall_cli(tmp, scenes, card)
    out["dist"] = dist_card(scenes, dev)
    out["preview"] = preview_card(scenes)
    out["replay"] = replay_card(dev)
    stats["frontend"] = out


KERNEL_SOURCES = {
    "dense_closest": ("dense_intersect.cu",
                      "optixpathtracer_tpu/intersect/pallas_kernels.py:114"),
    "dense_any": ("dense_intersect.cu",
                  "optixpathtracer_tpu/intersect/pallas_kernels.py:145"),
    "walk_candidates": ("walk_intersect.cu",
                        "optixpathtracer_tpu/intersect/walk_kernels.py:444"),
    "walk_closest": ("walk_intersect.cu",
                     "optixpathtracer_tpu/intersect/walk_kernels.py:139"),
    "walk_any": ("walk_intersect.cu",
                 "optixpathtracer_tpu/intersect/walk_kernels.py:240"),
    "packet_closest": ("packet_intersect.cu",
                       "optixpathtracer_tpu/intersect/packet_kernels.py:182"),
    "packet_any": ("packet_intersect.cu",
                   "optixpathtracer_tpu/intersect/packet_kernels.py:290"),
    # the chains were Python loops around _closest_kernel
    "cutout_closest": ("dense_intersect.cu",
                       "optixpathtracer_tpu/integrate/cutout.py:63 "
                       "intersect_closest_cutout (split path)"),
    "cutout_any": ("dense_intersect.cu",
                   "optixpathtracer_tpu/integrate/cutout.py:196 "
                   "intersect_any_cutout (split path)"),
    "layered_f": ("layered_bsdf.cu", None),  # no TPU kernel: plain jnp
    "lobes_f": ("layered_bsdf.cu", None),
    "lobes_sample": ("layered_bsdf.cu", None),
}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from optixpathtracer_tpu_torch import _build
    from optixpathtracer_tpu_torch.scene import flatten_model
    from optixpathtracer_tpu_torch.scene.procedural import PRESETS

    card = Card()
    log(f"card: {card.name_power}, max SM clock {card.max_sm_mhz:.0f} MHz; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    stats = {"ptxas": reports}
    for line in "".join(reports.values()).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas: " + line.strip())
    registers = kernel_registers(reports)
    log("registers a thread (ptxas -v; static shared bytes, spill store "
        "bytes): " + ", ".join(f"{k} {v[0]} ({v[1]}, {v[2]})"
                                for k, v in registers.items()))
    dev = torch.device("cuda")

    scenes = {}
    cells = {name: (spp, bounces) for name, spp, bounces in CELLS}
    for name in dict.fromkeys([c[0] for c in CELLS] + list(IMAGE_SCENES)):
        model, camera, lights = PRESETS[name]()
        t0 = time.perf_counter()
        scene = flatten_model(model, lights, device=dev)
        seconds = time.perf_counter() - t0
        spp, bounces = cells.get(name, (2, 2))
        scenes[name] = (scene, camera, spp, bounces)
        main_scene = scene if scene.opaque_scene is None else \
            scene.opaque_scene
        log(f"{name}: {int(scene.tri_valid.sum())} triangles, "
            f"{main_scene.walk_tris.shape[0]} walk chunks of "
            f"{main_scene.walk_chunk}"
            + ("" if scene.cutout_sub is None else
               f" (opaque sub-scene; cutout sub-scene "
               f"{int(scene.cutout_sub.tri_valid.sum())} triangles)")
            + f", flattened in {seconds:.1f} s")
        if name not in cells:
            continue
        log("kernel phase")
        closest, shadow, chains = frame_waves(scene, camera, bounces, dev)
        waves = (closest, shadow)
        if name in DENSE_SCENES:
            dense_phase(name, scene, closest, shadow, card, stats)
        if name == "scene3_cornell":
            wide = frame_waves(scene, camera, bounces, dev, *WIDE)[:2]
            dense_phase(f"{name} {WIDE[0]}x{WIDE[1]}", scene, *wide, card,
                        stats)
            del wide
        if name in WALK_SCENES:
            walk_phase(name, scene, waves, card, stats,
                       dense_table=name == "diffuse")
        if name == "diffuse":
            chunk256_phase(model, lights, camera, dev, stats)
        if name in BSDF_SCENES:
            bsdf_phase(name, scene, camera, bounces, dev, card, stats)
        if name == "hall":
            walk_phase(name, main_scene, waves, card, stats,
                       primary_sub=SUBSAMPLE)
            packet_phase(name, main_scene, waves, card, stats)
            chain_phase(name, chains, card, stats)
    log("path phase")
    for name, spp, bounces in CELLS:
        scene, camera, _, _ = scenes[name]
        path_phase(name, scene, camera, spp, bounces, dev, stats, card)
    for name in ("scene3_cornell",) + WALK_SCENES + ("hall",):
        scene, camera, _, bounces = scenes[name]
        profile_frame(name, scene, camera, bounces, dev)
    log("images")
    images_phase(scenes, dev)
    gpu_vs_cpu_phase(scenes, dev)
    log("options phase")
    options_phase(scenes, dev, stats)
    log("backward phase")
    backward_phase(scenes, dev, card, stats)
    log("front-end phase")
    frontend_phase(scenes, dev, card, stats)

    # the launches of the options, backward and front-end paths, by path
    opt, bwd = stats["options"], stats["backward"]
    path_launches = {
        **{f"options: {what}": r["launches"]
           for what, r in opt["sorts"].items()},
        "backward: layered": bwd["launches"],
        "backward: hall_small auto": bwd["hall_small auto launches"],
        "backward: hall_small packet": bwd["hall_small packet launches"],
        **frontend_launches(stats["frontend"])}
    kernels = []
    for name, spp, bounces in CELLS:
        for kname, (src, replaces) in KERNEL_SOURCES.items():
            s = stats.get((name, kname))
            if s is None or "launches" not in s:
                continue
            kernels.append({
                "name": f"{kname}:{name}", "route": "cuda",
                "source": f"optixpathtracer_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": s["launches"],
                "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": s["bound_by"], "library_ms": None,
                "bounce_ms": s["bounce_ms"],
                "bounce_bound_ms": s.get("bounce_bound_ms"),
                "registers": registers.get(kname, (None,))[0],
                "render_mrays_per_s": stats[(name, "render")]["mrays_per_s"],
                "path_launches": {k: v.get(kname)
                                  for k, v in path_launches.items()},
            })
    assert {k["name"].split(":")[0] for k in kernels} == set(KERNEL_SOURCES)
    wide = f"scene3_cornell {WIDE[0]}x{WIDE[1]}"
    print(json.dumps({"dense_vs_walk": stats[("diffuse", "dense_vs_walk")],
                      "dense_wide": {k: stats[(wide, k)]
                                     for k in ("dense_closest", "dense_any")},
                      "block_compare": stats[("diffuse", "block_compare")],
                      "walk_vs_packet": stats[("hall", "walk_vs_packet")],
                      "options": opt, "backward": bwd,
                      "frontend": stats["frontend"]}))
    print(json.dumps({"kernels": kernels}))
    print(card.name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

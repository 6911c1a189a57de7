#!/usr/bin/env python3
"""Time versions of the packet kernels (csrc/packet_intersect.cu) or, with
--dense, of the dense kernels (csrc/dense_intersect.cu) or, with --walk, of
the walk sweeps (csrc/walk_intersect.cu) against each other on the
wavefronts where the engine runs, in one process on one NVIDIA GPU.

    python3 packet_bench.py [--dense | --walk] [NAME=PATH.cu ...]

The repository's own source is always measured, as "current". Each other
PATH is a version of csrc/packet_intersect.cu with the same two C entry
points, launched with the current source's shared-memory plan
(packet_kernels.smem_plan); a version that needs more shared memory adds
it in its own entry points. Every version is compiled with the port's nvcc
flags (one nvcc per source, all started together) and its ptxas report
printed.

On the bounce-0 and bounce-1 closest and shadow wavefronts of one 1080p
`hall` frame (chip_smoke.frame_waves), after the walk engine's coherence
sort and candidate kernel (block 256), each version must return the same
t, ids or blocked flags as the current source, bit for bit; then each is
timed with CUDA events (10 launches after a warm-up) in turns, forward and
backward order, twice, and the mean is kept. Printed per wavefront and
version: ms, the subchunks swept per packet, the ray-triangle and slab
tests it reports, and its bound (chip_smoke's: tests x 54 + slab tests x
28 FP32 operations at the card's max SM clock, or the bytes at 3.35 TB/s)
with the reach (bound / ms). The last line of output is one JSON object
with every number.

With --dense, each PATH is a version of csrc/dense_intersect.cu with the
same two C entry points (`dense_closest`, `dense_any`, n_live included),
run on the four wavefronts of one 1080p Cornell frame (closest at the
primary and bounce 1, occlusion at both shadow wavefronts), where the
dense sweeps serve the main path (hall's cutout chains run as their own
kernels). Each version must return the current source's t, ids
or blocked flags bit for bit; it is timed as above and read against one
bound for all versions, chip_smoke's needed-work bound (the FP32 operations of the
tests `dense_kernels.needed_work` counts for these inputs, each up to
where it can end: 28 once u rules the hit out, 46 once v does, else 54).
Printed per wavefront and version: ms, the tests the version reports,
and the reach.

With --walk, each PATH is a version of csrc/walk_intersect.cu with the
same C entry points (`walk_closest`, `walk_any`), run on every wavefront
the walk sweeps serve in one 1080p frame of `diffuse` (closest and shadow
at bounces 0-2), `layered` (bounces 0-1) and `hall` (the primary and the
bounce-0 shadow rays; its bounce-1 rays go to the packet engine), after
the coherence sort and the current source's candidate kernel (block 256).
Each version must return the current source's t, ids or blocked flags bit
for bit; it is timed as above and read against one bound for all
versions, chip_smoke's needed-work bound (the tests
`walk_kernels.needed_work` counts for these inputs, weighed as with
--dense). Printed per wavefront and version: ms, the chunks swept and
tests the version reports against the model's, and the reach.
"""
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

import chip_smoke as cs

ROUNDS = 2
REPS = 10


def build(variants):
    """{name: ctypes library} of the variant sources, compiled together."""
    from optixpathtracer_tpu_torch import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, path in variants.items():
        with open(path, "rb") as f:
            digest = hashlib.sha1(f.read()).hexdigest()[:12]
        out = os.path.join(_build.BUILD_DIR, f"variant-{name}-{digest}.so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                cs.log(f"  ptxas {name}: {line.strip()}")
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(out)
    return libs


def launcher(lib):
    """launch(kind, walk_tris, sub_box, cand, tnear, count, o, d, tmin, tmax)
    -> (output, counts [3, n_blocks]) for one compiled version."""
    import torch
    from optixpathtracer_tpu_torch.intersect import packet_kernels as pk
    fns = {}
    for kind, name in (("closest", "packet_closest"), ("any", "packet_any")):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = pk._ARGTYPES[name], ctypes.c_int
        fns[kind] = fn

    def launch(kind, walk_tris, sub_box, cand, tnear, count, o, d, tmin,
               tmax, block_rays=pk.BLOCK_RAYS):
        r, (n_chunks, _, chunk) = o.shape[0], walk_tris.shape
        nb = -(-r // block_rays)
        maxc_pad = cand.shape[1]
        outs = ((torch.empty(r, device=o.device),
                 torch.empty(r, dtype=torch.int32, device=o.device))
                if kind == "closest" else
                (torch.empty(r, dtype=torch.int32, device=o.device),))
        counts = torch.zeros((3, nb), dtype=torch.int32, device=o.device)
        plan = pk.smem_plan(chunk, block_rays, maxc_pad)
        ptrs = [x.data_ptr() for x in (o, d, tmin, tmax)]
        err = fns[kind](
            *ptrs, r, block_rays, cand.data_ptr(), tnear.data_ptr(),
            count.data_ptr(), maxc_pad, sub_box.data_ptr(), n_chunks,
            walk_tris.data_ptr(), chunk, *plan,
            *[x.data_ptr() for x in outs], 0, *[c.data_ptr() for c in counts],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{kind} launch failed: CUDA error {err}")
        return outs, counts

    return launch


def dense_launcher(lib):
    """launch(kind, tris, boxes, n_live, o, d, tmin, tmax) -> (output,
    counts [2, n_blocks]) for one compiled version of the dense kernels."""
    import torch
    from optixpathtracer_tpu_torch.intersect import dense_kernels as dk
    fns = {}
    for kind, name in (("closest", "dense_closest"), ("any", "dense_any")):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = dk._ARGTYPES[name], ctypes.c_int
        fns[kind] = fn

    def launch(kind, tris, boxes, n_live, o, d, tmin, tmax):
        r = o.shape[0]
        outs = ((torch.empty(r, device=o.device),
                 torch.empty(r, dtype=torch.int32, device=o.device))
                if kind == "closest" else
                (torch.empty(r, dtype=torch.int32, device=o.device),))
        counts = torch.zeros_like(dk._count_buffer(o))
        err = fns[kind](
            *[x.data_ptr() for x in (o, d, tmin, tmax)], r, tris.data_ptr(),
            boxes.data_ptr(), boxes.shape[1], n_live,
            *[x.data_ptr() for x in outs], *[c.data_ptr() for c in counts],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{kind} launch failed: CUDA error {err}")
        return outs, counts

    return launch


def walk_launcher(lib):
    """launch(kind, walk_tris, boxes, cand, tnear, count, o, d, tmin, tmax)
    -> (output, counts [2, n_blocks]) for one compiled version of the walk
    sweeps."""
    import torch
    from optixpathtracer_tpu_torch.intersect import walk_kernels as wk
    fns = {}
    for kind, name in (("closest", "walk_closest"), ("any", "walk_any")):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = wk._ARGTYPES[name], ctypes.c_int
        fns[kind] = fn

    def launch(kind, walk_tris, boxes, cand, tnear, count, o, d, tmin, tmax,
               block_rays=wk.BLOCK_RAYS):
        r, (n_chunks, _, chunk) = o.shape[0], walk_tris.shape
        nb, maxc_pad = cand.shape
        rays = [x.data_ptr() for x in (o, d, tmin, tmax)]
        counts = torch.zeros((2, nb), dtype=torch.int32, device=o.device)
        if kind == "closest":
            outs = (torch.empty(r, device=o.device),
                    torch.empty(r, dtype=torch.int32, device=o.device))
            err = fns[kind](
                *rays, r, block_rays, cand.data_ptr(), tnear.data_ptr(),
                count.data_ptr(), maxc_pad, boxes.data_ptr(), n_chunks,
                walk_tris.data_ptr(), chunk, *[x.data_ptr() for x in outs],
                *[c.data_ptr() for c in counts],
                torch.cuda.current_stream().cuda_stream)
        else:
            outs = (torch.empty(r, dtype=torch.int32, device=o.device),)
            err = fns[kind](
                *rays, r, block_rays, cand.data_ptr(), count.data_ptr(),
                maxc_pad, boxes.data_ptr(), n_chunks, walk_tris.data_ptr(),
                chunk, outs[0].data_ptr(), *[c.data_ptr() for c in counts],
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{kind} launch failed: CUDA error {err}")
        return outs, counts

    return launch


def time_in_turns(launch, label, *args):
    """Check every version's outputs against the current source's, bit for
    bit, then time them in turns: ({version: counts summed}, {version: [ms
    of each turn]})."""
    import torch
    want, _ = launch["current"](*args)
    counts = {}
    for name, fn in launch.items():
        got, c = fn(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"{name} {label}: {int((g != w).sum())} outputs differ "
                    f"from the current source's")
        counts[name] = [int(x.sum()) for x in c]
    ms = {name: [] for name in launch}
    order = list(launch)
    for _ in range(ROUNDS):
        for name in order + order[::-1]:
            ms[name].append(cs.cuda_time_ms(
                lambda fn=launch[name]: fn(*args), REPS))
    return counts, ms


def dense_rows(card, launch, dev):
    """The dense versions on Cornell's four wavefronts."""
    from optixpathtracer_tpu_torch.intersect import dense_kernels as dk
    from optixpathtracer_tpu_torch.scene import flatten_model
    from optixpathtracer_tpu_torch.scene.procedural import PRESETS
    waves = []
    model, camera, lights = PRESETS["scene3_cornell"]()
    cornell = flatten_model(model, lights, device=dev)
    closest, shadow, _ = cs.frame_waves(cornell, camera, 2, dev)
    waves += [("cornell", cornell, "closest", f"bounce-{b}", w)
              for b, w in enumerate(closest)]
    waves += [("cornell", cornell, "any", f"bounce-{b} shadow", w)
              for b, w in enumerate(shadow)]
    results = []
    for scene_name, scene, kind, label, rays in waves:
        tris, boxes, n_live = dk.dense_arrays(scene)
        args = (kind, tris, boxes, n_live, *rays)
        counts, ms = time_in_turns(launch, f"{scene_name} {kind} {label}",
                                   *args)
        bound_ms, bound_by, work = cs.dense_bound(card, kind, tris, boxes,
                                                  n_live, rays)
        need = int(work.tests.sum())
        live = int((rays[3] > rays[2]).sum())
        cs.log(f"{scene_name} dense_{kind} {label} ({rays[0].shape[0]} rays,"
               f" {live} live; {need:.4g} needed tests, ending at "
               f"{cs.exit_shares(work)}, bound {bound_ms:.4f} ms, "
               f"{bound_by}):")
        for name in launch:
            mean = sum(ms[name]) / len(ms[name])
            tests = counts[name][1]
            row = {"scene": scene_name, "kind": kind, "wavefront": label,
                   "version": name, "ms": mean, "ms_all": ms[name],
                   "tests": tests, "needed_tests": need,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "reach": bound_ms / mean}
            results.append(row)
            cs.log(f"  {name:>12}: {mean:.4f} ms "
                   f"[{', '.join(f'{x:.4f}' for x in ms[name])}], "
                   f"{tests:.4g} tests reported ({tests / need:.2f}x "
                   f"needed), reach {row['reach']:.1%}")
    return results


def walk_rows(card, launch, dev):
    """The walk sweep versions on every walk wavefront of `diffuse`,
    `layered` and `hall`."""
    from optixpathtracer_tpu_torch.scene import flatten_model
    from optixpathtracer_tpu_torch.scene.procedural import PRESETS
    results = []
    for scene_name, bounces, walk_bounces in (("diffuse", 3, 3),
                                              ("layered", 2, 2),
                                              ("hall", 2, 1)):
        model, camera, lights = PRESETS[scene_name]()
        full = flatten_model(model, lights, device=dev)
        scene = full if full.opaque_scene is None else full.opaque_scene
        closest, shadow, _ = cs.frame_waves(full, camera, bounces, dev)
        waves = ([("closest", f"bounce-{b}", w)
                  for b, w in enumerate(closest[:walk_bounces])]
                 + [("any", f"bounce-{b} shadow", w)
                    for b, w in enumerate(shadow[:walk_bounces])])
        for kind, label, rays in waves:
            srays, boxes, _, (cand, tnear, count) = cs.walk_prepare(
                scene, rays, 256)
            args = (kind, scene.walk_tris, boxes, cand, tnear, count, *srays)
            counts, ms = time_in_turns(launch, f"{scene_name} {kind} {label}",
                                       *args)
            bound_ms, bound_by, work = cs.walk_bound(
                card, kind, scene, boxes, cand, tnear, count, srays, 256)
            need, chunks = int(work.tests.sum()), int(work.chunks.sum())
            live = int((srays[3] > srays[2]).sum())
            cs.log(f"{scene_name} walk_{kind} {label} ({srays[0].shape[0]} "
                   f"rays, {live} live, {float(count.float().mean()):.1f} "
                   f"candidates a block; {chunks} chunks and {need:.4g} "
                   f"tests needed, ending at {cs.exit_shares(work)}, bound "
                   f"{bound_ms:.4f} ms, {bound_by}):")
            for name in launch:
                mean = sum(ms[name]) / len(ms[name])
                swept, tests = counts[name]
                row = {"scene": scene_name, "kind": kind, "wavefront": label,
                       "version": name, "ms": mean, "ms_all": ms[name],
                       "swept": swept, "tests": tests,
                       "needed_chunks": chunks, "needed_tests": need,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "reach": bound_ms / mean}
                results.append(row)
                cs.log(f"  {name:>12}: {mean:.4f} ms "
                       f"[{', '.join(f'{x:.4f}' for x in ms[name])}], "
                       f"{swept} chunks swept, {tests:.4g} tests reported "
                       f"({tests / need:.2f}x needed), reach "
                       f"{row['reach']:.1%}")
    return results


def packet_rows(card, launch, dev):
    """The packet versions on hall's four packet wavefronts."""
    from optixpathtracer_tpu_torch.scene import flatten_model
    from optixpathtracer_tpu_torch.scene.procedural import PRESETS
    model, camera, lights = PRESETS["hall"]()
    hall = flatten_model(model, lights, device=dev)
    scene = hall.opaque_scene
    closest, shadow, _ = cs.frame_waves(hall, camera, 2, dev)
    waves = [("closest", b, w) for b, w in enumerate(closest)] + \
        [("any", b, w) for b, w in enumerate(shadow)]
    results = []
    for kind, b, rays in waves:
        srays, _, _, (cand, tnear, count) = cs.walk_prepare(scene, rays, 256)
        args = (scene.walk_tris, scene.walk_sub_box, cand, tnear, count,
                *srays)
        counts, ms = time_in_turns(launch, f"{kind} bounce-{b}", kind, *args)
        r = srays[0].shape[0]
        packets = -(-r // 8)
        cs.log(f"hall packet_{kind} bounce-{b} ({r} rays, "
               f"{float(count.float().mean()):.1f} candidates a block):")
        for name in launch:
            swept, tests, slabs = counts[name]
            bound_ms, bound_by = cs.packet_bound(card, scene, kind, {
                "rays": r, "blocks": cand.shape[0],
                "maxc_pad": cand.shape[1], "tests": tests, "slabs": slabs})
            mean = sum(ms[name]) / len(ms[name])
            row = {"kind": kind, "bounce": b, "version": name, "ms": mean,
                   "ms_all": ms[name], "swept_per_packet": swept / packets,
                   "tests": tests, "slabs": slabs, "bound_ms": bound_ms,
                   "bound_by": bound_by, "reach": bound_ms / mean}
            results.append(row)
            cs.log(f"  {name:>12}: {mean:.3f} ms "
                   f"[{', '.join(f'{x:.3f}' for x in ms[name])}], "
                   f"{row['swept_per_packet']:.2f} swept a packet, "
                   f"{tests:.4g} tests, {slabs:.4g} slab tests, bound "
                   f"{bound_ms:.3f} ms ({bound_by}), reach {row['reach']:.1%}")
    return results


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("packet_bench: no CUDA device", file=sys.stderr)
        return 1
    from optixpathtracer_tpu_torch import _build

    mode = next((a for a in argv if a in ("--dense", "--walk")), None)
    source = {"--dense": "dense_intersect.cu", "--walk": "walk_intersect.cu",
              None: "packet_intersect.cu"}[mode]
    variants = {"current": os.path.join(_build.CSRC, source)}
    variants.update(arg.split("=", 1) for arg in argv if arg != mode)
    card = cs.Card()
    cs.log(f"card: {card.name_power}, max SM clock {card.max_sm_mhz:.0f} MHz"
           f"; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build(variants)
    cs.log(f"{len(libs)} versions built in {time.perf_counter() - t0:.1f} s")
    make, rows_of = {"--dense": (dense_launcher, dense_rows),
                     "--walk": (walk_launcher, walk_rows),
                     None: (launcher, packet_rows)}[mode]
    launch = {name: make(lib) for name, lib in libs.items()}
    rows = rows_of(card, launch, torch.device("cuda"))
    print(json.dumps({"card": card.name_power, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

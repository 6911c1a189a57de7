#!/usr/bin/env python3
"""Time versions of the packet kernels (csrc/packet_intersect.cu) against
each other on the `hall` wavefronts where the packet engine runs, in one
process on one NVIDIA GPU.

    python3 packet_bench.py [NAME=PATH.cu ...]

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


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("packet_bench: no CUDA device", file=sys.stderr)
        return 1
    from optixpathtracer_tpu_torch import _build
    from optixpathtracer_tpu_torch.scene import flatten_model
    from optixpathtracer_tpu_torch.scene.procedural import PRESETS

    variants = {"current": os.path.join(_build.CSRC, "packet_intersect.cu")}
    variants.update(arg.split("=", 1) for arg in argv)
    card = cs.Card()
    cs.log(f"card: {card.name_power}, max SM clock {card.max_sm_mhz:.0f} MHz"
           f"; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build(variants)
    cs.log(f"{len(libs)} versions built in {time.perf_counter() - t0:.1f} s")
    launch = {name: launcher(lib) for name, lib in libs.items()}

    dev = torch.device("cuda")
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
        want, _ = launch["current"](kind, *args)
        counts = {}
        for name, fn in launch.items():
            got, c = fn(kind, *args)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"{name} {kind} bounce-{b}: {int((g != w).sum())} "
                        f"outputs differ from the current source's")
            counts[name] = [int(x.sum()) for x in c]
        ms = {name: [] for name in launch}
        order = list(launch)
        for _ in range(ROUNDS):
            for name in order + order[::-1]:
                ms[name].append(cs.cuda_time_ms(
                    lambda fn=launch[name]: fn(kind, *args), REPS))
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
    print(json.dumps({"card": card.name_power, "rows": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The readings that the limits of `correct` are set from, on the card, in
one process:

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n,n,...> [--control-seeds <k>] [--out <file.jsonl>]

For every seed: one untraced run of the cell as `run.py` makes it (the
program against the reference: the lower readings). For the first k seeds
also the control, the reference computed in bfloat16 put in the program's
place, against the float32 reference, and for the fitting cell two faults
planted in the reference put in the program's place: half of the rows
left out with the mean taken over the rest, and each step's loss altered
by 1% (the upper readings). A state left unchanged reads 1 by the
measures of `traffic/fit.py` and needs no run. One JSON line per seed.
The benchmark's own runs never run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def upper_readings(runner, kind_module):
    """{control or fault: {number: value}} for the runner's last window."""
    if runner.unit == "frame":
        px, py = runner.sample_pixels()
        want = runner.reference(px, py, "float32")
        got = runner.reference(px, py, "bfloat16")
        return {"control_bf16": kind_module.compare(
            got, want, float(runner.ctx.workload["pixel_rtol"]))}
    want = runner.reference("float32")
    lr = runner.lr
    control = runner.reference("bfloat16")
    half = runner.reference("float32", rows=runner.height // 2)
    altered = [x * 1.01 for x in want[0]]
    return {"control_bf16": kind_module.compare(control[0], control[1],
                                                *want, lr),
            "half_rows": kind_module.compare(half[0], half[1], *want, lr),
            "loss_altered": kind_module.compare(altered, want[1], *want, lr)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from portbench.harness import driver
    from portbench.harness.registry import Registry
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    registry = Registry()
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(seeds):
        cell = registry.cell(args.workload)
        extra = {}

        def after(runner):
            if i < args.control_seeds:
                t = time.perf_counter()
                extra.update(upper_readings(runner, cell.kind))
                extra["upper_s"] = time.perf_counter() - t

        t0 = time.perf_counter()
        r = driver.run_cell(cell, registry, seed, args.seconds, False,
                            torch.device("cuda"), t0,
                            lambda m: print(m, file=sys.stderr), after)
        line = {"cell": args.workload, "seed": seed,
                "run_s": time.perf_counter() - t0,
                "attempted": r["attempted"], "correct": r["correct"],
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "program": {k: c["value"] for k, c in r["checks"].items()},
                **extra}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        torch.cuda.empty_cache()
    found = driver.forbidden_modules()
    print(f"calibrate: done in {time.perf_counter() - T0:.1f} s; "
          f"forbidden modules loaded: {found}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

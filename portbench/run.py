"""Benchmark of optixpathtracer_tpu_torch (the PyTorch and CUDA port) on
NVIDIA GPUs: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell
asks for. It sets up the cell (scene, kernels, warm-up: `setup_s`), runs
the window for --seconds (with --trace 1: the traffic's traced frames or
steps under torch.profiler), checks what the window produced against the
plain reference in `portbench/reference/`, and prints one JSON line last
on standard output. Without CUDA, with too few cards, with JAX or the JAX
package loaded, or outside a full checkout it exits non-zero and prints
no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".cache", "portbench")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel caches at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)
    import torch
    from portbench.harness import driver
    from portbench.harness.registry import Registry

    registry = Registry()
    cell = registry.cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(msg):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    result = driver.run_cell(cell, registry, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda"), T0,
                             log)
    found = driver.forbidden_modules()
    if found:
        print(f"portbench: loaded {found}: the run may import neither JAX "
              f"nor the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

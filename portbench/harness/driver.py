"""One run of one cell: set-up, the measured (or traced) window, the
check against the reference, and the result line."""
from __future__ import annotations

import dataclasses
import importlib.util
import math
import os
import sys
import time

import torch

from . import profile, spans
from .registry import HERE
from .timing import UnitClock

FORBIDDEN = ("jax", "jaxlib", "flax", "optixpathtracer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's (`optixpathtracer_tpu_torch` is neither)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    device: torch.device
    seed: int
    config: dict
    traffic: dict
    workload: dict
    desc: dict              # the plain scene description


def scene_module(config: dict, folder=HERE):
    """The module `scenes/<config["scenes"]>.py`. It defines `build(config)`,
    the plain scene description of a configuration from the
    configuration's own keys, and `CPU_CUT`, the keys that cut any of its
    configurations to a size the CPU tests render in seconds."""
    path = os.path.join(folder, "scenes", f"{config['scenes']}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_scenes_{config['scenes']}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def scene_description(config: dict, folder=HERE) -> dict:
    return scene_module(config, folder).build(config)


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a missing or non-finite number fails."""
    checks = {k: {"value": numbers.get(k, math.inf), "limit": v}
              for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell, registry, seed: int, seconds: float, trace: bool,
             device, t0: float, log=print, after=None):
    """The result dict of one run (see the benchmark's contract).
    `after(runner)`, if given, is called once the check is done."""
    from torch.profiler import ProfilerActivity, record_function
    cfg = cell.config
    ctx = Context(device=device, seed=seed, config=cfg, traffic=cell.traffic,
                  workload=cell.workload,
                  desc=scene_description(cfg, registry.folder))
    runner = cell.kind.make(ctx)
    runner.warm_up()
    _sync(device)
    setup_s = time.perf_counter() - t0
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    clock = UnitClock(device)
    traced = None
    if trace:
        n = runner.trace_units
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with spans.installed(), torch.profiler.profile(
                activities=acts) as prof:
            with record_function(spans.WINDOW):
                e2e = runner.window(clock, lambda units: units < n)
        records = profile.records_from_kineto(prof)
        traced = profile.reduce(records, clock.units, runner.unit)
        log(f"trace: {len(records)} events, {traced.launches} kernels, "
            f"busy {traced.busy_s:.4f} s of {traced.window_s:.4f} s, "
            f"spans {traced.span_s}")
    else:
        start = time.perf_counter()
        e2e = runner.window(
            clock, lambda units: time.perf_counter() - start < seconds)
    e2e["setup_s"] = setup_s
    units = clock.units
    peak = max(setup_peak, torch.cuda.max_memory_allocated()) if cuda else 0
    log(f"set-up {setup_s:.3f} s; {units} {runner.unit}s in the window; "
        f"peak {peak} bytes")
    t_check = time.perf_counter()
    numbers = runner.check()
    log(f"check against the reference {time.perf_counter() - t_check:.3f} s")
    correct, checks = verdict(numbers, cell.workload["limits"])
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = registry.reader(m["name"])(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        missing = [m["name"] for m in cell.end_to_end
                   if m["name"] not in e2e]
        if missing and cuda:  # a CPU test run has no device readings
            raise RuntimeError(f"the window measured no {missing}")
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": units,
              "failed": 0 if correct else units, "metrics": metrics,
              "device": dev}
    if traced is not None:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = {"device_ops": traced.device_ops,
                               "idle_gaps": traced.idle_gaps}
    if after is not None:
        after(runner)
    result["checks"] = checks
    return result

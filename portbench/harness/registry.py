"""Find a cell's parts by name.

`BENCHMARK.json` (at the root of the checkout) names the cells, their
configurations and traffic, and the metrics. Each part sits in a file of
its own under the benchmark's folder, found by its name:

    configs/<config>.json     the scene: its module, its keys, bounces
    scenes/<module>.py        the plain scene description a config's
                              keys build (meshes, materials, textures,
                              lights, camera) and its cut for CPU tests
    traffic/<traffic>.json    the mix: its kind and parameters
    traffic/<kind>.py         the driver of every mix of that kind
    workloads/<cell>.json     the cell's check: sample sizes and limits
    metrics/<metric>.py       one reader per per-layer metric

so a later change adds a configuration, a cell or a metric by adding a
file and an entry, and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    kind: object            # the traffic kind's module
    end_to_end: list        # BENCHMARK.json entries reported by this cell
    per_layer: list


class Registry:
    """The benchmark as described by `benchmark_json`, with its files under
    `folder` (by default this folder and the repository's
    BENCHMARK.json)."""

    def __init__(self, benchmark_json=None, folder=HERE):
        self.folder = folder
        self.spec = _load_json(benchmark_json
                               or os.path.join(ROOT, "BENCHMARK.json"))

    def path(self, *parts):
        return os.path.join(self.folder, *parts)

    def _metrics(self, key, cell):
        return [m for m in self.spec[key]
                if cell in m.get("workloads", [cell])]

    def cell(self, name: str) -> Cell:
        entry = [w for w in self.spec["workloads"] if w["name"] == name]
        if not entry:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        entry = entry[0]
        traffic = _load_json(self.path("traffic", f"{entry['traffic']}.json"))
        return Cell(
            name=name, chips=int(entry["chips"]),
            config=_load_json(self.path("configs",
                                        f"{entry['config']}.json")),
            traffic=traffic,
            workload=_load_json(self.path("workloads", f"{name}.json")),
            kind=_load_module(self.path("traffic", f"{traffic['kind']}.py"),
                              f"portbench_traffic_{traffic['kind']}"),
            end_to_end=self._metrics("end_to_end", name),
            per_layer=self._metrics("per_layer", name))

    def reader(self, metric: str):
        """The `read(trace)` function of a per-layer metric."""
        module = _load_module(self.path("metrics", f"{metric}.py"),
                              "portbench_metric_" + metric.replace(".", "_"))
        return module.read

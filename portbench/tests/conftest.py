"""Tests of the port's benchmark (`portbench/`). Run from the repository
root: `python -m pytest portbench/tests -q`. They import no JAX; the ones
marked `cuda` need an NVIDIA GPU and skip without one."""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where "
        "torch.cuda.is_available() is false")


def edit_json(path, **kv):
    with open(path) as f:
        data = json.load(f)
    data.update(kv)
    with open(path, "w") as f:
        json.dump(data, f)


def cut_configs(folder):
    """Cut each configuration under `folder` by its scene module's
    `CPU_CUT`."""
    from portbench.harness import driver
    for name in os.listdir(os.path.join(folder, "configs")):
        path = os.path.join(folder, "configs", name)
        with open(path) as f:
            config = json.load(f)
        edit_json(path, **driver.scene_module(config, folder).CPU_CUT)


def make_tiny_registry(folder, width=16, height=12, fit_size=8):
    """A copy of the benchmark's files under `folder`, with the scenes,
    frames and fitting images cut to a size the CPU renders in seconds.
    Returns the Registry over it."""
    from portbench.harness.registry import HERE, Registry
    for d in ("traffic", "metrics", "scenes", "configs", "workloads"):
        shutil.copytree(os.path.join(HERE, d), os.path.join(folder, d))
    cut_configs(folder)
    for name in os.listdir(os.path.join(folder, "traffic")):
        if name.endswith(".json"):
            size = (fit_size, fit_size) if name.startswith("fit") \
                else (width, height)
            edit_json(os.path.join(folder, "traffic", name),
                      width=size[0], height=size[1])
    for name in os.listdir(os.path.join(folder, "workloads")):
        if ".fit-" in name:
            edit_json(os.path.join(folder, "workloads", name),
                      rows_per_block=4)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    if not any(w["name"] == FIT_CELL["name"] for w in spec["workloads"]):
        spec["workloads"].append(FIT_CELL)
        spec["end_to_end"] += FIT_METRICS
    with open(os.path.join(folder, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return Registry(os.path.join(folder, "BENCHMARK.json"), folder)


# The fitting cell, which BENCHMARK.json leaves out while the port's
# material gradient can turn NaN (PERF.md, Open questions); its files are
# in place and tested here.
FIT_CELL = {"name": "layered.fit-512", "config": "layered",
            "traffic": "fit-512", "chips": 1, "why": "material fitting"}
FIT_METRICS = [
    {"name": "fit_mrays_s", "unit": "Mrays/s", "better": "higher",
     "bound": 0.25, "source": "device_trace",
     "workloads": ["layered.fit-512"]},
    {"name": "peak_mem_gib", "unit": "GiB", "better": "lower",
     "bound": 0.25, "source": "device_trace",
     "workloads": ["layered.fit-512"]}]


@pytest.fixture
def tiny(tmp_path):
    return make_tiny_registry(str(tmp_path))


# A cell that new files and BENCHMARK.json entries alone add: the files
# under files_only_cell/ (a textured scene module with all five material
# types and alpha holes, its configuration and its cell's check) and the
# existing render traffic.
FILES_ONLY_CELL = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "files_only_cell")
TEXTURED_CELL = "textured.render-1080p"


def add_files_only_cell(registry):
    """Copy FILES_ONLY_CELL's files into the registry's folder (each a new
    file there), add the configuration, the cell and the cell to
    `mrays_s` in its BENCHMARK.json, and return the Registry over it."""
    from portbench.harness.registry import Registry
    folder = registry.folder
    for sub in os.listdir(FILES_ONLY_CELL):
        for name in os.listdir(os.path.join(FILES_ONLY_CELL, sub)):
            target = os.path.join(folder, sub, name)
            assert not os.path.exists(target), target
            shutil.copy(os.path.join(FILES_ONLY_CELL, sub, name), target)
    cut_configs(folder)
    spec_path = os.path.join(folder, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["configs"].append({
        "name": "textured", "source": "portbench/tests/files_only_cell",
        "file": "portbench/configs/textured.json", "reduced": [],
        "why": "every material type, albedo textures, alpha holes"})
    spec["workloads"].append({
        "name": TEXTURED_CELL, "config": "textured",
        "traffic": "render-1080p", "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "mrays_s":
            m["workloads"].append(TEXTURED_CELL)
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    return Registry(spec_path, folder)


@pytest.fixture
def tiny_textured(tiny):
    return add_files_only_cell(tiny)

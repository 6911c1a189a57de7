"""A configuration, a traffic mix, a cell and a per-layer metric are
picked up from new files and a new BENCHMARK.json entry alone, with no
edit to a file the benchmark has."""
import json
import os
import shutil
import time

import torch

from portbench.harness import driver
from portbench.harness.registry import Registry

SEED = 2_500_000_001


def test_new_files_make_a_new_cell(tiny):
    folder = tiny.folder
    shutil.copy(os.path.join(folder, "configs", "diffuse.json"),
                os.path.join(folder, "configs", "diffuse2.json"))
    with open(os.path.join(folder, "traffic", "render-tiny.json"), "w") as f:
        json.dump({"kind": "render", "width": 8, "height": 6,
                   "warm_frames": 1, "trace_frames": 2}, f)
    shutil.copy(os.path.join(folder, "workloads",
                             "diffuse.render-1080p.json"),
                os.path.join(folder, "workloads",
                             "diffuse2.render-tiny.json"))
    with open(os.path.join(folder, "metrics", "frames_traced.render.py"),
              "w") as f:
        f.write("def read(trace):\n    return float(trace.units)\n")
    spec_path = os.path.join(folder, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["configs"].append(dict(spec["configs"][1], name="diffuse2",
                                file="portbench/configs/diffuse2.json"))
    spec["workloads"].append({"name": "diffuse2.render-tiny",
                              "config": "diffuse2", "traffic": "render-tiny",
                              "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "mrays_s":
            m["workloads"].append("diffuse2.render-tiny")
    spec["per_layer"].append({
        "name": "frames_traced.render", "unit": "frames", "better": "higher",
        "source": "device_trace", "layer": "device", "moves": "mrays_s",
        "workloads": ["diffuse2.render-tiny"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)

    reg = Registry(spec_path, folder)
    cell = reg.cell("diffuse2.render-tiny")
    assert cell.traffic["width"] == 8 and cell.config["name"] == "diffuse"
    assert [m["name"] for m in cell.per_layer] == ["frames_traced.render"]
    r = driver.run_cell(cell, reg, SEED, 0.2, True, torch.device("cpu"),
                        time.perf_counter(), log=lambda m: None)
    assert r["correct"]
    assert r["metrics"] == {"frames_traced.render": {"value": 2.0,
                                                     "unit": "frames"}}
    r = driver.run_cell(cell, reg, SEED, 0.2, False, torch.device("cpu"),
                        time.perf_counter(), log=lambda m: None)
    assert set(r["metrics"]) == {"mrays_s", "setup_s"}


def _file_digests(folder):
    out = {}
    for base, _, names in os.walk(folder):
        for name in names:
            path = os.path.join(base, name)
            if name != "BENCHMARK.json" and "__pycache__" not in path:
                with open(path, "rb") as f:
                    out[os.path.relpath(path, folder)] = hash(f.read())
    return out


def test_new_files_make_a_textured_cell(tiny):
    """A scene of its own shape, with textures, alpha holes and all five
    material types, comes in by new files and entries alone, and the
    reference checks it."""
    from conftest import TEXTURED_CELL, add_files_only_cell
    from portbench.harness import port
    before = _file_digests(tiny.folder)
    reg = add_files_only_cell(tiny)
    after = _file_digests(tiny.folder)
    assert {k: after[k] for k in before} == before
    assert len(after) > len(before)

    cell = reg.cell(TEXTURED_CELL)
    desc = driver.scene_description(cell.config, reg.folder)
    sizes = {t.shape[:2] for t in desc["textures"]}
    assert len(sizes) == 2 and (256, 256) not in sizes
    assert {m["material"]["mat_type"] for m in desc["meshes"]} == {
        "diffuse", "conductor", "dielectric", "glossy_diffuse",
        "metallic_mix"}
    scene, _ = port.scene_and_camera(desc, torch.device("cpu"))
    options = port.render_options(scene)
    assert options["use_textures"] and options["use_alpha_cutout"]
    assert options["active_lobes"] == (0, 1, 2, 3)

    r = driver.run_cell(cell, reg, SEED, 0.2, False, torch.device("cpu"),
                        time.perf_counter(), log=lambda m: None)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert set(r["metrics"]) == {"mrays_s", "setup_s"}

"""The hall configuration on the CPU: the frozen scene
(`portbench/scenes/hall.py`) is the port's `scene_hall` bit for bit; its
cell, cut by `CPU_CUT`, reads `correct` through `run_cell` and its
bfloat16 control does not; the packet engine, which takes the hall's
secondary bounces on the card, agrees with the plain reference; and the
readers of the packet sweeps' time and the cutout chains' host syncs read
the port's spans, and nothing without them. The card run skips without an
NVIDIA GPU."""
import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench.harness import driver
from portbench.harness.registry import Registry
from portbench.harness.spans import WINDOW
from portbench.scenes import hall
from test_portbench_program import _fake_profile, dev, host, trace_of
from test_portbench_reference import SEED, runner_after_window

CELL = "hall.render-1080p"
MESH_ARRAYS = ("positions", "indices", "normals", "uvs")
MATERIAL_FIELDS = ("base_color", "metallic", "roughness", "ior", "mat_type",
                   "albedo_texture", "metal_rough_texture", "normal_texture")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _port_as_description(detail):
    """The port's `scene_hall(detail)` in the description's form."""
    from optixpathtracer_tpu_torch.scene.procedural import scene_hall
    model, camera, lights = scene_hall(detail)
    meshes = [dict({k: getattr(m, k) for k in MESH_ARRAYS},
                   material={f: getattr(m.material, f)
                             for f in MATERIAL_FIELDS})
              for m in model.meshes]
    return dict(meshes=meshes,
                lights=[(l.position, l.color) for l in lights],
                camera=dict(position=camera.position,
                            rotation=camera.rotation,
                            fov_degrees=camera.fov_degrees),
                textures=[t.pixels for t in model.textures])


def _digest(desc):
    h = hashlib.sha256()
    for m in desc["meshes"]:
        for k in MESH_ARRAYS:
            h.update(np.ascontiguousarray(m[k]).tobytes())
    for t in desc["textures"]:
        h.update(np.ascontiguousarray(t).tobytes())
    return h.hexdigest()


def test_frozen_hall_is_the_ports_at_the_cpu_cut():
    got = hall.build(hall.CPU_CUT)
    want = _port_as_description(hall.CPU_CUT["detail"])
    assert len(got["meshes"]) == len(want["meshes"]) == 70
    assert sum(len(m["indices"]) for m in got["meshes"]) == 10334
    for g, w in zip(got["meshes"], want["meshes"]):
        for k in MESH_ARRAYS:
            assert _same(g[k], w[k]), k
        for f in MATERIAL_FIELDS:
            assert _same(g["material"].get(f, -1), w["material"][f]), f
    assert len(got["textures"]) == len(want["textures"]) == 3
    for g, w in zip(got["textures"], want["textures"]):
        assert _same(g, w)
    assert len(got["lights"]) == len(want["lights"]) == 3
    for (gp, gc), (wp, wc) in zip(got["lights"], want["lights"]):
        assert _same(gp, wp) and _same(gc, wc)
    for k in ("position", "rotation", "fov_degrees"):
        assert _same(got["camera"][k], want["camera"][k]), k


def test_frozen_hall_is_the_ports_at_full_size():
    with open(f"{ROOT}/portbench/configs/hall.json") as f:
        config = json.load(f)
    got = hall.build(config)
    n = sum(len(m["indices"]) for m in got["meshes"])
    assert n == config["triangles"] == 338270
    assert _digest(got) == _digest(_port_as_description(config["detail"]))


def test_hall_cell_runs_on_the_ports_path(tiny):
    from portbench.harness import port
    cell = tiny.cell(CELL)
    assert cell.config["detail"] == hall.CPU_CUT["detail"]
    desc = driver.scene_description(cell.config, tiny.folder)
    scene, _ = port.scene_and_camera(desc, torch.device("cpu"))
    options = port.render_options(scene)
    assert options["use_textures"] and options["use_alpha_cutout"]
    assert options["active_lobes"] == (0, 1, 2, 3)
    r = driver.run_cell(cell, tiny, SEED, 0.3, False, torch.device("cpu"),
                        time.perf_counter(), log=lambda m: None)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert {"mrays_s", "setup_s"} <= set(r["metrics"])


def test_hall_bfloat16_control_fails(tiny):
    from portbench.calibrate import upper_readings
    cell, runner = runner_after_window(tiny, CELL, units=2)
    runner.check()
    readings = upper_readings(runner, cell.kind)
    correct, checks = driver.verdict(readings["control_bf16"],
                                     cell.workload["limits"])
    assert not correct, checks


def test_packet_engine_agrees_with_the_reference(tiny, monkeypatch):
    """The cell's frames with every query on the packet engine's plain
    path (on the card the router sends it the secondary bounces of a
    scene of 512 walk chunks or more), against the reference's
    accumulation of the same frames."""
    from optixpathtracer_tpu_torch.integrate import path
    from optixpathtracer_tpu_torch.intersect import packet_kernels
    swept = []
    real = packet_kernels.plain_launch

    def counted(sweep, *args):
        swept.append(sweep.__name__)
        return real(sweep, *args)

    monkeypatch.setattr(packet_kernels, "plain_launch", counted)
    cell = tiny.cell(CELL)
    ctx = driver.Context(torch.device("cpu"), SEED, cell.config,
                         cell.traffic, cell.workload,
                         driver.scene_description(cell.config, tiny.folder))
    runner = cell.kind.make(ctx)
    runner.frame = lambda accum, s: path.render_chunk(
        runner.scene, *runner.cam, runner.width, runner.height, accum, s, 1,
        runner.bounces, "packet", **runner.options)
    runner.window(driver.UnitClock(ctx.device), lambda n: n < 2)
    numbers = runner.check()
    assert {"packet_closest_plain", "packet_any_plain"} <= set(swept)
    correct, checks = driver.verdict(numbers, cell.workload["limits"])
    assert correct, checks
    assert numbers == {"bad_pixel_share": 0.0, "mean_rel_err": 0.0}


# A traced frame of two bounces: a cutout chain holding a closest query
# on the packet engine, and a packet occlusion query outside it.
SPANS = [
    host("tracer.frame", 100, 9000),
    host("tracer.cutout", 200, 3000),
    host("tracer.isect.closest", 300, 2000),
    host("tracer.isect.kernel", 400, 1000),
    host("tracer.packet", 450, 900),
    host("tracer.isect.any", 4000, 6000),
    host("tracer.isect.kernel", 4100, 5000),
    host("tracer.packet", 4200, 4800),
]
RUNTIME = [
    host(WINDOW, 0, 10000),
    host("cudaLaunchKernel", 500, 501, 1),      # in the first packet span
    host("cudaMemsetAsync", 600, 601, 2),       # in the first packet span
    host("cudaStreamSynchronize", 1200, 1300),  # in the closest query
    host("cudaStreamSynchronize", 2100, 2200),  # in the cutout chain
    host("cudaMemcpy", 2500, 2600),             # in the cutout chain
    host("cudaLaunchKernel", 4300, 4301, 3),    # in the second packet span
    host("cudaLaunchKernel", 5500, 5501, 4),    # in the occlusion query
]
DEVICE = [
    dev("packet_closest_kernel", 600, 1100, 1),
    dev("Memset (Device)", 1100, 1150, 2),
    dev("packet_any_kernel", 5000, 5300, 3),
    dev("unsort", 5600, 5700, 4),
]
READERS = ("packet_ms_per_frame.render", "cutout_syncs_per_frame.render")


def _read(name, trace, prof):
    """A reader called as `run_cell` calls it: by a caller that holds the
    run's profiler."""
    assert prof is None or isinstance(prof, torch.profiler.profile)
    return Registry().reader(name)(trace)


def test_readers():
    records = RUNTIME + DEVICE + SPANS
    prof = _fake_profile(records)
    trace = trace_of(records, 2)
    got = {n: _read(n, trace, prof) for n in READERS
           + ("isect_glue_ms_per_frame.render",)}
    assert got == pytest.approx({
        "packet_ms_per_frame.render": 850e-6 / 2,
        "cutout_syncs_per_frame.render": 2 / 2,
        # the packet sweeps are no glue; the unsort is
        "isect_glue_ms_per_frame.render": 100e-6 / 2})


@pytest.mark.parametrize("name", READERS)
def test_readers_silent_without_their_spans(name):
    records = RUNTIME + DEVICE
    assert _read(name, trace_of(records), _fake_profile(records)) is None
    assert _read(name, trace_of(records + SPANS), None) is None
    # the port's spans, but none of the reader's own (a walk-only scene)
    kept = [r for r in SPANS if r.name not in ("tracer.packet",
                                               "tracer.cutout")]
    assert _read(name, trace_of(records + kept),
                 _fake_profile(records + kept)) is None


def test_hall_entries_and_span_names():
    from optixpathtracer_tpu_torch import spans
    reg = Registry()
    cell = reg.cell(CELL)
    assert cell.chips == 1 and cell.config["reduced"] == []
    assert set(READERS) <= {m["name"] for m in cell.per_layer}
    assert "frame_ms_p95" not in {m["name"] for m in cell.end_to_end}
    assert {reg.reader(n).__globals__[k] for n, k in zip(
        READERS, ("PACKET", "CUTOUT"))} == {spans.PACKET, spans.CUTOUT}
    assert not spans.PACKET.startswith("tracer.isect.")
    for name in ("layered.render-1080p", "diffuse.render-1080p"):
        assert not set(READERS) & {m["name"]
                                   for m in reg.cell(name).per_layer}


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_hall_cell_runs_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run on the card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "3000000031", "--seconds", "5", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert r["metrics"]["packet_ms_per_frame.render"]["value"] > 0
        assert r["metrics"]["cutout_syncs_per_frame.render"]["value"] >= 1

"""The Cornell configuration on the CPU: the frozen scene
(`portbench/scenes/cornell.py`) is the port's `scene_cornell` bit for
bit; its cell, cut to a small resolution, runs through `run_cell`, and
the program, on the brute-force and on the dense engine (which takes
every query of the scene on the card), equals the plain reference bit
for bit at every pixel but the knife-edge ones: primary rays that meet a
room edge at one t, where the program's tie rule (the lowest id in BVH
order) and the reference's (the lowest in mesh order) pick different
walls; its bfloat16 control fails; and the reader of the dense sweeps'
time reads the port's span, and nothing without it. The card run skips
without an NVIDIA GPU."""
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
from portbench.scenes import cornell
from test_portbench_program import _fake_profile, dev, host, trace_of
from test_portbench_reference import SEED, runner_after_window

CELL = "cornell.render-2160p"
READER = "dense_ms_per_frame.render"
MESH_ARRAYS = ("positions", "indices", "normals", "uvs")
MATERIAL_FIELDS = ("base_color", "metallic", "roughness", "ior", "mat_type",
                   "albedo_texture", "metal_rough_texture", "normal_texture")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_frozen_cornell_is_the_ports():
    from optixpathtracer_tpu_torch.scene.procedural import scene_cornell
    model, camera, lights = scene_cornell()
    with open(f"{ROOT}/portbench/configs/cornell.json") as f:
        config = json.load(f)
    got = cornell.build(config)
    assert cornell.CPU_CUT == {}
    assert len(got["meshes"]) == len(model.meshes) == 7
    assert sum(len(m["indices"]) for m in got["meshes"]) \
        == config["triangles"] == 34
    for g, w in zip(got["meshes"], model.meshes):
        for k in MESH_ARRAYS:
            assert _same(g[k], getattr(w, k)), k
        for f in MATERIAL_FIELDS:
            assert _same(g["material"].get(f, -1),
                         getattr(w.material, f)), f
    assert got["textures"] == [] and model.textures == []
    assert len(got["lights"]) == len(lights) == 1
    (gp, gc), = got["lights"]
    assert _same(gp, lights[0].position) and _same(gc, lights[0].color)
    for k in ("position", "rotation", "fov_degrees"):
        assert _same(got["camera"][k], getattr(camera, k)), k


def _knife_edge(runner):
    """The pixels of the runner's frame whose primary ray (a pixel centre,
    the same in every frame) meets two or more triangles at one least t,
    where the program's rule (the lowest id in its BVH order) and the
    reference's (the lowest id in mesh order) pick different triangles:
    {(px, py)}. On Cornell's symmetric view these are rays that meet a
    room edge exactly."""
    from optixpathtracer_tpu_torch.camera.camera import generate_rays
    from portbench.reference import intersect as ref_intersect
    from portbench.reference import scene as ref_scene
    w, h = runner.width, runner.height
    ys = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w)
    o, d = generate_rays(*runner.cam, w, h, xs, ys)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    rs = ref_scene.flatten(runner.ctx.desc, o.device)
    r = o.shape[0]
    t, hit = ref_intersect._mt(o, d, rs.tri_v0, rs.tri_e1, rs.tri_e2,
                               torch.zeros(r), torch.full((r,), 100.0))
    t = torch.where(hit, t, float("inf"))
    tied = (t == t.amin(dim=1, keepdim=True)) & hit
    src = runner.scene.tri_src.long()
    position = torch.empty_like(src)
    position[src[src >= 0]] = torch.nonzero(src >= 0)[:, 0]
    out = set()
    for lane in torch.nonzero(tied.sum(dim=1) > 1)[:, 0].tolist():
        ids = torch.nonzero(tied[lane])[:, 0]
        if int(ids[torch.argmin(position[ids])]) != int(ids.min()):
            out.add((lane % w, lane // w))
    return out


def test_cornell_cell_runs_on_the_ports_path(tiny):
    """At the CPU cut the check reads every pixel exact but the knife-edge
    one, pixel (11, 9), whose primary ray meets the ceiling and the green
    wall at one t; one pixel of the 192 is more than `mean_rel_err`
    allows, so the cut reads not correct (on the card's 3840x2160 frame
    117 of 8,294,400 pixels lie on such an edge)."""
    from portbench.harness import port
    cell = tiny.cell(CELL)
    assert (cell.traffic["width"], cell.traffic["height"]) == (16, 12)
    desc = driver.scene_description(cell.config, tiny.folder)
    scene, _ = port.scene_and_camera(desc, torch.device("cpu"))
    assert scene.walk_tris.shape[0] == 1  # one chunk: the dense engine
    options = port.render_options(scene)
    assert not options["use_textures"] and not options["use_alpha_cutout"]
    assert options["active_lobes"] == (0,)
    r = driver.run_cell(cell, tiny, SEED, 0.3, False, torch.device("cpu"),
                        time.perf_counter(), log=lambda m: None)
    assert {"mrays_s", "setup_s"} <= set(r["metrics"])
    assert r["checks"]["bad_pixel_share"]["value"] == pytest.approx(1 / 192)
    assert not r["correct"]


def test_cornell_bfloat16_control_fails(tiny):
    from portbench.calibrate import upper_readings
    cell, runner = runner_after_window(tiny, CELL, units=2)
    runner.check()
    readings = upper_readings(runner, cell.kind)
    correct, checks = driver.verdict(readings["control_bf16"],
                                     cell.workload["limits"])
    assert not correct, checks


@pytest.mark.parametrize("method", ["auto", "pallas"])
def test_cornell_differs_from_the_reference_only_on_the_knife_edge(
        tiny, monkeypatch, method):
    """The cell's frames at the CPU cut, routed as on the CPU ("auto": the
    brute-force engine) and with every query on the dense engine's plain
    sweeps ("pallas"; on the card the router sends it every query of a
    scene of fewer than 8 walk chunks), against the reference's
    accumulation of the same frames at every pixel: equal bit for bit but
    at the pixels whose primary ray ties between triangles that the two
    tie rules order differently."""
    from optixpathtracer_tpu_torch.integrate import path
    from optixpathtracer_tpu_torch.intersect import dense_kernels
    swept = []
    for name in ("closest_plain", "any_plain"):
        real = getattr(dense_kernels, name)

        def counted(*args, real=real, name=name):
            swept.append(name)
            return real(*args)

        monkeypatch.setattr(dense_kernels, name, counted)
    cell = tiny.cell(CELL)
    ctx = driver.Context(torch.device("cpu"), SEED, cell.config,
                         cell.traffic, cell.workload,
                         driver.scene_description(cell.config, tiny.folder))
    runner = cell.kind.make(ctx)
    runner.frame = lambda accum, s: path.render_chunk(
        runner.scene, *runner.cam, runner.width, runner.height, accum, s, 1,
        runner.bounces, method, **runner.options)
    runner.window(driver.UnitClock(ctx.device), lambda n: n < 2)
    px, py = runner.sample_pixels()
    assert px.numel() == runner.width * runner.height
    got = runner.accum[py, px]
    want = runner.reference(px, py, "float32")
    differ = (got != want).any(dim=-1)
    assert {(int(x), int(y)) for x, y in zip(px[differ], py[differ])} \
        == _knife_edge(runner) == {(11, 9)}
    assert torch.equal(got[~differ], want[~differ])
    n = 4 if method == "pallas" else 0
    assert swept.count("closest_plain") == swept.count("any_plain") == n


# A traced frame of one bounce on the dense engine: a closest and an
# occlusion sweep, each inside the kernel span of its query.
SPANS = [
    host("tracer.frame", 100, 9000),
    host("tracer.isect.closest", 300, 2000),
    host("tracer.isect.order", 320, 380),
    host("tracer.isect.kernel", 400, 1000),
    host("tracer.dense", 410, 990),
    host("tracer.isect.unsort", 1100, 1900),
    host("tracer.isect.any", 4000, 6000),
    host("tracer.isect.kernel", 4100, 5000),
    host("tracer.dense", 4110, 4990),
]
RUNTIME = [
    host(WINDOW, 0, 10000),
    host("cudaLaunchKernel", 500, 501, 1),      # in the first dense span
    host("cudaLaunchKernel", 1200, 1201, 2),    # in the hit record
    host("cudaLaunchKernel", 4300, 4301, 3),    # in the second dense span
]
DEVICE = [
    dev("dense_closest_kernel", 600, 1100, 1),
    dev("where", 1300, 1400, 2),
    dev("dense_any_kernel", 5000, 5300, 3),
]


def _read(name, trace, prof):
    """A reader called as `run_cell` calls it: by a caller that holds the
    run's profiler."""
    assert prof is None or isinstance(prof, torch.profiler.profile)
    return Registry().reader(name)(trace)


def test_dense_reader():
    records = RUNTIME + DEVICE + SPANS
    prof = _fake_profile(records)
    trace = trace_of(records, 2)
    got = {n: _read(n, trace, prof) for n in
           (READER, "isect_glue_ms_per_frame.render")}
    assert got == pytest.approx({
        READER: 800e-6 / 2,
        # the dense sweeps are no glue; the hit record is
        "isect_glue_ms_per_frame.render": 100e-6 / 2})


def test_dense_reader_silent_without_its_span():
    records = RUNTIME + DEVICE
    assert _read(READER, trace_of(records), _fake_profile(records)) is None
    assert _read(READER, trace_of(records + SPANS), None) is None
    # the port's spans, but none of the reader's own (a walk scene, or a
    # version of the port without the span)
    kept = [r for r in SPANS if r.name != "tracer.dense"]
    assert _read(READER, trace_of(records + kept),
                 _fake_profile(records + kept)) is None


def test_cornell_entries_and_span_name():
    from optixpathtracer_tpu_torch import spans
    reg = Registry()
    cell = reg.cell(CELL)
    assert cell.chips == 1 and cell.config["reduced"] == []
    assert cell.config["bounces"] == 2 and cell.config["scenes"] == "cornell"
    assert (cell.traffic["width"], cell.traffic["height"]) == (3840, 2160)
    per_layer = {m["name"] for m in cell.per_layer}
    assert READER in per_layer
    assert {"launches_per_frame.render", "isect_ms_per_frame.render",
            "shade_ms_per_frame.render", "device_idle_pct.render",
            "host_syncs_per_frame.render", "sync_idle_ms_per_frame.render",
            "isect_glue_ms_per_frame.render",
            "bsdf_ms_per_frame.render"} <= per_layer
    assert not {"packet_ms_per_frame.render",
                "cutout_syncs_per_frame.render"} & per_layer
    assert {m["name"] for m in cell.end_to_end} == {"mrays_s", "setup_s"}
    assert reg.reader(READER).__globals__["DENSE"] == spans.DENSE
    assert spans.DENSE in spans.NAMES
    assert not spans.DENSE.startswith("tracer.isect.")
    for name in ("layered.render-1080p", "diffuse.render-1080p",
                 "hall.render-1080p"):
        assert READER not in {m["name"] for m in reg.cell(name).per_layer}


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_cornell_cell_runs_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run on the card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "3000000037", "--seconds", "5", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert r["metrics"][READER]["value"] > 0
        assert r["metrics"]["host_syncs_per_frame.render"]["value"] >= 1

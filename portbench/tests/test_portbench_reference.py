"""The plain reference agrees with the port on the CPU at a tiny size, on
the timed path of each cell, and its bfloat16 control does not."""
import time

import numpy as np
import pytest
import torch

from portbench.harness import driver

CELLS = ("layered.render-1080p", "diffuse.render-1080p", "layered.fit-512")
SEED = 3_000_000_019  # above 2**31, as the driver's seeds are


def runner_after_window(registry, name, units=3, seed=SEED):
    cell = registry.cell(name)
    ctx = driver.Context(torch.device("cpu"), seed, cell.config,
                         cell.traffic, cell.workload,
                         driver.scene_description(cell.config,
                                                  registry.folder))
    runner = cell.kind.make(ctx)
    runner.warm_up()
    clock = driver.UnitClock(ctx.device)
    runner.window(clock, lambda n: n < units)
    return cell, runner


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_port(tiny, name):
    cell, runner = runner_after_window(tiny, name)
    numbers = runner.check()
    assert set(numbers) == set(cell.workload["limits"])
    for k, v in numbers.items():
        assert v <= 1e-6, (k, v)


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_fails(tiny, name):
    from portbench.calibrate import upper_readings
    cell, runner = runner_after_window(tiny, name)
    runner.check()
    readings = upper_readings(runner, cell.kind)
    correct, checks = driver.verdict(readings["control_bf16"],
                                     cell.workload["limits"])
    assert not correct, checks


def test_run_cell_end_to_end(tiny):
    name = "diffuse.render-1080p"
    r = driver.run_cell(tiny.cell(name), tiny, SEED, 0.5, False,
                        torch.device("cpu"), time.perf_counter(),
                        log=lambda m: None)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert {"mrays_s", "setup_s"} <= set(r["metrics"])


def test_textured_bfloat16_control_fails(tiny_textured):
    from conftest import TEXTURED_CELL
    from portbench.calibrate import upper_readings
    cell, runner = runner_after_window(tiny_textured, TEXTURED_CELL)
    assert runner.check() == {"bad_pixel_share": 0.0, "mean_rel_err": 0.0}
    readings = upper_readings(runner, cell.kind)
    correct, checks = driver.verdict(readings["control_bf16"],
                                     cell.workload["limits"])
    assert not correct, checks


def _sphere_scene(n_theta=20, n_phi=40, copies=400):
    """A RefScene of one mesh larger than a triangle block: a sphere and,
    after it, copies of its first triangles (exact ties on t)."""
    from portbench.reference import scene as ref_scene
    from portbench.scenes.material_test import uv_sphere
    mesh = uv_sphere(1.0, (0.0, 0.0, 0.0), n_theta, n_phi, dict(
        base_color=np.ones(3, np.float32), metallic=0.0, roughness=0.5,
        ior=1.5, mat_type="diffuse"))
    mesh["indices"] = np.concatenate([mesh["indices"],
                                      mesh["indices"][:copies]])
    desc = dict(meshes=[mesh], lights=[((0.0, 3.0, 0.0), (1.0, 1.0, 1.0))])
    return ref_scene.flatten(desc, torch.device("cpu"))


def test_blocked_intersection_equals_one_block(monkeypatch):
    """Blocks over rays and triangles give the ids and t of the whole
    (ray, triangle) product: the least t, the lowest id on a tie."""
    from portbench.reference import intersect
    sc = _sphere_scene()
    n = sc.tri_v0.shape[0]
    g = torch.Generator().manual_seed(7)
    o = torch.randn((3000, 3), generator=g) * 0.2 + torch.tensor(
        [0.0, 0.0, 3.0])
    d = -o + torch.randn((3000, 3), generator=g) * 0.5
    d = d / d.norm(dim=-1, keepdim=True)
    tmin = torch.zeros(3000)
    tmax = torch.full((3000,), 100.0)
    t, hit = intersect._mt(o, d, sc.tri_v0, sc.tri_e1, sc.tri_e2, tmin,
                           tmax)
    t = torch.where(hit, t, float("inf"))
    want_t = t.amin(dim=1)
    want_id = torch.where(t == want_t[:, None], torch.arange(n),
                          n).amin(dim=1)
    want_id = torch.where(torch.isfinite(want_t), want_id, -1)
    assert n > 2 * 256 and bool((want_id < 400).any())
    monkeypatch.setattr(intersect, "TRIS_PER_BLOCK", 256)
    monkeypatch.setattr(intersect, "PAIRS_PER_BLOCK", 256 * 128)
    got_id, got_t = intersect.closest(sc, o, d, tmin, tmax)
    assert torch.equal(got_id, want_id)
    assert torch.equal(got_t, want_t)
    assert torch.equal(intersect.occluded(sc, o, d, tmin, tmax),
                       torch.isfinite(want_t))


@pytest.mark.parametrize("key", ["metal_rough_texture", "normal_texture"])
def test_reference_raises_on_unshaded_textures(key):
    from portbench.reference import scene as ref_scene
    from portbench.scenes import material_test
    desc = material_test.build({"scene": "diffuse", "segments": [4, 8]})
    desc["textures"] = [np.ones((8, 8, 4), np.float32)]
    desc["meshes"][0]["material"][key] = 0
    with pytest.raises(NotImplementedError):
        ref_scene.flatten(desc, torch.device("cpu"))


@pytest.mark.parametrize("flat", [False, True])
def test_flat_shading_follows_the_program(flat):
    """The reference shades with the geometric normal exactly where the
    program's `scene_flat_shading` has it do so."""
    from optixpathtracer_tpu_torch.scene.flatten import scene_flat_shading
    from portbench.harness import port
    from portbench.reference import scene as ref_scene
    from portbench.scenes import material_test
    desc = material_test.build({"scene": "diffuse", "segments": [4, 8]})
    if flat:
        desc["meshes"] = desc["meshes"][-5:]  # the room's quads alone
    cpu = torch.device("cpu")
    program, _ = port.scene_and_camera(desc, cpu)
    assert scene_flat_shading(program) is flat
    assert ref_scene.flatten(desc, cpu).flat_shading is flat

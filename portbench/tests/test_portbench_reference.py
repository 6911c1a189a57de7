"""The plain reference agrees with the port on the CPU at a tiny size, on
the timed path of each cell, and its bfloat16 control does not."""
import time

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

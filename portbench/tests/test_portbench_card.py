"""One short run of each cell on the card, as the driver runs it (the
card-only path: CUDA events, the allocator's peak, the profiler's device
trace). Skips without an NVIDIA GPU."""
import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

CELLS = ("layered.render-1080p", "diffuse.render-1080p")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run on the card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "3000000029", "--seconds", "5", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]

"""Each fault a cell can have, planted under the timed path, turns
`correct` false: a step that returns its state unchanged, half of the
batch left out (the mean taken over the rest), an answer altered where it
is produced. One card, so no exchange between chips to leave out."""
import dataclasses
import time

import pytest
import torch

from portbench.harness import driver

SEED = 3_000_000_023


def _run(tiny, name, seconds=0.3):
    return driver.run_cell(tiny.cell(name), tiny, SEED, seconds, False,
                           torch.device("cpu"), time.perf_counter(),
                           log=lambda m: None)


def _render_fault(kind, orig):
    def render_chunk(scene, pos, iv, ip, w, h, accum, s, *a, **k):
        if kind == "unchanged":
            time.sleep(0.02)  # as long as a frame, so the window stays short
            return accum
        new = orig(scene, pos, iv, ip, w, h, accum, s, *a, **k)
        if kind == "half":
            new = torch.cat([new[:h // 2], accum[h // 2:]])
        elif kind == "altered":
            new = new.clone()
            new.view(-1, 3)[::16] *= 1.01
        return new
    return render_chunk


@pytest.mark.parametrize("name", ["layered.render-1080p",
                                  "diffuse.render-1080p"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_render_fault_fails(tiny, monkeypatch, name, fault):
    from optixpathtracer_tpu_torch.integrate import path
    assert _run(tiny, name)["correct"]
    monkeypatch.setattr(path, "render_chunk",
                        _render_fault(fault, path.render_chunk))
    r = _run(tiny, name)
    assert not r["correct"] and r["failed"] == r["attempted"], r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fit_fault_fails(tiny, monkeypatch, fault):
    from optixpathtracer_tpu_torch import dist
    orig = dist.material_grad_step

    def step(mesh, scene, cam, target, w, h, frame_id, lr=0.05, **k):
        if fault == "half":  # the first half of the rows, mean over them
            half = dataclasses.replace(mesh, size=2, rank=0)
            new, loss = orig(half, scene, cam, target, w, h, frame_id,
                             lr=2 * lr, **k)
            return new, 2 * loss
        new, loss = orig(mesh, scene, cam, target, w, h, frame_id, lr=lr,
                         **k)
        if fault == "unchanged":
            return scene, loss  # after the step's own time
        return new, loss * 1.01

    assert _run(tiny, "layered.fit-512")["correct"]
    monkeypatch.setattr(dist, "material_grad_step", step)
    r = _run(tiny, "layered.fit-512")
    assert not r["correct"], r["checks"]


def _conductor_as_glossy(shade):
    orig = shade.surface

    def surface(*a, **k):
        seed, pos, ng, frame, wo, mat = orig(*a, **k)
        t = torch.where(mat.mat_type == shade.CONDUCTOR,
                        shade.GLOSSY_DIFFUSE, mat.mat_type)
        return seed, pos, ng, frame, wo, mat._replace(
            mat_type=t.to(torch.int32))
    return surface


@pytest.mark.parametrize("fault", ["ignores_alpha", "drops_albedo_texture",
                                   "conductor_as_glossy"])
def test_reference_fault_fails(tiny_textured, monkeypatch, fault):
    """A reference without one of the features the textured cell uses
    does not pass the program: each feature is checked."""
    from conftest import TEXTURED_CELL
    from portbench.reference import cutout, shade
    assert _run(tiny_textured, TEXTURED_CELL)["correct"]
    if fault == "ignores_alpha":
        monkeypatch.setattr(cutout, "uses_alpha_cutout", lambda s: False)
    elif fault == "drops_albedo_texture":
        monkeypatch.setattr(shade, "albedo_at",
                            lambda scene, mat_id, albedo, *a: albedo)
    else:
        monkeypatch.setattr(shade, "surface", _conductor_as_glossy(shade))
    r = _run(tiny_textured, TEXTURED_CELL)
    assert not r["correct"], r["checks"]

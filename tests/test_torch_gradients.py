"""The port's backward pass (`optixpathtracer_tpu_torch.diff`) against the
JAX package's: `param_gradients` against `jax.grad` of the reference run
op by op (`jax.disable_jit()`, see tests/test_torch_render.py), the
finite-difference checks of tests/test_gradients.py, gradients through
every engine's plain version, and the backward pass under anomaly
detection (tests/test_sanitize.py's debug-NaN check).

Tolerance: rtol 1e-4 with atol 1e-6 x max|g_ref| per field. Both sides
run the same per-lane arithmetic; what remains is the order in which the
backward passes sum the lanes' contributions into the material table."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.diff import param_gradients as jparam_gradients
from optixpathtracer_tpu.integrate import path as jpath
from optixpathtracer_tpu.scene import flatten_model as jflatten
from optixpathtracer_tpu.scene.procedural import PRESETS as JPRESETS
from optixpathtracer_tpu.scene.procedural import \
    scene_material_test as jmaterial_test
from optixpathtracer_tpu_torch.diff import (DIFF_FIELDS, finite_difference,
                                            param_gradients)
from optixpathtracer_tpu_torch.integrate import path
from optixpathtracer_tpu_torch.scene import flatten_model
from optixpathtracer_tpu_torch.scene.flatten import scene_active_lobes
from optixpathtracer_tpu_torch.scene.procedural import (PRESETS,
                                                        scene_hall,
                                                        scene_material_test)

torch.set_num_threads(1)

# the material scene cut as in tests/test_torch_render_layered.py
SEGMENTS = (6, 12)


@pytest.fixture(scope="module")
def cornell():
    return _scenes("scene3_cornell")


def _scenes(name):
    """(port scene, camera, reference scene, camera) of a preset; the
    material scenes cut as in tests/test_torch_render_layered.py."""
    if name == "scene3_cornell":
        (model, camera, lights), (jmodel, jcamera, jlights) = (
            PRESETS[name](), JPRESETS[name]())
    else:
        (model, camera, lights), (jmodel, jcamera, jlights) = (
            scene_material_test(name, segments=SEGMENTS),
            jmaterial_test(name, segments=SEGMENTS))
    return (flatten_model(model, lights, device="cpu"), camera,
            jflatten(jmodel, jlights), jcamera)


@pytest.mark.parametrize("name,size,bounces,lobes", [
    ("scene3_cornell", 16, 1, "scene"),
    # render_sample's default: every lobe on every lane, so the masked
    # lobes' backward must add no NaN (the torch.where trap that the
    # reference's safe_sqrt / safe_div guard)
    ("scene3_cornell", 16, 2, "all"),
    # tests/test_gradients.py's multi-bounce case: grazing total internal
    # reflection on secondary bounces, roughness and IOR gradients
    ("dielectric", 8, 2, "scene"),
])
def test_param_gradients_match_reference(monkeypatch, name, size, bounces,
                                         lobes):
    """All five DIFF_FIELDS. With lobes="scene" both packages shade with
    the scene's own lobes, as `render` does (their render_loss_fn takes
    render_sample from the path module when called); the reference's op by
    op backward of every lobe costs a minute a case."""
    scene, camera, jscene, jcamera = _scenes(name)
    if lobes == "scene":
        for mod in (path, jpath):
            monkeypatch.setattr(mod, "render_sample", functools.partial(
                mod.render_sample, active_lobes=scene_active_lobes(scene),
                use_textures=False))
    got = param_gradients(scene, camera.raygen_params(size, size,
                                                      device="cpu"),
                          size, size, [0], max_bounces=bounces)
    with jax.disable_jit():
        want = jparam_gradients(jscene, jcamera.raygen_params(size, size),
                                size, size, [0], max_bounces=bounces)
    assert set(got) == set(want) == set(DIFF_FIELDS)
    for field, w in want.items():
        g, w = got[field].numpy(), np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g).all(), field
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max(),
                                   err_msg=field)
    nonzero = (("mat_albedo", "mat_roughness", "mat_ior")
               if name == "dielectric" else ("mat_albedo", "light_color"))
    for field in nonzero:
        assert got[field].abs().max() > 0, field


@pytest.mark.parametrize("field,rtol,atol", [("mat_albedo", 5e-2, 1e-5),
                                             ("light_color", 2e-2, 1e-6)])
def test_gradient_matches_finite_difference(cornell, field, rtol, atol):
    """tests/test_gradients.py's checks: neither albedo nor the light colour
    steers sampling, so the detached gradient equals same-seed central
    differences at the largest entry."""
    scene, camera, _, _ = cornell
    params = camera.raygen_params(16, 16, device="cpu")
    g = param_gradients(scene, params, 16, 16, [0], fields=(field,),
                        max_bounces=1)[field].numpy()
    idx = np.unravel_index(np.abs(g).argmax(), g.shape)
    fd = finite_difference(scene, params, 16, 16, [0], field, idx, h=1e-2,
                           max_bounces=1)
    np.testing.assert_allclose(g[idx], fd, rtol=rtol, atol=atol)


def test_gradients_through_every_engine_equal_brute(cornell):
    """The engines only choose the triangle (detached); the refinement from
    its id is what gets differentiated, so every engine's plain version
    gives brute's gradients bit for bit."""
    scene, camera, _, _ = cornell
    params = camera.raygen_params(16, 16, device="cpu")
    frames = [0, 1]
    want = param_gradients(scene, params, 16, 16, frames, max_bounces=2,
                           intersect_method="brute")
    for method in ("pallas", "walk", "packet"):
        got = param_gradients(scene, params, 16, 16, frames, max_bounces=2,
                              intersect_method=method)
        for field in DIFF_FIELDS:
            assert torch.equal(got[field], want[field]), (method, field)


def test_cutout_gradients_reach_the_outer_material_table():
    """hall at detail 0.1 (10,336 triangles): its alpha-cutout foliage
    lies in a sub-scene with a material table of its own. The cutout
    chains only choose the triangle; the surface reads the outer scene's
    table, so the foliage's gradient lands there, the sub-scene's table
    gets none, and the packet engine's plain version gives brute's
    gradients bit for bit."""
    model, camera, lights = scene_hall(0.1)
    scene = flatten_model(model, lights, device="cpu")
    sub = scene.cutout_sub
    foliage = torch.unique(
        scene.tri_mat[sub.tri_outer_id[sub.tri_valid].long()].long())
    params = camera.raygen_params(16, 16, device="cpu")
    flags = dict(active_lobes=scene_active_lobes(scene),
                 use_alpha_cutout=True)
    grads = []
    for method in ("brute", "packet"):
        albedo = scene.mat_albedo.clone().requires_grad_(True)
        sub_albedo = sub.mat_albedo.clone().requires_grad_(True)
        s = dataclasses.replace(scene, mat_albedo=albedo,
                                cutout_sub=dataclasses.replace(
                                    sub, mat_albedo=sub_albedo))
        img = path.render_sample(s, *params, 16, 16, 0, 2, method, **flags)
        g, g_sub = torch.autograd.grad(img.mean(), [albedo, sub_albedo],
                                       allow_unused=True)
        assert g_sub is None and torch.isfinite(g).all()
        assert g[foliage].abs().sum() > 0
        grads.append(g)
    assert torch.equal(*grads)


def test_gradient_under_anomaly_detection(cornell):
    """Reverse mode must be NaN-free operation by operation, after
    tests/test_sanitize.py::test_gradient_under_debug_nans."""
    scene, camera, _, _ = cornell
    pos, iv, ip = camera.raygen_params(8, 8, device="cpu")
    albedo = scene.mat_albedo.clone().requires_grad_(True)
    with torch.autograd.detect_anomaly():
        img = path.render_sample(dataclasses.replace(scene,
                                                     mat_albedo=albedo),
                                 pos, iv, ip, 8, 8, 0, max_bounces=1)
        (g,) = torch.autograd.grad(img.mean(), albedo)
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_no_graph_without_a_leaf_that_requires_grad(cornell):
    scene, camera, _, _ = cornell
    img = path.render_sample(scene, *camera.raygen_params(8, 8,
                                                          device="cpu"),
                             8, 8, 0, max_bounces=2)
    assert img.grad_fn is None and not img.requires_grad

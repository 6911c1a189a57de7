"""Port parity of the scene layer: the port's flatten_model, and
scene_from_jax applied to the JAX flatten's leaves, each give leaves
exactly equal to the JAX package's flatten_model (walk_tris, walk_node_box,
walk_node_link and walk_sub_box included), on Cornell and on two
multi-chunk README material scenes, `diffuse` and `layered`."""
import dataclasses

import numpy as np
import pytest
import torch

from optixpathtracer_tpu.scene import flatten as jflatten_mod
from optixpathtracer_tpu.scene import flatten_model as jflatten
from optixpathtracer_tpu.scene.procedural import \
    scene_material_test as jmaterial_test
from optixpathtracer_tpu.scene.procedural import PRESETS as JPRESETS
from optixpathtracer_tpu_torch.scene import flatten_model, scene_from_jax
from optixpathtracer_tpu_torch.scene.flatten import (SceneData,
                                                     scene_active_lobes,
                                                     scene_flat_shading,
                                                     scene_uses_textures)
from optixpathtracer_tpu_torch.scene.procedural import (PRESETS,
                                                        scene_material_test)

torch.set_num_threads(1)

# The README material scenes with their spheres cut from (12, 24) to (6, 12)
# segments (~4.3k instead of ~19k triangles, 34 walk chunks) to keep the
# CPU test fast; the full presets run in chip_smoke.py.
DIFFUSE_SEGMENTS = (6, 12)

SCENES = {
    "scene3_cornell": (lambda: JPRESETS["scene3_cornell"](),
                       lambda: PRESETS["scene3_cornell"]()),
    "diffuse_6x12": (lambda: jmaterial_test("diffuse",
                                            segments=DIFFUSE_SEGMENTS),
                     lambda: scene_material_test("diffuse",
                                                 segments=DIFFUSE_SEGMENTS)),
    "layered_6x12": (lambda: jmaterial_test("layered",
                                            segments=DIFFUSE_SEGMENTS),
                     lambda: scene_material_test("layered",
                                                 segments=DIFFUSE_SEGMENTS)),
}


def jax_leaves(jscene):
    return {k: None if v is None else np.asarray(v)
            for k, v in jscene._asdict().items()}


def assert_leaves_equal(scene, want):
    got = scene.leaves()
    fields = [f.name for f in dataclasses.fields(SceneData)
              if f.name != "cache"]
    for k in fields:
        if want[k] is None:
            assert getattr(scene, k) is None, k
            continue
        g = got[k].numpy()
        assert g.dtype == want[k].dtype, (k, g.dtype, want[k].dtype)
        np.testing.assert_array_equal(g, want[k], err_msg=k)


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    jbuild, tbuild = SCENES[request.param]
    model, _, lights = jbuild()
    jscene = jflatten(model, lights)
    facts = (jflatten_mod.scene_active_lobes(jscene),
             jflatten_mod.scene_uses_textures(jscene),
             jflatten_mod.scene_flat_shading(jscene))
    return request.param, jax_leaves(jscene), tbuild, facts


def test_flatten_model_leaves_equal(case):
    _, want, tbuild, _ = case
    model, _, lights = tbuild()
    assert_leaves_equal(flatten_model(model, lights, device="cpu"), want)


def test_scene_from_jax_leaves_equal(case):
    name, want, _, _ = case
    if name != "scene3_cornell":
        assert want["walk_tris"].shape[0] >= 8  # multi-chunk
    scene = scene_from_jax(want, device="cpu")
    assert_leaves_equal(scene, want)
    # .to() copies every tensor and starts an empty cache
    scene.cache["x"] = 1
    moved = scene.to("cpu")
    assert moved.cache == {}
    assert_leaves_equal(moved, want)


def test_scene_static_facts(case):
    name, want, _, facts = case
    scene = scene_from_jax(want, device="cpu")
    got = (scene_active_lobes(scene), scene_uses_textures(scene),
           scene_flat_shading(scene))
    assert got == facts
    assert got[0] == ((3,) if name == "layered_6x12" else (0,))
    assert got[1] is False
    assert got[2] is (name == "scene3_cornell")

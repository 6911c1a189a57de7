"""The README material scenes that need the new lobes, `layered`,
`conductor` and `dielectric`, through the port's `render` against the JAX
package's, by the criterion and with the op-by-op reference explained in
tests/test_torch_render.py. The port runs the walk engine (its plain
version on the CPU), the reference its brute oracle, so the two also hold
the walk engine's hits to the oracle's over whole frames."""
import jax
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.integrate import render as jrender
from optixpathtracer_tpu.scene import flatten_model as jflatten
from optixpathtracer_tpu.scene.procedural import \
    scene_material_test as jmaterial_test
from optixpathtracer_tpu_torch.integrate import path
from optixpathtracer_tpu_torch.intersect import walk_kernels
from optixpathtracer_tpu_torch.scene import flatten_model
from optixpathtracer_tpu_torch.scene.procedural import scene_material_test

from test_torch_render import assert_images_match

torch.set_num_threads(1)

# spheres cut from (12, 24) to (6, 12) segments (~4.3k instead of ~19k
# triangles, 34 walk chunks) to keep the CPU test fast; chip_smoke.py
# renders the presets at 1920x1080
SEGMENTS = (6, 12)


@pytest.mark.parametrize("kind,size,bounces", [
    ("layered", 24, 2),     # scenes/config4_layered.json's 2 bounces
    ("conductor", 16, 2),
    ("dielectric", 16, 2),
])
def test_material_scene_matches_jax(kind, size, bounces):
    model, camera, lights = scene_material_test(kind, segments=SEGMENTS)
    jmodel, jcamera, jlights = jmaterial_test(kind, segments=SEGMENTS)
    with jax.disable_jit():
        want = np.asarray(jrender(jflatten(jmodel, jlights), jcamera, size,
                                  size, spp=1, max_bounces=bounces,
                                  intersect_method="brute"))
    scene = flatten_model(model, lights, device="cpu")
    assert scene.walk_tris.shape[0] >= 8
    before = walk_kernels.candidates_kernel.launches
    img = path.render(scene, camera, size, size, spp=1, max_bounces=bounces,
                      intersect_method="walk").numpy()
    assert walk_kernels.candidates_kernel.launches == before  # plain on CPU
    assert img.mean() > 1e-4  # lit (the glass room is dim)
    assert_images_match(img, want)

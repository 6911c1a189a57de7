"""The `diffuse` README scene through the port's `render` against the JAX
package's, by the criterion and with the op-by-op reference explained in
tests/test_torch_render.py."""
import jax
import numpy as np
import torch

from optixpathtracer_tpu.integrate import render as jrender
from optixpathtracer_tpu.scene import flatten_model as jflatten
from optixpathtracer_tpu.scene.procedural import \
    scene_material_test as jmaterial_test
from optixpathtracer_tpu_torch.integrate import path
from optixpathtracer_tpu_torch.scene import flatten_model
from optixpathtracer_tpu_torch.scene.procedural import scene_material_test

from test_torch_render import assert_images_match

torch.set_num_threads(1)

# spheres cut from (12, 24) to (6, 12) segments (~4.3k instead of ~19k
# triangles) to keep the CPU test fast; chip_smoke.py renders the preset
SEGMENTS = (6, 12)


def test_diffuse_scene_matches_jax():
    """16x16, 1 spp, 3 bounces as in scenes/config1_diffuse.json. The port
    runs the dense engine ("pallas", its plain version on the CPU), the
    reference its brute oracle; four lights exercise the light pick."""
    model, camera, lights = scene_material_test("diffuse", segments=SEGMENTS)
    jmodel, jcamera, jlights = jmaterial_test("diffuse", segments=SEGMENTS)
    with jax.disable_jit():
        want = np.asarray(jrender(jflatten(jmodel, jlights), jcamera, 16, 16,
                                  spp=1, max_bounces=3,
                                  intersect_method="brute"))
    img = path.render(flatten_model(model, lights, device="cpu"), camera,
                      16, 16, spp=1, max_bounces=3,
                      intersect_method="pallas").numpy()
    assert img.mean() > 0.01
    assert_images_match(img, want)

"""A stack of six parallel leaf quads with aligned holes, for the cutout
chain tests on the CPU (tests/test_torch_cutout.py) and on the card
(tests/test_torch_cuda.py). Imports no jax.

Quads Q1..Q6 stand at x = 1..6 (z in [-1, 1], y in [0, 1], facing +x),
their albedo alpha 0 in the band y in [0.25, 0.75) and 1 elsewhere; an
opaque wall stands at x = 0. A coincident pair at x = 8 (z in [2, 4]): one
quad with the band's hole, one whose hole is y < 0.25, so a ray at y = 0.5
meets a hole and a solid leaf at the same t. Rays run along -x from x = 10,
so Qk lies at t = 10 - k and the wall at t = 10.
"""
import numpy as np
import torch

from optixpathtracer_tpu_torch.scene import (Material, Model, PointLight,
                                             Texture)
from optixpathtracer_tpu_torch.scene.procedural import quad

# (y, z, tmin, tmax) of each lane, and what the chain over the six quads
# gives it by hand: the closest hit's t (None: the chain stops nothing),
# whether the occlusion chain blocks it, and the layers it re-traces
# beyond its first
LANES = {
    "all six holes: exhausted at Q2": ((0.5, 0.0, 0.0, 100.0), 8.0, True, 4),
    "solid band of Q6": ((0.1, 0.0, 0.0, 100.0), 4.0, True, 0),
    "from past Q6: exhausted at Q1": ((0.5, 0.0, 4.5, 100.0), 9.0, True, 4),
    "from past Q5: four holes, then out": ((0.5, 0.0, 5.5, 9.5), None,
                                           False, 4),
    "bound before Q2: four holes, then out": ((0.5, 0.0, 0.0, 7.5), None,
                                              False, 4),
    "dead lane": ((0.5, 0.0, 3.0, -1.0), None, False, 0),
    "beside the stack": ((0.5, -3.0, 0.0, 100.0), None, False, 0),
}
TIE_LANE = (0.5, 3.0, 0.0, 100.0)  # the coincident pair, then the wall


def _hole_texture(rows):
    pix = np.ones((64, 64, 4), np.float32)
    pix[rows, :, 3] = 0.0
    return Texture(pixels=pix)


def stack_model():
    """(model, lights): the six quads, the coincident pair and the wall."""
    band = Material(mat_type="diffuse", albedo_texture=0)
    low = Material(mat_type="diffuse", albedo_texture=1)
    meshes = [quad((float(k), 0.0, 1.0), (0.0, 0.0, -2.0), (0.0, 1.0, 0.0),
                   band, f"q{k}") for k in range(1, 7)]
    meshes += [quad((8.0, 0.0, 4.0), (0.0, 0.0, -2.0), (0.0, 1.0, 0.0), m,
                    name) for m, name in ((band, "pair_band"),
                                          (low, "pair_low"))]
    meshes.append(quad((0.0, -1.0, 6.0), (0.0, 0.0, -12.0), (0.0, 3.0, 0.0),
                       Material(mat_type="diffuse"), "wall"))
    return (Model(meshes=meshes, textures=[_hole_texture(slice(16, 48)),
                                           _hole_texture(slice(0, 16))]),
            [PointLight(np.array([12.0, 0.5, 0.0]), np.ones(3))])


def stack_rays(lanes, device):
    """(o, d, tmin, tmax) of lanes given as (y, z, tmin, tmax)."""
    a = torch.tensor(lanes, dtype=torch.float32, device=device)
    o = torch.stack([torch.full_like(a[:, 0], 10.0), a[:, 0], a[:, 1]], 1)
    d = torch.zeros_like(o)
    d[:, 0] = -1.0
    return o, d, a[:, 2].contiguous(), a[:, 3].contiguous()

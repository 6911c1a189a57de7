"""The Cornell box as plain arrays: a frozen copy of
`optixpathtracer_tpu_torch/scene/procedural.py` `scene_cornell`, its front
camera and its light, built with the hall's copies of the port's quad and
box helpers. The reference renderer's Scene3 (`main.cpp:33-42`) loads a
Cornell glTF that is not shipped, so this is the procedural stand-in both
packages build: a 2 m room of five diffuse quads (white floor, ceiling and
back wall, a green and a red side wall) with a short and a tall white
box, 34 triangles in one 128-triangle chunk, lit by one unit point light
under the ceiling. Kept here so that a later change to the port's preset
cannot move the benchmark's inputs.

`build(config)` returns the plain scene description (see
`portbench/scenes/material_test.py`); the scene takes no keys of the
configuration. It is already tiny, so `CPU_CUT` cuts nothing: the CPU
tests cut only the resolution they render at.
"""
from __future__ import annotations

import numpy as np

from portbench.scenes.hall import (_material, blender_to_engine_position,
                                   blender_to_engine_rotation, box, quad)

CPU_CUT = {}

# the front camera and the light, Blender convention (procedural.py
# _CAM_FRONT, scene_cornell)
CAM_BLENDER_POS = (3.85382, 0.0, 1.0)
CAM_BLENDER_ROT = (90.0, 0.0, 90.0)
FOV_DEGREES = 40.0
LIGHT_BLENDER_POS = (0.0, 0.0, 1.69221)
LIGHT_COLOR = (1.0, 1.0, 1.0)


def build(config):
    """The plain scene description of the Cornell box (procedural.py
    scene_cornell)."""
    white = _material((0.73, 0.73, 0.73), "diffuse")
    red = _material((0.65, 0.05, 0.05), "diffuse")
    green = _material((0.12, 0.45, 0.15), "diffuse")
    s = 1.0  # half extent; the room is 2 x 2 x 2 around (0, 1, 0)
    meshes = [
        quad((-s, 0, -s), (0, 0, 2 * s), (2 * s, 0, 0), white),  # floor
        quad((-s, 2 * s, -s), (2 * s, 0, 0), (0, 0, 2 * s), white),  # ceil
        quad((-s, 0, -s), (0, 2 * s, 0), (0, 0, 2 * s), white),  # back
        quad((-s, 0, -s), (2 * s, 0, 0), (0, 2 * s, 0), green),  # right
        quad((-s, 0, s), (0, 2 * s, 0), (2 * s, 0, 0), red),  # left
        box((0.3, 0.3, -0.35), 0.3, white),  # short box
        box((-0.35, 0.6, 0.3), (0.3, 0.6, 0.3), white),  # tall box
    ]
    lights = [(blender_to_engine_position(LIGHT_BLENDER_POS),
               np.asarray(LIGHT_COLOR, np.float32))]
    camera = dict(position=blender_to_engine_position(CAM_BLENDER_POS),
                  rotation=blender_to_engine_rotation(CAM_BLENDER_ROT),
                  fov_degrees=FOV_DEGREES)
    return dict(meshes=meshes, lights=lights, camera=camera, textures=[])

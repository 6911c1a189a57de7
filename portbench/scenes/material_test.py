"""The README material-test scene as plain arrays: a frozen copy of the
geometry of `optixpathtracer_tpu_torch/scene/procedural.py`
`scene_material_test` (the reference renderer's Scene1, `main.cpp:6-18`):
a 6 x 6 grid of UV spheres between coloured walls, four point lights and
the front camera. Kept here so that a later change to the port's preset
cannot move the benchmark's inputs.

`build(config)` returns a dict of numpy arrays and numbers only, from the
configuration's keys `scene` (the material kind) and `segments` (the
sphere tessellation); `portbench/harness/port.py` turns it into the
port's Model and Camera, and `portbench/reference/scene.py` flattens it on
its own. The CPU tests cut a configuration by `CPU_CUT`.
"""
from __future__ import annotations

import numpy as np

# GOLDEN_GEO merged with the per-scene GOLDEN_FIT entry, for the two kinds
# the benchmark renders (procedural.py: GOLDEN_GEO, GOLDEN_FIT).
_COMMON = dict(grid_y=1.0, grid_z=0.0)
GEOMETRY = {
    "diffuse": dict(
        _COMMON, radius=0.19942, spacing=0.46339, back_x=-0.00762,
        floor_y=-0.54874, ceil_y=2.5591, sphere_rgb=(0.9744, 0.0032, 0.003),
        back_rgb=(0.5165, 0.5699, 0.5707), green_rgb=(0.0368, 0.8521, 0.0184),
        blue_rgb=(0.0349, 0.0186, 0.8483), wall_rough=0.999,
        light_scale=0.3157),
    "layered": dict(
        _COMMON, radius=0.20147, spacing=0.46289, back_x=0.02013,
        floor_y=-0.47206, ceil_y=2.45594, sphere_rgb=(0.8297, 0.0004, 0.0006),
        back_rgb=(0.3169, 0.3064, 0.3069), green_rgb=(0.0361, 0.4707, 0.0033),
        blue_rgb=(0.0283, 0.003, 0.4733), wall_rough=0.7468,
        light_scale=0.2263),
}
MAT_TYPE = {"diffuse": "diffuse", "layered": "glossy_diffuse"}
CPU_CUT = {"segments": [4, 8]}

# the front camera, Blender convention (procedural.py _CAM_FRONT)
CAM_BLENDER_POS = (3.85382, 0.0, 1.0)
CAM_BLENDER_ROT = (90.0, 0.0, 90.0)
FOV_DEGREES = 40.0
LIGHTS_BLENDER = ((1.33906, -0.7, 0.299367), (1.33906, 0.7, 0.299367),
                  (1.33906, 0.7, 1.69937), (1.33906, -0.7, 1.69937))


def blender_to_engine_position(p):
    """(x, y, z)_blender -> (x, z, -y)_engine (`GlmHelperMethods.cpp:4-6`)."""
    x, y, z = p
    return np.array([x, z, -y], np.float64)


def blender_to_engine_rotation(r):
    """(rx, ry, rz)_blender -> (90-rx, 180+rz, ry) (`GlmHelperMethods.cpp:8-10`)."""
    x, y, z = r
    return np.array([90.0 - x, 180.0 + z, y], np.float64)


def _material(rgb, roughness, mat_type):
    return dict(base_color=np.asarray(rgb, np.float32), metallic=0.0,
                roughness=float(roughness), ior=1.5, mat_type=mat_type)


def uv_sphere(radius, center, n_theta, n_phi, material):
    """Lat-long sphere mesh with smooth normals (procedural.py uv_sphere)."""
    theta = np.linspace(0.0, np.pi, n_theta + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, n_phi + 1)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    normals = pos.copy()
    uvs = np.stack([pp / (2 * np.pi), 1.0 - tt / np.pi],
                   axis=-1).reshape(-1, 2)
    pos = pos * radius + np.asarray(center)

    def vid(i, j):
        return i * (n_phi + 1) + j

    faces = []
    for i in range(n_theta):
        for j in range(n_phi):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            if i > 0:
                faces.append([a, b, c])
            if i < n_theta - 1:
                faces.append([b, d, c])
    return dict(positions=pos.astype(np.float32),
                indices=np.asarray(faces, np.int32),
                normals=normals.astype(np.float32),
                uvs=uvs.astype(np.float32), material=material)


def quad(corner, edge_u, edge_v, material):
    """Two-triangle quad; normal = cross(edge_u, edge_v) (procedural.py quad)."""
    c = np.asarray(corner, np.float64)
    u = np.asarray(edge_u, np.float64)
    v = np.asarray(edge_v, np.float64)
    pos = np.stack([c, c + u, c + u + v, c + v])
    n = np.cross(u, v)
    n = n / np.linalg.norm(n)
    return dict(positions=pos.astype(np.float32),
                indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                normals=np.tile(n, (4, 1)).astype(np.float32),
                uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                material=material)


def build(config: dict) -> dict:
    """The scene of one material kind: {"meshes": [mesh dicts], "lights":
    [(position float64[3], colour float32[3])], "camera": {"position",
    "rotation" (engine-space degrees), "fov_degrees"}}. Each mesh dict has
    positions, indices, normals, uvs and a material dict (base_color,
    metallic, roughness, ior, mat_type)."""
    kind, segments = config["scene"], tuple(config["segments"])
    g = GEOMETRY[kind]
    mat_type = MAT_TYPE[kind]
    meshes = []
    s = g["spacing"]
    for i in range(6):        # rows (y)
        for j in range(6):    # columns; j=0 is screen-left (+z), rough 0
            y = g["grid_y"] + (2.5 - i) * s
            z = g["grid_z"] + (2.5 - j) * s
            meshes.append(uv_sphere(
                g["radius"], (0.0, y, z), segments[0], segments[1],
                _material(g["sphere_rgb"], j / 5.0, mat_type)))

    def wall(rgb):
        return _material(rgb, g["wall_rough"], mat_type)

    bx = g["back_x"]
    zw = 0.535 * (3.854 - bx)
    y0, y1 = g["floor_y"], g["ceil_y"]
    h = y1 - y0
    meshes += [
        quad((bx, y0, -zw), (0, h, 0), (0, 0, 2 * zw), wall(g["back_rgb"])),
        quad((bx, y0, zw), (0, h, 0), (4.854 - 0.354, 0, 0),
             wall(g["green_rgb"])),
        quad((bx, y0, -zw), (4.854 - 0.354, 0, 0), (0, h, 0),
             wall(g["blue_rgb"])),
        quad((bx, y0, -zw), (0, 0, 2 * zw), (4.854 - 0.354, 0, 0),
             wall(g["back_rgb"])),
        quad((bx, y1, -zw), (4.854 - 0.354, 0, 0), (0, 0, 2 * zw),
             wall(g["back_rgb"])),
    ]
    lc = np.full(3, g["light_scale"], np.float32)
    lights = [(blender_to_engine_position(p), lc) for p in LIGHTS_BLENDER]
    camera = dict(position=blender_to_engine_position(CAM_BLENDER_POS),
                  rotation=blender_to_engine_rotation(CAM_BLENDER_ROT),
                  fov_degrees=FOV_DEGREES)
    return dict(meshes=meshes, lights=lights, camera=camera)

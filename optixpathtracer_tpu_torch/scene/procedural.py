"""Procedural geometry and the preset scenes of the port's slice (port of
`optixpathtracer_tpu/scene/procedural.py`, which cannot be imported without
jax: its package `__init__` and its camera import pull jax in).

The code below is the reference's, line for line, so both packages build
the same meshes: the mesh helpers, the Cornell box and the README
material-test scene with its fitted geometry (GOLDEN_GEO, GOLDEN_FIT).
PRESETS holds the presets the port renders so far: Cornell, the README
material scenes and scene1_spheres (the conductor scene). The dragon and
sponza stand-ins (their mesh helpers are not ported yet) and the textured
hall come in later slices.
"""
from __future__ import annotations

import numpy as np

from ..camera import Camera, blender_to_engine_position
from .types import Material, Mesh, Model, PointLight

def uv_sphere(radius=1.0, center=(0, 0, 0), n_theta=32, n_phi=64,
              material=None, name="sphere"):
    """Lat-long sphere mesh with smooth normals."""
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
    return Mesh(positions=pos.astype(np.float32),
                indices=np.asarray(faces, np.int32),
                normals=normals.astype(np.float32),
                uvs=uvs.astype(np.float32),
                material=material or Material(), name=name)


def quad(corner, edge_u, edge_v, material=None, name="quad"):
    """Two-triangle quad; normal = cross(edge_u, edge_v)."""
    c = np.asarray(corner, np.float64)
    u = np.asarray(edge_u, np.float64)
    v = np.asarray(edge_v, np.float64)
    pos = np.stack([c, c + u, c + u + v, c + v])
    n = np.cross(u, v)
    n = n / np.linalg.norm(n)
    normals = np.tile(n, (4, 1))
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return Mesh(positions=pos.astype(np.float32), indices=faces,
                normals=normals.astype(np.float32), uvs=uvs,
                material=material or Material(), name=name)


def box(center, half_extent, material=None, name="box", inward=False):
    """Axis-aligned box from 6 quads; inward=True flips faces (room)."""
    cx, cy, cz = center
    hx, hy, hz = (half_extent, half_extent, half_extent) \
        if np.isscalar(half_extent) else half_extent
    meshes = []
    faces = [
        ((cx - hx, cy - hy, cz - hz), (2 * hx, 0, 0), (0, 2 * hy, 0)),  # back
        ((cx - hx, cy - hy, cz + hz), (0, 2 * hy, 0), (2 * hx, 0, 0)),  # front
        ((cx - hx, cy - hy, cz - hz), (0, 0, 2 * hz), (2 * hx, 0, 0)),  # floor
        ((cx - hx, cy + hy, cz - hz), (2 * hx, 0, 0), (0, 0, 2 * hz)),  # ceil
        ((cx - hx, cy - hy, cz - hz), (0, 2 * hy, 0), (0, 0, 2 * hz)),  # left
        ((cx + hx, cy - hy, cz - hz), (0, 0, 2 * hz), (0, 2 * hy, 0)),  # right
    ]
    all_pos, all_n, all_uv, all_f = [], [], [], []
    base = 0
    for corner, eu, ev in faces:
        if inward:
            eu, ev = ev, eu
        q = quad(corner, eu, ev)
        all_pos.append(q.positions)
        all_n.append(q.normals)
        all_uv.append(q.uvs)
        all_f.append(q.indices + base)
        base += 4
    return Mesh(positions=np.concatenate(all_pos),
                indices=np.concatenate(all_f),
                normals=np.concatenate(all_n),
                uvs=np.concatenate(all_uv),
                material=material or Material(), name=name)


# ---------------------------------------------------------------------------
# The README material-test scene and the Cornell preset (main.cpp:6-42).
# Engine coordinates: x out of monitor, y up, z left (main.cpp:83-84).
# ---------------------------------------------------------------------------

_CAM_FRONT = dict(position=(3.85382, 0.0, 1.0), rotation_degrees=(90.0, 0.0, 90.0))


# Geometry of the reference's material-test scene (Scene1's untitled.gltf,
# not shipped), reconstructed by measurement from the shipped golden renders
# `Images/PNGs/*PBRT.png` of the reference renderer (1920x1080, fovy 40, camera
# Blender (3.85382, 0, 1) rot (90, 0, 90), `main.cpp:10-11`):
#   * 6x6 sphere grid in the x=0 plane centered at (0, 1, 0); measured
#     radius 0.199 +- 0.001 -> 0.2, center spacing 0.463.
#   * roughness varies per COLUMN 0..1 left->right (left column is the
#     mirror/clear one in conductor/dielectric20 goldens); screen-left = +z.
#   * grey back wall (sphere shadows visible), green wall screen-left,
#     blue wall screen-right; wall-corner edge at px 166.5 of 1920 ->
#     z_wall = 0.535 * (3.854 - back_x).
#   * all five goldens share this one scene; only the BSDF dispatch differs
#     (`devicePrograms.cu:303-341` comment-toggles), so the wall materials
#     change type with the spheres (glass walls explain the near-black
#     dielectric golden). dielectric20 = same scene with brighter lights.
# The free parameters below (albedos, wall distances, light scale) were then
# fitted by minimizing MSE against the goldens (benchmarks/accuracy.py).
GOLDEN_GEO = dict(
    radius=0.2, spacing=0.4627, back_x=-0.5, floor_y=-1.2, ceil_y=3.2,
    # sphere-grid center (world y / z) - a free parameter of the
    # reconstruction: the round-5 1080p comparison showed a vertical
    # framing offset vs the goldens with the grid pinned at (1.0, 0.0)
    grid_y=1.0, grid_z=0.0,
    # Albedos from the round-4 Adam fit (benchmarks/fit_goldens.py, 300
    # steps against the diffuse golden - the dispatch under which albedo
    # is most identifiable; the reference renders all five goldens from
    # ONE asset, so the fitted values are shared). The r2
    # coordinate-descent values sat in a dark local minimum (walls 0.12);
    # the gradient fit brightened them to 0.64-0.70 and cut diffuse
    # golden MSE 1.60e-2 -> 2.78e-3 at 240x135/64spp.
    sphere_rgb=(0.3807, 0.0013, 0.0012), back_rgb=(0.7013, 0.6406, 0.6409),
    green_rgb=(0.0084, 0.4879, 0.0081), blue_rgb=(0.0082, 0.0079, 0.486),
    # light scale for the dielectric20 golden, line-searched r4 (MSE
    # 1.115e-2 at 20 -> 9.86e-3 at 8; flat below 12, so the residual is
    # geometric, not radiometric)
    wall_rough=1.0, dielectric20_light=8.0,
)


# Per-scene fitted overrides from the round-5 full-parameter fit
# (benchmarks/fit_goldens.py: analytic Adam on materials + common-random-
# numbers FD on the silhouette geometry, per scene against ITS OWN
# golden). Merged over GOLDEN_GEO by scene_material_test; explicit `geo`
# arguments still win. Camera/light positions stay at the reference's
# exact published values (`main.cpp:10-17`).
GOLDEN_FIT: dict = {
    "diffuse": {
        "radius": 0.19942, "spacing": 0.46339, "back_x": -0.00762,
        "floor_y": -0.54874, "ceil_y": 2.5591,
        "sphere_rgb": (0.9744, 0.0032, 0.003),
        "back_rgb": (0.5165, 0.5699, 0.5707),
        "green_rgb": (0.0368, 0.8521, 0.0184),
        "blue_rgb": (0.0349, 0.0186, 0.8483),
        "wall_rough": 0.999, "light_scale": 0.3157,
    },
    "conductor": {
        "radius": 0.20086, "spacing": 0.46462, "back_x": 0.02272,
        "floor_y": -0.34342, "ceil_y": 2.33651,
        "sphere_rgb": (0.5874, 0.0003, 0.0002),
        "back_rgb": (0.3367, 0.2913, 0.2917),
        "green_rgb": (0.0326, 0.5936, 0.0109),
        "blue_rgb": (0.0256, 0.011, 0.5942),
        "wall_rough": 0.9998, "light_scale": 0.2986,
    },
    "dielectric": {
        "radius": 0.13299, "spacing": 0.53032, "back_x": 0.13168,
        "floor_y": -0.39872, "ceil_y": 2.40909,
        "sphere_rgb": (0.1592, 0.1052, 0.1051),
        "back_rgb": (0.4209, 0.4203, 0.4201),
        "green_rgb": (0.1902, 0.1927, 0.1897),
        "blue_rgb": (0.1913, 0.1906, 0.1935),
        "wall_rough": 0.9996, "light_scale": 0.4203,
    },
    "dielectric20": {
        "radius": 0.13602, "spacing": 0.5308, "back_x": 0.16058,
        "floor_y": -0.42982, "ceil_y": 2.48218,
        "sphere_rgb": (0.1807, 0.1845, 0.1836),
        "back_rgb": (0.1959, 0.1958, 0.1948),
        "green_rgb": (0.1465, 0.1464, 0.1464),
        "blue_rgb": (0.1487, 0.1486, 0.1484),
        "wall_rough": 0.9999, "light_scale": 15.3819,
    },
    "layered": {
        "radius": 0.20147, "spacing": 0.46289, "back_x": 0.02013,
        "floor_y": -0.47206, "ceil_y": 2.45594,
        "sphere_rgb": (0.8297, 0.0004, 0.0006),
        "back_rgb": (0.3169, 0.3064, 0.3069),
        "green_rgb": (0.0361, 0.4707, 0.0033),
        "blue_rgb": (0.0283, 0.003, 0.4733),
        "wall_rough": 0.7468, "light_scale": 0.2263,
    },
}


def scene_material_test(material_kind: str, geo: dict = None,
                        segments=(12, 24)):
    """One of the five README scenes (reference Scene1 + BSDF dispatch
    toggle): a 6x6 roughness-graded sphere grid between colored walls, four
    point lights (`main.cpp:6-18`). `material_kind` applies to every
    surface, as the reference's global dispatch toggle did.

    `segments` is the per-sphere (n_theta, n_phi) tessellation: the default
    (12, 24) keeps CPU tests tractable (~20k tris); accuracy eval renders
    use (24, 48) (~80k tris) for clean silhouettes at 1920x1080.

    Fitted per-scene overrides (GOLDEN_FIT) may add camera/light keys:
    cam_pos/cam_rot (engine-space), fov, light_dpos [L,3], light_scale."""
    g = dict(GOLDEN_GEO)
    g.update(GOLDEN_FIT.get(material_kind, {}))
    if geo:
        g.update(geo)
    kind = material_kind
    light_scale = 1.0
    if kind == "dielectric20":
        kind = "dielectric"
        light_scale = g["dielectric20_light"]
    mat_type = {"diffuse": "diffuse", "conductor": "conductor",
                "dielectric": "dielectric",
                "layered": "glossy_diffuse"}[kind]

    sphere_rgb = np.asarray(g["sphere_rgb"], np.float32)

    meshes = []
    s = g["spacing"]
    for i in range(6):        # rows (y)
        for j in range(6):    # columns; j=0 is screen-left (+z), rough 0
            rough = j / 5.0
            y = g["grid_y"] + (2.5 - i) * s
            z = g["grid_z"] + (2.5 - j) * s
            mat = Material(base_color=sphere_rgb, roughness=rough,
                           metallic=1.0 if mat_type == "conductor" else 0.0,
                           mat_type=mat_type)
            meshes.append(uv_sphere(g["radius"], (0.0, y, z), segments[0],
                                    segments[1], mat,
                                    name=f"sphere_{i}_{j}"))

    def wall_mat(rgb):
        return Material(base_color=np.asarray(rgb, np.float32),
                        roughness=g["wall_rough"],
                        metallic=1.0 if mat_type == "conductor" else 0.0,
                        mat_type=mat_type)

    bx = g["back_x"]
    zw = 0.535 * (3.854 - bx)
    y0, y1 = g["floor_y"], g["ceil_y"]
    h = y1 - y0
    # back wall (+x normal), side walls facing inward, floor + ceiling
    meshes += [
        quad((bx, y0, -zw), (0, h, 0), (0, 0, 2 * zw),
             wall_mat(g["back_rgb"]), "wall_back"),
        quad((bx, y0, zw), (0, h, 0), (4.854 - 0.354, 0, 0),
             wall_mat(g["green_rgb"]), "wall_green"),   # screen-left, -z nrm
        quad((bx, y0, -zw), (4.854 - 0.354, 0, 0), (0, h, 0),
             wall_mat(g["blue_rgb"]), "wall_blue"),     # screen-right, +z nrm
        quad((bx, y0, -zw), (0, 0, 2 * zw), (4.854 - 0.354, 0, 0),
             wall_mat(g["back_rgb"]), "floor"),
        quad((bx, y1, -zw), (4.854 - 0.354, 0, 0), (0, 0, 2 * zw),
             wall_mat(g["back_rgb"]), "ceiling"),
    ]

    model = Model(meshes=meshes)
    if "cam_pos" in g:
        camera = Camera(position=np.asarray(g["cam_pos"], np.float64),
                        rotation=np.asarray(g["cam_rot"], np.float64),
                        fov_degrees=float(g.get("fov", 40.0)))
    else:
        camera = Camera.from_blender(**_CAM_FRONT)
    lc = np.full(3, g.get("light_scale", light_scale), np.float32)
    base_lp = [
        blender_to_engine_position((1.33906, -0.7, 0.299367)),
        blender_to_engine_position((1.33906, 0.7, 0.299367)),
        blender_to_engine_position((1.33906, 0.7, 1.69937)),
        blender_to_engine_position((1.33906, -0.7, 1.69937)),
    ]
    dpos = np.asarray(g.get("light_dpos", np.zeros((4, 3))), np.float64)
    lights = [PointLight(p + dpos[i], lc) for i, p in enumerate(base_lp)]
    return model, camera, lights


def scene_cornell():
    """Cornell-style diffuse box (reference Scene3, `main.cpp:33-42`)."""
    white = Material(base_color=np.array([0.73, 0.73, 0.73], np.float32),
                     mat_type="diffuse")
    red = Material(base_color=np.array([0.65, 0.05, 0.05], np.float32),
                   mat_type="diffuse")
    green = Material(base_color=np.array([0.12, 0.45, 0.15], np.float32),
                     mat_type="diffuse")
    s = 1.0  # half extent; room is 2x2x2 centered (0, 1, 0)
    meshes = [
        quad((-s, 0, -s), (0, 0, 2 * s), (2 * s, 0, 0), white, "floor"),
        quad((-s, 2 * s, -s), (2 * s, 0, 0), (0, 0, 2 * s), white, "ceiling"),
        quad((-s, 0, -s), (0, 2 * s, 0), (0, 0, 2 * s), white, "back"),
        quad((-s, 0, -s), (2 * s, 0, 0), (0, 2 * s, 0), green, "right"),
        quad((-s, 0, s), (0, 2 * s, 0), (2 * s, 0, 0), red, "left"),
        box((0.3, 0.3, -0.35), 0.3, white, "short_box"),
        box((-0.35, 0.6, 0.3), (0.3, 0.6, 0.3), white, "tall_box"),
    ]
    camera = Camera.from_blender(**_CAM_FRONT)
    lights = [PointLight(blender_to_engine_position((0, 0, 1.69221)),
                         np.ones(3, np.float32))]
    return Model(meshes=meshes), camera, lights


PRESETS = {
    # reference main.cpp Scene1 and Scene3 (the bench headline)
    "scene1_spheres": lambda: scene_material_test("conductor"),
    "scene3_cornell": scene_cornell,
    # the README material scenes (scenes/config*.json)
    "conductor": lambda: scene_material_test("conductor"),
    "diffuse": lambda: scene_material_test("diffuse"),
    "dielectric": lambda: scene_material_test("dielectric"),
    "dielectric20": lambda: scene_material_test("dielectric20"),
    "layered": lambda: scene_material_test("layered"),
}

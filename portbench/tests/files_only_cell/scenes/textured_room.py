"""A small textured room for the benchmark's CPU tests: one sphere of each
material type (conductor, dielectric, glossy-diffuse, metallic-mix) in a
diffuse room whose back wall and floor carry a checker albedo texture,
behind two leaf screens whose albedo texture has alpha holes. The camera
looks through the screens, and the screens stand between the spheres and
the lights, so both camera and shadow rays cross the holes. The two
textures have different sizes, neither the program's texture resolution.

`build(config)` reads the configuration's key `segments` (the spheres'
tessellation); `CPU_CUT` leaves it as it is: the scene is small already.
"""
from __future__ import annotations

import numpy as np

CPU_CUT = {}


def _material(rgb, mat_type, roughness=0.5, metallic=0.0, ior=1.5,
              albedo_texture=-1):
    return dict(base_color=np.asarray(rgb, np.float32), metallic=metallic,
                roughness=roughness, ior=ior, mat_type=mat_type,
                albedo_texture=albedo_texture)


def uv_sphere(radius, center, n_theta, n_phi, material):
    """Lat-long sphere with smooth normals."""
    theta = np.linspace(0.0, np.pi, n_theta + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, n_phi + 1)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    pos = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                    np.sin(tt) * np.sin(pp)], axis=-1).reshape(-1, 3)
    uvs = np.stack([pp / (2 * np.pi), 1.0 - tt / np.pi],
                   axis=-1).reshape(-1, 2)
    faces = []
    for i in range(n_theta):
        for j in range(n_phi):
            a, b = i * (n_phi + 1) + j, i * (n_phi + 1) + j + 1
            c, d = a + n_phi + 1, b + n_phi + 1
            if i > 0:
                faces.append([a, b, c])
            if i < n_theta - 1:
                faces.append([b, d, c])
    return dict(positions=(pos * radius + np.asarray(center))
                .astype(np.float32),
                indices=np.asarray(faces, np.int32),
                normals=pos.astype(np.float32), uvs=uvs.astype(np.float32),
                material=material)


def quad(corner, edge_u, edge_v, material, uv_scale=None):
    """Two triangles with no normals (the geometric normal is taken), and
    uvs scaled by uv_scale, or none."""
    c = np.asarray(corner, np.float64)
    u = np.asarray(edge_u, np.float64)
    v = np.asarray(edge_v, np.float64)
    pos = np.stack([c, c + u, c + u + v, c + v])
    uvs = None if uv_scale is None else np.array(
        [[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * uv_scale
    return dict(positions=pos.astype(np.float32),
                indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                normals=None, uvs=uvs, material=material)


def checker(h=32, w=32, tiles=4):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    odd = ((xx * tiles // w) + (yy * tiles // h)) % 2
    rgb = np.where(odd[..., None], np.float32([0.3, 0.35, 0.8]),
                   np.float32([0.9, 0.85, 0.6]))
    return np.concatenate([rgb, np.ones((h, w, 1))], -1).astype(np.float32)


def leaves(h=24, w=40):
    """Green leaves of alpha 1 on alpha 0, about a third of the texels."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    alpha = ((np.sin(7.0 * xx + 2.0 * yy) * np.cos(5.0 * yy - xx)) > 0.2)
    rgb = np.stack([0.1 + 0.2 * alpha, 0.4 + 0.3 * alpha,
                    0.1 + 0.0 * alpha], axis=-1)
    return np.concatenate([rgb, alpha[..., None]], -1).astype(np.float32)


def build(config: dict) -> dict:
    """The plain scene description (see `portbench/scenes/material_test.py`)
    with `textures`: raw [H, W, 4] float32 arrays, and texture indices in
    the materials."""
    n_theta, n_phi = config["segments"]
    CHECKER, LEAVES = 0, 1
    wall = _material((0.7, 0.7, 0.7), "diffuse", roughness=1.0)
    textured = _material((1.0, 1.0, 1.0), "diffuse", roughness=1.0,
                         albedo_texture=CHECKER)
    screen = _material((1.0, 1.0, 1.0), "diffuse", roughness=1.0,
                       albedo_texture=LEAVES)
    spheres = [
        ((0.5, 0.35, 0.65), _material((0.95, 0.7, 0.4), "conductor",
                                      roughness=0.3, metallic=1.0)),
        ((0.5, 0.35, -0.65), _material((1.0, 1.0, 1.0), "dielectric",
                                       roughness=0.0)),
        ((0.5, 1.45, 0.65), _material((0.8, 0.2, 0.2), "glossy_diffuse",
                                      roughness=0.4)),
        ((0.5, 1.45, -0.65), _material((0.5, 0.3, 0.2), "metallic_mix",
                                       roughness=0.35, metallic=0.5)),
    ]
    meshes = [uv_sphere(0.3, c, n_theta, n_phi, m) for c, m in spheres]
    x0, x1, y0, y1, z = -0.2, 4.0, -0.3, 2.4, 1.6
    meshes += [
        quad((x0, y0, -z), (0, y1 - y0, 0), (0, 0, 2 * z), textured, 3.0),
        quad((x0, y0, -z), (0, 0, 2 * z), (x1 - x0, 0, 0), textured, 4.0),
        quad((x0, y1, -z), (x1 - x0, 0, 0), (0, 0, 2 * z), wall),
        quad((x0, y0, z), (0, y1 - y0, 0), (x1 - x0, 0, 0), wall),
        quad((x0, y0, -z), (x1 - x0, 0, 0), (0, y1 - y0, 0), wall),
        # two leaf screens between the spheres and the lights and camera
        quad((1.0, y0, -z), (0, 0, 2 * z), (0, y1 - y0, 0), screen, 2.0),
        quad((1.15, y0, -z), (0, 0, 2 * z), (0, y1 - y0, 0), screen, 1.3),
    ]
    lights = [(np.array([1.6, 1.7, 0.7]), np.full(3, 1.2, np.float32)),
              (np.array([1.6, 0.3, -0.7]), np.full(3, 0.8, np.float32))]
    camera = dict(position=np.array([3.85, 1.0, 0.0]),
                  rotation=np.array([0.0, 270.0, 0.0]), fov_degrees=40.0)
    return dict(meshes=meshes, lights=lights, camera=camera,
                textures=[checker(), leaves()])

"""The textured hall as plain arrays: a frozen copy of
`optixpathtracer_tpu_torch/scene/procedural.py` `scene_hall`, with its
mesh and texture helpers, its camera and its three lights. The reference
renderer's flagship Scene2/Scene6 loads the Sponza atrium
(`main.cpp:21-30,69-78`); its glTF asset is not shipped, so the hall is a
procedural stand-in at Sponza's scale: a 24 m x 8 m x 12 m shell with a
checker-textured floor, two colonnades of fluted marble-textured
glossy-diffuse columns with capitals, four high-tessellation conductor
statues, a dielectric and a metallic-mix sphere, and foliage quads whose
leaf texture has alpha holes. At detail 1.0: 338,270 triangles in 70
meshes. Kept here so that a later change to the port's preset cannot move
the benchmark's inputs.

`build(config)` returns the plain scene description (see
`portbench/scenes/material_test.py`) with `textures`, raw [H, W, 4]
float32 arrays, from the configuration's key `detail`, the tessellation
scale. The CPU tests cut a configuration by `CPU_CUT`: at detail 0.1 the
hall has 10,334 triangles, and the foliage still cuts.
"""
from __future__ import annotations

import numpy as np

CPU_CUT = {"detail": 0.1}

# the camera, Blender convention, and the lights in engine space
CAM_BLENDER_POS = (10.5, -0.4, 2.2)
CAM_BLENDER_ROT = (88.0, 0.0, 96.0)
FOV_DEGREES = 40.0
LIGHTS = (((0.0, 7.0, 0.0), 60.0), ((9.0, 5.0, 3.0), 30.0),
          ((-9.0, 5.0, -3.0), 30.0))


def blender_to_engine_position(p):
    """(x, y, z)_blender -> (x, z, -y)_engine (`GlmHelperMethods.cpp:4-6`)."""
    x, y, z = p
    return np.array([x, z, -y], np.float64)


def blender_to_engine_rotation(r):
    """(rx, ry, rz)_blender -> (90-rx, 180+rz, ry) (`GlmHelperMethods.cpp:8-10`)."""
    x, y, z = r
    return np.array([90.0 - x, 180.0 + z, y], np.float64)


def _material(rgb, mat_type, roughness=1.0, metallic=0.0, albedo_texture=-1):
    return dict(base_color=np.asarray(rgb, np.float32), metallic=metallic,
                roughness=roughness, ior=1.5, mat_type=mat_type,
                albedo_texture=albedo_texture)


def _mesh(pos, faces, normals, uvs, material):
    return dict(positions=pos.astype(np.float32),
                indices=np.asarray(faces, np.int32),
                normals=normals.astype(np.float32),
                uvs=uvs.astype(np.float32), material=material)


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
    return _mesh(pos, faces, normals, uvs, material)


def quad(corner, edge_u, edge_v, material=None):
    """Two-triangle quad; normal = cross(edge_u, edge_v) (procedural.py
    quad)."""
    c = np.asarray(corner, np.float64)
    u = np.asarray(edge_u, np.float64)
    v = np.asarray(edge_v, np.float64)
    pos = np.stack([c, c + u, c + u + v, c + v])
    n = np.cross(u, v)
    n = n / np.linalg.norm(n)
    return _mesh(pos, [[0, 1, 2], [0, 2, 3]], np.tile(n, (4, 1)),
                 np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                 material)


def box(center, half_extent, material, inward=False):
    """Axis-aligned box from 6 quads; inward=True flips faces (procedural.py
    box)."""
    cx, cy, cz = center
    hx, hy, hz = (half_extent, half_extent, half_extent) \
        if np.isscalar(half_extent) else half_extent
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
        all_pos.append(q["positions"])
        all_n.append(q["normals"])
        all_uv.append(q["uvs"])
        all_f.append(q["indices"] + base)
        base += 4
    return dict(positions=np.concatenate(all_pos),
                indices=np.concatenate(all_f),
                normals=np.concatenate(all_n),
                uvs=np.concatenate(all_uv), material=material)


def bumpy_sphere(radius, center, material, n_theta, n_phi, bump, freq):
    """Displaced sphere with face-averaged normals (procedural.py
    bumpy_sphere)."""
    mesh = uv_sphere(1.0, (0, 0, 0), n_theta, n_phi, material)
    p = mesh["positions"].astype(np.float64)
    disp = 1.0 + bump * (np.sin(freq * p[:, 0]) * np.sin(freq * p[:, 1])
                         * np.sin(freq * p[:, 2]))
    newp = p * disp[:, None] * radius + np.asarray(center)
    mesh["positions"] = newp.astype(np.float32)
    n = np.zeros_like(newp)
    f = mesh["indices"].astype(np.int64)
    fn = np.cross(newp[f[:, 1]] - newp[f[:, 0]], newp[f[:, 2]] - newp[f[:, 0]])
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    mesh["normals"] = n.astype(np.float32)
    return mesh


def cylinder(radius, height, center, n_phi, n_y, material, flutes,
             flute_depth):
    """Open-ended vertical cylinder with smooth normals and cosine fluting
    (procedural.py cylinder)."""
    phi = np.linspace(0.0, 2.0 * np.pi, n_phi + 1)
    ys = np.linspace(0.0, height, n_y + 1)
    pp, yy = np.meshgrid(phi, ys, indexing="ij")
    r = radius * (1.0 + (flute_depth * np.cos(flutes * pp) if flutes else 0.0))
    x = r * np.cos(pp)
    z = r * np.sin(pp)
    pos = np.stack([x, yy, z], axis=-1).reshape(-1, 3)
    nrm = np.stack([np.cos(pp), np.zeros_like(yy), np.sin(pp)],
                   axis=-1).reshape(-1, 3)
    uvs = np.stack([pp / (2 * np.pi), yy / height], axis=-1).reshape(-1, 2)
    pos = pos + np.asarray(center)

    def vid(i, j):
        return i * (n_y + 1) + j

    faces = []
    for i in range(n_phi):
        for j in range(n_y):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i, j + 1), vid(i + 1, j + 1)
            faces.append([a, c, b])
            faces.append([b, c, d])
    return _mesh(pos, faces, nrm, uvs, material)


def checker_texture(res=256, c0=(0.85, 0.82, 0.78), c1=(0.35, 0.32, 0.3),
                    tiles=8):
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    mask = ((xx * tiles // res) + (yy * tiles // res)) % 2
    px = np.where(mask[..., None], np.asarray(c1, np.float32),
                  np.asarray(c0, np.float32))
    rgba = np.concatenate([px, np.ones((res, res, 1), np.float32)], axis=-1)
    return rgba.astype(np.float32)


def marble_texture(res=256, seed=7):
    """Band-limited value-noise marble, sRGB-encoded like file textures."""
    rng = np.random.default_rng(seed)
    acc = np.zeros((res, res), np.float64)
    for octave in range(4):
        k = 4 << octave
        coarse = rng.standard_normal((k, k))
        ups = np.kron(coarse, np.ones((res // k, res // k)))
        acc += ups / (1 << octave)
    yy = np.linspace(0, 6 * np.pi, res)[:, None]
    veins = 0.5 + 0.5 * np.sin(yy + 2.5 * acc)
    rgb = (0.55 + 0.4 * veins)[..., None] * np.array([1.0, 0.97, 0.92])
    rgba = np.concatenate([rgb, np.ones((res, res, 1))], axis=-1)
    return np.clip(rgba, 0, 1).astype(np.float32)


def leaf_texture(res=128):
    """RGBA leaf clusters with alpha-cutout holes (`devicePrograms.cu:518-561`)."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, res), np.linspace(-1, 1, res),
                         indexing="ij")
    alpha = np.zeros((res, res))
    rng = np.random.default_rng(3)
    for _ in range(24):
        cx, cy = rng.uniform(-0.8, 0.8, 2)
        rx, ry = rng.uniform(0.08, 0.22, 2)
        ang = rng.uniform(0, np.pi)
        xr = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
        yr = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
        alpha = np.maximum(alpha, ((xr / rx) ** 2 + (yr / ry) ** 2) < 1.0)
    green = np.stack([0.1 + 0.15 * alpha, 0.35 + 0.3 * alpha,
                      0.08 + 0.05 * alpha], axis=-1)
    rgba = np.concatenate([green, alpha[..., None]], axis=-1)
    return rgba.astype(np.float32)


def build(config: dict) -> dict:
    """The hall at the configuration's `detail`: {"meshes", "lights",
    "camera", "textures"} as `portbench/scenes/material_test.py` describes
    them, with texture indices in the materials."""
    d = float(config["detail"])
    textures = [checker_texture(), marble_texture(), leaf_texture()]
    CHECKER, MARBLE, LEAF = 0, 1, 2

    floor_mat = _material(np.ones(3), "diffuse", roughness=0.85,
                          albedo_texture=CHECKER)
    wall_mat = _material((0.6, 0.55, 0.48), "diffuse", roughness=0.9)
    col_mat = _material(np.ones(3), "glossy_diffuse", roughness=0.25,
                        albedo_texture=MARBLE)
    statue_mat = _material((0.95, 0.78, 0.45), "conductor", roughness=0.2,
                           metallic=1.0)
    glass_mat = _material(np.ones(3), "dielectric", roughness=0.0)
    mix_mat = _material((0.55, 0.2, 0.15), "metallic_mix", roughness=0.45,
                        metallic=0.4)
    leaf_mat = _material(np.ones(3), "diffuse", roughness=1.0,
                         albedo_texture=LEAF)

    meshes = []
    # hall shell: 24m x 8m x 12m, inward-facing; separate textured floor
    meshes.append(box((0.0, 4.0, 0.0), (12.0, 4.0, 6.0), wall_mat,
                      inward=True))
    fl = quad((-12.0, 0.01, -6.0), (0, 0, 12.0), (24.0, 0, 0), floor_mat)
    fl["uvs"] = fl["uvs"] * 8.0  # tile the checker
    meshes.append(fl)

    # two colonnades of fluted columns with sphere capitals
    n_phi = max(24, int(96 * d))
    n_y = max(4, int(32 * d))
    seg_t = max(8, int(36 * d))
    for i in range(-3, 4):
        for zs in (-3.0, 3.0):
            cx = i * 3.0
            meshes.append(cylinder(0.32, 3.2, (cx, 0.0, zs), n_phi, n_y,
                                   col_mat, flutes=20, flute_depth=0.06))
            meshes.append(uv_sphere(0.42, (cx, 3.45, zs), seg_t, 2 * seg_t,
                                    col_mat))
            meshes.append(box((cx, 3.8, zs), (0.45, 0.12, 0.45), col_mat))

    # statues (high-tessellation bumpy spheres) down the nave
    st = max(16, int(104 * d))
    for k, cx in enumerate((-7.5, -2.5, 2.5, 7.5)):
        meshes.append(bumpy_sphere(0.7, (cx, 1.0, 0.0), statue_mat,
                                   n_theta=st, n_phi=2 * st, bump=0.12,
                                   freq=7.0 + k))
    # one glass sphere and one metallic-mix sphere
    meshes.append(uv_sphere(0.6, (5.0, 0.8, -1.8), seg_t, 2 * seg_t,
                            glass_mat))
    meshes.append(uv_sphere(0.6, (-5.0, 0.8, 1.8), seg_t, 2 * seg_t,
                            mix_mat))

    # foliage: crossed alpha-cutout quads hanging between columns
    for i in range(-2, 3):
        for zs in (-3.0, 3.0):
            cx = i * 3.0 + 1.5
            meshes.append(quad((cx - 0.6, 2.2, zs), (1.2, 0, 0),
                               (0, 1.0, 0), leaf_mat))
            meshes.append(quad((cx, 2.2, zs - 0.6), (0, 0, 1.2),
                               (0, 1.0, 0), leaf_mat))

    lights = [(np.asarray(p, np.float32), np.full(3, power, np.float32))
              for p, power in LIGHTS]
    camera = dict(position=blender_to_engine_position(CAM_BLENDER_POS),
                  rotation=blender_to_engine_rotation(CAM_BLENDER_ROT),
                  fov_degrees=FOV_DEGREES)
    return dict(meshes=meshes, lights=lights, camera=camera,
                textures=textures)

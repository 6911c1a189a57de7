"""Differentiable scene replay for the material-test golden scenes (port of
`optixpathtracer_tpu/diff/replay.py`).

Everything a golden render depends on is a differentiable function of a
parameter dict, for a fitting loop through autograd:

  * geometry: sphere radius / grid spacing, wall positions. Every vertex
    of the scene is an affine function of these scalars, so the
    per-parameter vertex Jacobians are computed exactly by single-step
    finite differences of the procedural scene, and `scene_with` rebuilds
    tri_v0/e1/e2 from the parameters (gradients flow through
    intersect/api._refine: hit ids detach, hit parameters do not).
  * camera: position / Euler rotation / fov, through `raygen_with`, the
    tensor twin of `Camera.raygen_params` (`devicePrograms.cu:601-623`).
  * lights: per-light position deltas and a shared intensity scale.
  * materials: grouped albedos (spheres / back+floor+ceiling / green /
    blue, through a sigmoid), wall roughness.

Use with intersect method "pallas": the dense engine reads tri_v0/e1/e2
and `scene_with` hands it an empty cache, so it rebuilds its triangle
planes and chunk boxes from the replayed geometry. The walk and packet
engines read copies packed at flatten time and would sweep the old
triangles.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.math import cos_sin, cross, dot, exp, sqrt

GEO_KEYS = ("radius", "spacing", "back_x", "floor_y", "ceil_y",
            "grid_y", "grid_z")

# material-table group of each mesh in scene_material_test order:
# 36 spheres, then [back, green, blue, floor, ceiling] walls
N_SPHERES = 36
GROUPS = ("sphere", "back", "green", "blue")
_WALL_GROUP = [1, 2, 3, 1, 1]


def _concat_world_verts(model):
    """All mesh vertices, world space, concatenated in mesh order."""
    out = []
    for mesh in model.meshes:
        m = mesh.model_matrix()
        out.append(mesh.positions.astype(np.float64) @ m[:3, :3].T
                   + m[:3, 3])
    return np.concatenate(out).astype(np.float32)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _sigmoid(x):
    return 1.0 / (1.0 + exp(-x))


def _unit(v):
    return v / sqrt(dot(v, v))


def replay_params_from_jax(params, device="cuda"):
    """A reference replay's parameter dict (values as numpy arrays) as the
    port's tensors on `device`, for `MaterialTestReplay.scene_with`."""
    from ..scene.flatten import _device
    device = _device(device)
    return {k: torch.as_tensor(np.array(v, order="C"), device=device)
            for k, v in params.items()}


class MaterialTestReplay:
    """Replays scene_material_test geometry/camera/lights/materials as
    tensor functions of a parameter dict (see `init_params`), on `device`
    (the GPU unless the caller asks for the CPU)."""

    def __init__(self, kind: str, segments=(12, 24), geo: dict = None,
                 device="cuda"):
        from ..scene import flatten_model
        from ..scene.procedural import (GOLDEN_FIT, GOLDEN_GEO,
                                        scene_material_test)

        self.kind = kind
        self.segments = segments
        self.geo0 = dict(GOLDEN_GEO)
        self.geo0.update(GOLDEN_FIT.get(kind, {}))
        if geo:
            self.geo0.update(geo)

        model, camera, lights = scene_material_test(kind, self.geo0,
                                                    segments)
        self.camera0 = camera
        self.scene0 = flatten_model(model, lights, device=device)
        dev = self.device = self.scene0.device
        base = _concat_world_verts(model)
        self.base_verts = torch.as_tensor(base, device=dev)

        # exact affine Jacobians: vertex positions are affine in each geo
        # scalar, so a single +1 step recovers d(verts)/d(param) exactly
        jac = []
        for k in GEO_KEYS:
            g2 = dict(self.geo0)
            g2[k] = g2[k] + 1.0
            m2, _, _ = scene_material_test(kind, g2, segments)
            jac.append(_concat_world_verts(m2) - base)
        self.jac = torch.as_tensor(np.stack(jac), device=dev)  # [P, V, 3]

        # triangle corner -> concat vertex index, pre-BVH concat order
        tri_idx, off = [], 0
        for mesh in model.meshes:
            tri_idx.append(mesh.indices.astype(np.int64) + off)
            off += len(mesh.positions)
        self.tri_idx = torch.as_tensor(np.concatenate(tri_idx),
                                       device=dev)          # [T_real, 3]
        self.tri_src = self.scene0.tri_src.long()           # [T_pad]

        # material-table group map (flatten keeps mesh order)
        self.group_map = torch.as_tensor(
            np.array([0] * N_SPHERES + _WALL_GROUP, np.int64), device=dev)
        self.is_wall = torch.as_tensor(
            np.array([False] * N_SPHERES + [True] * 5), device=dev)

    def init_params(self):
        s = self.scene0
        a0 = np.zeros((len(GROUPS), 3), np.float32)
        alb = _host(s.mat_albedo)
        a0[0] = alb[:N_SPHERES].mean(axis=0)
        a0[1] = alb[[N_SPHERES, N_SPHERES + 3, N_SPHERES + 4]].mean(axis=0)
        a0[2] = alb[N_SPHERES + 1]
        a0[3] = alb[N_SPHERES + 2]
        a0 = np.clip(a0, 1e-3, 1 - 1e-3)
        wr = float(np.clip(self.geo0["wall_rough"], 1e-3, 1 - 1e-3))

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=self.device)

        return {
            "alb_logits": t(np.log(a0 / (1 - a0))),
            "wall_rough_logit": t(np.log(wr / (1 - wr))),
            "geo": t([self.geo0[k] for k in GEO_KEYS]),
            "cam_pos": t(self.camera0.position),
            "cam_rot": t(self.camera0.rotation),
            "fov": t(self.camera0.fov_degrees),
            "light_dpos": t(np.zeros((s.light_pos.shape[0], 3))),
            "light_logi": t(np.log(float(_host(s.light_color)[0, 0]))),
        }

    def scene_with(self, params):
        """scene0 with geometry/material/light fields replayed from params
        (all differentiable), and an empty cache, so no engine reuses the
        arrays it derived from scene0's triangles."""
        s = self.scene0
        geo0 = torch.tensor([self.geo0[k] for k in GEO_KEYS],
                            dtype=torch.float32, device=self.device)
        delta = params["geo"] - geo0
        offset = delta[0] * self.jac[0]
        for p in range(1, len(GEO_KEYS)):
            offset = offset + delta[p] * self.jac[p]
        verts = self.base_verts + offset
        tri = verts[self.tri_idx]                       # [T_real, 3, 3]
        src = self.tri_src
        v = tri[torch.clamp(src, min=0)]                # [T_pad, 3, 3]
        padded = (src < 0)[:, None]
        v0 = torch.where(padded, 1e10, v[:, 0])
        e1 = torch.where(padded, 0.0, v[:, 1] - v[:, 0])
        e2 = torch.where(padded, 0.0, v[:, 2] - v[:, 0])

        albedo = torch.clamp(_sigmoid(params["alb_logits"]), 1e-4, 1.0)
        mat_albedo = albedo[self.group_map]
        wall_rough = _sigmoid(params["wall_rough_logit"])
        mat_rough = torch.where(self.is_wall, wall_rough, s.mat_roughness)

        light_pos = s.light_pos + params["light_dpos"]
        light_color = (exp(params["light_logi"])
                       * torch.ones_like(s.light_color))
        return dataclasses.replace(
            s, tri_v0=v0, tri_e1=e1, tri_e2=e2, mat_albedo=mat_albedo,
            mat_roughness=mat_rough, light_pos=light_pos,
            light_color=light_color, cache={})

    def raygen_with(self, params, width: int, height: int):
        """(position, inv_view, inv_proj) as differentiable tensors: the
        twin of Camera.raygen_params (lookAt rows / analytic perspective
        inverse; the fovy-as-vertical quirk kept)."""
        pos = params["cam_pos"]
        cos_r, sin_r = cos_sin(params["cam_rot"] * (math.pi / 180.0))
        f = _unit(torch.stack([sin_r[1] * cos_r[0], -sin_r[0],
                               cos_r[0] * cos_r[1]]))
        up = torch.as_tensor(np.asarray(self.camera0.world_up, np.float32),
                             device=pos.device)
        s_ = _unit(cross(f, up))
        u = cross(s_, f)
        # inverse of the rigid lookAt: columns (s, u, -f), translation eye
        zero = torch.zeros((1,), device=pos.device)
        one = torch.ones((1,), device=pos.device)
        inv_view = torch.stack([torch.cat([s_, zero]), torch.cat([u, zero]),
                                torch.cat([-f, zero]), torch.cat([pos, one])],
                               dim=1)

        t = torch.tan((params["fov"] * (math.pi / 180.0)).double() / 2.0
                      ).float()
        aspect = width / height
        near, far = self.camera0.near, self.camera0.far
        m22 = -(far + near) / (far - near)
        m23 = -2.0 * far * near / (far - near)
        z = torch.zeros((), device=pos.device)

        def c(x):
            return torch.tensor(x, dtype=torch.float32, device=pos.device)

        inv_proj = torch.stack([
            torch.stack([aspect * t, z, z, z]),
            torch.stack([z, t, z, z]),
            torch.stack([z, z, z, c(-1.0)]),
            torch.stack([z, z, c(1.0 / m23), c(m22 / m23)])])
        return pos, inv_view, inv_proj

    def fitted_geo(self, params):
        """Host-side dict of fitted values in scene_material_test terms
        (paste into procedural.GOLDEN_FIT)."""
        albedo = 1.0 / (1.0 + np.exp(-_host(params["alb_logits"])))
        geo = {k: round(float(v), 5)
               for k, v in zip(GEO_KEYS, _host(params["geo"]))}
        geo.update(
            sphere_rgb=albedo[0].round(4).tolist(),
            back_rgb=albedo[1].round(4).tolist(),
            green_rgb=albedo[2].round(4).tolist(),
            blue_rgb=albedo[3].round(4).tolist(),
            wall_rough=round(float(
                1.0 / (1.0 + np.exp(-float(params["wall_rough_logit"])))),
                4),
            cam_pos=_host(params["cam_pos"]).round(5).tolist(),
            cam_rot=_host(params["cam_rot"]).round(4).tolist(),
            fov=round(float(params["fov"]), 4),
            light_dpos=_host(params["light_dpos"]).round(4).tolist(),
            light_scale=round(float(np.exp(_host(params["light_logi"]))),
                              4),
        )
        return geo

"""Euler-angle fly camera and inverse-matrix raygen
(port of `optixpathtracer_tpu/camera/camera.py`).

Matrices are built on the host in numpy (float64, then cast) exactly as the
reference builds them; the device ray generator consumes only (position,
inverse_view, inverse_projection). The reference's quirk is kept:
`fov_degrees` is applied vertically (glm::perspective's fovy).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.math import div, normalize


def blender_to_engine_position(p):
    """(x, y, z)_blender -> (x, z, -y)_engine (`GlmHelperMethods.cpp:4-6`)."""
    x, y, z = p
    return np.array([x, z, -y], np.float64)


def blender_to_engine_rotation(r):
    """(rx, ry, rz)_blender -> (90-rx, 180+rz, ry) (`GlmHelperMethods.cpp:8-10`)."""
    x, y, z = r
    return np.array([90.0 - x, 180.0 + z, y], np.float64)


def look_at(eye, center, up):
    """glm::lookAt (right-handed)."""
    eye = np.asarray(eye, np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fovy_radians, aspect, near=0.1, far=100.0):
    """glm::perspective (right-handed, [-1,1] clip depth), row-major."""
    t = np.tan(fovy_radians / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -2.0 * far * near / (far - near)
    m[3, 2] = -1.0
    return m


@dataclasses.dataclass
class Camera:
    """Fly camera; world up (0,1,0), default FOV 40 degrees
    (reference `Camera.h:6`, `Camera.cpp:7`)."""
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    rotation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))  # degrees: (pitch, yaw, roll)
    fov_degrees: float = 40.0
    near: float = 0.1
    far: float = 100.0
    world_up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0]))

    @classmethod
    def from_blender(cls, position, rotation_degrees, fov_degrees=40.0):
        """Build from a Blender-convention pose as the scene presets do."""
        return cls(position=blender_to_engine_position(position),
                   rotation=blender_to_engine_rotation(rotation_degrees),
                   fov_degrees=fov_degrees)

    def forward(self):
        """Pitch/yaw -> forward (reference `Camera.cpp:37-49`)."""
        r = np.radians(self.rotation)
        x = np.sin(r[1]) * np.cos(r[0])
        y = -np.sin(r[0])
        z = np.cos(r[0]) * np.cos(r[1])
        v = np.array([x, y, z])
        return v / np.linalg.norm(v)

    def view_matrix(self):
        return look_at(self.position, self.position + self.forward(),
                       self.world_up)

    def projection_matrix(self, aspect):
        return perspective(np.radians(self.fov_degrees), aspect,
                           self.near, self.far)

    def raygen_params(self, width, height, device="cuda"):
        """(position, inv_view, inv_proj) as float32 tensors on `device`
        (the GPU unless the caller asks for the CPU)."""
        from ..scene.flatten import _device
        device = _device(device)
        inv_view = np.linalg.inv(self.view_matrix())
        inv_proj = np.linalg.inv(self.projection_matrix(width / height))
        return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                     for a in (self.position, inv_view, inv_proj))


def generate_rays(position, inv_view, inv_proj, width, height,
                  pixel_x=None, pixel_y=None):
    """World-space primary rays (reference `devicePrograms.cu:601-623`):
    (origins, directions), each [..., 3]. pixel_x/pixel_y (float32
    tensors of one shape) default to the pixel centres of the full image,
    [height, width], row 0 at the bottom (GL convention)."""
    if pixel_x is None or pixel_y is None:
        device = inv_proj.device
        pixel_y, pixel_x = torch.meshgrid(
            torch.arange(height, dtype=torch.float32, device=device),
            torch.arange(width, dtype=torch.float32, device=device),
            indexing="ij")
    x_ndc = div(pixel_x + 0.5, float(width)) * 2.0 - 1.0
    y_ndc = div(pixel_y + 0.5, float(height)) * 2.0 - 1.0
    one = torch.ones_like(x_ndc)
    ndc = (x_ndc, y_ndc, one, one)
    p_view = _mat_vec(inv_proj, ndc)
    p_view[3] = torch.zeros_like(x_ndc)  # a direction: drop w
    p_world = _mat_vec(inv_view, p_view)
    d = normalize(torch.stack(p_world[:3], dim=-1))
    return position.expand_as(d), d


def jittered_rays(seed, position, inv_view, inv_proj, width, height):
    """Primary rays with a per-sample sub-pixel jitter, for antialiased
    accumulation (the reference shoots through pixel centres,
    `devicePrograms.cu:607-608`). seed: [height, width] (int64 holding
    u32). Returns (seed, o, d)."""
    from ..core import rng
    device = inv_proj.device
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    seed, u = rng.rnd2(seed)
    px = xs + u[..., 0] - 0.5
    py = ys + u[..., 1] - 0.5
    o, d = generate_rays(position, inv_view, inv_proj, width, height, px, py)
    return seed, o, d


def _mat_vec(m, x):
    """The reference's float32 `x @ m.T` for the 4-vectors x = (x0, x1, x2,
    x3): row j is x0*m[j,0] + x1*m[j,1] + x2*m[j,2] + x3*m[j,3], each
    product and sum rounded to float32 in index order. Elementwise, with no
    BLAS (cuBLAS and the CPU's BLAS order and fuse the sums differently)
    and no float64, so every device rounds as the reference does."""
    out = []
    for j in range(4):
        acc = x[0] * m[j, 0]
        for k in range(1, 4):
            acc = acc + x[k] * m[j, k]
        out.append(acc)
    return out

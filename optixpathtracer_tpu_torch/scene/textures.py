"""Texture sampling (port of `optixpathtracer_tpu/scene/textures.py`):
bilinear, wrap addressing, raw values then the shader-side sRGB decode, as
the reference's CUDA texture objects (linear filter, wrap, sRGB off,
`OptixRenderer.cpp:595-612`) and its `SRGB8ToLinear` (`devicePrograms.cu:
62-73`).

Every operation rounds as the reference's does and the same on every
device: the decode's power goes through `core.math.pow` and its divisions
through `core.math.div`.
"""
from __future__ import annotations

import torch

from ..core.math import div, pow


def srgb_to_linear(c):
    """Per-channel sRGB EOTF, applied to all four channels alpha included
    (the reference's vec4 decode, `devicePrograms.cu:62-73`)."""
    a = div(c, 12.92)
    b = pow(div(c + 0.055, 1.055), 2.4)
    return torch.where(c <= 0.04045, a, b)


def sample_bilinear(textures, tex_id, u, v):
    """Sample textures[tex_id] at (u, v) with wrap addressing and bilinear
    filtering: textures [K, R, R, 4]; tex_id [...] int (clamped, so callers
    mask by tex_id >= 0); u, v [...] float. Texel centres lie at
    (i + 0.5) / R, CUDA's convention for normalised coordinates."""
    k, res = textures.shape[0], textures.shape[1]
    tid = tex_id.clamp(0, k - 1).long()

    # wrap to [0, 1)
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)

    x = uu * res - 0.5
    y = vv * res - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def _texel(xi, yi):
        # floor-mod, as jnp.mod on ints: -1 wraps to res - 1
        xi = torch.remainder(xi.to(torch.int64), res)
        yi = torch.remainder(yi.to(torch.int64), res)
        return textures[tid, yi, xi]

    c00 = _texel(x0, y0)
    c10 = _texel(x0 + 1, y0)
    c01 = _texel(x0, y0 + 1)
    c11 = _texel(x0 + 1, y0 + 1)
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy

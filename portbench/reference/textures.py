"""Frozen copies of `optixpathtracer_tpu_torch/scene/textures.py` (whole, imports
rewritten) and of the texture resample of
`optixpathtracer_tpu_torch/scene/flatten.py` (`TEXTURE_RES`,
`_resize_texture`, here `resize_texture`) for the benchmark's plain
reference, so that a later change to the port does not move the
yardstick. The original docstring follows.

Texture sampling (port of `optixpathtracer_tpu/scene/textures.py`):
bilinear, wrap addressing, raw values then the shader-side sRGB decode, as
the reference's CUDA texture objects (linear filter, wrap, sRGB off,
`OptixRenderer.cpp:595-612`) and its `SRGB8ToLinear` (`devicePrograms.cu:
62-73`).

Every operation rounds as the reference's does and the same on every
device: the decode's power goes through `core.math.pow` and its divisions
through `core.math.div`.
"""
from __future__ import annotations

import numpy as np
import torch

from .pmath import div, pow

TEXTURE_RES = 256  # uniform texture array resolution (bilinear-resampled)


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


def resize_texture(pixels: np.ndarray, res: int) -> np.ndarray:
    """Bilinear resample [H, W, 4] -> [res, res, 4] via PIL."""
    if pixels.shape[0] == res and pixels.shape[1] == res:
        return pixels.astype(np.float32)
    from PIL import Image
    out = np.zeros((res, res, 4), np.float32)
    for c in range(4):
        img = Image.fromarray(pixels[..., c].astype(np.float32), mode="F")
        out[..., c] = np.asarray(img.resize((res, res), Image.BILINEAR))
    return out

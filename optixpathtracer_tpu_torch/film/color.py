"""Color transfer and tonemapping (port of `optixpathtracer_tpu/film/
color.py`; reference `Final.frag`).

The display transform is PBRT's linear->sRGB transfer
(`Final.frag:12-17,33`); the AgX tonemapper the reference implemented but
left commented out (`Final.frag:23,104-130`) is an option.

The transfers take tensors (or arrays, which become float32 CPU tensors)
and return float32 tensors on the input's device, differentiable, so a
fitting loss can sit on top of them. Their `pow` goes through `core.math`:
evaluated in float64 and rounded once, the same on every device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.math import div, pow as _pow


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.as_tensor(np.asarray(x, np.float32))


def linear_to_srgb(x):
    """PBRT linear->sRGB transfer (`Final.frag:12-17`)."""
    x = _f32(x)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * _pow(torch.clamp(x, min=0.0), 1.0 / 2.4)
                       - 0.055)


def srgb_to_linear(x):
    x = _f32(x)
    return torch.where(x <= 0.04045, div(x, 12.92),
                       _pow(div(x + 0.055, 1.055), 2.4))


# --- AgX (reference `Final.frag:104-130`, Blender/Troy Sobotka fit) ---

_AGX_MAT = np.array([
    [0.842479062253094, 0.0423282422610123, 0.0423756549057051],
    [0.0784335999999992, 0.878468636469772, 0.0784336],
    [0.0792237451477643, 0.0791661274605434, 0.879142973793104]], np.float32)

_AGX_MAT_INV = np.array([
    [1.19687900512017, -0.0528968517574562, -0.0529716355144438],
    [-0.0980208811401368, 1.15190312990417, -0.0980434501171241],
    [-0.0990297440797205, -0.0989611768448433, 1.15107367264116]], np.float32)

_AGX_MIN_EV = -12.47393
_AGX_MAX_EV = 4.026069


def _agx_default_contrast(x):
    """6th-order polynomial sigmoid approximation."""
    x2 = x * x
    x4 = x2 * x2
    return (15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4 - 6.868 * x2 * x
            + 0.4298 * x2 + 0.1191 * x - 0.00232)


def agx_tonemap(rgb):
    """AgX display transform on linear rgb [H, W, 3], on the host in numpy
    as in the reference (a display option, not a fitting loss)."""
    v = np.asarray(rgb, np.float32) @ _AGX_MAT.T
    v = np.clip(np.log2(np.maximum(v, 1e-10)), _AGX_MIN_EV, _AGX_MAX_EV)
    v = (v - _AGX_MIN_EV) / (_AGX_MAX_EV - _AGX_MIN_EV)
    v = _agx_default_contrast(v)
    v = np.clip(v, 0.0, 1.0) @ _AGX_MAT_INV.T
    # AgX outputs an sRGB-encoded-ish signal; linearize then let the caller
    # apply the standard display transfer for consistency.
    return np.clip(v, 0.0, 1.0)

"""Frozen copy of `optixpathtracer_tpu_torch/core/rng.py` for the benchmark's
plain reference (imports rewritten; nothing else changed), so that a
later change to the port does not move the yardstick. The original
docstring follows.

Counter-free, stream-per-ray RNG: the TEA/LCG generators of
`optixpathtracer_tpu/core/rng.py`, bit for bit.

Each lane carries its 32-bit seed as one element of an int64 tensor. torch's
`uint32` has no `+`, `<<` or `>>`, so the arithmetic runs in int64 and is
masked back to 32 bits with `& 0xFFFFFFFF`. That is exact: the widest
intermediate is `1664525 * seed + 1013904223` < 2^53, and the low 32 bits of
a sum, product, xor or left shift depend only on the low 32 bits of its
operands (right shifts are taken of masked values). No global RNG is used
anywhere.
"""
from __future__ import annotations

import torch

from .pmath import cos_sin, sqrt

MASK32 = 0xFFFFFFFF


def _u32(x, like=None):
    """As an int64 tensor holding a 32-bit unsigned value."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    device = like.device if like is not None else None
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK32


def tea(val0, val1, rounds: int = 16):
    """TEA hash of two u32 words (reference `random.h:33-48` tea<N>)."""
    v0 = _u32(val0)
    v1 = _u32(val1, like=v0)
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & MASK32
        v0 = (v0 + (((v1 << 4) + 0xA341316C)
                    ^ (v1 + s0)
                    ^ ((v1 >> 5) + 0xC8013EA4))) & MASK32
        v1 = (v1 + (((v0 << 4) + 0xAD90777D)
                    ^ (v0 + s0)
                    ^ ((v0 >> 5) + 0x7E95761E))) & MASK32
    return v0


def lcg(seed):
    """One LCG step; returns (new_seed, 24-bit random value)
    (reference `random.h:51-57`)."""
    new = (1664525 * _u32(seed) + 1013904223) & MASK32
    return new, new & 0x00FFFFFF


def rnd(seed):
    """Uniform float32 in [0, 1); returns (new_seed, u)
    (reference `random.h:66-69`)."""
    new, bits = lcg(seed)
    return new, bits.to(torch.float32) * (1.0 / 0x01000000)


def rnd2(seed):
    """Two uniforms; returns (new_seed, u2[..., 2])."""
    seed, u0 = rnd(seed)
    seed, u1 = rnd(seed)
    return seed, torch.stack([u0, u1], dim=-1)


def pixel_seed(width, x, y, frame_id):
    """Per-(pixel, frame) stream seed: tea<16>(w*y + x, frame)
    (reference `devicePrograms.cu:631`)."""
    y = _u32(y)
    return tea((width * y + _u32(x, like=y)) & MASK32,
               _u32(frame_id, like=y), rounds=16)


def float_hash_seed(*floats_and_seeds):
    """Chained TEA reseed from float-derived keys, as the layered BSDF does:
    tea(x*1000, y*1000) chained (reference `GlossyDiffuse.h:215-218,
    417-418`). A float key is 1000 * x truncated toward zero to int32 and
    taken modulo 2^32, as the reference's float -> unsigned conversion
    wraps on the GPU; an integer tensor is a u32 seed."""
    vals = []
    for v in floats_and_seeds:
        if v.is_floating_point():
            vals.append((v * 1000.0).to(torch.int32).to(torch.int64) & MASK32)
        else:
            vals.append(_u32(v))
    s = tea(vals[0], vals[1], rounds=16)
    for v in vals[2:]:
        s = tea(s, v, rounds=16)
    return s


def sample_uniform_disk_polar(seed):
    """r = sqrt(u0), theta = 2 pi u1 (reference `random.h:76-84`).
    Returns (seed, p[..., 2])."""
    seed, u = rnd2(seed)
    r = sqrt(u[..., 0])
    theta = (2.0 * 3.14159265359) * u[..., 1]
    cos, sin = cos_sin(theta)
    return seed, torch.stack([r * cos, r * sin], dim=-1)


def sample_uniform_disk_concentric(seed):
    """Concentric disk map (reference `LambertDiffuse.h:35-55`).
    Returns (seed, p[..., 2])."""
    pi_over_4 = 0.78539816339744830961
    pi_over_2 = 1.57079632679489661923
    seed, u = rnd2(seed)
    uo = 2.0 * u - 1.0
    ux, uy = uo[..., 0], uo[..., 1]
    degenerate = (ux == 0.0) & (uy == 0.0)
    use_x = ux.abs() > uy.abs()
    r = torch.where(use_x, ux, uy)
    # Guard the divisions; the degenerate case is folded into the final
    # where (the reference divides unguarded behind an early return).
    safe_ux = torch.where(ux == 0.0, 1.0, ux)
    safe_uy = torch.where(uy == 0.0, 1.0, uy)
    theta = torch.where(use_x, pi_over_4 * (uy / safe_ux),
                        pi_over_2 - pi_over_4 * (ux / safe_uy))
    cos, sin = cos_sin(theta)
    p = torch.stack([r * cos, r * sin], dim=-1)
    return seed, torch.where(degenerate[..., None], 0.0, p)


def sample_cosine_hemisphere(seed):
    """Cosine-weighted hemisphere via the concentric disk
    (reference `LambertDiffuse.h:57-61`). Returns (seed, w[..., 3])."""
    seed, d = sample_uniform_disk_concentric(seed)
    z = sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2,
                               min=0.0))
    return seed, torch.stack([d[..., 0], d[..., 1], z], dim=-1)

"""Frozen copy of `optixpathtracer_tpu_torch/core/math.py` for the benchmark's
plain reference (imports rewritten; nothing else changed), so that a
later change to the port does not move the yardstick. The original
docstring follows.

Core math helpers (port of `optixpathtracer_tpu/core/math.py`).

Vectors are tensors whose last axis has size 3. The local shading frame has
the normal at +z. Products and sums are written out component by component
in the reference's order (`jnp.cross`'s formula, left-to-right dots), so the
port rounds where the reference does. Divisions and square roots keep the
reference's guards, which also keep gradients finite at masked lanes.

A tensor is never divided by a Python number other than a power of two, nor
a Python number other than +-1 by a tensor: on CUDA, PyTorch computes
`x / c` as `x * (1 / c)`, and everywhere `c / x` as `(1 / x) * c`, each
rounding twice. Such a division goes through a tensor divisor (`div`).
"""
from __future__ import annotations

import torch

INV_PI = 0.31830988618379067154
PI = 3.14159265358979323846


def sqr(x):
    """x^2 (reference `glmCUDA.h` Sqr)."""
    return x * x


def div(num, den):
    """num / den, correctly rounded on every device, where num or den may
    be a Python number (see the module docstring)."""
    like = den if isinstance(den, torch.Tensor) else num
    if not isinstance(num, torch.Tensor):
        num = torch.full_like(like, num)
    if not isinstance(den, torch.Tensor):
        den = torch.full_like(like, den)
    return torch.div(num, den)


def ipow(x, n: int):
    """x ** n for a positive int n by binary exponentiation, multiplying in
    the order `jnp`'s integer power does (x^5 = x * ((x*x) * (x*x))):
    `torch.pow` with a float exponent rounds differently."""
    acc = None
    while n:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def dot(a, b):
    """Dot product over the trailing axis."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def abs_dot(a, b):
    """|a . b| (reference `glmCUDA.h` AbsDot)."""
    return dot(a, b).abs()


def sqrt(x):
    """Correctly rounded float32 square root on every device. CUDA's sqrtf
    is; PyTorch's vectorised CPU sqrt is one ulp off on some float32
    arguments (XLA's and numpy's are not), so on the CPU it is taken in
    float64 and rounded once, which is exact for a square root."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def length_sqr(v):
    return dot(v, v)


def length(v):
    return sqrt(length_sqr(v))


def safe_sqrt(x):
    """sqrt clamped to 0 below, with a zero gradient at x <= 0."""
    ok = x > 0.0
    return torch.where(ok, sqrt(torch.where(ok, x, 1.0)), 0.0)


def safe_div(num, den, eps: float = 0.0):
    """num / den with 0 where den == 0 (|den| <= eps for eps > 0)."""
    den_ok = den != 0.0 if eps == 0.0 else den.abs() > eps
    return torch.where(den_ok, num / torch.where(den_ok, den, 1.0), 0.0)


def normalize(v, eps: float = 1e-20):
    """v / |v|, 0 for zero-length vectors (gradient-safe)."""
    len2 = length_sqr(v)
    ok = len2 > eps
    inv = torch.where(ok, 1.0 / sqrt(torch.where(ok, len2, 1.0)), 0.0)
    return v * inv[..., None]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def face_forward(v, ref):
    """Flip v so it lies in the same hemisphere as ref."""
    s = torch.sign(dot(v, ref))
    s = torch.where(s == 0.0, 1.0, s)
    return v * s[..., None]


def reflect(wo, n):
    """PBRT-style reflect: wo and the result both point away from the
    surface (reference `Conductor.h:154-156`)."""
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


def vec3(x, y, z):
    """Stack three broadcastable component tensors into a trailing-3
    vector."""
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def splat3(s):
    """Broadcast [...] to a [..., 3] vector."""
    return s[..., None].expand(s.shape + (3,))


# Spherical geometry in the local shading frame (normal = +z), reference
# `PBRT/SphericalGeometry.h`.

def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return sqr(w[..., 2])


def abs_cos_theta(w):
    return w[..., 2].abs()


def sin2_theta(w):
    return torch.clamp(1.0 - cos2_theta(w), min=0.0)


def sin_theta(w):
    return safe_sqrt(sin2_theta(w))


def tan_theta(w):
    return safe_div(sin_theta(w), cos_theta(w))


def tan2_theta(w):
    """sin^2 / cos^2, +inf where cos == 0 as in the reference
    (`Microfacet.h:13` tests isinf)."""
    c2 = cos2_theta(w)
    s2 = sin2_theta(w)
    return torch.where(c2 > 0.0, s2 / torch.where(c2 > 0.0, c2, 1.0),
                       float("inf"))


def cos_phi(w):
    st = sin_theta(w)
    return torch.where(st == 0.0, 1.0,
                       torch.clamp(safe_div(w[..., 0], st), -1.0, 1.0))


def sin_phi(w):
    st = sin_theta(w)
    return torch.where(st == 0.0, 0.0,
                       torch.clamp(safe_div(w[..., 1], st), -1.0, 1.0))


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


def cos_sin(theta):
    """(cos, sin) of a float32 angle, evaluated in float64 and rounded once
    to float32. float32 libms differ by an ulp on some arguments (CUDA's
    cosf/sinf, the CPU's vectorised ones, XLA's), which would make the GPU
    and CPU renders part at the first sampled direction; the float64 values
    round to the same float32 on every device, and to the nearest one."""
    t = theta.double()
    return torch.cos(t).float(), torch.sin(t).float()


def exp(x):
    """exp of a float32 tensor, evaluated in float64 and rounded once to
    float32, for the reason given in `cos_sin`."""
    return torch.exp(x.double()).float()


def pow(x, p: float):
    """x ** p of a float32 tensor for a float exponent, evaluated in float64
    and rounded once to float32, for the reason given in `cos_sin` (CUDA's
    powf, the CPU's and XLA's differ by an ulp)."""
    return torch.pow(x.double(), p).float()


def spherical_direction(sin_t, cos_t, phi):
    """(sinT cosPhi, sinT sinPhi, cosT) (reference `SphericalGeometry.h`)."""
    cos_phi, sin_phi = cos_sin(phi)
    return vec3(sin_t * cos_phi, sin_t * sin_phi, cos_t)


def coordinate_system(v1):
    """Branchless orthonormal basis (v2, v3) of a unit vector, with
    [v2, v3, v1] right-handed (reference `GlossyDiffuse.h:32-38`)."""
    z = v1[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = v1[..., 0] * v1[..., 1] * a
    v2 = vec3(1.0 + sign * sqr(v1[..., 0]) * a, sign * b, -sign * v1[..., 0])
    v3 = vec3(b, sign + sqr(v1[..., 1]) * a, -v1[..., 1])
    return v2, v3


def build_tangent_space(n):
    """The reference's tangent frame (`devicePrograms.cu:168-184`): the
    longer of n x (0,0,1) and n x (0,1,0) is the tangent, bitangent =
    tangent x n. Returns (tangent, bitangent)."""
    z = torch.zeros_like(n[..., 0])
    one = torch.ones_like(z)
    c1 = cross(n, torch.stack([z, z, one], dim=-1))
    c2 = cross(n, torch.stack([z, one, z], dim=-1))
    use_c1 = (length_sqr(c1) > length_sqr(c2))[..., None]
    t = normalize(torch.where(use_c1, c1, c2))
    return t, cross(t, n)


def to_local(t, b, n, v_world):
    """World -> shading space (rows are the frame axes)."""
    return torch.stack([dot(v_world, t), dot(v_world, b), dot(v_world, n)],
                       dim=-1)


def to_world(t, b, n, v_local):
    """Shading -> world space (TBN columns)."""
    return (v_local[..., 0:1] * t + v_local[..., 1:2] * b
            + v_local[..., 2:3] * n)

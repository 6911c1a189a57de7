"""Launchers of the BSDF kernels (`csrc/layered_bsdf.cu`) for
`dispatch.py`, which alone decides when they run: `layered_f` (the layered
lobe's f walks, on the lanes of that type), `lobes_f` (the closed-form
lobes' value) and `lobes_sample` (a sample of any lobe). Each lane
evaluates only its own lobe, bit for bit the plain lobes of this package;
the lanes' types come from `mat_type`. Each launcher counts its launches
(`.launches`).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .base import BSDFSample
from .glossy_diffuse import _F32_TINY, MAX_DEPTH, N_SAMPLES, THICKNESS

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "layered_f": [_P] * 7 + [_I, _I, _I, _I, _F, _I, _P, _P, _P],
    "lobes_f": [_P] * 6 + [_I, _I, _P, _P, _P],
    "lobes_sample": [_P] * 6 + [_I, _I, _P, _I, _F, _I] + [_P] * 7,
}


def _fn(name):
    fn = getattr(_build.load("layered_bsdf"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _lanes(wo, *specs):
    """Each (x, dtype, tail) of `specs` broadcast to wo's lanes and made
    contiguous as [n, *tail]; raise unless it is of that dtype on wo's
    CUDA device. A Python number becomes a tensor of the dtype."""
    batch, out = wo.shape[:-1], []
    for x, dtype, tail in specs:
        if not isinstance(x, torch.Tensor):
            x = torch.full((), x, dtype=dtype, device=wo.device)
        if not (x.is_cuda and x.device == wo.device and x.dtype == dtype):
            raise ValueError(f"kernel input {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}: expected {dtype} on {wo.device}")
        out.append(x.expand(batch + tail).reshape((-1,) + tail).contiguous())
    if out[0].shape[0] >= 2**31:
        raise ValueError("too many lanes for one launch")
    return out


def _ptr(x):
    return None if x is None else x.data_ptr()


def _out(out, wo):
    """`out`, or a new float32 tensor of wo's shape; raise unless it is a
    contiguous one on wo's device."""
    if out is None:
        return torch.empty(wo.shape, dtype=torch.float32, device=wo.device)
    if not (out.shape == wo.shape and out.dtype == torch.float32
            and out.device == wo.device and out.is_contiguous()):
        raise ValueError(f"kernel output {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}: expected contiguous float32 "
                         f"{tuple(wo.shape)} on {wo.device}")
    return out


def _launch(name, *args, device):
    with torch.cuda.device(device):
        err = _fn(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _layer_args(n_samples, max_depth, thickness):
    if n_samples < 1 or max_depth < 0:
        raise ValueError(f"n_samples {n_samples} < 1 or max_depth "
                         f"{max_depth} < 0")
    return -abs(thickness), int(abs(thickness) <= _F32_TINY)


def layered_f(seed, mat_type, albedo, roughness, wo, wi, eta, out=None,
              others=True, n_samples=N_SAMPLES, max_depth=MAX_DEPTH,
              thickness=THICKNESS, ops=None):
    """Launch the layered lobe's f kernel: the lobe's rgb on each lane whose
    int32 `mat_type` is the layered lobe's; a lane of another type walks
    nothing, and its rgb is written zero where `others`, else left as it
    is in `out` (a contiguous float32 tensor of wo's shape, or None for a
    new one). Returns `out`. ops: None, or a CUDA uint64 [2] tensor the
    kernel adds its FP32 operations and float64 calls to."""
    neg_dz, thin = _layer_args(n_samples, max_depth, thickness)
    f32 = torch.float32
    wo_l, wi_l, seed_l, alb_l, rough_l, eta_l, type_l = _lanes(
        wo, (wo, f32, (3,)), (wi, f32, (3,)), (seed, torch.int64, ()),
        (albedo, f32, (3,)), (roughness, f32, ()), (eta, f32, ()),
        (mat_type, torch.int32, ()))
    out = _out(out, wo)
    _launch("layered_f", seed_l.data_ptr(), type_l.data_ptr(),
            alb_l.data_ptr(), rough_l.data_ptr(), wo_l.data_ptr(),
            wi_l.data_ptr(), eta_l.data_ptr(), wo_l.shape[0], int(others),
            n_samples, max_depth, neg_dz, thin, out.data_ptr(), _ptr(ops),
            device=wo.device)
    layered_f.launches += 1
    return out


def lobes_f(mat_type, albedo, roughness, wo, wi, eta, mask, out, ops=None):
    """Launch the closed-form lobes' f kernel into `out` (a contiguous
    float32 tensor of wo's shape): lobe t's value on each lane of type t
    whose bit is in `mask`, zero on the others, but the layered lanes where
    mask has the layered lobe's bit, which are layered_f's and left as
    they are. ops: see layered_f."""
    f32 = torch.float32
    type_l, alb_l, rough_l, wo_l, wi_l, eta_l = _lanes(
        wo, (mat_type, torch.int32, ()), (albedo, f32, (3,)),
        (roughness, f32, ()), (wo, f32, (3,)), (wi, f32, (3,)),
        (eta, f32, ()))
    out = _out(out, wo)
    _launch("lobes_f", type_l.data_ptr(), alb_l.data_ptr(),
            rough_l.data_ptr(), wo_l.data_ptr(), wi_l.data_ptr(),
            eta_l.data_ptr(), wo_l.shape[0], mask, out.data_ptr(), _ptr(ops),
            device=wo.device)
    lobes_f.launches += 1


def lobes_sample(seed, mat_type, albedo, roughness, wo, eta, mask, draws,
                 max_depth=MAX_DEPTH, thickness=THICKNESS, ops=None):
    """Launch the sample kernel: lobe t's sample on each lane of type t
    (int32 `mat_type`) whose bit is in `mask`, the invalid sample on the
    others. Every lobe t of `mask` takes draws[t] lcg steps on every lane,
    in lobe order, a lane sampling its own from the seed at that lobe's
    offset. Returns (seed, BSDFSample). ops: see layered_f."""
    neg_dz, thin = _layer_args(1, max_depth, thickness)
    f32 = torch.float32
    batch, dev = wo.shape[:-1], wo.device
    wo_l, seed_l, alb_l, rough_l, eta_l, type_l = _lanes(
        wo, (wo, f32, (3,)), (seed, torch.int64, ()), (albedo, f32, (3,)),
        (roughness, f32, ()), (eta, f32, ()), (mat_type, torch.int32, ()))
    seed_out = torch.empty(batch, dtype=torch.int64, device=dev)
    color = torch.empty(wo.shape, dtype=f32, device=dev)
    direction = torch.empty(wo.shape, dtype=f32, device=dev)
    pdf = torch.empty(batch, dtype=f32, device=dev)
    flags = torch.empty((5,) + batch, dtype=torch.bool, device=dev)
    _launch("lobes_sample", seed_l.data_ptr(), type_l.data_ptr(),
            alb_l.data_ptr(), rough_l.data_ptr(), wo_l.data_ptr(),
            eta_l.data_ptr(), wo_l.shape[0], mask, (ctypes.c_int * 4)(*draws),
            max_depth, neg_dz, thin, seed_out.data_ptr(), color.data_ptr(),
            direction.data_ptr(), pdf.data_ptr(), flags.data_ptr(), _ptr(ops),
            device=dev)
    lobes_sample.launches += 1
    return seed_out, BSDFSample(color, direction, pdf, *flags.unbind(0))


layered_f.launches = 0
lobes_f.launches = 0
lobes_sample.launches = 0

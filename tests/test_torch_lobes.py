"""Port parity of the conductor, dielectric and layered glossy-diffuse lobes
and of the four-lobe dispatch, against the JAX package run op by op
(`jax.disable_jit()`) on the same numpy-made inputs and seeds; and the
white-furnace and consistency checks of tests/test_bsdf.py, run on the
port.

Seeds must come out bit-identical. Values must agree within rtol 1e-5 /
atol 1e-6 on at least 99.9% of lanes. The few lanes outside that are
traced to one source: the cos and sin of `rng.sample_uniform_disk_polar`.
The port evaluates them in float64 and rounds once (`core.math.cos_sin`,
so the GPU and the CPU agree); XLA's float32 cos and sin differ from that
by one ulp on some arguments. That ulp moves the sampled microfacet
normal by an ulp or so, which a lane amplifies past 1e-5 where the value is
ill-conditioned in it: a near-delta NDF (alpha ~ 3e-3, where D changes
0.5% per ulp of wm). With the inputs below that is a few of the 4096
layered samples, in f and pdf but not in their ratio, the weight the integrator
takes (see `assert_sample_close`); no branch (lobe choice, TIR, roulette)
flips on them.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.bsdf import conductor as jconductor
from optixpathtracer_tpu.bsdf import dielectric as jdielectric
from optixpathtracer_tpu.bsdf import dispatch as jdispatch
from optixpathtracer_tpu.bsdf import glossy_diffuse as jglossy
from optixpathtracer_tpu.core import fresnel as jfresnel
from optixpathtracer_tpu.core import rng as jrng
from optixpathtracer_tpu_torch.bsdf import (conductor, dielectric, diffuse,
                                            dispatch, glossy_diffuse, kernels)
from optixpathtracer_tpu_torch.core import fresnel, rng
from optixpathtracer_tpu_torch.core.math import abs_cos_theta, normalize

torch.set_num_threads(1)

N = 4096
MIN_CLOSE = 0.999


@pytest.fixture(scope="module")
def inputs():
    r = np.random.default_rng(3)

    def unit(n):
        v = r.normal(size=(n, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    rough = r.uniform(0, 1, N).astype(np.float32)
    rough[::7] = 0.0  # smooth (delta) lanes
    return dict(wo=unit(N), wi=unit(N),
                albedo=r.uniform(0, 1, (N, 3)).astype(np.float32),
                rough=rough,
                ior=r.uniform(1.2, 2.0, N).astype(np.float32),
                seed=r.integers(0, 2**32, N, dtype=np.uint64).astype(
                    np.uint32),
                mat_type=r.integers(0, 4, N).astype(np.int32))


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                            else a.copy())


def assert_close(got, want, what, min_close=MIN_CLOSE):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype == np.bool_:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    assert np.isfinite(got).all(), what
    close = np.isclose(got, want, rtol=1e-5, atol=1e-6)
    close = close.reshape(close.shape[0], -1).all(axis=1)
    assert close.mean() >= min_close, (what, close.mean())


def assert_seed_equal(got, want):
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want))


def _weight(color, direction, pdf):
    """The throughput factor the integrator takes: f |cos| / pdf."""
    color, direction, pdf = (np.asarray(a) for a in (color, direction, pdf))
    return (color * np.abs(direction[:, 2:3])
            / np.where(pdf == 0.0, 1.0, pdf)[:, None])


def assert_sample_close(got, want, what):
    """Every field, and the throughput weight f |cos| / pdf. The layered
    walk's f and pdf are products over up to ten interface events, so a
    near-delta coat multiplies the sampler's ulp (see the module docstring)
    into relative differences of several percent in each factor on a few
    lanes here; their ratio, the weight, agrees on every lane."""
    for k in want._fields:
        assert_close(getattr(got, k).numpy(), getattr(want, k),
                     f"{what}.{k}")
    assert_close(_weight(got.color, got.direction, got.pdf),
                 _weight(want.color, want.direction, want.pdf),
                 f"{what} weight")


def test_float_hash_seed_and_polar_disk(inputs):
    x = inputs
    with jax.disable_jit():
        want = jrng.float_hash_seed(x["wo"][:, 0], x["wo"][:, 1],
                                    x["wi"][:, 0], jnp.asarray(x["seed"]))
        jseed, jp = jrng.sample_uniform_disk_polar(jnp.asarray(x["seed"]))
    got = rng.float_hash_seed(_t(x["wo"][:, 0]), _t(x["wo"][:, 1]),
                              _t(x["wi"][:, 0]), _t(x["seed"]))
    assert_seed_equal(got, want)
    tseed, tp = rng.sample_uniform_disk_polar(_t(x["seed"]))
    assert_seed_equal(tseed, jseed)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)


def test_fresnel_terms(inputs):
    x = inputs
    cos = x["wo"][:, 2]
    with jax.disable_jit():
        want = {
            "conductor": jfresnel.fresnel_conductor(np.abs(cos), x["albedo"]),
            "dielectric": jfresnel.fresnel_dielectric(cos, x["ior"]),
            "schlick": jfresnel.fresnel_schlick(x["albedo"],
                                                np.abs(cos)[:, None]),
            "f82": jfresnel.fresnel_82(x["albedo"], x["albedo"] * 0.5,
                                       np.abs(cos)[:, None]),
        }
        jvalid, jetap, jwt = jfresnel.refract(x["wo"], x["wi"], x["ior"])
    got = {
        "conductor": fresnel.fresnel_conductor(_t(np.abs(cos)),
                                               _t(x["albedo"])),
        "dielectric": fresnel.fresnel_dielectric(_t(cos), _t(x["ior"])),
        "schlick": fresnel.fresnel_schlick(_t(x["albedo"]),
                                           _t(np.abs(cos)[:, None])),
        "f82": fresnel.fresnel_82(_t(x["albedo"]), _t(x["albedo"] * 0.5),
                                  _t(np.abs(cos)[:, None])),
    }
    for k in want:
        assert_close(got[k].numpy(), want[k], k)
    valid, etap, wt = fresnel.refract(_t(x["wo"]), _t(x["wi"]), _t(x["ior"]))
    assert_close(valid.numpy(), jvalid, "refract.valid")
    assert_close(etap.numpy(), jetap, "refract.etap")
    assert_close(wt.numpy(), jwt, "refract.wt")


def test_conductor_f_sample_pdf(inputs):
    x = inputs
    args = (x["albedo"], x["rough"], x["wo"])
    with jax.disable_jit():
        jf = jconductor.f(*args, x["wi"])
        jp = jconductor.pdf(x["rough"], x["wo"], x["wi"])
        jseed, js = jconductor.sample(jnp.asarray(x["seed"]), *args)
    targs = [_t(a) for a in args]
    assert_close(conductor.f(*targs, _t(x["wi"])).numpy(), jf, "f")
    assert_close(conductor.pdf(_t(x["rough"]), _t(x["wo"]),
                               _t(x["wi"])).numpy(), jp, "pdf")
    tseed, ts = conductor.sample(_t(x["seed"]), *targs)
    assert_seed_equal(tseed, jseed)
    assert_sample_close(ts, js, "sample")


@pytest.mark.parametrize("radiance_mode", [True, False])
def test_dielectric_f_sample_pdf(inputs, radiance_mode):
    x = inputs
    with jax.disable_jit():
        jf = jdielectric.f(x["rough"], x["wo"], x["wi"], eta=x["ior"],
                           radiance_mode=radiance_mode)
        jseed, js = jdielectric.sample(jnp.asarray(x["seed"]), x["rough"],
                                       x["wo"], eta=x["ior"],
                                       radiance_mode=radiance_mode)
    rough, wo, wi, ior = (_t(x[k]) for k in ("rough", "wo", "wi", "ior"))
    assert_close(dielectric.f(rough, wo, wi, eta=ior,
                              radiance_mode=radiance_mode).numpy(), jf, "f")
    tseed, ts = dielectric.sample(_t(x["seed"]), rough, wo, eta=ior,
                                  radiance_mode=radiance_mode)
    assert_seed_equal(tseed, jseed)
    assert_sample_close(ts, js, "sample")


@pytest.mark.parametrize("reflection,transmission",
                         [(True, True), (True, False), (False, True)])
def test_dielectric_pdf_and_one_sided_sample(inputs, reflection,
                                             transmission):
    x = inputs
    with jax.disable_jit():
        jp = jdielectric.pdf(x["rough"], x["wo"], x["wi"], eta=x["ior"],
                             reflection=reflection, transmission=transmission)
        jseed, js = jdielectric.sample(
            jnp.asarray(x["seed"]), x["rough"], x["wo"], eta=x["ior"],
            reflection=reflection, transmission=transmission)
    rough, wo, wi, ior = (_t(x[k]) for k in ("rough", "wo", "wi", "ior"))
    assert_close(dielectric.pdf(rough, wo, wi, eta=ior, reflection=reflection,
                                transmission=transmission).numpy(), jp,
                 "pdf")
    tseed, ts = dielectric.sample(_t(x["seed"]), rough, wo, eta=ior,
                                  reflection=reflection,
                                  transmission=transmission)
    assert_seed_equal(tseed, jseed)
    assert_sample_close(ts, js, "sample")


def test_glossy_diffuse_f(inputs):
    x = inputs
    with jax.disable_jit():
        jseed, jf = jglossy.f(jnp.asarray(x["seed"]), x["albedo"], x["rough"],
                              x["wo"], x["wi"], eta=x["ior"])
    tseed, tf = glossy_diffuse.f(_t(x["seed"]), _t(x["albedo"]),
                                 _t(x["rough"]), _t(x["wo"]), _t(x["wi"]),
                                 eta=_t(x["ior"]))
    assert_seed_equal(tseed, jseed)
    assert_close(tf.numpy(), jf, "f")
    assert (tf.numpy() >= 0).all()


def test_glossy_diffuse_sample(inputs):
    x = inputs
    with jax.disable_jit():
        jseed, js = jglossy.sample(jnp.asarray(x["seed"]), x["albedo"],
                                   x["rough"], x["wo"], eta=x["ior"])
    tseed, ts = glossy_diffuse.sample(_t(x["seed"]), _t(x["albedo"]),
                                      _t(x["rough"]), _t(x["wo"]),
                                      eta=_t(x["ior"]))
    assert_seed_equal(tseed, jseed)
    assert_sample_close(ts, js, "sample")


def _mats(x, mod, conv, n):
    return mod.MaterialParams(albedo=conv(x["albedo"][:n]),
                              metallic=conv(np.zeros(n, np.float32)),
                              roughness=conv(x["rough"][:n]),
                              ior=conv(x["ior"][:n]),
                              mat_type=conv(x["mat_type"][:n]))


def test_dispatch_mixed_lanes(inputs):
    """f, sample and pdf over lanes of all four resolved types, with every
    lobe active: every lobe draws on every lane, so the seeds stay
    bit-identical."""
    x = inputs
    n = N // 2
    jm = _mats(x, jdispatch, jnp.asarray, n)
    tm = _mats(x, dispatch, _t, n)
    seed, wo, wi = x["seed"][:n], x["wo"][:n], x["wi"][:n]
    with jax.disable_jit():
        jseed_f, jf = jdispatch.f(jnp.asarray(seed), jm, wo, wi)
        jseed_s, js = jdispatch.sample(jnp.asarray(seed), jm, wo)
        jp = jdispatch.pdf(jm, wo, wi, layered="approx")
        jp_err = jdispatch.pdf(jm, wo, wi)
    tseed_f, tf = dispatch.f(_t(seed), tm, _t(wo), _t(wi))
    assert_seed_equal(tseed_f, jseed_f)
    assert_close(tf.numpy(), jf, "f")
    tseed_s, ts = dispatch.sample(_t(seed), tm, _t(wo))
    assert_seed_equal(tseed_s, jseed_s)
    assert_sample_close(ts, js, "sample")
    assert_close(dispatch.pdf(tm, _t(wo), _t(wi), layered="approx").numpy(),
                 jp, "pdf")
    p_err = dispatch.pdf(tm, _t(wo), _t(wi)).numpy()
    layered = x["mat_type"][:n] == dispatch.GLOSSY_DIFFUSE
    assert np.isnan(p_err[layered]).all()
    assert_close(p_err[~layered], np.asarray(jp_err)[~layered], "pdf error")
    with pytest.raises(ValueError):
        dispatch.pdf(tm, _t(wo), _t(wi), layered="bogus")


# ---------------------------------------------------------------------------
# tests/test_bsdf.py's checks, on the port
# ---------------------------------------------------------------------------

N_FURNACE = 16384


def _random_wo(seed, n_dirs):
    """Uniform hemisphere directions off the pole and horizon."""
    u = np.random.default_rng(seed).uniform(size=(n_dirs, 2))
    z = u[:, 0] * 0.98 + 0.01
    r = np.sqrt(1.0 - z * z)
    phi = 2.0 * np.pi * u[:, 1]
    return torch.from_numpy(np.stack([r * np.cos(phi), r * np.sin(phi), z],
                                     axis=-1).astype(np.float32))


def _furnace(sample_fn, wo, n_samples=N_FURNACE):
    """Max channel per wo of the mean of f |cos| / pdf over n_samples
    draws, all draws in one wavefront."""
    n_dirs = wo.shape[0]
    seeds = rng.tea(torch.arange(n_dirs * n_samples, dtype=torch.int64),
                    0xC0FFEE)
    _, s = sample_fn(seeds, wo.repeat(n_samples, 1))
    contrib = (s.color * abs_cos_theta(s.direction)[..., None]
               / torch.where(s.pdf == 0.0, 1.0, s.pdf)[..., None])
    contrib = torch.where((s.valid & (s.pdf > 0.0))[..., None], contrib, 0.0)
    return contrib.reshape(n_samples, n_dirs, 3).mean(dim=0).amax(dim=-1)


def _const(n, value):
    return torch.full((n,), value)


def test_diffuse_furnace():
    wo = _random_wo(0, 8)
    est = _furnace(lambda s, w: diffuse.sample(s, torch.ones(w.shape), w),
                   wo)
    np.testing.assert_allclose(est.numpy(), 1.0, atol=1e-3)


@pytest.mark.parametrize("lobe", ["conductor", "dielectric",
                                  "dielectric_importance", "glossy_diffuse"])
@pytest.mark.parametrize("roughness", [0.0, 0.5, 1.0])
def test_white_furnace(lobe, roughness):
    """White lobes conserve energy (reference `SpherGeom_Test.cpp:28-252`):
    below 1.01 (1.02 for the dielectric), and exactly 1 for a smooth
    dielectric in importance mode."""
    n_samples = 4096 if lobe == "glossy_diffuse" else N_FURNACE
    wo = _random_wo(1, 4 if lobe == "glossy_diffuse" else 8)

    def sample_fn(s, w):
        n = w.shape[0]
        rough = _const(n, roughness)
        if lobe == "conductor":
            return conductor.sample(s, torch.ones(n, 3), rough, w)
        if lobe == "glossy_diffuse":
            return glossy_diffuse.sample(s, torch.ones(n, 3), rough, w)
        return dielectric.sample(s, rough, w,
                                 radiance_mode=lobe == "dielectric")

    est = _furnace(sample_fn, wo, n_samples)
    assert float(est.max()) < (1.01 if lobe in ("conductor", "glossy_diffuse")
                               else 1.02)
    if lobe == "dielectric_importance" and roughness == 0.0:
        np.testing.assert_allclose(est.numpy(), 1.0, atol=1e-3)


def test_conductor_smooth_is_mirror_and_sample_matches_eval():
    wo = normalize(torch.tensor([[0.3, 0.2, 0.9]]))
    _, s = conductor.sample(torch.tensor([7]), torch.ones(1, 3),
                            torch.zeros(1), wo)
    np.testing.assert_allclose(s.direction.numpy(),
                               (wo * torch.tensor([-1.0, -1.0, 1.0])).numpy(),
                               atol=1e-6)
    assert bool(s.specular[0]) and float(s.pdf[0]) == 1.0
    n = 1024
    wo = normalize(torch.tensor([0.4, 0.1, 0.8])).expand(n, 3)
    seeds = rng.tea(torch.arange(n), 21)
    rough, alb = _const(n, 0.5), torch.full((n, 3), 0.8)
    _, s = conductor.sample(seeds, alb, rough, wo)
    m = s.valid.numpy()
    np.testing.assert_allclose(s.color.numpy()[m],
                               conductor.f(alb, rough, wo,
                                           s.direction).numpy()[m],
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(s.pdf.numpy()[m],
                               conductor.pdf(rough, wo,
                                             s.direction).numpy()[m],
                               rtol=1e-3, atol=1e-5)


def test_dielectric_snell_and_sample_matches_eval():
    n = 4096
    wo = normalize(torch.tensor([0.5, 0.0, 0.7])).expand(n, 3)
    _, s = dielectric.sample(rng.tea(torch.arange(n), 33), torch.zeros(n), wo)
    trans = (s.transmission & s.valid).numpy()
    assert trans.sum() > 100
    wt = s.direction.numpy()[trans]
    sin_i = float(torch.linalg.norm(wo[0, :2]))
    np.testing.assert_allclose(np.linalg.norm(wt[:, :2], axis=-1),
                               sin_i / 1.5, atol=1e-5)
    assert (wt[:, 2] < 0).all()
    wo = normalize(torch.tensor([0.2, -0.3, 0.8])).expand(n, 3)
    rough = _const(n, 0.7)
    _, s = dielectric.sample(rng.tea(torch.arange(n), 55), rough, wo)
    m = (s.valid & (s.pdf > 1e-6)).numpy()
    np.testing.assert_allclose(
        s.color.numpy()[m], dielectric.f(rough, wo, s.direction).numpy()[m],
        rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(
        s.pdf.numpy()[m], dielectric.pdf(rough, wo, s.direction).numpy()[m],
        rtol=2e-3, atol=1e-4)


def test_glossy_diffuse_f_properties():
    """Nonnegative with a diffuse-like mean; zero for transmission pairs;
    two-sided."""
    n = 512
    wo = normalize(torch.tensor([0.3, 0.0, 0.9])).expand(n, 3)
    wi = normalize(torch.tensor([-0.2, 0.4, 0.8])).expand(n, 3)
    _, fv = glossy_diffuse.f(rng.tea(torch.arange(n), 77),
                             torch.full((n, 3), 0.8), _const(n, 0.5), wo, wi)
    assert (fv >= 0).all() and 0.05 < float(fv.mean(dim=0)[0]) < 0.5
    _, fv = glossy_diffuse.f(torch.tensor([3]), torch.ones(1, 3),
                             _const(1, 0.5), torch.tensor([[0.0, 0.0, 1.0]]),
                             torch.tensor([[0.1, 0.0, -0.99]]))
    assert float(fv.abs().max()) == 0.0
    wo = normalize(torch.tensor([[0.3, 0.1, 0.9]]))
    wi = normalize(torch.tensor([[-0.1, 0.2, 0.95]]))
    args = (torch.tensor([11]), torch.full((1, 3), 0.7), _const(1, 0.4))
    _, f_up = glossy_diffuse.f(*args, wo, wi)
    _, f_dn = glossy_diffuse.f(*args, -wo, -wi)
    np.testing.assert_allclose(f_up.numpy(), f_dn.numpy(), atol=1e-6)


def test_glossy_diffuse_kernel_routing(inputs, monkeypatch):
    """The BSDF takes its CUDA kernels only for CUDA inputs that autograd
    does not record, as `dispatch.uses_kernel` alone decides: never on the
    CPU; with the device check made to answer CUDA, not while grad mode is
    on and an input requires grad, and otherwise yes."""
    n = 8
    mat = _mats(inputs, dispatch, _t, n)
    seed, wo, wi = (_t(inputs[k][:n]) for k in ("seed", "wo", "wi"))
    grad_mat = mat._replace(roughness=mat.roughness.clone().requires_grad_())
    assert not dispatch.uses_kernel(seed, grad_mat, wo, wi)
    with torch.no_grad():
        assert not dispatch.uses_kernel(seed, mat, wo)

    monkeypatch.setattr(dispatch, "_on_cuda", lambda x: True)
    assert not dispatch.uses_kernel(seed, grad_mat, wo, wi)
    assert dispatch.uses_kernel(seed, mat, wo, wi)
    assert dispatch.uses_kernel(seed, mat, wo)
    with torch.no_grad():
        assert dispatch.uses_kernel(seed, grad_mat, wo, wi)
    with torch.enable_grad():
        for field in ("albedo", "roughness", "ior"):
            leaf = getattr(mat, field).clone().requires_grad_()
            assert not dispatch.uses_kernel(
                seed, mat._replace(**{field: leaf}), wo), field
        assert not dispatch.uses_kernel(seed, mat, wo.clone()
                                        .requires_grad_())
        assert not dispatch.uses_kernel(seed, mat, wo, wi.clone()
                                        .requires_grad_())


def test_dispatch_kernel_routing(inputs, monkeypatch):
    """`dispatch.f` and `sample` take their kernels only where
    `dispatch.uses_kernel` holds: never on the CPU, not while grad mode is
    on and an input requires grad; and hand them the active lobes."""
    n = 16
    mat = _mats(inputs, dispatch, _t, n)
    seed, wo, wi = (_t(inputs[k][:n]) for k in ("seed", "wo", "wi"))
    calls = []
    monkeypatch.setattr(dispatch, "f_kernel", lambda s, m, wo, wi, lobes:
                        calls.append(("f", lobes)) or (s, None))
    monkeypatch.setattr(dispatch, "sample_kernel", lambda s, m, wo, lobes:
                        calls.append(("sample", lobes)) or (s, None))

    def run(mat, **kw):
        dispatch.f(seed, mat, wo, wi, **kw)
        dispatch.sample(seed, mat, wo, **kw)

    run(mat)
    assert calls == []  # the CPU: the plain dispatch ran
    monkeypatch.setattr(dispatch, "_on_cuda", lambda x: True)
    grad_mat = mat._replace(albedo=mat.albedo.clone().requires_grad_())
    run(grad_mat)
    assert calls == []  # autograd records the albedo
    with torch.no_grad():
        run(grad_mat)
    run(mat, active_lobes=(dispatch.DIFFUSE, dispatch.GLOSSY_DIFFUSE))
    every, two = dispatch.ALL_LOBES, (dispatch.DIFFUSE,
                                      dispatch.GLOSSY_DIFFUSE)
    assert calls == [("f", every), ("sample", every), ("f", two),
                     ("sample", two)]


def _tensors(out):
    """The tensors of a (seed, rgb) or (seed, BSDFSample)."""
    seed, rest = out
    return [seed] + ([rest] if isinstance(rest, torch.Tensor) else list(rest))


PLAIN_CALLS = {
    "dispatch.f_plain": lambda seed, mat, wo, wi: dispatch.f_plain(
        seed, mat, wo, wi, dispatch.ALL_LOBES),
    "dispatch.sample_plain": lambda seed, mat, wo, wi: dispatch.sample_plain(
        seed, mat, wo, dispatch.ALL_LOBES),
    "glossy_diffuse.f": lambda seed, mat, wo, wi: glossy_diffuse.f(
        seed, mat.albedo, mat.roughness, wo, wi, eta=mat.ior),
    "glossy_diffuse.sample": lambda seed, mat, wo, wi: glossy_diffuse.sample(
        seed, mat.albedo, mat.roughness, wo, eta=mat.ior),
}


@pytest.mark.parametrize("call", list(PLAIN_CALLS))
def test_plain_bsdf_launches_no_kernel(inputs, monkeypatch, call):
    """Only `dispatch.f` and `sample` choose the kernels: with the device
    check made to answer CUDA and no grad, where they would launch, the
    plain dispatch and the layered lobe launch no kernel and give what
    they give on the CPU, bit for bit."""
    n = 64
    mat = _mats(inputs, dispatch, _t, n)
    seed, wo, wi = (_t(inputs[k][:n]) for k in ("seed", "wo", "wi"))
    run = PLAIN_CALLS[call]
    with torch.no_grad():
        want = run(seed, mat, wo, wi)
    launched = []
    monkeypatch.setattr(dispatch, "_on_cuda", lambda x: True)
    monkeypatch.setattr(kernels, "_launch",
                        lambda name, *a, **k: launched.append(name))
    with torch.no_grad():
        assert dispatch.uses_kernel(seed, mat, wo, wi)
        got = run(seed, mat, wo, wi)
    assert launched == []
    got, want = _tensors(got), _tensors(want)
    assert len(got) == len(want) and all(map(torch.equal, got, want))


def _lcg_steps(seed, advanced, most=64):
    """k such that k lcg steps take every lane of `seed` to `advanced`."""
    for k in range(most + 1):
        if torch.equal(seed, advanced):
            return k
        seed = rng.lcg(seed)[0]
    raise AssertionError(f"not within {most} lcg steps of the input")


@pytest.mark.parametrize("lobes", [
    lobes for k in range(len(dispatch.ALL_LOBES) + 1)
    for lobes in itertools.combinations(dispatch.ALL_LOBES, k)])
def test_sample_draw_counts(inputs, lobes):
    """The draws the sample kernel steps a lane past each lobe by
    (`dispatch.SAMPLE_DRAWS`) are the lcg steps each plain lobe's sample
    takes on every lane, whatever its type: their sum over the lobes is
    the plain dispatch's step on every lane, for every set of lobes."""
    n = 64
    mat = _mats(inputs, dispatch, _t, n)
    seed, wo = _t(inputs["seed"][:n]), _t(inputs["wo"][:n])
    advanced, _ = dispatch.sample_plain(seed, mat, wo, lobes)
    assert _lcg_steps(seed, advanced) == sum(
        dispatch.SAMPLE_DRAWS[lobe] for lobe in lobes)


@pytest.mark.parametrize("max_depth", [0, 7, 12])
def test_layered_sample_draw_count(inputs, max_depth):
    """`glossy_diffuse.sample_draws` is the plain layered sample's lcg
    steps at any walk depth."""
    n = 64
    x = {k: _t(inputs[k][:n]) for k in ("seed", "albedo", "rough", "wo",
                                         "ior")}
    advanced, _ = glossy_diffuse.sample(
        x["seed"], x["albedo"], x["rough"], x["wo"], x["ior"],
        max_depth=max_depth)
    assert _lcg_steps(x["seed"], advanced) == glossy_diffuse.sample_draws(
        max_depth)


def test_metallic_mix_resolution():
    n = 4096
    mat = dispatch.MaterialParams(
        albedo=torch.full((n, 3), 0.5), metallic=_const(n, 0.3),
        roughness=_const(n, 0.5), ior=_const(n, 1.5),
        mat_type=torch.full((n,), dispatch.METALLIC_MIX, dtype=torch.int32))
    _, resolved = dispatch.resolve_stochastic_lobe(
        rng.tea(torch.arange(n), 2), mat)
    frac = float((resolved.mat_type == dispatch.CONDUCTOR).float().mean())
    assert abs(frac - 0.3) < 0.03
    assert not (resolved.mat_type == dispatch.METALLIC_MIX).any()

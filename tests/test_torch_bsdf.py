"""Port parity of the diffuse BSDF and the dispatch around it, with the same
numpy-made inputs and seeds handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.bsdf import diffuse as jdiffuse
from optixpathtracer_tpu.bsdf import dispatch as jdispatch
from optixpathtracer_tpu_torch.bsdf import diffuse, dispatch

torch.set_num_threads(1)

N = 4096


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)

    def unit(n):
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    wo, wi = unit(N), unit(N)
    albedo = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    seed = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    # mostly diffuse lanes, some of another (resolved) type: with only the
    # diffuse lobe active those must come out zero / invalid
    mat_type = np.where(rng.uniform(size=N) < 0.8, 0, 1).astype(np.int32)
    rough = rng.uniform(0, 1, N).astype(np.float32)
    return dict(wo=wo, wi=wi, albedo=albedo, seed=seed, mat_type=mat_type,
                rough=rough)


def _mats(x, mod, conv):
    return mod.MaterialParams(albedo=conv(x["albedo"]),
                              metallic=conv(np.zeros(N, np.float32)),
                              roughness=conv(x["rough"]),
                              ior=conv(np.full(N, 1.5, np.float32)),
                              mat_type=conv(x["mat_type"]))


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                            else a.copy())


def test_diffuse_f_pdf_sample(inputs):
    x = inputs
    np.testing.assert_allclose(
        diffuse.f(_t(x["albedo"]), _t(x["wo"]), _t(x["wi"])).numpy(),
        np.asarray(jdiffuse.f(x["albedo"], x["wo"], x["wi"])),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        diffuse.pdf(_t(x["wo"]), _t(x["wi"])).numpy(),
        np.asarray(jdiffuse.pdf(x["wo"], x["wi"])), rtol=1e-5, atol=1e-5)
    jseed, js = jdiffuse.sample(jnp.asarray(x["seed"]), x["albedo"], x["wo"])
    tseed, ts = diffuse.sample(_t(x["seed"]), _t(x["albedo"]), _t(x["wo"]))
    np.testing.assert_array_equal(tseed.numpy().astype(np.uint32),
                                  np.asarray(jseed))
    for k in js._fields:
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(js, k)),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_dispatch_f_and_sample(inputs):
    x = inputs
    lobes = (jdispatch.DIFFUSE,)
    jm = _mats(x, jdispatch, jnp.asarray)
    tm = _mats(x, dispatch, _t)
    jseed, jf = jdispatch.f(jnp.asarray(x["seed"]), jm, x["wo"], x["wi"],
                            active_lobes=lobes)
    tseed, tf = dispatch.f(_t(x["seed"]), tm, _t(x["wo"]), _t(x["wi"]),
                           active_lobes=lobes)
    np.testing.assert_array_equal(tseed.numpy().astype(np.uint32),
                                  np.asarray(jseed))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-5)
    assert (tf.numpy()[x["mat_type"] != 0] == 0).all()

    jseed, js = jdispatch.sample(jnp.asarray(x["seed"]), jm, x["wo"],
                                 active_lobes=lobes)
    tseed, ts = dispatch.sample(_t(x["seed"]), tm, _t(x["wo"]),
                                active_lobes=lobes)
    np.testing.assert_array_equal(tseed.numpy().astype(np.uint32),
                                  np.asarray(jseed))
    for k in js._fields:
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(js, k)),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    # backfacing wo samples the mirrored (-z) hemisphere
    back = (x["wo"][:, 2] < 0) & (x["mat_type"] == 0)
    assert (ts.direction.numpy()[back, 2] <= 0).all()


def test_resolve_stochastic_lobe_and_unported_lobes(inputs):
    x = inputs
    mix = dict(x, mat_type=np.full(N, jdispatch.METALLIC_MIX, np.int32))
    jm = _mats(mix, jdispatch, jnp.asarray)._replace(
        metallic=jnp.asarray(x["rough"]))
    tm = _mats(mix, dispatch, _t)._replace(metallic=_t(x["rough"]))
    jseed, jr = jdispatch.resolve_stochastic_lobe(jnp.asarray(x["seed"]), jm)
    tseed, tr = dispatch.resolve_stochastic_lobe(_t(x["seed"]), tm)
    np.testing.assert_array_equal(tseed.numpy().astype(np.uint32),
                                  np.asarray(jseed))
    np.testing.assert_array_equal(tr.mat_type.numpy(),
                                  np.asarray(jr.mat_type))
